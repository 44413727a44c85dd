"""MUSIC-AVQA annotation and answer-vocabulary readers.

This package's own copy of ``qa_tiger_tpu/data/annotations.py``.
Annotation schema (``data/annots/music_avqa/*.json``): ``{video_id,
question_id, type: '["Modality","QType"]', question_content (templated
text), templ_values, question_deleted, anser[sic]}``. The answer vocabulary
file (``answer2idx.json``) holds ``{ans2ix: {...}, max_que_len: N}``.

The 9-way question-type index (reference: src/dataset.py:22-27) doubles as
the metrics' bucket id everywhere; this is the port's one table of it.
"""
from __future__ import annotations

import ast
import json
from pathlib import Path

# modality -> qtype -> bucket index (reference: src/dataset.py:22-27)
qtype2idx: dict[str, dict[str, int]] = {
    "Audio": {"Counting": 0, "Comparative": 1},
    "Visual": {"Counting": 2, "Location": 3},
    "Audio-Visual": {"Existential": 4, "Counting": 5, "Location": 6,
                     "Comparative": 7, "Temporal": 8},
}

NUM_QTYPES = 9

# bucket index -> (modality, qtype), for report formatting
idx2qtype: list[tuple[str, str]] = [("", "")] * NUM_QTYPES
for _mod, _types in qtype2idx.items():
    for _qt, _ix in _types.items():
        idx2qtype[_ix] = (_mod, _qt)


def qtype_index(type_str: str) -> int:
    """'["Audio", "Counting"]' -> 0 (``ast.literal_eval`` like the
    reference, src/dataset.py:112-116)."""
    modality, qtype = ast.literal_eval(type_str)
    return qtype2idx[modality][qtype]


def load_annotations(path: str | Path) -> list[dict]:
    with open(Path(path)) as f:
        return json.load(f)


def load_answer_vocab(path: str | Path) -> tuple[dict[str, int], int]:
    """Returns (answer -> index map, max question length)."""
    with open(Path(path)) as f:
        info = json.load(f)
    return info["ans2ix"], info.get("max_que_len", 77)


def substitute_template(question_content: str, templ_values: str) -> str:
    """Fill '<...>' slots with templ_values (the offline question-feature
    extractor's behaviour, scripts/extract_clip_feat/extract_qst_...py:69-79).

    The dataset's online tokenization feeds the raw templated text with its
    placeholders left in (reference: src/dataset.py:127-128); trained
    checkpoints expect that, so the dataset never calls this.
    """
    values = (ast.literal_eval(templ_values)
              if isinstance(templ_values, str) else list(templ_values or []))
    words = question_content.rstrip().split(" ")
    if words:
        words[-1] = words[-1][:-1]  # drop the trailing '?' from the last word
    vi = 0
    for pos, w in enumerate(words):
        if "<" in w and vi < len(values):
            words[pos] = values[vi]  # the whole word replaced, like the extractor
            vi += 1
    return " ".join(words) + "?"
