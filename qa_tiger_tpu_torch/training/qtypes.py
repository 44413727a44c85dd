"""The 9-way question-type buckets of MUSIC-AVQA.

This package's own copy of ``NUM_QTYPES`` and ``idx2qtype`` from
``qa_tiger_tpu/data/annotations.py:19-32`` (reference: src/dataset.py:22-27):
the bucket index doubles as the metrics' counter index.
"""
from __future__ import annotations

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
