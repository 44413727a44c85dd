"""Shared by the port's data and CLI tests: a CLIP BPE merges file learned
from real MUSIC-AVQA questions, and a small corpus of those questions over
synthetic features, with a config file for the entry points.

The real merges file (``bpe_simple_vocab_16e6.txt.gz``) is not in the
repository; ``write_merges`` (the port's ``data.bpe``) writes one in the
same format (a header line, then one merge per line) with a few hundred
merges.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from qa_tiger_tpu_torch.data.bpe import write_merges  # noqa: F401  (the tests import it here)

REPO = Path(__file__).resolve().parents[1]
ANNOTS = REPO / "data" / "annots" / "music_avqa"
VAL_JSON = ANNOTS / "music_avqa_val.json"
ANSWERS_JSON = ANNOTS / "answer2idx.json"


def val_questions() -> list[dict]:
    return json.loads(VAL_JSON.read_text())


def write_corpus(root: Path, splits: dict[str, tuple[int, int]], dims: dict[str, tuple],
                 seed: int = 0) -> Path:
    """Under ``root``: ``<split>.json`` holding the val file's questions
    [start, stop) for each split, ``answer2idx.json`` (the real 42
    answers), and one fp32 ``.npy`` per video and feature directory
    (``dims``: directory -> item shape) drawn from ``seed``."""
    root.mkdir(parents=True, exist_ok=True)
    questions = val_questions()
    videos = []
    for split, (start, stop) in splits.items():
        part = questions[start:stop]
        (root / f"{split}.json").write_text(json.dumps(part))
        videos += [q["video_id"] for q in part]
    (root / "answer2idx.json").write_text(ANSWERS_JSON.read_text())
    rng = np.random.default_rng(seed)
    for sub, shape in dims.items():
        (root / sub).mkdir(exist_ok=True)
        for vid in sorted(set(videos)):
            np.save(root / sub / f"{vid}.npy", rng.standard_normal(shape, dtype=np.float32))
    return root


def write_config(path: Path, data_root: Path, out_dir: Path, model: dict, **top) -> Path:
    """A config file in the shape of ``configs/qa-tiger/vitl14.py`` over
    ``write_corpus``'s files; ``top`` overrides top-level keys, and
    ``platform`` / ``cache_qst_features`` go into ``hyper_params``."""
    hyper = {k: top.pop(k) for k in ("platform", "cache_qst_features") if k in top}
    batch = top.pop("batch_size", 8)
    config = dict(
        type="qa-tiger", seed=1, epochs=1, num_labels=42, log_interval=100,
        output_dir=str(out_dir), weight="",
        data=dict(root=str(data_root), img_size=336, batch_size=batch, eval_batch_size=batch,
                  num_workers=0, frame_sample_rate=1, train_annot="train.json",
                  valid_annot="val.json", test_annot="test.json", test_annots=None,
                  ans_quelen="answer2idx.json", quest_feat=None, audio_feat="vggish",
                  video_feat="clip", patch_feat="tome", prompt_feat=None),
        hyper_params=dict(
            gpus="0", model_type="QA-TIGER_test", model=model, **hyper,
            optim=dict(lr=1e-3, encoder_lr=None, min_lr=1e-7, weight_decay=0,
                       betas=(0.95, 0.999)),
            sched=dict(name="StepLR", mode="min", gamma=0.1, step_size=8, factor=0.5,
                       patience=5, verbose=True, warmup_epochs=1)))
    config.update(top)
    path.write_text(f"config = {config!r}\n")
    return path
