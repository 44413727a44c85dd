"""Question answering over extracted features: ``Predictor``, and the
single-question entry point ``python -m qa_tiger_tpu_torch.predict``.

``Predictor`` is the model half of ``src/predict.py``, widened from one
question to a batch of requests: the config's model is built (weights from a
seed, a state_dict, a JAX parameter pytree or a ``best.npz``), cast to the
serving dtype as ``bench.py`` casts it, and each call to ``answer`` runs one
forward over the batch and names the top-k answers from the config's
``answer2idx.json``. Questions arrive as CLIP token ids [N, 77], e.g. from
``data.ClipTokenizer`` (which reads the CLIP BPE merges file).

The entry point is the port of ``src/predict.py``: it answers one question
about one video from the config's feature directories and prints the top-k
answers with their probabilities as one JSON line::

    python -m qa_tiger_tpu_torch.predict --config configs/qa-tiger/vitl14.py \\
        --weight best.npz --video 00000093 \\
        --question "How many instruments are sounding in the video?" [--topk 5]

The model runs in fp32, as the JAX entry point runs it, on the device
``hyper_params.platform`` names (the card unless it says "cpu"; no
fallback).
"""
from __future__ import annotations

import argparse
import json
import sys
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from qa_tiger_tpu_torch.convert import load_npz, params_from_jax
from qa_tiger_tpu_torch.data.dataset import load_video_features
from qa_tiger_tpu_torch.data.tokenizer import ClipTokenizer
from qa_tiger_tpu_torch.models.qa_tiger import check_text_ctx
from qa_tiger_tpu_torch.models.registry import build_model, resolve_device, select_device
from qa_tiger_tpu_torch.models.tspm import TOKEN_IDS_REFUSED, TSPM
from qa_tiger_tpu_torch.training.checkpoint import load_checkpoint, load_clip_text_state
from qa_tiger_tpu_torch.utils.config import load_config_module

ROOT = Path(__file__).resolve().parents[1]


def answer_vocab(cfg: Mapping) -> dict[int, str]:
    """index -> answer name, from the config's ``data.ans_quelen`` file."""
    root = Path(cfg["data"]["root"])
    if not root.is_absolute():
        root = ROOT / root
    vocab = json.loads((root / cfg["data"]["ans_quelen"]).read_text())["ans2ix"]
    return {int(i): name for name, i in vocab.items()}


def top_indices(probs: np.ndarray, k: int) -> np.ndarray:
    """The indices of the ``k`` largest values along the last axis, largest
    first; on ties the lower index first (``np.argmax``'s choice for the
    top-1). ``torch.topk`` leaves the order of ties undefined."""
    return np.argsort(-probs, axis=-1, kind="stable")[..., :k]


def answer_payload(probs: np.ndarray, ix2ans: Mapping[int, str], topk: int) -> dict:
    """One row's ``{"answer": name, "topk": [{"answer": name, "prob": p},
    ...]}`` from its [num_labels] probabilities, probabilities rounded to 4
    places as the JAX entry points print them."""
    top = top_indices(probs, topk)
    names = [ix2ans.get(int(i), str(int(i))) for i in top]
    return {"answer": names[0],
            "topk": [{"answer": n, "prob": round(float(probs[i]), 4)}
                     for n, i in zip(names, top)]}


class Predictor:
    """Answers batches of questions about extracted audio/video features.

    ``config`` is a config file path or its loaded dict. The model runs on
    ``device`` (``cuda`` unless given; without a GPU, pass ``"cpu"``) in
    ``dtype``. ``weights`` is None (random weights from ``seed``), a path to
    a ``best.npz``, or a mapping: a ``state_dict`` or a JAX parameter pytree
    of numpy arrays. Loading is strict.

    A TSPM config raises ``NotImplementedError``, the JAX entry point's
    error: questions arrive as token ids, and TSPM reads precomputed
    question and prompt features only.
    """

    def __init__(self, config, device: str | torch.device | None = None,
                 dtype: torch.dtype = torch.bfloat16, weights=None, seed: int = 0):
        cfg = load_config_module(str(config)) if isinstance(config, (str, Path)) \
            else config
        self.device = resolve_device(device)
        self.dtype = dtype
        self.ix2ans = answer_vocab(cfg)
        hp = cfg["hyper_params"]
        model = build_model(hp["model_type"], hp["model"],
                            num_labels=len(self.ix2ans), device="cpu",
                            seed=seed)
        if isinstance(model, TSPM):
            raise NotImplementedError(TOKEN_IDS_REFUSED)
        if weights is not None:
            state = load_npz(weights) if isinstance(weights, (str, Path)) \
                else params_from_jax(weights)
            model.load_state_dict(state, strict=True)
        self.model = model.to(self.device, dtype)
        self.cfg = self.model.cfg

    @classmethod
    def from_config(cls, cfg: Mapping, device: str | torch.device | None = None,
                    dtype: torch.dtype = torch.float32) -> Predictor:
        """The model as the JAX entry points load it: weights from the
        config's ``seed``, then ``hyper_params.model.clip_weights`` into the
        frozen tower (strict), then the config's ``weight`` (``best.npz`` or
        a ``.pt``) laid over the model's own parameters, its missing and
        unexpected keys printed to stderr."""
        pred = cls(cfg, device=device, dtype=dtype, seed=int(cfg.get("seed", 0)))
        clip_weights = cfg["hyper_params"]["model"].get("clip_weights")
        if clip_weights:
            pred.model.quest_encoder.load_state_dict(load_clip_text_state(clip_weights),
                                                     strict=True)
        if cfg.get("weight"):
            params, missing, unexpected = load_checkpoint(cfg["weight"], pred.model.state_dict())
            if missing or unexpected:
                print(f"# missing={missing} unexpected={unexpected}", file=sys.stderr)
            pred.model.load_state_dict(params, strict=True)
        return pred

    def to_batch(self, batch: Mapping) -> dict:
        """numpy arrays or tensors -> tensors on the device: floating ones in
        the serving dtype, integer ones (token ids) as int64. Raises
        ``ValueError`` first when a question does not fit ``text_ctx``."""
        check_text_ctx(batch.get("quest"), self.cfg.get("text_ctx"))
        out = {}
        for key, value in batch.items():
            t = torch.as_tensor(value)
            dt = self.dtype if torch.is_floating_point(t) else torch.int64
            out[key] = t.to(self.device, dt)
        return out

    @torch.inference_mode()
    def logits(self, batch: Mapping) -> torch.Tensor:
        """[N, num_labels] logits on the device, in the serving dtype."""
        return self.model(self.to_batch(batch))["out"]

    def answer(self, batch: Mapping, topk: int = 5) -> list[dict]:
        """One forward over N requests -> N dicts
        ``{"answer": name, "topk": [{"answer": name, "prob": p}, ...]}``,
        ranked by ``top_indices``.

        ``batch``: quest [N, 77] token ids, audio [N, T, audio_dim],
        video [N, T, video_dim], patch [N, T, P, patch_dim]."""
        probs = torch.softmax(self.logits(batch).float(), dim=-1).cpu().numpy()
        return [answer_payload(row, self.ix2ans, topk) for row in probs]


def load_features(cfg: Mapping, video_id: str) -> dict[str, np.ndarray]:
    """One video's features from the config's directories, as a batch of 1."""
    feats = load_video_features(cfg["data"], video_id, repo_root=ROOT)
    return {k: v[None] for k, v in feats.items()}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--weight", default="", help="best.npz or torch best.pt")
    ap.add_argument("--question", required=True)
    ap.add_argument("--video", required=True,
                    help="video_id (feature files are <dir>/<video_id>.npy)")
    ap.add_argument("--topk", type=int, default=5)
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Answer ``--question`` about ``--video``; prints and returns
    ``{"question", "video", "answer", "topk"}``."""
    args = parse_args(argv)
    cfg = load_config_module(args.config)
    if args.weight:
        cfg["weight"] = args.weight
    device = select_device(cfg)
    pred = Predictor.from_config(cfg, device, torch.float32)
    batch = load_features(cfg, args.video)
    batch["quest"] = ClipTokenizer()(args.question, truncate=True)
    out = {"question": args.question, "video": args.video,
           **pred.answer(batch, topk=args.topk)[0]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
