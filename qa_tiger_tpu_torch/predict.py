"""Batch question answering: the serving entry point of the port.

Port of the model half of ``src/predict.py``, widened from one question to
a batch of requests: the config's model is built (weights from a seed, a
state_dict, a JAX parameter pytree or a ``best.npz``), cast to the serving
dtype as ``bench.py`` casts it, and each call to ``answer`` runs one forward
over the batch and names the top-k answers from the config's
``answer2idx.json``.

Questions arrive as CLIP token ids [N, 77], e.g. from
``data.ClipTokenizer`` (which reads the CLIP BPE merges file).
"""
from __future__ import annotations

import json
from collections.abc import Mapping
from pathlib import Path

import torch

from qa_tiger_tpu_torch.convert import load_npz, params_from_jax
from qa_tiger_tpu_torch.models.registry import build_model, resolve_device
from qa_tiger_tpu_torch.utils.config import load_config_module

ROOT = Path(__file__).resolve().parents[1]


def answer_vocab(cfg: Mapping) -> dict[int, str]:
    """index -> answer name, from the config's ``data.ans_quelen`` file."""
    root = Path(cfg["data"]["root"])
    if not root.is_absolute():
        root = ROOT / root
    vocab = json.loads((root / cfg["data"]["ans_quelen"]).read_text())["ans2ix"]
    return {int(i): name for name, i in vocab.items()}


class Predictor:
    """Answers batches of questions about extracted audio/video features.

    ``config`` is a config file path or its loaded dict. The model runs on
    ``device`` (``cuda`` unless given; without a GPU, pass ``"cpu"``) in
    ``dtype``. ``weights`` is None (random weights from ``seed``), a path to
    a ``best.npz``, or a mapping: a ``state_dict`` or a JAX parameter pytree
    of numpy arrays. Loading is strict.
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
        if weights is not None:
            state = load_npz(weights) if isinstance(weights, (str, Path)) \
                else params_from_jax(weights)
            model.load_state_dict(state, strict=True)
        self.model = model.to(self.device, dtype)
        self.cfg = self.model.cfg

    def to_batch(self, batch: Mapping) -> dict:
        """numpy arrays or tensors -> tensors on the device: floating ones in
        the serving dtype, integer ones (token ids) as int64."""
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
        ``{"answer": name, "topk": [{"answer": name, "prob": p}, ...]}``.

        ``batch``: quest [N, 77] token ids, audio [N, T, audio_dim],
        video [N, T, video_dim], patch [N, T, P, patch_dim]."""
        probs = torch.softmax(self.logits(batch).float(), dim=-1)
        top_p, top_i = probs.topk(topk, dim=-1)
        results = []
        for ps, ids in zip(top_p.tolist(), top_i.tolist()):
            names = [self.ix2ans.get(i, str(i)) for i in ids]
            results.append({"answer": names[0],
                            "topk": [{"answer": n, "prob": round(p, 4)}
                                     for n, p in zip(names, ps)]})
        return results
