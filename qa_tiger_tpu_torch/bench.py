"""Eval throughput (QA pairs/s on one card) at the shipped configs.

    python -m qa_tiger_tpu_torch.bench [--model qa-tiger|tspm] [--device cuda|cpu]

Port of ``bench.py``'s measurement, with its protocol: batch 256 in bf16,
weights from seed 0 cast to bf16, one synthetic batch at the shipped
shapes from numpy seed 0 (``_batch``; ``_tspm_batch`` for TSPM, whose
questions and QA prompts are [B, 768] features) put on the device once,
one compiling call and 3 warm-up calls, then 3 repeats of 20 forwards,
each repeat ended by reading the last logits back; the median rate is
reported. QA-TIGER is ``configs/qa-tiger/vitl14.py``'s network (the frozen
CLIP-L/14 text tower on 77 token ids included), TSPM
``configs/tspm/vitl14.py``'s.

Prints one JSON line with the JAX script's keys (``metric``:
``qa_pairs_per_sec_per_chip`` or ``tspm_qa_pairs_per_sec_per_chip``,
``value``, ``unit``) and the device's name. The JAX script's TPU probe and
torch-CPU denominator have no counterpart. The device is cuda unless
``--device`` names another; without a card that raises. On the CPU the
plain versions run and the rate is the CPU's.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from qa_tiger_tpu_torch.models import build_model

BATCH = 256
T, P = 60, 14
WARMUP_ITERS = 3
BENCH_ITERS = 20
REPEATS = 3
EVAL_DTYPE = torch.bfloat16
# bench.py's two networks: model_type and the config's model kwargs
MODELS = {
    "qa-tiger": ("QA-TIGER", dict(d_model=512, video_dim=768, patch_dim=1024, audio_dim=128,
                                  topK=7, num_experts=7, encoder_type="ViT-L/14@336px")),
    "tspm": ("TSPM", dict(topK=10)),
}
METRICS = {"qa-tiger": "qa_pairs_per_sec_per_chip", "tspm": "tspm_qa_pairs_per_sec_per_chip"}


def _batch(rng, b: int) -> dict:
    return {
        "quest": rng.integers(1, 49406, (b, 77)).astype(np.int64),
        "audio": rng.standard_normal((b, T, 128)).astype(np.float32),
        "video": rng.standard_normal((b, T, 768)).astype(np.float32),
        "patch": rng.standard_normal((b, T, P, 1024)).astype(np.float32),
    }


def _tspm_batch(rng, b: int) -> dict:
    """TSPM reads precomputed CLIP question and QA-prompt features."""
    batch = _batch(rng, b)
    batch["quest"] = rng.standard_normal((b, 768)).astype(np.float32)
    batch["prompt"] = rng.standard_normal((b, 768)).astype(np.float32)
    return batch


def setup(model: str, device: str | torch.device | None = None, batch: int | None = None):
    """(the bf16 eval model from seed 0, its device batch from numpy seed 0)
    of ``model`` ("qa-tiger" or "tspm")."""
    model_type, kwargs = MODELS[model]
    net = build_model(model_type, kwargs, num_labels=42, device=device, seed=0)
    net = net.to(EVAL_DTYPE)
    make = _tspm_batch if model == "tspm" else _batch
    host = make(np.random.default_rng(0), BATCH if batch is None else batch)
    dev = next(net.parameters()).device
    return net, {k: torch.from_numpy(v).to(dev, EVAL_DTYPE if v.dtype == np.float32 else None)
                 for k, v in host.items()}


def measure(net, batch: dict) -> dict:
    """bench.py's protocol on one model and device batch: rates of each
    repeat and their median, in QA pairs per second."""
    b = next(iter(batch.values())).shape[0]

    @torch.inference_mode()
    def fwd():
        return net(batch)["out"]

    fwd().cpu()
    for _ in range(WARMUP_ITERS):
        fwd().cpu()
    rates = []
    for _ in range(REPEATS):
        start = time.perf_counter()
        for _ in range(BENCH_ITERS):
            out = fwd()
        out.cpu()
        rates.append(b * BENCH_ITERS / (time.perf_counter() - start))
    return {"rates": rates, "median": statistics.median(rates)}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="qa-tiger", choices=sorted(MODELS))
    ap.add_argument("--device", default=None, help="cuda unless given")
    args = ap.parse_args(argv)
    net, batch = setup(args.model, args.device)
    dev = next(net.parameters()).device
    result = measure(net, batch)
    line = {"metric": METRICS[args.model], "value": round(result["median"], 2),
            "unit": "qa/s",
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
