"""Train-step throughput at the reference recipe (batch 32, fp32, Adam).

    python -m qa_tiger_tpu_torch.bench_train [--batch 32] [--accum 1]
        [--iters 20] [--repeats 3] [--cache-qst] [--steps-per-dispatch 1]
        [--train-dtype bfloat16] [--trace DIR] [--device cuda|cpu]

Port of ``scripts/bench_train.py``, with its flags: the whole train step
(forward with dropout, CE loss, backward, two-group-LR Adam) through
``AVQARunner`` on one synthetic batch at the shipped feature shapes, built
with numpy from seed 0 and put on the device once. ``--steps-per-dispatch
K`` > 1 steps K copies of it per window through ``train_window`` (on the
card a CUDA graph of the step, captured at the first window's second step);
``--cache-qst`` runs the frozen text tower once and gathers its rows per
step; ``--trace DIR`` writes a ``torch.profiler`` trace of 3 warm calls
there (``bench_train.json``, Chrome trace format, through
``utils.profiling.trace``; ``trace_summary`` reads it). One call (K steps)
warms up, 3 more follow; then ``--repeats`` runs of ``--iters`` calls, each
ended by reading the last loss; the median rate is reported.

Prints one JSON line with the JAX script's keys (``metric``, ``value`` in
steps/s, ``unit``, ``qa_pairs_per_sec``, ``step_ms``) and the device's
name. The device is cuda unless ``--device`` names another; without a card
that raises. On the CPU the plain versions run and the rate is the CPU's.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from qa_tiger_tpu_torch.models import qa_tiger_config
from qa_tiger_tpu_torch.models.registry import resolve_device
from qa_tiger_tpu_torch.training import AVQARunner
from qa_tiger_tpu_torch.utils.profiling import trace

# the shipped recipe's model (configs/qa-tiger/vitl14.py) and feature shapes
MODEL = dict(d_model=512, video_dim=768, patch_dim=1024, audio_dim=128, topK=7,
             num_experts=7, num_labels=42, encoder_type="ViT-L/14@336px")
T, P = 60, 14
VOCAB, CTX = 49408, 77
TRACE_FILE = "bench_train.json"  # --trace's file, in its directory


def make_batch(batch: int) -> dict:
    """The synthetic batch of ``scripts/bench_train.py``, from seed 0."""
    rng = np.random.default_rng(0)
    return {
        "quest": rng.integers(1, VOCAB - 2, (batch, CTX)).astype(np.int64),
        "audio": rng.standard_normal((batch, T, MODEL["audio_dim"])).astype(np.float32),
        "video": rng.standard_normal((batch, T, MODEL["video_dim"])).astype(np.float32),
        "patch": rng.standard_normal((batch, T, P, MODEL["patch_dim"])).astype(np.float32),
        "label": rng.integers(0, 42, batch).astype(np.int32),
        "qtype_label": rng.integers(0, 9, batch).astype(np.int32),
        "valid": np.ones(batch, bool),
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--cache-qst", action="store_true",
                    help="run the frozen text tower once; each step gathers its rows")
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="K steps per window (hyper_params.steps_per_dispatch)")
    ap.add_argument("--train-dtype", default="",
                    help="compute dtype of the step, e.g. bfloat16 (fp32 master weights)")
    ap.add_argument("--trace", default="",
                    help="write a torch.profiler trace of 3 warm calls into this directory")
    ap.add_argument("--device", default=None, help="cuda unless given")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    B, spd = args.batch, max(args.steps_per_dispatch, 1)
    hp = {"optim": dict(lr=1e-4, betas=(0.95, 0.999), weight_decay=0, encoder_lr=None,
                        grad_accum=args.accum),
          "steps_per_dispatch": spd}
    if args.train_dtype:
        hp["train_dtype"] = args.train_dtype
    cfg = {"debug": False, "log_interval": 1000, "hyper_params": hp}
    print("# building runner...", file=sys.stderr, flush=True)
    runner = AVQARunner(cfg, qa_tiger_config(**MODEL), device=device, seed=0)
    host_batch = make_batch(B)
    lr = 1e-4
    if args.cache_qst:
        runner.build_question_cache_from_tokens(host_batch["quest"], "bench")
        runner._active_qst_cache = runner._qst_caches["bench"]
        host_batch["ds_idx"] = np.arange(B, dtype=np.int32)

    # on the device once (with the cache: its ds_idx, gathered in each step)
    staged = runner.stage_batch(host_batch)
    if spd > 1:
        def step() -> list:  # K copies of the batch in one window
            return runner.train_window([staged] * spd, lr)
    else:
        def step() -> list:
            return [runner.train_step(staged, lr, runner._step_generator)]

    def force(losses: list) -> None:
        float(losses[-1]["total_loss"])

    start = time.perf_counter()
    force(step())
    print(f"# build and first call: {time.perf_counter() - start:.1f}s", file=sys.stderr,
          flush=True)
    for _ in range(3):
        force(step())
    if args.trace:
        with trace(args.trace, TRACE_FILE):
            for _ in range(3):
                losses = step()
            force(losses)
        print(f"# trace written to {Path(args.trace) / TRACE_FILE}", file=sys.stderr,
              flush=True)
    rates = []
    for _ in range(args.repeats):
        start = time.perf_counter()
        for _ in range(args.iters):
            losses = step()
        force(losses)
        rates.append(args.iters * spd / (time.perf_counter() - start))
    sps = statistics.median(rates)
    line = {
        "metric": "train_steps_per_sec_b%d%s%s%s%s" % (
            B, f"_accum{args.accum}" if args.accum > 1 else "",
            f"_{args.train_dtype}" if args.train_dtype else "",
            "_cacheqst" if args.cache_qst else "", f"_spd{spd}" if spd > 1 else ""),
        "value": sps, "unit": "steps/s", "qa_pairs_per_sec": sps * B, "step_ms": 1e3 / sps,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
