"""A/B micro-bench of the text tower's fused attention half on one card.

    python -m qa_tiger_tpu_torch.bench_resblock [--fn attn_ln2|attn_half]
        [--batch 256 --seq 77 --width 768 --heads 12 --iters 24 --repeats 5]
        [--device cuda|cpu]

One bf16 ``ResidualAttentionBlock`` with weights from seed 0, x [B, S, W]
from seed 1 and a causal mask. The function (``attn_ln2``:
``fused_attn_ln2``; ``attn_half``: ``fused_attn_half``, which skips the
ln_2 output) is applied ``iters`` times, each output feeding the next
input, as the JAX ``scripts/bench_resblock.py`` scans it. One chain warms
up (and builds the kernels); the best of ``repeats`` chains, each between
two synchronizes, over ``iters`` is the time of one layer. Prints one JSON
line. ``fused_attn_ln2``'s second output is computed and dropped: PyTorch
runs eagerly, so nothing needs folding in to stay alive.

The device is cuda unless ``--device`` names another; without a card that
raises. On the CPU the plain versions run and the time is the CPU's.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from qa_tiger_tpu_torch.models.clip_text import ResidualAttentionBlock, causal_mask
from qa_tiger_tpu_torch.models.registry import resolve_device
from qa_tiger_tpu_torch.ops import _build
from qa_tiger_tpu_torch.ops.resblock import fused_attn_half, fused_attn_ln2

TEXT_LAYERS = 12  # sets the init statistics of the block's projections


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seq", type=int, default=77)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--fn", default="attn_ln2", choices=["attn_ln2", "attn_half"])
    ap.add_argument("--device", default=None, help="cuda unless given")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    dtype = torch.bfloat16
    block = ResidualAttentionBlock(args.width, TEXT_LAYERS,
                                   torch.Generator().manual_seed(0)).to(device, dtype)
    x = torch.randn(args.batch, args.seq, args.width,
                    generator=torch.Generator().manual_seed(1)).to(device, dtype)
    mask = causal_mask(args.seq, device=device)
    if args.fn == "attn_half":
        def step(t):
            return fused_attn_half(t, block, mask, args.heads)
    else:
        def step(t):
            return fused_attn_ln2(t, block, mask, args.heads)[0]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def chain() -> float:
        sync()
        start = time.perf_counter()
        y = x
        for _ in range(args.iters):
            y = step(y)
        sync()
        return time.perf_counter() - start

    with torch.inference_mode():
        chain()
        best = min(chain() for _ in range(args.repeats))
    line = {"metric": f"fused_{args.fn}_ms_per_layer", "value": best / args.iters * 1e3,
            "unit": "ms", "B": args.batch, "S": args.seq, "W": args.width,
            "heads": args.heads, "iters": args.iters, "repeats": args.repeats,
            "dtype": "bfloat16",
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "build_s": _build.build_seconds}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
