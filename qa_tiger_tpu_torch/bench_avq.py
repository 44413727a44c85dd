"""The fused AVQ train kernels on their own, at the shipped train shapes.

    python -m qa_tiger_tpu_torch.bench_avq [--steps 30] [--N 64] [--T 60] [--S 77]
        [--D 512] [--nhead 8] [--fwd-only] [--plain] [--device cuda|cpu]

Counterpart of ``scripts/bench_avq.py``: ``fused_avq_train`` (one AVQ
direction over the 2B batch rows under dropout, the eight masks of
``make_avq_dropout_masks`` at p 0.1) at N=2B=64, T=60, S=77, D=512, 8
heads, fp32, with ``AVQCrossAttn``'s parameters from seed 0 and inputs from
a generator on the device, seeded 0. It times the forward (the loss
``sum(out ** 2)``) and the forward with the backward (``torch.autograd.grad``
of that loss to the input and every parameter), each ``--steps`` calls
after one, ended by reading a value back to the host. Where the JAX script
prints compile times, this prints the kernel library's build or load time
and each first call's. ``--plain`` times the plain version
(``avq_sub_forward_masked``, PyTorch ops) at the same shapes, as ``--jnp``
times the JAX oracle.

Prints the JAX script's two JSON lines' keys: ``{"metric": "avq_fwd_ms",
...}`` with ``--fwd-only``, else ``{"metric": "avq_train_ms", ...,
"fwd_ms": ...}``, and the device's name. The device is cuda unless
``--device`` names another; without a card that raises.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from qa_tiger_tpu_torch.models.modules import AVQCrossAttn, make_avq_dropout_masks
from qa_tiger_tpu_torch.models.registry import resolve_device
from qa_tiger_tpu_torch.ops import _build
from qa_tiger_tpu_torch.ops.avq import avq_sub_forward_masked, fused_avq_train


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _steady_ms(fn, steps: int) -> tuple[float, float]:
    """(seconds of the first call, ms per call over ``steps`` more)."""
    start = time.perf_counter()
    fn().item()
    first = time.perf_counter() - start
    start = time.perf_counter()
    for _ in range(steps):
        out = fn()
    out.item()
    return first, (time.perf_counter() - start) / steps * 1e3


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--N", type=int, default=64)
    ap.add_argument("--T", type=int, default=60)
    ap.add_argument("--S", type=int, default=77)
    ap.add_argument("--D", type=int, default=512)
    ap.add_argument("--nhead", type=int, default=8)
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--plain", action="store_true",
                    help="time the plain version (PyTorch ops, no kernel) at the same shapes")
    ap.add_argument("--device", default=None, help="cuda unless given")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    N, T, S, D, h = args.N, args.T, args.S, args.D, args.nhead
    start = time.perf_counter()
    if device.type == "cuda" and not args.plain:
        _build.library()
    build_s = time.perf_counter() - start
    _log(f"# device={device.type} plain={args.plain} kernel library build or load: "
         f"{build_s:.1f}s")

    params = AVQCrossAttn(D, torch.Generator().manual_seed(0)).to(device)
    g = torch.Generator(device=device).manual_seed(0)
    src, val, wrd = (torch.randn(shape, generator=g, device=device)
                     for shape in ((N, T, D), (N, T, D), (N, S, D)))
    masks = make_avq_dropout_masks(g, N, T, S, D, nhead=h, dropout_p=0.1)
    weights = list(params.parameters())

    def loss(s: torch.Tensor) -> torch.Tensor:
        if args.plain:
            out = avq_sub_forward_masked(params, s, val, wrd, masks, nhead=h)
        else:
            out = fused_avq_train(s, val, wrd, params, masks, h)
        return (out.float() ** 2).sum()

    with torch.no_grad():
        fwd_first_s, fwd_ms = _steady_ms(lambda: loss(src), args.steps)
    _log(f"# fwd first call: {fwd_first_s:.2f}s; run: {fwd_ms:.3f} ms/step")
    line = {"metric": "avq_fwd_ms", "value": fwd_ms, "unit": "ms", "build_s": build_s,
            "first_call_s": fwd_first_s}
    if not args.fwd_only:
        src_g = src.clone().requires_grad_(True)
        params.requires_grad_(True)

        def train_step() -> torch.Tensor:
            grads = torch.autograd.grad(loss(src_g), [src_g, *weights])
            return grads[0][0, 0, 0]

        bwd_first_s, train_ms = _steady_ms(train_step, args.steps)
        _log(f"# fwd+bwd first call: {bwd_first_s:.2f}s; run: {train_ms:.3f} ms/step")
        line = {"metric": "avq_train_ms", "value": train_ms, "unit": "ms", "fwd_ms": fwd_ms,
                "build_s": build_s, "fwd_first_call_s": fwd_first_s,
                "bwd_first_call_s": bwd_first_s}
    line.update(plain=args.plain, shape=[N, T, S, D, h],
                device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
