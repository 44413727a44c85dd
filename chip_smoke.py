#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (qa_tiger_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, in order; any failure ends the run with a non-zero exit:

1. device — a CUDA card is required; prints its name and power limit;
2. build  — builds the CUDA kernels from qa_tiger_tpu_torch/csrc;
3. kernels — each kernel at the main path's shapes (B=256, bf16) against
   its plain PyTorch version on the same inputs, and again at a small fp32
   shape; prints kernel, plain and library times beside the card's bound;
4. slice  — the Predictor at configs/qa-tiger/vitl14.py with weights from a
   seed: (a) fp32 logits at B=4 against the same state_dict run through the
   plain versions on the CPU; (b) the bf16 B=256 main path through
   ``answer``, with every launch counter reset just before and read just
   after, then qa/s from the median of timed forwards; (c) 8 requests
   answered, their top-5 answer names printed;
5. the kernel table as one JSON line, then the device's JSON line last.

``--profile DIR`` also writes a torch.profiler table of one bf16 forward
to DIR. All inputs come from numpy with fixed seeds. TF32 is off.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM (NVIDIA data sheet): HBM rate and dense peaks. The bound of a call
# is the larger of its bytes over the memory rate and its operations over
# the peak of its type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
BF16_TOL = 3e-2   # max|k - p| <= BF16_TOL * max(1, max|p|): bf16 rounding
FP32_TOL = 1e-4   # the same at fp32: summation order only
LOGITS_TOL = dict(rtol=2e-3, atol=5e-4)  # fp32 card vs CPU, as the JAX parity tests
T, P, S, VOCAB = 60, 14, 77, 49408
CONFIG = ROOT / "configs" / "qa-tiger" / "vitl14.py"
# where each kernel's Pallas original makes its pl.pallas_call
REPLACES = {
    "fused_attn_ln2": "qa_tiger_tpu/ops/pallas/resblock.py:391",
    "attention_wide": "qa_tiger_tpu/ops/pallas/attention.py:351",
    "fused_patch_select": "qa_tiger_tpu/ops/pallas/patch_select.py:738",
    "fused_gaussian_moe": "qa_tiger_tpu/ops/pallas/gaussian_moe.py:107",
}
SOURCES = {
    "fused_attn_ln2": "qa_tiger_tpu_torch/csrc/resblock.cu",
    "attention_wide": "qa_tiger_tpu_torch/csrc/attention.cu",
    "fused_patch_select": "qa_tiger_tpu_torch/csrc/patch_select.cu",
    "fused_gaussian_moe": "qa_tiger_tpu_torch/csrc/gaussian_moe.cu",
}


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want) -> tuple[float, float]:
    import torch

    got = [got] if torch.is_tensor(got) else list(got)
    want = [want] if torch.is_tensor(want) else list(want)
    require(all(bool(torch.isfinite(g).all()) for g in got), "non-finite kernel output")
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    scale = max(w.float().abs().max().item() for w in want)
    return err, scale


# ---------------------------------------------------------------------------
# phase 3: the kernels
# ---------------------------------------------------------------------------

def kernel_cases(dtype, B: int, rng, gen):
    """(name, shape label, kernel call, plain call, library call or None,
    bytes, flops) for each kernel at the main path's shapes for batch B."""
    import torch
    from torch.nn import functional as F

    from qa_tiger_tpu_torch.models.clip_text import ResidualAttentionBlock, causal_mask
    from qa_tiger_tpu_torch.models.modules import PatchSelecter
    from qa_tiger_tpu_torch.ops import attention as A
    from qa_tiger_tpu_torch.ops import gaussian_moe as G
    from qa_tiger_tpu_torch.ops import patch_select as PS
    from qa_tiger_tpu_torch.ops import resblock as R

    dev = "cuda"
    isz = torch.tensor([], dtype=dtype).element_size()

    def rn(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape, dtype=np.float32))).to(dev, dtype)

    cases = []
    # text tower: one launch per layer, x [B, 77, 768], causal, 12 heads
    W, H = 768, 12
    blk = ResidualAttentionBlock(W, 12, gen).to(dev, dtype)
    x = rn(B, S, W)
    mask = causal_mask(S, device=dev)
    nbytes = (3 * B * S * W + 4 * W * W + 8 * W) * isz + S * S * 4
    flops = 2 * B * S * W * 4 * W + 2 * B * W * S * (S + 1)  # causal: keys <= query
    cases.append(("fused_attn_ln2", f"x[{B},{S},{W}] causal h{H}",
                  lambda: R.fused_attn_ln2(x, blk, mask, H),
                  lambda: R._attn_ln2_plain(blk, x, heads=H, mask=mask), None, nbytes, flops))

    # attention: AVQ question (60 x 77), self and cross (60 x 60) over the 2B
    # batch; TempMoE (1 x 60) and QstGrounding (1 x 2) over B
    D, heads = 512, 8
    for sq, sk, b in ((T, S, 2 * B), (T, T, 2 * B), (1, T, B), (1, 2, B)):
        q, k, v = rn(b, sq, D), rn(b, sk, D), rn(b, sk, D)
        sc = 1.0 / 8.0

        def sdpa(q=q, k=k, v=v, b=b, sq=sq, sk=sk):
            return F.scaled_dot_product_attention(
                q.view(b, sq, heads, 64).transpose(1, 2), k.view(b, sk, heads, 64).transpose(1, 2),
                v.view(b, sk, heads, 64).transpose(1, 2), scale=sc)

        cases.append(("attention_wide", f"q[{b},{sq},{D}] kv[{b},{sk},{D}] h{heads}",
                      lambda q=q, k=k, v=v: A.attention_wide(q, k, v, None, sc, heads),
                      lambda q=q, k=k, v=v: A._wide_reference(q, k, v, None, sc, heads),
                      sdpa, (2 * b * sq * D + 2 * b * sk * D) * isz, 4 * b * sq * sk * D))

    # PatchSelecter: patch [B, 60, 14, 512], audio/video [B, 60, 512]
    ps = PatchSelecter(D, gen).to(dev, dtype)
    patch, audio, video = rn(B, T, P, D), rn(B, T, D), rn(B, T, D)
    BT = B * T
    wcount = 2 * (4 * D * D + 4 * D) + D * D + 3 * D // 2 + 4 * D
    nbytes = (BT * P * D + 4 * BT * D + wcount) * isz
    flops = (2 * BT * P * D * (3 * D + D + 2 * D) + 2 * 2 * BT * D * (D + D + D)
             + 4 * BT * P * P * D + 4 * BT * 2 * P * D)
    cases.append(("fused_patch_select", f"patch[{B},{T},{P},{D}] h{heads}",
                  lambda: PS.fused_patch_select(patch, audio, video, ps, heads),
                  lambda: PS.patch_selecter_plain(ps, patch, audio, video, nhead=heads),
                  None, nbytes, flops))

    # TempMoE: audio over B rows, both visual streams over 2B rows
    E, Hd = 7, D // 2
    w1t, b1 = rn(E, D, Hd, scale=0.05), rn(E, Hd, scale=0.1)
    w2t, b2 = rn(E, Hd, D, scale=0.05), rn(E, D, scale=0.1)
    for b in (B, 2 * B):
        xm = rn(b, T, D)
        w = torch.from_numpy(0.05 * rng.random((b, E, T), dtype=np.float32)).to(dev, dtype)
        nbytes = (b * T * D + b * E * T + 2 * E * D * Hd + E * (Hd + D) + b * D) * isz
        flops = 2 * b * T * E * D * Hd + 2 * b * E * T * Hd + 2 * b * E * Hd * D
        cases.append(("fused_gaussian_moe", f"x[{b},{T},{D}] E{E} H{Hd}",
                      lambda xm=xm, w=w: G.fused_gaussian_moe(xm, w1t, b1, w2t, b2, w),
                      lambda xm=xm, w=w: G._reference_impl(xm, w1t, b1, w2t, b2, w),
                      None, nbytes, flops))
    return cases


def check_kernels(rng, gen) -> dict:
    """Phase 3. Returns the JSON entry of each kernel at its largest
    main-path call."""
    import torch

    entries = {}
    with torch.inference_mode():
        for dtype, B, tol, timed in ((torch.float32, 2, FP32_TOL, False),
                                     (torch.bfloat16, 256, BF16_TOL, True)):
            dname = str(dtype).replace("torch.", "")
            for name, shape, kernel, plain, library, nbytes, flops in kernel_cases(
                    dtype, B, rng, gen):
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                err, scale = max_err(got, want)
                ok = err <= tol * max(1.0, scale)
                line = {"kernel": name, "dtype": dname, "shape": shape,
                        "max_abs_err": err, "max_abs_plain": scale,
                        "tolerance": tol * max(1.0, scale), "ok": ok}
                if timed:
                    b_ms, b_by = bound(nbytes, flops, dname)
                    line.update(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                                library_ms=cuda_ms(library) if library else None,
                                bound_ms=b_ms, bound_by=b_by)
                    first = name not in entries
                    if first or b_ms > entries[name]["bound_ms"]:
                        entries[name] = {
                            "name": name, "route": "cuda", "source": SOURCES[name],
                            "replaces": REPLACES[name], "launches": 0, "shape": shape,
                            "max_abs_err": err, "ms": line["ms"],
                            "plain_ms": line["plain_ms"], "bound_ms": b_ms,
                            "bound_by": b_by, "library_ms": line["library_ms"]}
                print(json.dumps(line), flush=True)
                require(ok, f"{name} {dname} {shape}: max|k-p| {err:.3e} over tolerance")
    return entries


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------

def make_batch(rng, b: int) -> dict:
    """Token rows (SOT, ids, EOT = the largest id, zero pad) and features at
    the shipped widths, T=60 frames of P=14 patches."""
    quest = np.zeros((b, S), dtype=np.int64)
    for i in range(b):
        n = int(rng.integers(5, 30))
        quest[i, 0] = VOCAB - 2
        quest[i, 1:n] = rng.integers(1, VOCAB - 2, n - 1)
        quest[i, n] = VOCAB - 1
    return {"quest": quest,
            "audio": rng.standard_normal((b, T, 128), dtype=np.float32),
            "video": rng.standard_normal((b, T, 768), dtype=np.float32),
            "patch": rng.standard_normal((b, T, P, 1024), dtype=np.float32)}


def check_slice(rng, entries: dict, profile_dir: Path | None) -> None:
    import torch

    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch.predict import Predictor

    # (a) fp32 B=4: the card against the same state_dict on the CPU
    card = Predictor(CONFIG, device="cuda", dtype=torch.float32, seed=0)
    state = {k: v.detach().cpu() for k, v in card.model.state_dict().items()}
    cpu = Predictor(CONFIG, device="cpu", dtype=torch.float32, weights=state)
    batch = make_batch(rng, 4)
    got = card.logits(batch).float().cpu()
    want = cpu.logits(batch)
    err = (got - want).abs().max().item()
    ok = bool(torch.allclose(got, want, **LOGITS_TOL))
    print(json.dumps({"phase": "slice_fp32_b4", "logits_max_abs_err": err,
                      "max_abs_logit": want.abs().max().item(), **LOGITS_TOL,
                      "argmax_equal": bool((got.argmax(1) == want.argmax(1)).all()),
                      "ok": ok}), flush=True)
    require(ok, f"fp32 logits on the card differ from the CPU run by {err:.3e}")
    del card, cpu, state
    torch.cuda.empty_cache()

    # (b) bf16 B=256: the main path through answer(), counters read around it
    pred = Predictor(CONFIG, seed=0)
    batch = pred.to_batch(make_batch(rng, 256))
    pred.answer(batch)  # first call: allocator and library warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    answers = pred.answer(batch, topk=5)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    expected = {"fused_attn_ln2": 12, "fused_gaussian_moe": 2, "fused_patch_select": 1}
    print(json.dumps({"phase": "main_path_launches", **counts}), flush=True)
    for name, n in expected.items():
        require(counts[name] == n, f"{name}: {counts[name]} launches, expected {n}")
    require(counts["attention_wide"] >= 3, "attention_wide: fewer than 3 launches")
    for name, n in counts.items():
        require(n > 0, f"{name} was never launched on the main path")
        entries[name]["launches"] = n
    require(len(answers) == 256, "answer() returned the wrong number of rows")

    logits = pred.logits(batch)
    require(tuple(logits.shape) == (256, 42) and bool(torch.isfinite(logits).all()),
            "bf16 logits are not finite [256, 42]")
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        start = time.perf_counter()
        pred.logits(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    median = statistics.median(times)
    print(json.dumps({"phase": "slice_bf16_b256", "forward_ms_median": median * 1e3,
                      "forward_ms_all": [t * 1e3 for t in times],
                      "qa_per_s": 256 / median,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)

    if profile_dir is not None:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        profile_dir.mkdir(parents=True, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            start = time.perf_counter()
            pred.logits(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        events = prof.key_averages()
        table = events.table(sort_by="self_cuda_time_total", row_limit=40)
        (profile_dir / "forward_bf16_b256.txt").write_text(table)
        print(table, flush=True)
        # kernel time only, as the table's "Self CUDA time total" counts it
        busy = sum(e.self_device_time_total for e in events
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
        print(json.dumps({"phase": "profile", "wall_ms": wall * 1e3, "device_busy_ms": busy,
                          "idle_share": 1 - busy / (wall * 1e3)}), flush=True)

    # (c) eight requests answered
    served = pred.answer(make_batch(rng, 8), topk=5)
    require(len(served) == 8, "answer() did not serve 8 requests")
    for i, row in enumerate(served):
        print(json.dumps({"request": i, "top5": [t["answer"] for t in row["topk"]],
                          "probs": [t["prob"] for t in row["topk"]]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=Path, default=None,
                    help="write a torch.profiler table of one forward here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device", file=sys.stderr)
        return 1
    try:
        from qa_tiger_tpu_torch import ops
        from qa_tiger_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: FAIL: the port is not importable here: {exc}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        card = gpu_line()
        print(card, flush=True)
        print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__,
                          "cuda": torch.version.cuda,
                          "device": torch.cuda.get_device_name(0)}), flush=True)
        start = time.perf_counter()
        _build.library()
        print(json.dumps({"phase": "build", "seconds": time.perf_counter() - start,
                          "log": str(_build.build_log)}), flush=True)

        rng = np.random.default_rng(0)
        gen = torch.Generator().manual_seed(0)
        entries = check_kernels(rng, gen)
        check_slice(rng, entries, args.profile)
        require(set(entries) == set(ops.KERNELS), "a kernel is missing from the table")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
