"""Summarise a torch.profiler Chrome trace into tables of device time.

    python -m qa_tiger_tpu_torch.trace_summary TRACE [--top 30] [--by-class] [--long]

Counterpart of ``scripts/trace_summary.py``, which decodes the XSpace
protobufs of ``jax.profiler``. The port's traces are the Chrome traces that
``utils.profiling.trace`` writes (``profile_stages --trace``,
``bench_train --trace``, ``train_epoch``'s ``profile_dir``,
``chip_smoke.py --profile``): JSON with a ``traceEvents`` list. TRACE is
such a file (``.json`` or ``.json.gz``) or a directory, whose newest one is
read.

It prints:

- device time and count by name: the events of category ``kernel`` and the
  card's copies and fills (``gpu_memcpy``, ``gpu_memset``), top N by time;
- with ``--by-class``, the same grouped into the routines PERF.md uses
  (``gemm_sm90``, ``gemm_tf32x3``, ``gemm_tile``, the attention routes
  ``mma`` / ``mma_short`` / ``mma_wide`` / ``mma_wide_short`` / ``fma``,
  the MoE, LayerNorm, column sums, cuBLAS, cuDNN, other PyTorch);
- the busy time (the union of the device intervals), the traced window (the
  profiler's span) and the idle share, 1 - busy / window: the card's idle
  share where the traced block is one timed window, as
  ``utils.profiling.trace`` around it makes it;
- launches by port kernel: while the profiler records, each launch of a
  kernel library entry (``qt_attn_ln2``, ``qt_attention``, ...) is a region
  of that name (``ops._build.launch``); each device kernel is tied to the
  region its launch call sits in, through the ``correlation`` of the kernel
  and of the runtime call, or else its ``External id``. Per wrapper that
  counts the launches (an ``ops.KERNELS`` name, or ``ops.gemm``'s
  ``gemm_sm90`` / ``gemm_tf32x3``): the regions, the regions whose device
  kernels the trace holds, and those kernels' names. ``attention_wide``'s
  regions include its key-bias launches, which ``attention_wide_key_bias``
  counts apart.
"""
from __future__ import annotations

import argparse
import bisect
import gzip
import json
import re
from collections import Counter, defaultdict
from pathlib import Path

# each launcher of the kernel library -> the wrapper whose counter counts it
LAUNCHERS = {
    "qt_attn_ln2": "fused_attn_ln2",
    "qt_attention": "attention_wide",
    "qt_patch_select": "fused_patch_select",
    "qt_gaussian_moe": "fused_gaussian_moe",
    "qt_avq_train_fwd": "fused_avq_train",
    "qt_avq_train_bwd": "fused_avq_train_bwd",
    "qt_patch_select_train_fwd": "fused_patch_select_train",
    "qt_patch_select_train_bwd": "fused_patch_select_train_bwd",
    "qt_fused_attention": "fused_attention",
    "qt_attn_half": "fused_attn_half",
    "qt_mlp_half": "fused_resblock",
    "qt_gemm_sm90": "gemm_sm90",
    "qt_gemm_tf32x3": "gemm_tf32x3",
}
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# (routine, pattern) in order: the first match names a device event's routine
ROUTINES = [(name, re.compile(pattern)) for name, pattern in (
    ("gemm_sm90", r"gemm_sm90_kernel"),
    ("gemm_tf32x3", r"gemm_tf32x3_kernel|splitk_reduce_kernel"),
    ("gemm_tile", r"::gemm_kernel<"),
    ("attention mma_wide", r"attention_mma_wide_kernel"),
    ("attention mma_wide_short", r"attention_wide_short_kernel"),
    ("attention mma_short", r"attention_short_kernel"),
    ("attention mma", r"attention_mma_kernel"),
    ("attention fma", r"attention_(?:kernel|tiled_kernel|wide_head_kernel|bwd_kernel)"),
    ("MoE", r"moe_hidden_"),
    ("LayerNorm", r"layer_norm_kernel|layer_norm_bwd_kernel|row_stats_kernel"),
    ("column sums", r"col_sum_kernel"),
    ("PatchSelecter staging", r"interleave_rows_kernel"),
    ("cuDNN", r"cudnn|fprop|dgrad|wgrad|implicit_convolve|nchwToNhwc|nhwcToNchw"),
    ("cuBLAS", r"nvjet|xmma_gemm|cutlass|gemv|sgemm|gemmSN|gemmk1|cublas|splitKreduce"),
    ("copies and fills", r"^Memcpy|^Memset"),
)]


def load_events(path: str | Path) -> list[dict]:
    """The ``traceEvents`` of a Chrome trace file, or of the newest
    ``*.json`` / ``*.json.gz`` under a directory."""
    path = Path(path)
    if path.is_dir():
        found = sorted((p for p in path.rglob("*.json*") if p.suffix in (".json", ".gz")),
                       key=lambda p: p.stat().st_mtime)
        if not found:
            raise FileNotFoundError(f"no .json trace under {path}")
        path = found[-1]
    raw = path.read_bytes()
    if path.suffix == ".gz":
        raw = gzip.decompress(raw)
    return json.loads(raw)["traceEvents"]


def routine(name: str) -> str:
    for label, pattern in ROUTINES:
        if pattern.search(name):
            return label
    return "other PyTorch"


def device_events(events: list[dict]) -> list[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def by_name(events: list[dict]) -> dict[str, tuple[int, float]]:
    """{device event name: (count, total us)}."""
    table: dict[str, list] = defaultdict(lambda: [0, 0.0])
    for e in device_events(events):
        table[e["name"]][0] += 1
        table[e["name"]][1] += float(e.get("dur", 0.0))
    return {k: (n, us) for k, (n, us) in table.items()}


def by_routine(table: dict[str, tuple[int, float]]) -> dict[str, tuple[int, float]]:
    out: dict[str, list] = defaultdict(lambda: [0, 0.0])
    for name, (n, us) in table.items():
        out[routine(name)][0] += n
        out[routine(name)][1] += us
    return {k: (n, us) for k, (n, us) in out.items()}


def busy_and_window(events: list[dict]) -> dict:
    """Device busy ms (the union of the device intervals), the sum of the
    device events' ms, the traced window's ms (the profiler's span, else
    the span of all events) and the idle share."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in device_events(events))
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    window = [e for e in events if e.get("ph") == "X" and e.get("cat") == "Trace"]
    if window:
        w_us = max(float(e.get("dur", 0.0)) for e in window)
    else:
        timed = [e for e in events if e.get("ph") == "X" and "ts" in e]
        w_us = (max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in timed)
                - min(float(e["ts"]) for e in timed)) if timed else 0.0
    return {"busy_ms": busy / 1e3, "device_sum_ms": sum(b - a for a, b in spans) / 1e3,
            "window_ms": w_us / 1e3, "idle_share": 1 - busy / w_us if w_us else None}


def port_launches(events: list[dict]) -> dict[str, dict]:
    """{wrapper name: {"launcher", "launches", "traced", "kernels"}}:
    the launcher's regions in the trace, those that hold at least one device
    kernel of the trace, and the kernels' names and counts."""
    regions = [e for e in events if e.get("ph") == "X" and e.get("name") in LAUNCHERS
               and e.get("cat") in ("user_annotation", "cpu_op")]
    by_thread = defaultdict(list)  # (pid, tid) -> sorted [(ts, end, index)]
    for i, e in enumerate(regions):
        by_thread[(e.get("pid"), e.get("tid"))].append(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), i))
    for spans in by_thread.values():
        spans.sort()
    external = {e.get("args", {}).get("External id"): i for i, e in enumerate(regions)}
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}

    def region_of(kernel: dict) -> int | None:
        args = kernel.get("args", {})
        call = calls.get(args.get("correlation"))
        if call is not None:
            spans = by_thread.get((call.get("pid"), call.get("tid")), [])
            t = float(call["ts"])
            j = bisect.bisect_right(spans, (t, float("inf"), len(regions))) - 1
            if j >= 0 and spans[j][0] <= t <= spans[j][1]:
                return spans[j][2]
        return external.get(args.get("External id"))

    made = defaultdict(Counter)  # region index -> kernel names
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            i = region_of(e)
            if i is not None:
                made[i][e["name"]] += 1
    out: dict[str, dict] = {}
    for i, e in enumerate(regions):
        entry = out.setdefault(LAUNCHERS[e["name"]], {
            "launcher": e["name"], "launches": 0, "traced": 0, "kernels": Counter()})
        entry["launches"] += 1
        entry["traced"] += int(bool(made[i]))
        entry["kernels"].update(made[i])
    for entry in out.values():
        entry["kernels"] = dict(entry["kernels"])
    return out


def summarize(path: str | Path) -> dict:
    """Everything the CLI prints, as data: ``kernels`` {name: (count, us)},
    ``routines`` the same by routine, busy / window / idle share, and
    ``port_launches``."""
    events = load_events(path)
    table = by_name(events)
    return {"kernels": table, "routines": by_routine(table), **busy_and_window(events),
            "port_launches": port_launches(events)}


def _print_table(title: str, rows: dict[str, tuple[int, float]], top: int, width: int) -> None:
    total = sum(us for _, us in rows.values()) or 1.0
    print(f"\n== {title}  (total {total / 1e3:.3f} ms)")
    print(f"{'name':<{width + 1}}{'count':>7}{'ms':>11}{'%':>7}")
    for name, (n, us) in sorted(rows.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"{name[:width]:<{width + 1}}{n:>7}{us / 1e3:>11.4f}{100 * us / total:>6.1f}%")


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="a Chrome trace (.json, .json.gz) or a directory of them")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--by-class", action="store_true",
                    help="also group the names into routines")
    ap.add_argument("--long", action="store_true", help="print the names whole")
    args = ap.parse_args(argv)

    summary = summarize(args.trace)
    width = 200 if args.long else 72
    _print_table("device time by name", summary["kernels"], args.top, width)
    if args.by_class:
        _print_table("device time by routine", summary["routines"], args.top, 28)
    idle = summary["idle_share"]
    print(f"\nbusy {summary['busy_ms']:.4f} ms (device events summed "
          f"{summary['device_sum_ms']:.4f}) in a traced window of {summary['window_ms']:.4f} ms"
          + (f": idle share {idle:.4f}" if idle is not None else ""))
    if summary["port_launches"]:
        print("\n== launches by port kernel (launcher regions; with device kernels in the trace)")
        for name, entry in sorted(summary["port_launches"].items()):
            print(f"{name:<30}{entry['launcher']:<28}{entry['launches']:>6}{entry['traced']:>6}")
            for kname, n in sorted(entry["kernels"].items(), key=lambda kv: -kv[1]):
                print(f"    {n:>6}  {kname[:width]}")
    return summary


if __name__ == "__main__":
    main()
