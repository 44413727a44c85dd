#!/usr/bin/env python3
"""The train phase of ``chip_smoke.py`` for two checkouts on one GPU, each run
alone in fresh processes, in alternating order.

    python3 chip_ab.py DIR_A DIR_B [--pairs 6] [--out build/ab]

Each process prints the card's name and power limit (``nvidia-smi``), then
runs that checkout's ``chip_smoke.check_train`` (phase 6(a)-(c): the fp32
B=4 step against the CPU, the fp32 B=32 recipe with 10 timed steps and one
profiled, ``evaluate``) and, where the checkout has it, ``chip_smoke.time_train_graph``
(the same recipe with ``steps_per_dispatch`` 4: the median wall of 10
single replays of the step's CUDA graph, and a window of 8 replays per
step), with TF32 off, as ``chip_smoke.py`` runs them; the first process of a checkout
builds its kernels, the others reuse the build under its ``build/``. The
order is A B B A, repeated ``--pairs`` / 2 times (A B for an odd last
pair), so that neither checkout always runs first. One JSON line per
process (the recipe's step times, the profiled step's device time and
idle share, the graph step's times or null; the profile tables go to
``--out``, with that of a window of 8 replayed graph steps,
``profile_train_graph``, and its device time), then one summary line per
checkout: the median of the step medians, of the device times and of the
graph step's medians. A later change to the train step is measured on the
graph step by these rows.

The same process then times the evaluation forward that ``test`` and every
epoch's validation run, with this file's own code (so that a parent
checkout is timed as the change is): ``AVQARunner.eval_step`` on a fresh
recipe runner (fp32, the tower in bf16) at B=32, the median wall of 10
calls, each between two synchronizes, after 3 warm-up calls, and one
``chip_smoke.profile_step`` table of it (``eval_fp32_b32.txt`` under
``--out``); then the checkout's ``chip_smoke.run_kernel_case`` on its fp32
B=32 ``attention_wide`` and ``fused_patch_select`` cases, timed. Each
process's line and each checkout's summary carry the eval medians and the
kernels' times by shape.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

TRAIN = r"""
import collections, json, sys
from pathlib import Path
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(json.dumps({{"phase": "ab_card", "card": chip_smoke.gpu_line()}}), flush=True)
chip_smoke.check_train(np.random.default_rng(0), collections.defaultdict(dict), Path({out!r}))
if hasattr(chip_smoke, "time_train_graph"):
    torch.cuda.empty_cache()
    chip_smoke.time_train_graph(np.random.default_rng(0), Path({out!r}))

import statistics, time
from qa_tiger_tpu_torch.training import AVQARunner

torch.cuda.empty_cache()
cfg, mcfg = chip_smoke.train_setup()
runner = AVQARunner(cfg, mcfg, device="cuda", seed=0)
batch = runner._device_batch(chip_smoke.make_train_batch(np.random.default_rng(1), 32))
for _ in range(3):
    runner.eval_step(batch)
times = []
for _ in range(10):
    torch.cuda.synchronize()
    start = time.perf_counter()
    runner.eval_step(batch)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - start) * 1e3)
print(json.dumps({{"phase": "ab_eval_fp32_b32", "eval_ms_median": statistics.median(times),
                  "eval_ms_all": times}}), flush=True)
chip_smoke.profile_step(lambda: runner.eval_step(batch), Path({out!r}) / "eval_fp32_b32.txt",
                        "ab_profile_eval")
del runner, batch
torch.cuda.empty_cache()
with torch.inference_mode():
    for case in chip_smoke.kernel_cases(torch.float32, 32, np.random.default_rng(2),
                                        torch.Generator().manual_seed(2)):
        if case[0] in ("attention_wide", "fused_patch_select"):
            chip_smoke.run_kernel_case(case, torch.float32, chip_smoke.FP32_TOL, True, None)
"""


def run_one(tree: Path, out: Path) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([sys.executable, "-c", TRAIN.format(out=str(out))], cwd=tree,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise SystemExit(f"chip_ab: {tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    phases, kernels = {}, {}
    for text in proc.stdout.splitlines():
        if text.startswith("{"):
            line = json.loads(text)
            phases[line.get("phase")] = line
            if line.get("kernel") and line.get("dtype") == "float32" and "ms" in line:
                kernels[f"{line['kernel']} {line['shape']}"] = {
                    k: line.get(k) for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                             "route", "attn_kernel", "gemm_route",
                                             "max_abs_err")}
    step, prof = phases["train_fp32_b32"], phases["profile_train"]
    graph = phases.get("train_graph_time", {})
    window = phases.get("profile_train_graph", {})
    return {"tree": str(tree), "card": phases["ab_card"]["card"],
            "step_ms_median": step["step_ms_median"],
            "step_ms_all": step["step_ms_all"], "device_busy_ms": prof["device_busy_ms"],
            "profiled_wall_ms": prof["wall_ms"], "idle_share": prof["idle_share"],
            "graph_replay_ms_median": graph.get("replay_ms_median"),
            "graph_replay_ms_all": graph.get("replay_ms_all"),
            "graph_window_ms_per_step": graph.get("window_ms_per_step"),
            "graph_profile_busy_ms": window.get("device_busy_ms"),
            "graph_profile_idle_share": window.get("idle_share"),
            "eval_ms_median": phases["ab_eval_fp32_b32"]["eval_ms_median"],
            "eval_ms_all": phases["ab_eval_fp32_b32"]["eval_ms_all"],
            "eval_profile_busy_ms": phases["ab_profile_eval"]["device_busy_ms"],
            "eval_profile_idle_share": phases["ab_profile_eval"]["idle_share"],
            "kernels_fp32_b32": kernels}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs=2, type=Path)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--out", type=Path, default=Path("build/ab"))
    args = ap.parse_args()
    out = args.out.resolve()
    a, b = (t.resolve() for t in args.trees)
    order = []
    for i in range(args.pairs):
        order += [a, b] if i % 2 == 0 else [b, a]
    results = {str(a): [], str(b): []}
    for i, tree in enumerate(order):
        res = run_one(tree, out / f"train_{i:02d}_{tree.name}")
        res["run"] = i
        print(json.dumps(res), flush=True)
        results[str(tree)].append(res)
    for tree, runs in results.items():
        meds = [r["step_ms_median"] for r in runs]
        busy = [r["device_busy_ms"] for r in runs]
        graph = [r["graph_replay_ms_median"] for r in runs
                 if r["graph_replay_ms_median"] is not None]
        evals = [r["eval_ms_median"] for r in runs]
        kernel_ms = {shape: statistics.median(r["kernels_fp32_b32"][shape]["ms"] for r in runs)
                     for shape in runs[0]["kernels_fp32_b32"]}
        print(json.dumps({"tree": tree, "runs": len(runs),
                          "step_ms_median_of_medians": statistics.median(meds),
                          "step_ms_medians": meds,
                          "device_busy_ms_median": statistics.median(busy),
                          "device_busy_ms": busy,
                          "graph_replay_ms_median_of_medians":
                              statistics.median(graph) if graph else None,
                          "graph_replay_ms_medians": graph,
                          "eval_ms_median_of_medians": statistics.median(evals),
                          "eval_ms_medians": evals,
                          "kernel_ms_fp32_b32_medians": kernel_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
