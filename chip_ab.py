#!/usr/bin/env python3
"""The train phase of ``chip_smoke.py`` for two checkouts on one GPU, each run
alone in fresh processes, in alternating order.

    python3 chip_ab.py DIR_A DIR_B [--pairs 6] [--out build/ab]

Each process starts in one checkout and runs that checkout's
``chip_smoke.check_train`` (phase 6(a)-(c): the fp32 B=4 step against the
CPU, the fp32 B=32 recipe with 10 timed steps and one profiled,
``evaluate``) and, where the checkout has it, ``chip_smoke.time_train_graph``
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
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

TRAIN = r"""
import collections, sys
from pathlib import Path
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
chip_smoke.check_train(np.random.default_rng(0), collections.defaultdict(dict), Path({out!r}))
if hasattr(chip_smoke, "time_train_graph"):
    torch.cuda.empty_cache()
    chip_smoke.time_train_graph(np.random.default_rng(0), Path({out!r}))
"""


def run_one(tree: Path, out: Path) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([sys.executable, "-c", TRAIN.format(out=str(out))], cwd=tree,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise SystemExit(f"chip_ab: {tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    phases = {}
    for text in proc.stdout.splitlines():
        if text.startswith("{"):
            line = json.loads(text)
            phases[line.get("phase")] = line
    step, prof = phases["train_fp32_b32"], phases["profile_train"]
    graph = phases.get("train_graph_time", {})
    window = phases.get("profile_train_graph", {})
    return {"tree": str(tree), "step_ms_median": step["step_ms_median"],
            "step_ms_all": step["step_ms_all"], "device_busy_ms": prof["device_busy_ms"],
            "profiled_wall_ms": prof["wall_ms"], "idle_share": prof["idle_share"],
            "graph_replay_ms_median": graph.get("replay_ms_median"),
            "graph_replay_ms_all": graph.get("replay_ms_all"),
            "graph_window_ms_per_step": graph.get("window_ms_per_step"),
            "graph_profile_busy_ms": window.get("device_busy_ms"),
            "graph_profile_idle_share": window.get("idle_share")}


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
        print(json.dumps({"tree": tree, "runs": len(runs),
                          "step_ms_median_of_medians": statistics.median(meds),
                          "step_ms_medians": meds,
                          "device_busy_ms_median": statistics.median(busy),
                          "device_busy_ms": busy,
                          "graph_replay_ms_median_of_medians":
                              statistics.median(graph) if graph else None,
                          "graph_replay_ms_medians": graph}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
