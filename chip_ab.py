#!/usr/bin/env python3
"""The train phase of ``chip_smoke.py`` and the fp32 extraction forward for
two checkouts on one GPU, each run alone in fresh processes, in
alternating order.

    python3 chip_ab.py DIR_A DIR_B [--pairs 6] [--out build/ab]
                       [--phases train,eval,extract,kernels,bf16,gemm,moe]

Each process prints the card's name and power limit (``nvidia-smi``), then
runs the phases named (all by default) with TF32 off, as ``chip_smoke.py``
runs them; the first process of a checkout builds its kernels, the others
reuse the build under its ``build/``. The order is A B B A, repeated
``--pairs`` / 2 times (A B for an odd last pair), so that neither checkout
always runs first. One JSON line per process, then one summary line per
checkout: the median over its processes of each row. The phases:

- ``train``: that checkout's ``chip_smoke.check_train`` (phase 6(a)-(c):
  the fp32 B=4 step against the CPU, the fp32 B=32 recipe with 10 timed
  steps and one profiled, ``evaluate``) and, where the checkout has it,
  ``chip_smoke.time_train_graph`` (the same recipe with
  ``steps_per_dispatch`` 4: the median wall of 10 single replays of the
  step's CUDA graph, and a window of 8 replays per step; its profile table,
  ``profile_train_graph``, goes to ``--out``). A later change to the train
  step is measured on the graph step by these rows.
- ``eval``: the evaluation forward that ``test`` and every epoch's
  validation run, timed by this file's own code: ``AVQARunner.eval_step``
  on a fresh recipe runner (fp32, the tower in bf16) at B=32, the median
  wall of 10 calls, each between two synchronizes, after 3 warm-up calls,
  and one ``chip_smoke.profile_step`` table of it (``eval_fp32_b32.txt``).
- ``extract``: the fp32 per-video encoders of the extraction stages
  (``python -m qa_tiger_tpu_torch.pipeline.extract``), timed by this
  file's ``time_extract`` on the checkout's modules: the ``clip`` stage
  (``encode_clip``, ViT-L/14@336px over one video's 60 frames), the
  ``tome`` stage (``encode_tome``, ViT-L/16@384 with 23 merges of 25) and
  the ``questions`` stage (``encode_texts`` over 256 question texts, the
  tokenizer and the host copy included): 2 warm-up calls, then the median
  of 5, each between two synchronizes, random weights from seed 0, inputs
  from numpy seed 0; one profiled call each (device busy and idle share).
  Rows ``extract_ms_clip``, ``extract_ms_tome``, ``extract_ms_questions``.
- ``kernels``: the checkout's ``chip_smoke.run_kernel_case`` on its fp32
  kernel cases, timed: ``attention_wide`` and ``fused_patch_select`` at the
  eval forward's B=32; the raw-media shapes (``e2e_kernel_cases``: ToMe's
  key-bias attention at 552 and 27 tokens, 577-token attention, the CLIP
  image block of ``fused_attn_ln2``); TSPM's one-head AV_Attn and
  TokensAttn calls (``tspm_attention_cases``). Each line's ms by shape.
- ``bf16``: the checkout's ``chip_smoke.check_slice`` (``slice_bf16_b256``:
  the bf16 B=256 serving forward's median of 10) and
  ``chip_smoke.check_e2e_bf16`` (``e2e_bf16_b2``: the bf16 raw-media
  forward's median of 10), and the bf16 ``clip_forward`` of
  ViT-L/14@336px (one video's 60 frames against 42 prompts, the seed
  towers written as a CLIP ``.pt`` and read back, as ``chip_smoke.check_clip``
  builds them), timed by this file's own code: 3 warm-up calls, then the
  median of 10, each between two synchronizes (``clip_vitl336_bf16_ms``).
- ``gemm``: the checkout's ``ops.gemm.gemm_tf32x3`` alone at every shape
  and layout of this file's ``chip_smoke.tf32x3_gemm_shapes`` (the recipe's
  train products, the fp32 eval PatchSelecter's seven, the fp32 extraction's
  two), each with its own split-K plan, timed by the checkout's
  ``chip_smoke.cuda_ms`` on the same seeded operands in every process,
  beside ``torch.matmul`` fp32 (TF32 off) and with its error against the
  fp64 product. Rows ``gemm_ms`` by shape.
- ``moe``: the checkout's ``fused_gaussian_moe`` at every main-path call
  (``chip_smoke.moe_cases``: bf16 x[256] and x[512] of the serving forward,
  fp32 x[32] and x[64] of the train step, bf16 x[2] and x[4] of the
  raw-media forward, from the seeds ``chip_smoke.check_kernels`` takes),
  each against its plain version and timed by ``chip_smoke.run_kernel_case``.
  Rows ``moe_ms`` by dtype and shape.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

PHASES = ("train", "eval", "extract", "kernels", "bf16", "gemm", "moe")
EXTRACT_WARMUP, EXTRACT_RUNS, EXTRACT_TEXTS = 2, 5, 256

PROCESS = r"""
import collections, importlib.util, json, statistics, sys, time
from pathlib import Path
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke

PHASES, OUT, GEMM_SHAPES = {phases!r}, Path({out!r}), {gemm_shapes!r}
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(json.dumps({{"phase": "ab_card", "card": chip_smoke.gpu_line()}}), flush=True)
if "train" in PHASES:
    chip_smoke.check_train(np.random.default_rng(0), collections.defaultdict(dict), OUT)
    if hasattr(chip_smoke, "time_train_graph"):
        torch.cuda.empty_cache()
        chip_smoke.time_train_graph(np.random.default_rng(0), OUT)
    torch.cuda.empty_cache()
if "eval" in PHASES:
    from qa_tiger_tpu_torch.training import AVQARunner

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
    chip_smoke.profile_step(lambda: runner.eval_step(batch), OUT / "eval_fp32_b32.txt",
                            "ab_profile_eval")
    del runner, batch
    torch.cuda.empty_cache()
if "extract" in PHASES:
    spec = importlib.util.spec_from_file_location("chip_ab_timing", {here!r})
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    timing.time_extract(Path("."), OUT, chip_smoke.profile_step)
    torch.cuda.empty_cache()
if "kernels" in PHASES:
    with torch.inference_mode():
        cases = [c for c in chip_smoke.kernel_cases(torch.float32, 32, np.random.default_rng(2),
                                                    torch.Generator().manual_seed(2))
                 if c[0] in ("attention_wide", "fused_patch_select")]
        cases += chip_smoke.e2e_kernel_cases(torch.float32, np.random.default_rng(3),
                                             torch.Generator().manual_seed(3))
        cases += chip_smoke.tspm_attention_cases(torch.float32, np.random.default_rng(4))[:2]
        for case in cases:
            chip_smoke.run_kernel_case(case, torch.float32, chip_smoke.FP32_TOL, True, None)
            torch.cuda.empty_cache()
if "gemm" in PHASES:
    spec = importlib.util.spec_from_file_location("chip_ab_timing", {here!r})
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    timing.time_gemms(GEMM_SHAPES, chip_smoke.cuda_ms)
    torch.cuda.empty_cache()
if "moe" in PHASES:
    with torch.inference_mode():
        for dtype, B, tol, seed in ((torch.bfloat16, 256, chip_smoke.BF16_TOL, 5),
                                    (torch.float32, 32, chip_smoke.FP32_TOL, 8),
                                    (torch.bfloat16, 2, chip_smoke.BF16_TOL, 9)):
            for case in chip_smoke.moe_cases(dtype, B, np.random.default_rng(seed)):
                line = chip_smoke.run_kernel_case(case, dtype, tol, True, None)
                print(json.dumps({{"phase": "ab_moe",
                                  "shape": line["dtype"] + " " + line["shape"],
                                  "ms": line["ms"], "max_abs_err": line["max_abs_err"]}}),
                      flush=True)
    torch.cuda.empty_cache()
if "bf16" in PHASES:
    chip_smoke.check_slice(np.random.default_rng(5), collections.defaultdict(dict), None)
    torch.cuda.empty_cache()
    chip_smoke.check_e2e_bf16(np.random.default_rng(6), None)
    torch.cuda.empty_cache()
    import tempfile
    from qa_tiger_tpu_torch.models import clip

    encoder_type, px, _ = chip_smoke.CLIP_CASES["clip_vitl336"]
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_clip_checkpoint(encoder_type, Path(tmp) / "clip.pt", seed=0)
        text_sd, vision_sd, _ = clip.load(str(Path(tmp) / "clip.pt"))
    towers = clip.build_towers(text_sd, vision_sd, encoder_type, device="cuda",
                               dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(19)
    frames = torch.randn(chip_smoke.CLIP_FRAMES, px, px, 3, generator=g, device="cuda",
                         dtype=torch.bfloat16)
    prompts = torch.from_numpy(chip_smoke.make_tokens(np.random.default_rng(18),
                                                      chip_smoke.CLIP_PROMPTS)).cuda()
    with torch.inference_mode():
        for _ in range(3):
            clip.clip_forward(*towers, frames, prompts, encoder_type=encoder_type)
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            start = time.perf_counter()
            clip.clip_forward(*towers, frames, prompts, encoder_type=encoder_type)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
    print(json.dumps({{"phase": "ab_clip_vitl336_bf16",
                      "forward_ms_median": statistics.median(times),
                      "forward_ms_all": times}}), flush=True)
"""


def time_extract(root: Path, out: Path, profile_step, check=None) -> dict:
    """The fp32 encoders of the ``clip``, ``tome`` and ``questions`` stages
    on one video (60 frames) and on EXTRACT_TEXTS question texts, through
    the stages' own model loading (random weights, seed 0) on the card:
    EXTRACT_WARMUP warm-up calls, then (where given) ``check(stage, call)``,
    then the median wall of EXTRACT_RUNS calls, each between two
    synchronizes; then one call through ``profile_step`` (its table under
    ``out``, its line ``extract_profile_<stage>`` with the device busy time
    and idle share). The texts are the first of ``root``'s
    ``tests/torch_corpus.py`` validation questions with their slots filled,
    tokenized by a merges file learned from them. Prints and returns
    ``extract_ms_<stage>`` rows."""
    import argparse
    import importlib.util
    import os
    import tempfile
    import time

    import numpy as np
    import torch

    from qa_tiger_tpu_torch.models.clip_image import CLIPVisionTower
    from qa_tiger_tpu_torch.models.clip_text import CLIPTextTower
    from qa_tiger_tpu_torch.models.vit import VisionTransformer
    from qa_tiger_tpu_torch.pipeline import extract as E

    spec = importlib.util.spec_from_file_location("torch_corpus",
                                                  root / "tests" / "torch_corpus.py")
    corpus = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(corpus)
    texts = E.stage_texts(corpus.val_questions()[:EXTRACT_TEXTS], use_prompt=False)
    rng = np.random.default_rng(0)
    args = argparse.Namespace(weights=None, random_weights=True, device=None)
    stages = {
        "clip": (CLIPVisionTower, (60, 336, 336, 3), E.encode_clip),
        "tome": (VisionTransformer, (60, 384, 384, 3), lambda m, x: E.encode_tome(m, x, [25] * 23)),
        "questions": (lambda: CLIPTextTower("ViT-L/14@336px", torch.Generator().manual_seed(0)),
                      None, lambda m, x: E.encode_texts(m, texts))}
    rows = {}
    old_vocab = os.environ.get("QA_TIGER_BPE_VOCAB")
    with tempfile.TemporaryDirectory() as tmp:
        corpus.write_merges(Path(tmp) / "vocab.txt.gz", texts)
        os.environ["QA_TIGER_BPE_VOCAB"] = str(Path(tmp) / "vocab.txt.gz")
        try:
            for name, (build, shape, encode) in stages.items():
                model = E._load_params(args, build)
                x = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
                     if shape else None)
                with torch.inference_mode():
                    for _ in range(EXTRACT_WARMUP):
                        encode(model, x)
                    if check is not None:
                        check(name, lambda: encode(model, x))
                    times = []
                    for _ in range(EXTRACT_RUNS):
                        torch.cuda.synchronize()
                        start = time.perf_counter()
                        got = encode(model, x)
                        torch.cuda.synchronize()
                        times.append((time.perf_counter() - start) * 1e3)
                    got = torch.as_tensor(got)
                    rows[name] = {"phase": f"extract_ms_{name}",
                                  "ms_median": statistics.median(times), "ms_all": times,
                                  "shape": list(got.shape),
                                  "finite": bool(torch.isfinite(got).all())}
                    print(json.dumps(rows[name]), flush=True)
                    profile_step(lambda: encode(model, x), out / f"extract_{name}.txt",
                                 f"extract_profile_{name}")
                del model, x, got
                torch.cuda.empty_cache()
        finally:
            if old_vocab is None:
                os.environ.pop("QA_TIGER_BPE_VOCAB", None)
            else:
                os.environ["QA_TIGER_BPE_VOCAB"] = old_vocab
    return rows


def time_gemms(shapes, cuda_ms) -> None:
    """``gemm_tf32x3`` of the running checkout at each (M, N, K, A
    column-major, B as [N, K]) of ``shapes``, on operands drawn from one
    seed per shape, timed by ``cuda_ms`` beside ``torch.matmul`` fp32; its
    error against the fp64 product relative to max(1, max|ref|). One line
    ``ab_gemm`` per shape."""
    import torch

    from qa_tiger_tpu_torch.ops import gemm as GM

    with torch.inference_mode():
        for i, (m, n, k, col, b_nk) in enumerate(shapes):
            gen = torch.Generator(device="cuda").manual_seed(100 + i)
            a = torch.randn(*((k, m) if col else (m, k)), device="cuda", generator=gen)
            b = torch.randn(*((n, k) if b_nk else (k, n)), device="cuda", generator=gen)
            a_mat, b_mat = (a.t() if col else a), (b.t() if b_nk else b)
            ref = a_mat.double() @ b_mat.double()
            got = GM.gemm_tf32x3(a, b, a_col_major=col, b_nk=b_nk)
            err = ((got.double() - ref).abs().max() / ref.abs().max().clamp(min=1.0)).item()
            del ref, got
            ms = cuda_ms(lambda: GM.gemm_tf32x3(a, b, a_col_major=col, b_nk=b_nk))
            lib = cuda_ms(lambda: torch.matmul(a_mat, b_mat))
            print(json.dumps({"phase": "ab_gemm", "shape": gemm_key((m, n, k, col, b_nk)),
                              "ms": ms, "library_ms": lib,
                              "tflops": 2 * m * n * k / ms * 1e-9, "err_fp64": err}), flush=True)
            del a, b, a_mat, b_mat
        torch.cuda.empty_cache()


def gemm_key(shape) -> str:
    m, n, k, col, b_nk = shape
    return f"{m}x{n}x{k} a{'col' if col else 'row'} b{'nk' if b_nk else 'kn'}"


def gemm_shapes() -> list:
    """This checkout's ``chip_smoke.tf32x3_gemm_shapes``, as (M, N, K, A
    column-major, B as [N, K]) tuples."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke

    return [tuple(key) for key in sorted(chip_smoke.tf32x3_gemm_shapes())]


def run_one(tree: Path, out: Path, phases: tuple, shapes: list) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    script = PROCESS.format(phases=phases, out=str(out), here=str(Path(__file__).resolve()),
                            gemm_shapes=shapes)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tree, capture_output=True,
                          text=True, timeout=1500)
    if proc.returncode:
        raise SystemExit(f"chip_ab: {tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}"
                         f"\n{proc.stdout[-4000:]}")
    lines, kernels, gemms, moes = {}, {}, {}, {}
    for text in proc.stdout.splitlines():
        if text.startswith("{"):
            line = json.loads(text)
            lines[line.get("phase")] = line
            if line.get("phase") == "ab_gemm":
                gemms[line["shape"]] = {k: line[k] for k in ("ms", "library_ms", "err_fp64")}
            if line.get("phase") == "ab_moe":
                moes[line["shape"]] = {k: line[k] for k in ("ms", "max_abs_err")}
            if line.get("kernel") and line.get("dtype") == "float32" and "ms" in line:
                kernels[f"{line['kernel']} {line['shape']}"] = {
                    k: line.get(k) for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                             "route", "attn_kernel", "gemm_route",
                                             "gemm_routes", "attn_routes", "max_abs_err")}
    res = {"tree": str(tree), "card": lines["ab_card"]["card"]}
    if "train" in phases:
        step, prof = lines["train_fp32_b32"], lines["profile_train"]
        graph = lines.get("train_graph_time", {})
        window = lines.get("profile_train_graph", {})
        res.update(step_ms_median=step["step_ms_median"], step_ms_all=step["step_ms_all"],
                   device_busy_ms=prof["device_busy_ms"], profiled_wall_ms=prof["wall_ms"],
                   idle_share=prof["idle_share"],
                   graph_replay_ms_median=graph.get("replay_ms_median"),
                   graph_replay_ms_all=graph.get("replay_ms_all"),
                   graph_window_ms_per_step=graph.get("window_ms_per_step"),
                   graph_profile_busy_ms=window.get("device_busy_ms"),
                   graph_profile_idle_share=window.get("idle_share"))
    if "eval" in phases:
        res.update(eval_ms_median=lines["ab_eval_fp32_b32"]["eval_ms_median"],
                   eval_ms_all=lines["ab_eval_fp32_b32"]["eval_ms_all"],
                   eval_profile_busy_ms=lines["ab_profile_eval"]["device_busy_ms"],
                   eval_profile_idle_share=lines["ab_profile_eval"]["idle_share"])
    if "extract" in phases:
        for stage in ("clip", "tome", "questions"):
            row, prof = lines[f"extract_ms_{stage}"], lines[f"extract_profile_{stage}"]
            res[f"extract_ms_{stage}"] = row["ms_median"]
            res[f"extract_ms_{stage}_all"] = row["ms_all"]
            res[f"extract_{stage}_busy_ms"] = prof["device_busy_ms"]
            res[f"extract_{stage}_idle_share"] = prof["idle_share"]
    if "kernels" in phases:
        res["kernels_fp32"] = kernels
    if "gemm" in phases:
        res["gemm_ms"] = gemms
    if "moe" in phases:
        res["moe_ms"] = moes
    if "bf16" in phases:
        res.update(serving_bf16_ms=lines["slice_bf16_b256"]["forward_ms_median"],
                   serving_bf16_ms_all=lines["slice_bf16_b256"]["forward_ms_all"],
                   e2e_bf16_ms=lines["e2e_bf16_b2"]["forward_ms_median"],
                   e2e_bf16_ms_all=lines["e2e_bf16_b2"]["forward_ms_all"],
                   clip_vitl336_bf16_ms=lines["ab_clip_vitl336_bf16"]["forward_ms_median"],
                   clip_vitl336_bf16_ms_all=lines["ab_clip_vitl336_bf16"]["forward_ms_all"])
    return res


# the per-process numbers each checkout's summary takes the median of
SUMMARY_ROWS = ("step_ms_median", "device_busy_ms", "graph_replay_ms_median", "eval_ms_median",
                "extract_ms_clip", "extract_clip_busy_ms", "extract_ms_tome",
                "extract_tome_busy_ms", "extract_ms_questions", "extract_questions_busy_ms",
                "serving_bf16_ms", "e2e_bf16_ms", "clip_vitl336_bf16_ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs=2, type=Path)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--out", type=Path, default=Path("build/ab"))
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    phases = tuple(p for p in args.phases.split(",") if p)
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; choose from {PHASES}")
    out = args.out.resolve()
    a, b = (t.resolve() for t in args.trees)
    order = []
    for i in range(args.pairs):
        order += [a, b] if i % 2 == 0 else [b, a]
    results = {str(a): [], str(b): []}
    shapes = gemm_shapes() if "gemm" in phases else []
    for i, tree in enumerate(order):
        res = run_one(tree, out / f"run_{i:02d}_{tree.name}", phases, shapes)
        res["run"] = i
        print(json.dumps(res), flush=True)
        results[str(tree)].append(res)
    for tree, runs in results.items():
        summary = {"tree": tree, "runs": len(runs)}
        for row in SUMMARY_ROWS:
            values = [r[row] for r in runs if r.get(row) is not None]
            if values:
                summary[f"{row}_median"] = statistics.median(values)
                summary[f"{row}_values"] = values
        if "kernels_fp32" in runs[0]:
            summary["kernel_ms_fp32_medians"] = {
                shape: statistics.median(r["kernels_fp32"][shape]["ms"] for r in runs)
                for shape in runs[0]["kernels_fp32"]}
        if "gemm_ms" in runs[0]:
            summary["gemm_ms_medians"] = {
                shape: statistics.median(r["gemm_ms"][shape]["ms"] for r in runs)
                for shape in runs[0]["gemm_ms"]}
        if "moe_ms" in runs[0]:
            summary["moe_ms_medians"] = {
                shape: statistics.median(r["moe_ms"][shape]["ms"] for r in runs)
                for shape in runs[0]["moe_ms"]}
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
