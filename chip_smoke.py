#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (qa_tiger_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, in order; any failure ends the run with a non-zero exit:

1. device — a CUDA card is required; prints its name and power limit;
2. build  — builds the CUDA kernels from qa_tiger_tpu_torch/csrc;
3. kernels — each serving kernel at the serving path's shapes (B=256,
   bf16) against its plain PyTorch version on the same inputs, and again at
   a small fp32 shape; at the raw-media shapes (B*T=120 frames, fp32 and
   bf16) the key-bias attention at ToMe layers 1 and 22, attention over 577
   keys and the CLIP image block; their gradients (the plain-recompute
   backward, the key bias's included) at small fp32 shapes; each train
   kernel pair's outputs and every input and parameter gradient at a small
   fp32 shape and at the recipe shape (B=32) in fp32 and bf16; the
   op-level kernels (``fused_attention`` at the text tower's head-split
   [3072, 77, 64] causal and the packed route's [122880, 14, 64], and
   ``fused_attn_half`` and ``fused_resblock`` at [256, 77, 768] causal) in
   bf16 and at a small fp32 shape, with their gradients and the mask
   cotangents of the four wrappers that give one; ``fused_gaussian_moe``
   also in fp32 at the train step's shapes (x[32], x[64]), timed, and at
   every timed shape twice, bitwise the same; prints kernel, plain and
   library times beside the card's bound, the kernel's achieved TFLOP/s,
   for each kernel that runs ``qt::attention`` the route its dispatch took
   ("mma_short": bf16 tensor cores, a warp per problem of at most 16
   queries and keys, which the packed [122880, 14, 64] case and
   fused_patch_select in bf16 must take; "mma": bf16 tensor cores, 64 query
   rows per block; "fma": fp32 FMAs) and the kernel and shared memory of
   its plan (the library's ``qt_attention_plan`` equal to
   ``ops.attention.attention_plan``), PatchSelecter's self-attention in its
   own strided layout (column slices of one packed qkv) beside SDPA, and
   for fused_attn_ln2,
   fused_attn_half, fused_resblock, fused_patch_select and
   fused_gaussian_moe the GEMM routines of their products ("wgmma":
   gemm_sm90 or the MoE's wgmma kernel, "tf32x3": 3xTF32, "wmma"/"fma":
   gemm_tile; fused_resblock's MLP half must tally wgmma twice per bf16
   launch); then the Hopper GEMM alone at every distinct bf16 product shape
   of the four paths, the bf16 AVQ train forward and the MLP half, against
   its plain version, timed beside its bound and ``torch.matmul``; then the
   fp32 GEMM of every planned fp32 product (``gemm_tf32x3``: 3xTF32 on a
   Hopper kernel, TMA + ``wgmma``, split-K) alone at every product shape of
   the two train kernels' forwards and backwards at B=32, the fp32 eval
   PatchSelecter's seven and the fp32 extraction's CLIP image block's two,
   against its plain version and the fp64 product, timed beside its bound
   and fp32 ``torch.matmul``, with the kernel's registers and spills
   (``tf32x3_ptxas``); the fp32 recipe-shape train
   kernels run twice and must repeat bitwise, and the two train forwards'
   products (seven and ten) must take tf32x3 in fp32 and wgmma in bf16.
   A call shorter than 0.2 ms on the card is timed behind a spin kernel,
   so that the host's launch cost does not set its time (``cuda_ms``);
   fused_attn_ln2 also at the 512-wide text tower of RN50 (x[2, 77, 512]
   fp32, x[42, 77, 512] bf16 timed, causal, 8 heads: attention on mma,
   both products on gemm_sm90; ``clip_text_w512`` in its table entry);
   the keep-masked attention kernels (``attention_keep`` /
   ``attention_keep_bwd``, kernel "mma_keep", inside both train kernels)
   alone at the 12 calls of one recipe train step, fp32 and bf16, against
   their plain versions, their plans the library's, each twice bitwise,
   timed beside the plain versions and the bound (``keep_attention_step``
   sums the step's 12); the fp32 evaluation forward's ``attention_wide``
   calls (AVQ 60 x 77 and 60 x 60 over 2B, TempMoE 1 x 60 and
   QstGrounding 1 x 2 over B) and ``fused_patch_select`` at its batch,
   B=32, timed beside SDPA (fp32, TF32 off) and the 3xTF32 bound (the FMA
   peak's beside it), each twice bitwise, the kernel of each attention and
   the route of each product read back from the launch ("mma_nokeep": the
   keep-masked kernel without its keep multiply; tf32x3 x 7), listed under
   ``eval_fp32_b32`` in both table entries; every unmasked 14-key
   PatchSelecter attention must take "mma_short" in bf16 and "mma_nokeep"
   in fp32, and its eval TP stages the tp = 1 kernel's routes; the fp32
   extraction forward's calls at their shapes, each timed beside SDPA and
   the 3xTF32 bound, twice bitwise, its kernels read back from the launch
   (``extract_fp32`` in the table entries): the CLIP image block of
   fused_attn_ln2 (x[120, 577, 1024]: tf32x3 x 2, "mma_nokeep_tiled"),
   577-token attention and ToMe's key-bias layers 1 and 22
   ("mma_nokeep_tiled", "mma_nokeep"), and the text towers' causal
   attention at ``encode_texts``' chunk (q[256, 77, 768] h12) and RN50's
   prompts (q[42, 77, 512] h8) ("mma_nokeep"); every fp32 fused_attn_ln2
   line reads back tf32x3 x 2; the bf16 lines past 128 keys (qkv[120,
   577], key-bias qkv[120, 552], the CLIP image block) run the Hopper
   attention kernel ("mma_sm90", route "wgmma": bf16 past 128 keys at head
   size 64) and are timed again on attention_mma_kernel on the same inputs
   (``set_sm90_mode("off")`` plans those calls back onto it): the Hopper
   kernel's table entry; then (``sm90_sweep``) ToMe's 18 layers past 128
   tokens on both kernels, each read back and held to its plain version,
   timed in turns;
4. serving — the Predictor at configs/qa-tiger/vitl14.py with weights from
   a seed: (a) fp32 logits at B=4 against the same state_dict run through
   the plain versions on the CPU; (b) the bf16 B=256 path through
   ``answer``, with every launch counter reset just before and read just
   after (every product of fused_attn_ln2 and fused_patch_select on
   gemm_sm90, each fused_gaussian_moe call's on wgmma and tf32x3; the
   kernel of every attention as the launches read it back,
   ``main_path_attn_routes``: none an FMA kernel), then qa/s from the
   median of timed forwards; (c) 8 requests
   answered, their top-5 answer names printed;
5. serve — the serving surface (``qa_tiger_tpu_torch.serve``) over
   bench_serve's corpus (8 videos at the real shapes, a merges file learned
   from its questions), bf16, B=256, seed weights: (a) a full and a padded
   (100-row) batch through ``Service._dispatch`` on the device-cache path
   and on the host path, the two bitwise equal and within BF16_TOL of the
   Predictor on the same rows assembled and padded the same way (the same
   top-1), one dispatch of each path under
   ``torch.cuda.set_sync_debug_mode("error")`` (no hidden host sync), and
   a full batch's features staged to the card both ways (fp32 pageable,
   bf16 pinned), timed; (b) the launch counters reset around two served
   batches: per batch fused_attn_ln2 12, attention_wide 7,
   fused_patch_select 1, fused_gaussian_moe 2, every product of the first
   and third on wgmma; (c) bench_serve's protocol in-process at its
   defaults (4096 requests, 4 client threads, device cache 8:
   ``serve_cached``), then with the cache off over 1024 (``serve_host``),
   qa/s beside ``slice_bf16_b256``'s; (d) ``python -m
   qa_tiger_tpu_torch.serve`` as a subprocess on a free port (/health 200,
   8 concurrent /predict, one /predict_batch, /stats counting them, 404 for
   an unknown video, exit 0 on SIGTERM; its start-up seconds) and
   ``python -m qa_tiger_tpu_torch.predict`` once, against the Predictor in
   fp32 on the same row;
6. training — AVQARunner at the same config: (a) one fp32 B=4 step with
   dropout off, card against CPU (loss, updated parameters, gradients);
   (b) the recipe, fp32 B=32 with dropout: 3 warm-up steps, the launch
   counters reset around one step (every product of the two train kernels'
   forwards and backwards and of the two MoE calls on gemm_tf32x3; every
   keep-masked attention of the two train kernels, three a launch, on
   "mma_keep": ``train_step_attn_routes``), 10 timed steps, losses, peak
   memory;
   (c) ``evaluate`` over two batches, with its accuracy report; then
   ``eval_fp32_b32``: the forward ``evaluate`` runs (``eval_step``, fp32,
   the tower in bf16) at B=32, the counters reset around one call
   (fused_patch_select's products tf32x3 x 7 from its plan rows, no
   attention on an FMA kernel), the median of 10 calls and qa/s, one
   profiled call with ``--profile`` (``profile_eval``);
   (d) resume: two fp32 B=4 steps with dropout, the train state saved and
   restored into a fresh runner whose weights and dropout stream were
   scrambled, one more step on each: every parameter bitwise equal; then
   the weights through ``best.npz`` into a Predictor, whose fp32 logits
   must equal those of a Predictor given the same weights directly,
   bitwise; the launch counters reset around the phase;
   (e) cli: ``python -m qa_tiger_tpu_torch.train`` and ``.test`` through
   their ``main(argv)`` at the same config's widths (batch 32) over a
   corpus written to a temporary directory: the first 110 questions of
   music_avqa_val.json (70 train, 20 val, 20 test) with fp32 features at
   the real shapes from a seed and a merges file learned from them; train
   1 epoch with the counters reset around it (each train kernel 3 times,
   the MoE 2 per step and 2 per eval forward, the eval kernels in evaluate
   and the final test, every feature file read natively), test on its
   best.npz (the same report lines as the train run's final test), then a
   resume for epoch 2 with the question cache (one per split, the tower 12
   launches per split), then 4 epochs afresh, the rate read over epochs
   2-4; steps, epoch seconds, qa-pairs/s beside the recipe's rate of (b),
   the seconds spent waiting on the loader, the native reader's build time;
   then those 4 epochs again with ``steps_per_dispatch: 4``
   (``cli_warm_graph``: every step but the first a replay of the step's
   CUDA graph, the same launch counts, the rate and loader wait beside
   ``cli_warm``'s);
   (f) train_graph (run before (e)): ``steps_per_dispatch`` 4 at the recipe
   through ``AVQARunner.train_window``: 11 batches through the train step's
   CUDA graph (a warm-up, a capture, 10 replays) bitwise equal to the same
   static-input step run eagerly (losses, parameters, Adam's moments, the
   dropout stream); each replay from a default K=1 runner's state (copied
   in place) within rtol 2e-4 / atol 2e-5 of that runner's step, beside the
   free-running gaps; the launch counters reset around one replay (the
   eager step's counts and GEMM routes); 10 single replays and a window of
   8 timed, the window under ``set_sync_debug_mode("error")``, beside the
   eager median of (b); one window each in bf16 compute and with
   ``grad_accum`` 2 and a resume mid-run (restored into a runner that had
   captured its own graph), bitwise;
7. raw media — ``pipeline.e2e`` at full width (CLIP ViT-L/14@336px, ToMe
   vit_large_patch16_384 at r=[25]*23, VGGish, the QA-TIGER config):
   (a) fp32 B=1 x T=2 card against CPU (streams, logits, every ToMe
   matching), the launch counters reset around the card's run: no
   attention on an FMA kernel, fused_attn_ln2's products tf32x3, as the
   launches read them back (``e2e_fp32_b1_attn_routes``,
   ``_gemm_routes``); (b) bf16 B=2 x T=60 through ``e2e_forward`` with the
   launch counters reset around one forward (every product of
   fused_attn_ln2 and fused_patch_select on gemm_sm90; the kernel of each
   attention past 128 tokens read back, ``e2e_bf16_b2_attn_routes``: the 24
   CLIP image blocks and the 14 of ToMe's 18 layers past 128 tokens that
   the plan's rule gives the Hopper kernel on "mma_sm90"), then videos/s
   from the median of 10; (c) ``extract``: the fp32 ``clip``, ``tome`` and
   ``questions`` encoders (one 60-frame video, 256 question texts) timed
   by ``chip_ab.time_extract`` (2 warm-up calls, the median of 5, one
   profiled: device busy and idle share), the counters reset around one
   call of each (its launches, no attention on an FMA kernel,
   fused_attn_ln2's products tf32x3); then every stage's encoder once on
   one 60-frame video;
8. TSPM — ``configs/tspm/vitl14.py`` (hidden 512, topK 10, audio 128,
   vis 768, patch 1024, qst 768; T=60 frames of P=14 patches): (a)
   ``tspm_attention``: ``attention_wide`` at TSPM's calls (AV_Attn's one
   head of 512 over 60 frames, TokensAttn's over 14 patches, the
   four-head one-query attn_ffn calls over 14 and 10 keys) and a 256-lane
   head over 577 keys, bf16 and fp32, against its plain version, timed
   beside its bound and SDPA, each line naming its route and kernel
   (``attn_kernel``: in bf16 mma_wide, mma_wide_short and mma_short, in
   fp32 lane_split (the lane split's 3xTF32 stages at one rank) and
   mma_nokeep, each fp32 call twice bitwise; the library's plan held to
   ``ops.attention.attention_plan``), and one masked, key-biased call of
   the wide-head kernel (fp32) and of the wide mma kernel (bf16) twice,
   bitwise the same; (b) ``tspm_fp32_b4``:
   the eval forward card against CPU (LOGITS_TOL, the top-K frames equal,
   the seed's smallest top-K weight gap printed), no attention of the
   card's run on an FMA kernel; (c) ``tspm_bf16_b256``:
   ``bench``'s protocol, the counters reset around one forward
   (attention_wide 6, nothing else), profiled with ``--profile``
   (``profile_tspm``); (d) ``tspm_train_fp32_b32``: the recipe (fp32,
   B=32, Adam, dropout on: no kernel launches, every attention on the
   plain path as in the JAX package), the median of 10 steps, then
   ``steps_per_dispatch`` 2 over 5 batches through the step's CUDA graph,
   bitwise its eager twin (``train_graph_tspm``); (e) ``tspm_cli``: the ``questions`` and
   ``prompts`` extraction stages over the cli corpus (random text weights,
   a second run writing nothing), ``train.main`` one epoch, ``test.main``
   on its best.npz with the same accuracy, the counters reset around all
   three;
9. bench_resblock — ``python -m qa_tiger_tpu_torch.bench_resblock`` at its
   defaults (B=256, S=77, W=768, bf16, causal) for ``attn_half`` and
   ``attn_ln2``, the launch counters reset around each, both JSON lines;
10. CLIP (``models.clip``) at RN50 and ViT-L/14@336px: the seed towers
   written as a CLIP ``.pt`` (fp16, OpenAI's names, an RN tower's random
   BatchNorm statistics and ``num_batches_tracked``), read back through
   ``load`` and ``build_towers``; (a) ``clip_rn50_fp32`` /
   ``clip_vitl336_fp32``: ``clip_forward`` on 2 images x 4 texts, card
   against the CPU within LOGITS_TOL, the card's run with no attention on
   an FMA kernel and fused_attn_ln2's products tf32x3; (b) ``clip_rn50_bf16`` /
   ``clip_vitl336_bf16``: one video's 60 frames against 42 answer prompts,
   the launch counters reset around one forward (fused_attn_ln2 12 and 36
   times, on gemm_sm90, nothing else; ViT-L's 24 image blocks read back
   "mma_sm90"), images/s from the median of 10;
11. tools: ``profile_stages --batch 256 --trace DIR`` (the sum of its
   stages beside FULL), ``trace_summary`` over its trace (its launches by
   port kernel equal to the wrappers' over the traced block, each with its
   device kernels in the trace), ``bench_avq`` and ``bench_e2e --iters 2
   --repeats 1``;
12. data parallelism (``qa_tiger_tpu_torch.parallel``) and the v2
   config: (a) ``dp_eval`` and ``dp_train``: two ranks spawned on the card
   over gloo (NCCL refuses two ranks on one card; gloo reduces CUDA
   tensors through the host, so their times are no figure for NCCL) at
   the recipe's widths, fp32, ``gather_mode="paper"``, dropout off with
   the train kernels on (p = 1e-300 at the AVQ and PatchSelecter sites,
   whose masks are then all ones; the attention-dropout sites at 0),
   against one process on the same global batches: ``_run_eval`` over 65
   rows (16 per rank and batch; rank 1's third batch all padding), the
   all-reduced counters equal to one process's, integers exactly; then 2
   train steps at global B=32 (16 per rank), the ranks' parameters bitwise
   equal, their losses and parameters (where the last gradient is above
   1e-6) within rtol 2e-3 / atol 5e-4 of one process's, each rank's
   launches per step those of one train step; (b) ``dp_graph``: the
   recipe's graph step (``steps_per_dispatch`` 4) in this process under
   an NCCL group of world 1 (the replay holds its all-reduces) against
   the plain graph step: losses over 10 steps bitwise, windows of 8
   replays timed plain / group / plain; (c) ``dp_cli``: ``python -m
   torch.distributed.run --nproc-per-node 1 -m qa_tiger_tpu_torch.train
   --distributed`` over the cli corpus with ``steps_per_dispatch`` 4
   (NCCL), ``test --distributed`` on its best.npz, and the same train
   without ``--distributed`` (in this process): equal final reports, one
   best.npz;
   (d) ``cli_v2``: ``test.main`` with configs/qa-tiger/vitl14_v2.py as
   shipped (full width, batch 32, seed weights) over the first 64
   questions of each of its two test splits with features at the real
   shapes: each split's accuracy and the seconds;
13. tensor parallelism (``qa_tiger_tpu_torch.parallel.tensor``): (a) in
   phase 3, the tensor-parallel forms of fused_attn_ln2 (x[B,77,768], 12
   heads), fused_patch_select and fused_gaussian_moe (x[2B,60,512]) at
   tp 2 and 4, fp32 B=2 and bf16 B=256: every stage on every rank's
   shards against its plain version, the partials summed in rank order,
   the post-reduce launch, and the result against the single-rank kernel
   (``tp_chain`` lines, FP32_TOL / BF16_TOL); in bf16 each stage timed on
   rank 0 beside its bound and the single-rank kernel's time, twice and
   bitwise the same (the self- and cross-attention on "mma_short"), the
   lines kept under ``tp`` in the three kernels' table entries; (b)
   ``tp_eval``: two ranks spawned on the card over gloo (dp1 x tp2; NCCL
   refuses two ranks on one card, and gloo's host round trips make the
   times no figure for tensor parallelism) at the vitl14 config from seed
   0: fp32 B=4 logits within LOGITS_TOL of one process and the ranks
   bitwise equal; bf16 B=256 within BF16_TOL, each rank's launches those
   of one process (12 / 7 / 1 / 2) with the stage launches beside them,
   every bf16 stage product on gemm_sm90; (c) ``tp_grid``: dp2 x tp2, four
   ranks, fp32, ``_run_eval`` over 65 rows, the counters equal one
   process's exactly; (d) ``tp_train_chain`` (in phase 3, after the train
   kernels): the tensor-parallel stages of ``fused_avq_train`` (five: three
   forward, two backward) and ``fused_patch_select_train`` (four forward,
   three backward) at the recipe's widths and B=32, tp 2 and 4, fp32 and
   bf16: every stage on every rank against its plain version on the card
   (bf16 gradients against the fp32 plain version, as for the train
   kernels), the partials summed in rank order between stages, then the
   output and every input and parameter gradient against the single-rank
   kernel pair on the same inputs and masks, the replicated parameters'
   gradients bitwise equal on the ranks; the fp32 stages on rank 0 timed
   beside their 3xTF32 bounds and the single-rank kernels' times, kept
   under ``tp`` in the four train kernels' table entries; (e)
   ``tp_train``: dp1 x tp2, two ranks spawned on the card over gloo (no
   figure for tensor parallelism's speed), three fp32 B=32 ``train_step``
   calls with dropout on against one process's from the same step
   generator (the tower in fp32 too): each step's losses within rtol
   1e-5, the first step's gradients gathered within 1e-4 of the step's
   largest gradient element, the replicated parameters bitwise equal on
   the ranks after the last step, a rank's launches per step one
   process's and its stage launches printed; (b), (e), (g) and 12(a)
   share one spawn of two ranks (``pair_spawn``: data parallelism at world
   2, then a dp1 x tp2 grid), one process's runs of the same parts made
   while the ranks run;
   (f) ``tp_tspm_chain`` (in phase 3, after ``tp_chain``): one-head
   attention_wide split by lanes (``attention_wide_tp_scores``,
   ``attention_wide_tp_pv``) at TSPM's AV_Attn [512, 60, 512] and
   TokensAttn [2560, 14, 512], tp 2 and 4, bf16 and fp32: each rank's
   stages against their plain versions, the partial scores summed in rank
   order, the ranks' lanes against the single-rank kernel on the whole
   head (FP32_TOL / BF16_TOL), rank 0's stages timed beside their bounds,
   the lines under ``tp`` in attention_wide's table entry; (g)
   ``tp_tspm``: TSPM (configs/tspm/vitl14.py, seed 0) on the shared
   dp1 x tp2 ranks against one process: the bf16 B=256 forward's logits
   within BF16_TOL, the top-K frames one process's (a sample whose frames
   differ only at a K-th / (K+1)-th tie within 2 bf16 ulps, at most 4),
   the smallest gap printed, a rank's launches one process's and its stage
   launches 3 and 3; the fp32 B=32 recipe, dropout on, 2 steps: losses
   within rtol 1e-5, first-step gradients within 1e-4 of each tensor's
   own largest, replicated parameters bitwise, no launch; (h)
   ``tp_graph``: the model-axis step under a CUDA graph on the one card
   (NCCL refuses two ranks on one card): the train stage chain of (d) at
   tp 2 in fp32 and the two one-head stages in bf16, every rank in this
   process, captured in one graph, each of 3 replays bitwise the eager
   chain; and, where PyTorch has its fake process group (collectives that
   do nothing), one process at dp1 x tp2 whose ``train_window`` at K = 4
   captures rank 0's whole QA-TIGER step, 8 replays bitwise the eager
   static-input step (the capture, not a TP step's numbers);
14. the kernel table as one JSON line (each entry's ``launches`` from its
   own path, ``launches_by_path`` from all of them, ``serve`` per served
   batch, ``train_graph`` per replay, ``tspm`` per bf16 forward,
   ``tspm_train`` per step, ``tspm_cli`` the whole phase, ``dp_eval``
   rank 0's eval, ``dp_train`` rank 0's last step, ``dp_graph`` one
   replay under the group, ``cli_v2`` the whole phase, ``clip_rn50`` and
   ``clip_vitl336`` one bf16 forward;
   ``attention_wide``'s entry also lists the ``tspm`` lines; ``tp_eval``
   rank 0's bf16 forward; ``tp_train`` rank 0's last step; ``tp_tspm`` rank
   0's TSPM bf16 forward; ``tp_graph`` one replay of (h)'s captured step),
   then the device's JSON line last.

Every phase prints its wall seconds (``phase_seconds`` lines), and one line
before the card's sums them by phase (``"phase": "seconds"``).

``--profile DIR`` also writes torch.profiler tables of one bf16 serving
forward, a window of 1024 served requests under 4 client threads (its
device idle share: ``profile_serve``), one train step, a window of 8
replayed train steps (``profile_train_graph``: no FMA attention kernel may
run in it), one raw-media forward and
one TSPM bf16 B=256 forward (``profile_tspm``) and one bf16 CLIP forward
of each config (``profile_clip_rn50``, ``profile_clip_vitl336``) to DIR,
each through ``utils.profiling.trace``, whose Chrome trace
``trace_summary`` reads beside the table (``<phase>_trace``). All inputs
come from fixed seeds. TF32 is off.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import functools
import importlib.util
import json
import logging
import re
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
# "tf32x3": the dense TF32 tensor-core peak over the three passes of the
# train backwards' fp32 products (gemm_tf32x3), the least time an fp32 sum
# of products can take on this card
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 494.7e12 / 3}
BF16_TOL = 3e-2   # max|k - p| <= BF16_TOL * max(1, max|p|): bf16 rounding
FP32_TOL = 1e-4   # the same at fp32: summation order only
LOGITS_TOL = dict(rtol=2e-3, atol=5e-4)  # fp32 card vs CPU, as the JAX parity tests
T, P, S, VOCAB = 60, 14, 77, 49408
# the serving path's kernels: their "launches" in the kernel table are that
# path's, the train kernels' those of one train step
EVAL_KERNELS = ("fused_attn_ln2", "attention_wide", "fused_patch_select", "fused_gaussian_moe")
# launched by the raw-media forward only: its "launches" are that path's
E2E_ONLY_KERNELS = ("attention_wide_key_bias",)
# the op-level kernels: no model path of the JAX package runs them, and their
# "launches" are those of the bench_resblock path (0 for fused_attention and
# fused_resblock, whose only callers are the kernel checks)
OP_KERNELS = ("fused_attention", "fused_attn_half", "fused_resblock")
CONFIG = ROOT / "configs" / "qa-tiger" / "vitl14.py"
# where each kernel's Pallas original makes its pl.pallas_call
REPLACES = {
    "fused_attn_ln2": "qa_tiger_tpu/ops/pallas/resblock.py:391",
    "attention_wide": "qa_tiger_tpu/ops/pallas/attention.py:351",
    # the same call's bf16 bodies past 128 keys (_wide_nomask_kernel,
    # _wide_nomask_kb_kernel), on the Hopper kernel
    "attention_sm90": "qa_tiger_tpu/ops/pallas/attention.py:351",
    # _wide_kb_kernel (:247) / _wide_nomask_kb_kernel (:253) of the same call
    "attention_wide_key_bias": "qa_tiger_tpu/ops/pallas/attention.py:351",
    "fused_patch_select": "qa_tiger_tpu/ops/pallas/patch_select.py:738",
    "fused_gaussian_moe": "qa_tiger_tpu/ops/pallas/gaussian_moe.py:107",
    "fused_avq_train": "qa_tiger_tpu/ops/pallas/avq.py:532",
    "fused_avq_train_bwd": "qa_tiger_tpu/ops/pallas/avq.py:558",
    "fused_patch_select_train": "qa_tiger_tpu/ops/pallas/patch_select.py:827",
    "fused_patch_select_train_bwd": "qa_tiger_tpu/ops/pallas/patch_select.py:880",
    # _kernel / _no_mask_kernel; the packed route's case names :116
    "fused_attention": "qa_tiger_tpu/ops/pallas/attention.py:165",
    "fused_attn_half": "qa_tiger_tpu/ops/pallas/resblock.py:329",
    # the MLP half's call; the attention half's is fused_attn_half's
    "fused_resblock": "qa_tiger_tpu/ops/pallas/resblock.py:508",
}
SOURCES = {
    "fused_attn_ln2": "qa_tiger_tpu_torch/csrc/resblock.cu",
    "attention_wide": "qa_tiger_tpu_torch/csrc/attention.cu",
    "attention_wide_key_bias": "qa_tiger_tpu_torch/csrc/attention.cu",
    "attention_sm90": "qa_tiger_tpu_torch/csrc/attention_sm90.cuh",
    "fused_patch_select": "qa_tiger_tpu_torch/csrc/patch_select.cu",
    "fused_gaussian_moe": "qa_tiger_tpu_torch/csrc/gaussian_moe.cu",
    "fused_avq_train": "qa_tiger_tpu_torch/csrc/avq.cu",
    "fused_avq_train_bwd": "qa_tiger_tpu_torch/csrc/avq.cu",
    "fused_patch_select_train": "qa_tiger_tpu_torch/csrc/patch_select_train.cu",
    "fused_patch_select_train_bwd": "qa_tiger_tpu_torch/csrc/patch_select_train.cu",
    "fused_attention": "qa_tiger_tpu_torch/csrc/attention.cu",
    "fused_attn_half": "qa_tiger_tpu_torch/csrc/resblock.cu",
    "fused_resblock": "qa_tiger_tpu_torch/csrc/resblock.cu",
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


# a call that takes less than SHORT_MS on the card may take longer than
# that to queue on the host; cuda_ms times it again over SHORT_WINDOW_MS of
# device work (at most SHORT_MAX_ITERS calls) queued behind a spin kernel
SHORT_MS, SHORT_WINDOW_MS, SHORT_MAX_ITERS = 0.2, 2.0, 200
# a spin that ended before the calls behind it were queued is grown this
# many times, at most this many readings
SPIN_GROWTH, SPIN_TRIES = 4.0, 3


def _event_ms(fn, iters: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@functools.lru_cache(maxsize=None)
def _spin_cycles_per_ms() -> float:
    """Clock cycles per ms of torch.cuda._sleep, the spin kernel, measured
    once on this card."""
    import torch

    torch.cuda._sleep(1_000_000)  # warm-up
    return 10_000_000 / _event_ms(lambda: torch.cuda._sleep(10_000_000), 1)


def _spin_ms(fn, n: int, spin_ms: float) -> tuple[float, bool]:
    """n calls queued behind a spin of spin_ms, timed by events around them
    alone: (ms per call, whether the spin still ran when the last call and
    the end event had been queued, so that the calls ran from a full queue
    and none of them waited on the host)."""
    import torch

    torch.cuda.synchronize()
    spun = torch.cuda.Event()
    torch.cuda._sleep(int(_spin_cycles_per_ms() * spin_ms))
    spun.record()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    covered = not spun.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, covered


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls.

    Back to back, a call that is short on the card is paced by the host's
    launch cost: the events then time the host, not the kernel. So a call
    under SHORT_MS is timed again over n calls, enough for SHORT_WINDOW_MS of
    device work (at most SHORT_MAX_ITERS): the host's time to queue n calls
    is measured first, then a spin kernel (``torch.cuda._sleep``) holds the
    card for twice that plus 1 ms while the host queues the n calls behind
    it; the start event is recorded after the spin, so the two events
    bracket the n calls alone, run from a full queue with no gap between
    them. An event recorded behind the spin is queried once the calls are
    queued: where the spin had already ended (a slow host, or a call that
    waits on the host), the reading is taken again behind a spin SPIN_GROWTH
    times longer, at most SPIN_TRIES times, and every reading is printed
    beside the spin it was taken behind."""
    import torch

    for _ in range(warmup):
        fn()
    ms = _event_ms(fn, iters)
    if ms >= SHORT_MS:
        return ms
    n = min(SHORT_MAX_ITERS, max(iters, int(SHORT_WINDOW_MS / max(ms, 1e-3))))
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - start) * 1e3
    readings, spins = [], []
    for i in range(SPIN_TRIES):
        spins.append((2 * host_ms + 1.0) * SPIN_GROWTH ** i)
        ms, covered = _spin_ms(fn, n, spins[-1])
        readings.append(ms)
        if covered:
            break
    if len(readings) > 1:
        print(json.dumps({"cuda_ms_retimed": readings, "calls": n, "spins_ms": spins,
                          "covered": covered}), flush=True)
    return ms


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
    from qa_tiger_tpu_torch.ops import gemm as GM
    from qa_tiger_tpu_torch.ops import patch_select as PS
    from qa_tiger_tpu_torch.ops import resblock as R

    dev = "cuda"
    isz = torch.tensor([], dtype=dtype).element_size()
    fp32 = dtype == torch.float32
    # fp32: every product and attention on 3xTF32 (gemm_tf32x3, mma_nokeep)
    peak = "tf32x3" if fp32 else "bfloat16"

    def rn(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape, dtype=np.float32))).to(dev, dtype)

    # text tower: one launch per layer, x [B, 77, 768], causal, 12 heads
    cases = [text_block_case(dtype, B, 768, 12, rng, gen)]

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

        plan = A.attention_plan(dtype, sq, sk, D // heads)
        cases.append(("attention_wide", f"q[{b},{sq},{D}] kv[{b},{sk},{D}] h{heads}",
                      lambda q=q, k=k, v=v: A.attention_wide(q, k, v, None, sc, heads),
                      lambda q=q, k=k, v=v: A._wide_reference(q, k, v, None, sc, heads),
                      sdpa, (2 * b * sq * D + 2 * b * sk * D) * isz, 4 * b * sq * sk * D,
                      {"attn": (sq, sk, D // heads), "peak": peak, "tally": A.attention_wide,
                       "want_tally": {"attn_routes": {plan.kernel: 1}}}))

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
                  None, nbytes, flops, {"gemm": GM.patch_select_gemm_shapes(BT, P, D),
                                        "attn": (P, P, D // heads),
                                        "want_route": short_route(dtype), "peak": peak,
                                        "tally": PS.fused_patch_select,
                                        "want_tally": {
                                            "gemm_routes": {"tf32x3" if fp32 else "wgmma": 7},
                                            "attn_routes": {short_route(dtype): 2}}}))
    return cases + moe_cases(dtype, B, rng)


def text_block_case(dtype, B: int, W: int, H: int, rng, gen, want_route: str | None = None):
    """fused_attn_ln2 at one text-tower block, x [B, 77, W], causal, H
    heads, against ``_attn_ln2_plain``. Bytes: x, y and h and the block's
    weights once, the mask; flops: the two products and the causal scores
    (keys <= query)."""
    import torch

    from qa_tiger_tpu_torch.models.clip_text import ResidualAttentionBlock, causal_mask
    from qa_tiger_tpu_torch.ops import gemm as GM
    from qa_tiger_tpu_torch.ops import resblock as R

    isz = torch.tensor([], dtype=dtype).element_size()
    blk = ResidualAttentionBlock(W, 12, gen).to("cuda", dtype)
    x = torch.from_numpy(rng.standard_normal((B, S, W), dtype=np.float32)).to("cuda", dtype)
    mask = causal_mask(S, device="cuda")
    return ("fused_attn_ln2", f"x[{B},{S},{W}] causal h{H}",
            lambda: R.fused_attn_ln2(x, blk, mask, H),
            lambda: R._attn_ln2_plain(blk, x, heads=H, mask=mask), None,
            (3 * B * S * W + 4 * W * W + 8 * W) * isz + S * S * 4,
            2 * B * S * W * 4 * W + 2 * B * W * S * (S + 1),
            {"attn": (S, S, W // H), "attn_bias": True, "gemm": GM.attn_gemm_shapes(B * S, W),
             "want_route": want_route, "peak": "tf32x3" if dtype == torch.float32 else "bfloat16",
             **ln2_tally(dtype, S, W // H, True)})


def ln2_tally(dtype, S: int, hd: int, bias: bool) -> dict:
    """A fused_attn_ln2 case's read-back: in fp32 one launch's products on
    gemm_tf32x3 and its attention on the kernel ``attention_plan`` names,
    from its plan rows; in bf16 its products on gemm_sm90 by the route
    rule (a bf16 launch plans nothing)."""
    import torch

    from qa_tiger_tpu_torch.ops import attention as A
    from qa_tiger_tpu_torch.ops import resblock as R

    if dtype != torch.float32:
        return {"tally": R.fused_attn_ln2, "want_tally": {"gemm_routes": {"wgmma": 2}}}
    kernel = A.attention_plan(dtype, S, S, hd, limit=A.smem_limit("cuda"), has_bias=bias).kernel
    return {"tally": R.fused_attn_ln2,
            "want_tally": {"gemm_routes": {"tf32x3": 2}, "attn_routes": {kernel: 1}}}


def short_route(dtype) -> str:
    """The attention route an unmasked 14-key problem must take: the short
    tensor-core kernel in bf16, the keep-masked kernel without a keep mask
    in fp32 (3xTF32)."""
    import torch

    return "mma_short" if dtype == torch.bfloat16 else "mma_nokeep"


def patch_attention_case(dtype, B: int, rng):
    """PatchSelecter's self-attention in its own layout (csrc/patch_select.cu
    launches qt::attention on it): the column slices of one packed qkv
    [B T, 14, 3 x 512], 8 heads of 64, unmasked, here through
    attention_wide's entry to the same dispatch; SDPA on the same views.
    Bytes: q, k and v read once, the context written once."""
    import torch
    from torch.nn import functional as F

    from qa_tiger_tpu_torch.ops import attention as A

    BT, D, heads, hd = B * T, 512, 8, 64
    isz = torch.tensor([], dtype=dtype).element_size()
    qkv = torch.from_numpy(rng.standard_normal((BT, P, 3 * D), dtype=np.float32)).to("cuda", dtype)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]

    def sdpa():
        return F.scaled_dot_product_attention(
            *(t.view(BT, P, heads, hd).transpose(1, 2) for t in (q, k, v)), scale=0.125)

    return ("attention_wide", f"PatchSelecter self-attention qkv[{BT},{P},{3 * D}] h{heads}",
            lambda: A.attention_wide(q, k, v, None, 0.125, heads),
            lambda: A._wide_reference(q, k, v, None, 0.125, heads), sdpa,
            4 * BT * P * D * isz, 4 * BT * P * P * D,
            {"replaces": "qa_tiger_tpu/ops/pallas/patch_select.py:738",
             "attn": (P, P, hd), "want_route": short_route(dtype)})


def moe_cases(dtype, B: int, rng):
    """fused_gaussian_moe's two calls per TempMoE forward: the audio stream
    over B rows, both visual streams stacked over 2B rows. The line names
    the routes of its two products (``moe_route``'s for the hidden product,
    tf32x3 for the second); an fp32 call's bound is its operations over the
    3xTF32 peak, the FMA peak's beside it."""
    import torch

    from qa_tiger_tpu_torch.ops import gaussian_moe as G

    dev, D, E = "cuda", 512, 7
    Hd = D // 2
    isz = torch.tensor([], dtype=dtype).element_size()

    def rn(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape, dtype=np.float32))).to(dev, dtype)

    w1t, b1 = rn(E, D, Hd, scale=0.05), rn(E, Hd, scale=0.1)
    w2t, b2 = rn(E, Hd, D, scale=0.05), rn(E, D, scale=0.1)
    routes = sorted({G.moe_route(dtype, D), "tf32x3"})
    cases = []
    for b in (B, 2 * B):
        xm = rn(b, T, D)
        w = torch.from_numpy(0.05 * rng.random((b, E, T), dtype=np.float32)).to(dev, dtype)
        nbytes = (b * T * D + b * E * T + 2 * E * D * Hd + E * (Hd + D) + b * D) * isz
        flops = 2 * b * T * E * D * Hd + 2 * b * E * T * Hd + 2 * b * E * Hd * D
        cases.append(("fused_gaussian_moe", f"x[{b},{T},{D}] E{E} H{Hd}",
                      lambda xm=xm, w=w: G.fused_gaussian_moe(xm, w1t, b1, w2t, b2, w),
                      lambda xm=xm, w=w: G._reference_impl(xm, w1t, b1, w2t, b2, w),
                      None, nbytes, flops,
                      {"routes": routes,
                       "peak": "tf32x3" if dtype == torch.float32 else "bfloat16"}))
    return cases


def op_kernel_cases(dtype, B: int, rng, gen):
    """The kernel cases of the op-level kernels, with the Pallas call each
    replaces in the eighth item. ``fused_attention`` at the text tower's
    head-split attention, [12B, 77, 64] causal (Pallas :165), and at the
    packed route's PatchSelecter self-attention, [8 B T, 14, 64] unmasked
    (:116); ``fused_attn_half`` and ``fused_resblock`` at the text tower's
    block, [B, 77, 768] causal, 12 heads. Flops as the Pallas cost
    estimates count them, the causal scores halved as for fused_attn_ln2;
    bytes: inputs, parameters and the mask read once, the output written
    once."""
    import torch
    from torch.nn import functional as F

    from qa_tiger_tpu_torch.models.clip_text import ResidualAttentionBlock, causal_mask
    from qa_tiger_tpu_torch.ops import attention as A
    from qa_tiger_tpu_torch.ops import gemm as GM
    from qa_tiger_tpu_torch.ops import resblock as R

    dev, dh = "cuda", 64
    isz = torch.tensor([], dtype=dtype).element_size()

    def rn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)

    cases = []
    # SDPA sees [BH / heads, heads, S, dh], so that neither its batch nor its
    # heads pass 65535, the limit of a grid's y and z dimensions
    for bh, s, masked, site, heads in ((12 * B, S, True, ":165", 12),
                                       (8 * B * T, P, False, ":116", 8)):
        q, k, v = rn(bh, s, dh), rn(bh, s, dh), rn(bh, s, dh)
        mask = causal_mask(s, device=dev) if masked else None
        pairs = s * (s + 1) // 2 if masked else s * s

        def sdpa(q=q, k=k, v=v, mask=mask, s=s, heads=heads):
            return F.scaled_dot_product_attention(
                *(t.view(-1, heads, s, dh) for t in (q, k, v)),
                attn_mask=None if mask is None else mask.to(dtype), scale=0.125)

        cases.append(("fused_attention", f"[{bh},{s},{dh}]" + (" causal" if masked else ""),
                      lambda q=q, k=k, v=v, mask=mask: A.fused_attention(q, k, v, mask, 0.125),
                      lambda q=q, k=k, v=v, mask=mask: A._fused_attention_plain(
                          q, k, v, mask=mask, scale=0.125),
                      sdpa, 4 * bh * s * dh * isz + (s * s * 4 if masked else 0),
                      4 * bh * pairs * dh,
                      {"replaces": "qa_tiger_tpu/ops/pallas/attention.py" + site,
                       "attn": (s, s, dh), "attn_bias": masked,
                       "want_route": short_route(dtype) if site == ":116" else None}))

    W, H = 768, 12
    blk = ResidualAttentionBlock(W, 12, gen).to(dev, dtype)
    x = rn(B, S, W)
    mask = causal_mask(S, device=dev)
    attn_flops = 2 * B * S * W * 4 * W + 2 * B * W * S * (S + 1)
    cases.append(("fused_attn_half", f"x[{B},{S},{W}] causal h{H}",
                  lambda: R.fused_attn_half(x, blk, mask, H),
                  lambda: R._attn_half_flat(x, *R._attn_params(blk), heads=H, mask=mask), None,
                  (2 * B * S * W + 4 * W * W + 6 * W) * isz + S * S * 4, attn_flops,
                  {"attn": (S, S, W // H), "attn_bias": True,
                   "gemm": GM.attn_gemm_shapes(B * S, W)}))
    cases.append(("fused_resblock", f"x[{B},{S},{W}] causal h{H}",
                  lambda: R.fused_resblock(x, blk, mask, H),
                  lambda: R._resblock_flat(x, *R._resblock_params(blk), heads=H, mask=mask),
                  None, (2 * B * S * W + 12 * W * W + 13 * W) * isz + S * S * 4,
                  attn_flops + 16 * B * S * W * W,
                  {"attn": (S, S, W // H), "attn_bias": True,
                   "gemm": GM.attn_gemm_shapes(B * S, W) + GM.mlp_gemm_shapes(B * S, W)}))
    return cases


def run_kernel_case(case, dtype, tol: float, timed: bool, entries: dict | None) -> dict:
    """One kernel against its plain version on the same inputs; with
    ``timed``, kernel, plain and library times beside the bound and the
    kernel's achieved TFLOP/s on the bound's flop count. ``entries`` keeps
    each kernel's JSON entry at its largest-bound call.

    A case's optional eighth item is a dict: ``replaces`` (the Pallas call,
    where it is not the kernel's own in REPLACES) and ``attn`` ((Sq, Sk, hd)
    of the ``qt::attention`` call inside the kernel, whose route,
    "mma_short", "mma" or "fma", the line and the table entry then name;
    ``want_route``, where not None, the route it must be) and ``gemm``
    ((M, N, K) of the kernel's
    products, whose GEMM routine, "wgmma", "wmma" or "fma", the line and the
    table entry name) or ``routes`` (the routines' names themselves), and
    ``peak`` (the peak the bound divides by, where it is not the dtype's;
    at "tf32x3" the FMA peak's bound stands beside it). ``attn_bias``: the
    call adds a mask or a key bias, which the plan weighs. ``tally``: a
    wrapper whose ``gemm_routes`` / ``attn_routes`` are cleared before the
    checked launch and read after it (the routes its plan rows and the
    attention library wrote back), held to ``want_tally`` where given; the
    line's ``gemm_route`` is then the tally's. Returns the line."""
    import torch

    from qa_tiger_tpu_torch.ops import attention as A
    from qa_tiger_tpu_torch.ops import gemm as GM

    name, shape, kernel, plain, library, nbytes, flops, *rest = case
    extra = rest[0] if rest else {}
    dname = str(dtype).replace("torch.", "")
    tally = extra.get("tally")
    if tally is not None:
        for kind in ("gemm_routes", "attn_routes"):
            if hasattr(tally, kind):
                setattr(tally, kind, {})
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err, scale = max_err(got, want)
    del got, want
    ok = err <= tol * max(1.0, scale)
    line = {"kernel": name, "dtype": dname, "shape": shape,
            "max_abs_err": err, "max_abs_plain": scale,
            "tolerance": tol * max(1.0, scale), "ok": ok}
    if "attn" in extra:
        attn, bias = extra["attn"], extra.get("attn_bias", False)
        line["route"] = A.attention_route(dtype, *attn, has_bias=bias)
        plan = A.attention_plan(dtype, *attn, limit=A.smem_limit("cuda"), has_bias=bias)
        line.update(attn_kernel=plan.kernel, smem_bytes=plan.smem_bytes)
        planned = A.library_plan(dtype, attn[0], attn[1], plan.head, has_bias=bias)
        ok = line["ok"] = (ok and extra.get("want_route") in (None, line["route"])
                           and planned == (plan.kernel, plan.smem_bytes))
    if tally is not None:  # what one launch wrote back: its plan rows, its kernels
        for kind in ("gemm_routes", "attn_routes"):
            if hasattr(tally, kind):
                line[kind] = dict(getattr(tally, kind))
        ok = line["ok"] = ok and all(line.get(k) == v
                                     for k, v in extra.get("want_tally", {}).items())
    routes = extra.get("routes") or (sorted(line["gemm_routes"]) if "gemm_routes" in line
                                     else sorted({GM.gemm_route(dtype, *mnk)
                                                  for mnk in extra.get("gemm", ())}))
    if routes:
        line["gemm_route"] = routes[0] if len(routes) == 1 else routes
    peak = extra.get("peak", dname)
    if timed:
        b_ms, b_by = bound(nbytes, flops, peak)
        line.update(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                    library_ms=cuda_ms(library) if library else None,
                    bound_ms=b_ms, bound_by=b_by)
        if peak == "tf32x3":
            line["bound_fma_ms"] = bound(nbytes, flops, "float32")[0]
        line["tflops"] = flops / line["ms"] * 1e-9
        if entries is not None and (name not in entries or b_ms > entries[name]["bound_ms"]):
            entries[name] = {
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": extra.get("replaces", REPLACES[name]), "launches": 0,
                "shape": shape, "dtype": dname, "max_abs_err": err, "ms": line["ms"],
                "plain_ms": line["plain_ms"], "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": line["library_ms"]}
            if routes:
                entries[name].update(gemm_route=line["gemm_route"], tflops=line["tflops"])
            if "route" in line:
                entries[name]["attn_route"] = line["route"]
    print(json.dumps(line), flush=True)
    require(ok, f"{name} {dname} {shape}: max|k-p| {err:.3e} over tolerance"
                + (f", or route {line['route']}, expected {extra['want_route']}"
                   if extra.get("want_route") else "")
                + (", or the library's attention plan is not the Python one"
                   if "attn" in extra else "")
                + (f", or one launch's routes {[line.get(k) for k in extra['want_tally']]}, "
                   f"expected {list(extra['want_tally'].values())}"
                   if extra.get("want_tally") else ""))
    return line


def check_kernels(rng, gen) -> dict:
    """Phase 3. Returns the JSON entry of each kernel at its largest
    main-path call. fused_gaussian_moe runs at two shapes on each path, so
    its entry also lists its timed lines by path (``by_path``: the serving
    forward's x[256] and x[512] in bf16, the train step's x[32] and x[64]
    in fp32 and the raw-media forward's x[2] and x[4] in bf16, these two
    pairs from seeds of their own) and their sums per path; each call runs
    twice and must repeat bitwise. Then the fp32 evaluation forward's
    attention_wide and fused_patch_select calls at its batch, B=32, from a
    seed of their own, timed beside SDPA (fp32, TF32 off) and their bounds
    (3xTF32, the FMA peak's beside it), each launch's routes read back
    (``eval_fp32_b32`` under each entry), every launch twice bitwise."""
    import torch

    entries, moe = {}, {"serving": [], "train": [], "e2e": []}
    with torch.inference_mode():
        for dtype, B, tol, timed in ((torch.float32, 2, FP32_TOL, False),
                                     (torch.bfloat16, 256, BF16_TOL, True)):
            for case in kernel_cases(dtype, B, rng, gen):
                line = run_kernel_case(case, dtype, tol, timed, entries)
                if case[0] == "fused_gaussian_moe" and timed:
                    moe["serving"].append(line)
                    require_repeat(case)
        keys = ("shape", "dtype", "route", "attn_kernel", "gemm_route", "attn_routes",
                "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "bound_fma_ms", "tflops")
        for case in kernel_cases(torch.float32, 32, np.random.default_rng(23),
                                 torch.Generator().manual_seed(23)):
            if case[0] in ("attention_wide", "fused_patch_select"):
                line = run_kernel_case(case, torch.float32, FP32_TOL, True, None)
                require_repeat(case)
                entries[case[0]].setdefault("eval_fp32_b32", []).append(
                    {k: line[k] for k in keys if k in line})
        for path, dtype, B, tol, seed in (("train", torch.float32, 32, FP32_TOL, 8),
                                          ("e2e", torch.bfloat16, 2, BF16_TOL, 9)):
            for case in moe_cases(dtype, B, np.random.default_rng(seed)):
                moe[path].append(run_kernel_case(case, dtype, tol, True, None))
                require_repeat(case)
    keys = ("shape", "dtype", "gemm_route", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "bound_fma_ms", "tflops")
    entry = entries["fused_gaussian_moe"]
    entry["by_path"] = {path: [{k: ln[k] for k in keys if k in ln} for ln in lines]
                        for path, lines in moe.items()}
    for path, lines in moe.items():
        for k in ("ms", "plain_ms", "bound_ms"):
            entry[f"{k}_per_{path}_path"] = sum(ln[k] for ln in lines)
    return entries


def require_repeat(case) -> None:
    """Two launches of a case's kernel give bitwise the same result."""
    require(_repeat_equal(case[2]), f"{case[0]} {case[1]}: two launches differ")


def check_op_kernels(entries: dict) -> None:
    """Phase 3 for the op-level kernels, small fp32 (B=2) and bf16 at the
    text tower's B=256, timed, from seeds of their own (the earlier checks
    draw what they drew before). One launch of ``fused_resblock`` must
    tally its MLP half's two products on gemm_sm90 in bf16 (gemm_tile's FMA
    loop in fp32). Then PatchSelecter's self-attention in its own layout at
    the same B, from a seed of its own, which stays out of the table."""
    import torch

    from qa_tiger_tpu_torch.ops import resblock as R

    rng, gen = np.random.default_rng(4), torch.Generator().manual_seed(4)
    with torch.inference_mode():
        for dtype, B, tol, timed in ((torch.float32, 2, FP32_TOL, False),
                                     (torch.bfloat16, 256, BF16_TOL, True)):
            for case in op_kernel_cases(dtype, B, rng, gen):
                if case[0] == "fused_resblock":
                    R.fused_resblock.gemm_routes = {}
                    case[2]()
                    routes = dict(R.fused_resblock.gemm_routes)
                    want = {"wgmma" if dtype == torch.bfloat16 else "fma": 2}
                    print(json.dumps({"phase": "resblock_mlp_gemm_routes", "shape": case[1],
                                      "dtype": str(dtype).replace("torch.", ""),
                                      "fused_resblock": routes}), flush=True)
                    require(routes == want, f"fused_resblock {case[1]}: its MLP half's "
                                            f"products took {routes}, expected {want}")
                run_kernel_case(case, dtype, tol, timed, entries)
            run_kernel_case(patch_attention_case(dtype, B, np.random.default_rng(6)), dtype, tol,
                            timed, None)
            torch.cuda.empty_cache()


# the RN50 (and ViT-B) text tower: width 512, 8 heads (clip_text.py:36-38),
# over one video's 42 answer prompts
CLIP_TEXT_W, CLIP_TEXT_HEADS, CLIP_PROMPTS = 512, 8, 42


def check_clip_text_kernel(entries: dict) -> None:
    """Phase 3 at the 512-wide text tower of clip_rn50: fused_attn_ln2 at
    x[2, 77, 512] in fp32 and x[42, 77, 512] in bf16, causal, 8 heads, from
    seeds of their own, against its plain version; the bf16 call timed
    beside its bound, its attention on the mma route and its two products
    (qkv N=1536, K=512; out N=512) on gemm_sm90, by the route rule and by
    one launch's tally (gemm_tf32x3 in fp32). Its bf16 line joins the
    kernel's table entry as ``clip_text_w512``."""
    import torch

    from qa_tiger_tpu_torch.ops import resblock as R

    rng, gen = np.random.default_rng(17), torch.Generator().manual_seed(17)
    with torch.inference_mode():
        for dtype, B, tol, timed in ((torch.float32, 2, FP32_TOL, False),
                                     (torch.bfloat16, CLIP_PROMPTS, BF16_TOL, True)):
            bf16 = dtype == torch.bfloat16
            case = text_block_case(dtype, B, CLIP_TEXT_W, CLIP_TEXT_HEADS, rng, gen,
                                   want_route="mma" if bf16 else None)
            line = run_kernel_case(case, dtype, tol, timed, None)
            R.fused_attn_ln2.gemm_routes = {}
            case[2]()
            routes = dict(R.fused_attn_ln2.gemm_routes)
            want = {"wgmma": 2} if bf16 else {"tf32x3": 2}
            print(json.dumps({"phase": "clip_text_w512_gemm_routes", "shape": case[1],
                              "dtype": line["dtype"], "fused_attn_ln2": routes}), flush=True)
            require(routes == want and line["gemm_route"] == next(iter(want)),
                    f"fused_attn_ln2 {case[1]}: its products took {routes} "
                    f"(route rule: {line['gemm_route']}), expected {want}")
            if bf16:
                entries["fused_attn_ln2"]["clip_text_w512"] = {
                    k: line[k] for k in ("shape", "dtype", "max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by", "tflops", "gemm_route",
                                         "route")}
        torch.cuda.empty_cache()


def path_gemm_shapes() -> dict:
    """Every distinct bf16 (M, N, K) product that runs on gemm_sm90, with
    the paths that launch it (``paths``) and the kernels (``used_by``):
    fused_attn_ln2, fused_attn_half and fused_patch_select on the four paths
    (the text tower at B=256 for serving and bench_resblock, 32 for train,
    2 for raw media; the CLIP image tower over 120 frames; PatchSelecter
    over 256 x 60 and 2 x 60 frames), and, on no timed path, the bf16 AVQ
    train forward at the recipe (N = 64 rows of 60 frames, 77 words) and
    fused_resblock's MLP half at the text tower's B=256, which the kernel
    checks run."""
    from qa_tiger_tpu_torch.ops import gemm as GM

    shapes = {}
    for path, kernel, mnks in (
            ("serving", "fused_attn_ln2", GM.attn_gemm_shapes(256 * S, 768)),
            ("serving", "fused_patch_select", GM.patch_select_gemm_shapes(256 * T, P, 512)),
            ("train", "fused_attn_ln2", GM.attn_gemm_shapes(32 * S, 768)),
            ("e2e", "fused_attn_ln2", GM.attn_gemm_shapes(2 * T * 577, 1024)
             + GM.attn_gemm_shapes(2 * S, 768)),
            ("e2e", "fused_patch_select", GM.patch_select_gemm_shapes(2 * T, P, 512)),
            ("bench_resblock", "fused_attn_half", GM.attn_gemm_shapes(256 * S, 768)),
            ("bench_resblock", "fused_attn_ln2", GM.attn_gemm_shapes(256 * S, 768)),
            (None, "fused_avq_train", GM.avq_train_fwd_gemm_shapes(64, T, S, 512)),
            (None, "fused_resblock", GM.mlp_gemm_shapes(256 * S, 768))):
        for mnk in mnks:
            entry = shapes.setdefault(mnk, {"paths": [], "used_by": []})
            if path and path not in entry["paths"]:
                entry["paths"].append(path)
            if kernel not in entry["used_by"]:
                entry["used_by"].append(kernel)
    return shapes


def check_gemms() -> list:
    """Phase 3 for the Hopper GEMM under the fused bf16 kernels: at each
    shape of ``path_gemm_shapes``, ``gemm_sm90`` (through the bias epilogue,
    bf16 out) against its plain version (the fp32 product of the same bf16
    operands, rounded), timed beside its bound and beside
    ``torch.matmul`` on the same operands (``library_ms``, a yardstick the
    port never calls). One line per shape; returns them."""
    import torch

    from qa_tiger_tpu_torch.ops import gemm as GM

    gen = torch.Generator(device="cuda").manual_seed(6)
    lines = []
    with torch.inference_mode():
        for (m, n, k), users in sorted(path_gemm_shapes().items()):
            a = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
            b = (torch.randn(n, k, device="cuda", generator=gen) * k ** -0.5).bfloat16()
            bias = torch.randn(n, device="cuda", generator=gen).bfloat16()
            route = GM.gemm_route(torch.bfloat16, m, n, k)
            got, want = GM.gemm_sm90(a, b, bias=bias), GM.gemm_plain(a, b, bias=bias)
            torch.cuda.synchronize()
            err, scale = max_err(got, want)
            del got, want
            flops = 2 * m * n * k
            b_ms, b_by = bound((m * k + n * k + n + m * n) * 2, flops, "bfloat16")
            line = {"gemm": f"{m}x{n}x{k}", **users, "route": route,
                    "max_abs_err": err, "max_abs_plain": scale,
                    "tolerance": BF16_TOL * max(1.0, scale),
                    "ms": cuda_ms(lambda a=a, b=b, bias=bias: GM.gemm_sm90(a, b, bias=bias)),
                    "plain_ms": cuda_ms(lambda a=a, b=b, bias=bias: GM.gemm_plain(a, b,
                                                                                 bias=bias)),
                    "library_ms": cuda_ms(lambda a=a, b=b: torch.matmul(a, b.t())),
                    "bound_ms": b_ms, "bound_by": b_by}
            line["tflops"] = flops / line["ms"] * 1e-9
            line["ok"] = err <= line["tolerance"]
            print(json.dumps(line), flush=True)
            lines.append(line)
            require(route == "wgmma", f"gemm {m}x{n}x{k}: route {route}, expected wgmma")
            require(line["ok"], f"gemm_sm90 {m}x{n}x{k}: max|k-p| {err:.3e} over tolerance")
            del a, b
        torch.cuda.empty_cache()
    return lines


def tf32x3_gemm_shapes() -> dict:
    """Every distinct fp32 (M, N, K) product of the two train kernels,
    forward and backward, at the recipe (B = 32: 32 x 60 PatchSelecter
    frames of 14 patches, 64 AVQ rows of 60 frames and 77 words, width
    512), of the fp32 eval ``fused_patch_select`` at B = 32 (the train
    forward's seven) and of the fp32 extraction's CLIP image block
    (``fused_attn_ln2`` over x[120, 577, 1024]: qkv, out_proj) and of
    ``fused_gaussian_moe``'s second product (s [b, E*H] times W2 [E*H, 512],
    K = 7 x 256, in bf16 and fp32 alike) at every batch its main-path calls
    take (``moe_cases``: b = 256, 512 serving; 32, 64 train; 2, 4 raw
    media), keyed with its operands' layouts, with the kernels that launch
    it. A weight gradient reads A column-major (its K a row count: 26,880
    patch rows, 3,840 query or AVQ rows, 4,928 words) and B as [K, N]; a
    backward's dgrad and the MoE's second product read A row-major and B as
    [K, N]; a forward product A row-major and B (a weight) as [N, K]."""
    from qa_tiger_tpu_torch.ops import gemm as GM

    rows = {32 * T * P, 2 * 32 * T, 64 * T, 64 * S}
    moe = [(b, 512, 7 * 256) for B in (256, 32, 2) for b in (B, 2 * B)]
    shapes = {}
    for kernel, mnks, b_nk in (
            ("fused_patch_select_train_bwd",
             GM.patch_select_train_bwd_gemm_shapes(32 * T, P, 512), False),
            ("fused_avq_train_bwd", GM.avq_train_bwd_gemm_shapes(64, T, S, 512), False),
            ("fused_avq_train", GM.avq_train_fwd_gemm_shapes(64, T, S, 512), True),
            ("fused_patch_select_train", GM.patch_select_gemm_shapes(32 * T, P, 512), True),
            ("fused_patch_select", GM.patch_select_gemm_shapes(32 * T, P, 512), True),
            ("fused_attn_ln2", GM.attn_gemm_shapes(120 * 577, 1024), True),
            ("fused_gaussian_moe", moe, False)):
        for m, n, k in mnks:
            kernels = shapes.setdefault((m, n, k, not b_nk and k in rows, b_nk), [])
            if kernel not in kernels:
                kernels.append(kernel)
    return shapes


def check_tf32x3_gemms() -> list:
    """The fp32 GEMM under every planned fp32 product alone
    (``gemm_tf32x3``: 3xTF32 on the Hopper kernel, TMA + ``wgmma``, the
    split-K plan) at each distinct product shape and layout of
    ``tf32x3_gemm_shapes``: against its plain version (the same split,
    three fp32 products) and against the fp64 product, both at FP32_TOL;
    timed beside its bound (operations over the tf32x3 peak; bytes: A, B
    and C once) and beside ``torch.matmul`` on the same fp32 operands with
    TF32 off (``library_ms``, a yardstick the port never calls). One line
    per shape, then the kernel's registers and spills (``kernel_ptxas``, line
    ``tf32x3_ptxas``);
    returns the shape lines."""
    import torch

    from qa_tiger_tpu_torch.ops import gemm as GM

    gen = torch.Generator(device="cuda").manual_seed(7)
    sms = GM.sm_count(torch.device("cuda"))
    lines = []
    with torch.inference_mode():
        for (m, n, k, col, b_nk), kernels in sorted(tf32x3_gemm_shapes().items()):
            a = torch.randn(*((k, m) if col else (m, k)), device="cuda", generator=gen)
            b = torch.randn(*((n, k) if b_nk else (k, n)), device="cuda", generator=gen)
            a_mat = a.t() if col else a
            b_mat = b.t() if b_nk else b
            got = GM.gemm_tf32x3(a, b, a_col_major=col, b_nk=b_nk)
            want = GM.gemm_tf32x3_plain(a, b, a_col_major=col, b_nk=b_nk)
            ref = a_mat.double() @ b_mat.double()
            torch.cuda.synchronize()
            err, scale = max_err(got, want)
            err64 = (got.double() - ref).abs().max().item()
            scale64 = ref.abs().max().item()
            del got, want, ref
            flops = 2 * m * n * k
            b_ms, b_by = bound((m * k + k * n + m * n) * 4, flops, "tf32x3")
            line = {"gemm_tf32x3": f"{m}x{n}x{k}", "used_by": kernels,
                    "a": "col" if col else "row", "b": "nk" if b_nk else "kn",
                    "splits": GM.splitk_plan(m, n, k, sms).splits,
                    "max_abs_err": err, "max_abs_plain": scale, "max_abs_err_fp64": err64,
                    "max_abs_fp64": scale64, "tolerance": FP32_TOL * max(1.0, scale),
                    "ms": cuda_ms(lambda a=a, b=b: GM.gemm_tf32x3(a, b, a_col_major=col,
                                                                   b_nk=b_nk)),
                    "plain_ms": cuda_ms(lambda a=a, b=b: GM.gemm_tf32x3_plain(
                        a, b, a_col_major=col, b_nk=b_nk)),
                    "library_ms": cuda_ms(lambda a=a_mat, b=b_mat: torch.matmul(a, b)),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "bound_fma_ms": bound((m * k + k * n + m * n) * 4, flops, "float32")[0]}
            line["tflops"] = flops / line["ms"] * 1e-9
            line["ok"] = (err <= line["tolerance"]
                          and err64 <= FP32_TOL * max(1.0, scale64))
            print(json.dumps(line), flush=True)
            lines.append(line)
            require(line["ok"], f"gemm_tf32x3 {m}x{n}x{k}: max|k-p| {err:.3e}, against fp64 "
                                f"{err64:.3e}, over tolerance")
            del a, b, a_mat, b_mat
        torch.cuda.empty_cache()
    rows = kernel_ptxas("gemm_tf32x3_kernel", "tf32x3_ptxas")
    require(rows, "the build log names no gemm_tf32x3_kernel")
    return lines


def require_tensor_core_attention(label: str, kernels=("attention_wide", "fused_patch_select")
                                   ) -> dict:
    """Prints the kernel each attention launch of a forward took, as the
    launchers read it back (``attn_routes`` of ``kernels``, cleared by
    ``ops.reset_launches``), on a line ``label``, and requires that none
    took an FMA kernel. Returns the tallies."""
    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch.ops import attention as A

    attn = {name: dict(ops.KERNELS[name].attn_routes) for name in kernels}
    print(json.dumps({"phase": label, **attn}), flush=True)
    fma = {name: {k: n for k, n in routes.items() if A.KERNEL_ROUTES.get(k, "fma") == "fma"}
           for name, routes in attn.items()}
    fma = {name: routes for name, routes in fma.items() if routes}
    require(not fma, f"{label}: attentions took FMA kernels: {fma}")
    return attn


# the kernels whose launches read back the kernel of each attention they ran
ATTN_TALLY_KERNELS = ("attention_wide", "fused_patch_select", "fused_attn_ln2")


def require_fp32_tensor_cores(label: str) -> dict:
    """After an fp32 forward, the launch counters reset before it: no
    attention on an FMA kernel (``require_tensor_core_attention`` over
    ATTN_TALLY_KERNELS, line ``<label>_attn_routes``) and every product of
    fused_attn_ln2 on gemm_tf32x3, two a launch, as its plan rows read back
    (line ``<label>_gemm_routes``). Returns the attention tallies."""
    from qa_tiger_tpu_torch import ops

    attn = require_tensor_core_attention(f"{label}_attn_routes", ATTN_TALLY_KERNELS)
    n = ops.launch_counts()["fused_attn_ln2"]
    routes = dict(ops.KERNELS["fused_attn_ln2"].gemm_routes)
    print(json.dumps({"phase": f"{label}_gemm_routes", "fused_attn_ln2": routes,
                      "fused_attn_ln2_launches": n}), flush=True)
    require(routes == ({"tf32x3": 2 * n} if n else {}),
            f"{label}: fused_attn_ln2's products took {routes}, expected tf32x3 x {2 * n}")
    return attn


def require_wgmma(counts_phase: str) -> None:
    """Every product the bf16 calls of fused_attn_ln2 and fused_patch_select
    launched since the counters were reset went through gemm_sm90, and the
    two fused_gaussian_moe calls of the forward each took wgmma for their
    hidden product and tf32x3 for the second."""
    from qa_tiger_tpu_torch import ops

    routes = {name: dict(ops.KERNELS[name].gemm_routes)
              for name in ("fused_attn_ln2", "fused_patch_select", "fused_gaussian_moe")}
    print(json.dumps({"phase": counts_phase, **routes}), flush=True)
    for name in ("fused_attn_ln2", "fused_patch_select"):
        require(bool(routes[name]) and set(routes[name]) == {"wgmma"},
                f"{counts_phase}: {name}'s products took {routes[name]}, expected wgmma only")
    require(routes["fused_gaussian_moe"] == {"wgmma": 2, "tf32x3": 2},
            f"{counts_phase}: fused_gaussian_moe's products took {routes['fused_gaussian_moe']}, "
            "expected wgmma and tf32x3 twice each")


def e2e_kernel_cases(dtype, rng, gen):
    """The kernel cases at the raw-media forward's shapes, B*T = 120
    frames: ToMe's key-bias attention at layer 1 (552 tokens) and layer 22
    (27 tokens), its bias-free layer 0 (577 tokens), q, k and v as column
    slices of one packed qkv, 16 heads of 64, the bias the log of integer
    sizes 1-40; and one CLIP ViT-L/14@336px block (577 tokens, no mask)."""
    import torch
    from torch.nn import functional as F

    from qa_tiger_tpu_torch.models.clip_text import ResidualAttentionBlock
    from qa_tiger_tpu_torch.ops import attention as A
    from qa_tiger_tpu_torch.ops import gemm as GM
    from qa_tiger_tpu_torch.ops import resblock as R

    dev, BT, W, H = "cuda", 2 * T, 1024, 16
    isz = torch.tensor([], dtype=dtype).element_size()
    peak = "tf32x3" if dtype == torch.float32 else "bfloat16"

    def rn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)

    cases = []
    for n, bias in ((552, True), (27, True), (577, False)):
        qkv = rn(BT, n, 3 * W)
        q, k, v = qkv[..., :W], qkv[..., W:2 * W], qkv[..., 2 * W:]
        kb = torch.from_numpy(np.log(rng.integers(1, 41, (BT, n))).astype(np.float32)).to(dev) \
            if bias else None

        def sdpa(q=q, k=k, v=v, kb=kb, n=n):
            heads = [t.view(BT, n, H, 64).transpose(1, 2) for t in (q, k, v)]
            bias4 = None if kb is None else kb[:, None, None, :].to(dtype)
            return F.scaled_dot_product_attention(*heads, attn_mask=bias4, scale=0.125)

        cases.append(("attention_wide_key_bias" if bias else "attention_wide",
                      f"qkv[{BT},{n},{3 * W}] h{H}" + (" key_bias" if bias else ""),
                      lambda q=q, k=k, v=v, kb=kb: A.attention_wide(q, k, v, None, 0.125, H,
                                                                     key_bias=kb),
                      lambda q=q, k=k, v=v, kb=kb: A._wide_reference(q, k, v, None, 0.125, H,
                                                                      kb),
                      sdpa, 4 * BT * n * W * isz + (BT * n * 4 if bias else 0),
                      4 * BT * n * n * W, {"attn": (n, n, W // H), "attn_bias": bias,
                                           "peak": peak, **attn_tally(dtype, n, n, W // H, bias)}))
    S_ = 577
    blk = ResidualAttentionBlock(W, 24, gen).to(dev, dtype)
    x = rn(BT, S_, W)
    cases.append(("fused_attn_ln2", f"x[{BT},{S_},{W}] h{H}",
                  lambda: R.fused_attn_ln2(x, blk, None, H),
                  lambda: R._attn_ln2_plain(blk, x, heads=H, mask=None), None,
                  (3 * BT * S_ * W + 4 * W * W + 8 * W) * isz,
                  2 * BT * S_ * W * 4 * W + 4 * BT * S_ * S_ * W,
                  {"attn": (S_, S_, W // H), "gemm": GM.attn_gemm_shapes(BT * S_, W),
                   "peak": peak, **ln2_tally(dtype, S_, W // H, False)}))
    return cases


def attn_tally(dtype, sq: int, sk: int, hd: int, bias: bool) -> dict:
    """An attention_wide case's read-back: the one launch's kernel, as the
    library wrote it, the kernel ``attention_plan`` names."""
    from qa_tiger_tpu_torch.ops import attention as A

    kernel = A.attention_plan(dtype, sq, sk, hd, limit=A.smem_limit("cuda"), has_bias=bias).kernel
    return {"tally": A.attention_wide, "want_tally": {"attn_routes": {kernel: 1}}}


def text_attention_cases(rng):
    """attention_wide alone at the fp32 text towers' calls, causal: the
    ``questions`` / ``prompts`` stages' chunk of 256 texts through the
    ViT-L/14@336px tower (W 768, 12 heads) and RN50's 42 answer prompts (W
    512, 8 heads), q, k and v as column slices of one packed qkv, as
    fused_attn_ln2 hands them to the same dispatch; SDPA on the same views
    and mask. Bytes: q, k, v and the output once, the mask; operations:
    every score (the kernel computes the masked ones too)."""
    import torch
    from torch.nn import functional as F

    from qa_tiger_tpu_torch.models.clip_text import causal_mask
    from qa_tiger_tpu_torch.ops import attention as A

    dtype, cases = torch.float32, []
    mask = causal_mask(S, device="cuda")
    for b, W, H in ((256, 768, 12), (CLIP_PROMPTS, CLIP_TEXT_W, CLIP_TEXT_HEADS)):
        hd = W // H
        qkv = torch.from_numpy(rng.standard_normal((b, S, 3 * W), dtype=np.float32)).cuda()
        q, k, v = qkv[..., :W], qkv[..., W:2 * W], qkv[..., 2 * W:]

        def sdpa(q=q, k=k, v=v, b=b, H=H, hd=hd):
            return F.scaled_dot_product_attention(
                *(t.view(b, S, H, hd).transpose(1, 2) for t in (q, k, v)), attn_mask=mask,
                scale=hd ** -0.5)

        cases.append(("attention_wide", f"text qkv[{b},{S},{3 * W}] causal h{H}",
                      lambda q=q, k=k, v=v, H=H, hd=hd: A.attention_wide(q, k, v, mask,
                                                                         hd ** -0.5, H),
                      lambda q=q, k=k, v=v, H=H, hd=hd: A._wide_reference(q, k, v, mask,
                                                                          hd ** -0.5, H),
                      sdpa, 4 * b * S * W * 4 + S * S * 4, 4 * b * S * S * W,
                      {"attn": (S, S, hd), "attn_bias": True, "peak": "tf32x3",
                       **attn_tally(dtype, S, S, hd, True)}))
    return cases


def check_e2e_kernels(rng, gen, entries: dict) -> None:
    """Phase 3, at the raw-media shapes, fp32 and bf16, each timed, each
    launch's kernels read back (the attention's, and fused_attn_ln2's
    products: tf32x3 x 2 in fp32, wgmma x 2 in bf16). The key-bias
    kernel's table entry is its bf16 layer-1 call (the bf16 forward's
    largest); the other kernels keep their serving entries. The fp32 lines
    are the extraction forward's (the ``clip`` stage's image tower, the
    ``tome`` stage's key-bias layers), each run twice, bitwise the same;
    with them the fp32 text towers' causal attentions
    (``text_attention_cases``, from a seed of their own), and all go into
    the kernels' table entries under ``extract_fp32``. The bf16 lines past
    128 keys run the Hopper attention kernel ("mma_sm90"): each is timed
    again with its attention planned on attention_mma_kernel
    (``sm90_extra``), and the 577-token attention_wide line, with the
    key-bias and fused_attn_ln2 lines beside it, is that kernel's table
    entry (``SM90``)."""
    import torch

    keys = ("shape", "route", "attn_kernel", "gemm_route", "attn_routes", "max_abs_err", "ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_fma_ms", "tflops")
    e2e_entries, fp32_lines, sm90 = {}, {}, {}
    with torch.inference_mode():
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            bf16 = dtype == torch.bfloat16
            cases = e2e_kernel_cases(dtype, rng, gen)
            if not bf16:
                cases += text_attention_cases(np.random.default_rng(25))
            for case in cases:
                line = run_kernel_case(case, dtype, tol, True, e2e_entries if bf16 else None)
                if bf16 and case[7]["attn"][1] > 128:
                    require(line["attn_kernel"] == "mma_sm90",
                            f"{case[1]}: planned on {line['attn_kernel']}, not mma_sm90")
                    sm90[case[0]] = {**{k: line[k] for k in keys if k in line},
                                     **sm90_extra(case, line)}
                if not bf16:
                    require_repeat(case)
                    fp32_lines.setdefault(case[0], []).append(
                        {k: line[k] for k in keys if k in line})
                torch.cuda.empty_cache()
    entries["attention_wide_key_bias"] = e2e_entries["attention_wide_key_bias"]
    for name, lines in fp32_lines.items():
        entries[name]["extract_fp32"] = lines
    entry = dict(e2e_entries["attention_wide"], name=SM90, source=SOURCES[SM90],
                 replaces=REPLACES[SM90])
    entry.update({k: sm90["attention_wide"][k] for k in SM90_EXTRA},
                 key_bias=sm90["attention_wide_key_bias"], fused_attn_ln2=sm90["fused_attn_ln2"])
    entries[SM90] = entry


# the Hopper attention kernel (csrc/attention_sm90.cuh, kernel "mma_sm90"):
# not a wrapper of its own but the kernel attention_wide and the attention
# halves launch for bf16 calls past 128 keys at head size 64; its table
# entry counts the launches the wrappers read back (attn_routes)
SM90 = "attention_sm90"
# ToMe's layers at r = 25: the tokens each of the 24 attends over (layer 0
# without a key bias)
TOME_TOKENS = [577 - 25 * layer for layer in range(24)]


def sm90_launches() -> int:
    """The Hopper kernel's launches since ``ops.reset_launches``: the
    "mma_sm90" entries of every wrapper's read-back tally."""
    from qa_tiger_tpu_torch import ops

    return sum(fn.attn_routes.get("mma_sm90", 0)
               for fn in {id(f): f for f in ops.KERNELS.values()}.values()
               if hasattr(fn, "attn_routes"))


def sm90_ms(fn, mode: str) -> float:
    """``fn`` timed with the Hopper kernel's switch at ``mode``
    (``ops.attention.SM90_MODES``), set back after."""
    from qa_tiger_tpu_torch.ops import attention as A

    before = A.set_sm90_mode(mode)
    try:
        return cuda_ms(fn)
    finally:
        A.set_sm90_mode(before)


# the numbers sm90_extra adds to a line
SM90_EXTRA = ("mma_ms", "mma_over_sm90", "tflops_two_pass", "ex2_per_s")


def sm90_extra(case, line: dict) -> dict:
    """A bf16 kernel line whose attention ran on the Hopper kernel, timed
    again on the same inputs with that call planned on attention_mma_kernel
    (switch "off": ``mma_ms``); for an attention_wide line also the Hopper
    kernel's own rates: two Q·Kᵀ and one P·V (1.5x the function's products)
    and an exponential a score a pass. Printed on a line of its own."""
    extra = {"mma_ms": sm90_ms(case[2], "off")}
    extra["mma_over_sm90"] = extra["mma_ms"] / line["ms"]
    if case[0] != "fused_attn_ln2":
        scores = case[6] / (4 * case[7]["attn"][2])  # the products count 4 hd a score
        extra.update(tflops_two_pass=1.5 * case[6] / line["ms"] * 1e-9,
                     ex2_per_s=2 * scores / line["ms"] * 1e3)
    print(json.dumps({"kernel": case[0], "shape": case[1], "attn_kernel": "mma_sm90",
                      **extra}), flush=True)
    return extra


def require_long_key_routes(label: str, want: dict) -> int:
    """After a bf16 forward, the launch counters reset before it: the kernel
    each attention of attention_wide and fused_attn_ln2 took, as the
    launches read it back (attention_wide every call, a bf16 attention half
    its calls past 128 tokens), on a line ``<label>_attn_routes``. Requires
    each wrapper's calls past 128 keys on the kernels the plan names:
    ``want[name]``, a Counter of them, is the whole tally of an attention
    half and the "mma_sm90" count of attention_wide (whose shorter calls
    keep theirs); and no FMA kernel. Returns the Hopper kernel's launches."""
    from qa_tiger_tpu_torch import ops

    attn = {name: dict(ops.KERNELS[name].attn_routes) for name in want}
    print(json.dumps({"phase": f"{label}_attn_routes", **attn}), flush=True)
    for name, counter in want.items():
        got = ({"mma_sm90": attn[name].get("mma_sm90", 0)} if name == "attention_wide"
               else attn[name])
        exp = ({"mma_sm90": counter.get("mma_sm90", 0)} if name == "attention_wide"
               else {k: n for k, n in counter.items() if n})
        require(got == exp, f"{label}: {name}'s attentions took {attn[name]}, expected {exp}")
    require_tensor_core_attention(f"{label}_no_fma", tuple(want))
    return sm90_launches()


def planned(calls) -> collections.Counter:
    """The kernels the plan gives bf16 calls (Sq, Sk, head size, bias), at
    the card's shared-memory limit."""
    import torch

    from qa_tiger_tpu_torch.ops import attention as A

    limit = A.smem_limit("cuda")
    return collections.Counter(A.attention_plan(torch.bfloat16, sq, sk, hd, limit=limit,
                                                has_bias=bias).kernel
                               for sq, sk, hd, bias in calls)


def check_sm90_sweep(rng, entries: dict) -> None:
    """Phase 3, ToMe's 18 layers past 128 tokens at the raw-media shape (B*T
    = 120 frames, 16 heads of 64, q, k and v column slices of one packed
    qkv; layer 0 without a key bias), each on the Hopper kernel (switch
    "always") and on attention_mma_kernel ("off"): each launch read back on
    its kernel and held to the plain version within BF16_TOL, then both
    timed in turns beside the kernel the plan gives the layer
    (``sm90_sweep``): the numbers the plan's rule, ``sm90_faster``, stands
    on, and the check of attention_mma_kernel's two-pass form at the
    lengths the rule leaves on it. Then the Hopper kernel's registers and
    spills (``sm90_ptxas``)."""
    import torch

    from qa_tiger_tpu_torch.ops import attention as A

    rows = []
    B, W, H = 2 * T, 1024, 16
    g = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    with torch.inference_mode():
        for layer, n in enumerate(TOME_TOKENS):
            if n <= 2 * 64:
                continue
            qkv = torch.randn(B, n, 3 * W, generator=g, device="cuda", dtype=torch.bfloat16)
            kb = (torch.randint(1, 41, (B, n), generator=g, device="cuda").float().log()
                  if layer else None)
            q, k, v = qkv[..., :W], qkv[..., W:2 * W], qkv[..., 2 * W:]

            def call(q=q, k=k, v=v, kb=kb):
                return A.attention_wide(q, k, v, None, 0.125, H, key_bias=kb)

            want = A._wide_reference(q, k, v, None, 0.125, H, kb)
            row = {"layer": layer, "tokens": n, "key_bias": kb is not None,
                   "plan": A.attention_plan(torch.bfloat16, n, n, 64,
                                            has_bias=kb is not None).kernel}
            for mode, kernel in (("always", "mma_sm90"), ("off", "mma")):
                before = A.set_sm90_mode(mode)
                try:
                    A.attention_wide.attn_routes = {}
                    got = call()
                    torch.cuda.synchronize()
                    routes = dict(A.attention_wide.attn_routes)
                finally:
                    A.set_sm90_mode(before)
                err, scale = max_err(got, want)
                row[f"{kernel}_max_abs_err"] = err
                require(routes == {kernel: 1} and err <= BF16_TOL * max(1.0, scale),
                        f"ToMe layer {layer} ({n} tokens) with the switch at {mode}: "
                        f"launched {routes}, max|k-p| {err:.3e} over {BF16_TOL} x "
                        f"max(1, {scale:.3e})")
            del got, want
            ms = [sm90_ms(call, "always"), sm90_ms(call, "off"), sm90_ms(call, "always")]
            row.update(ms=min(ms[0], ms[2]), mma_ms=ms[1], sm90_faster=min(ms[0], ms[2]) < ms[1])
            rows.append(row)
            del qkv, kb, q, k, v
        print(json.dumps({"phase": "sm90_sweep", "rows": rows}), flush=True)
        torch.cuda.empty_cache()
    entries[SM90]["tome_sweep"] = rows
    entries[SM90]["ptxas"] = sm90_ptxas()


def sm90_ptxas() -> list:
    """The Hopper attention kernel's registers, spills and stack per
    instantiation (``kernel_ptxas``); a line ``sm90_ptxas``."""
    rows = kernel_ptxas("attention_sm90_kernel", "sm90_ptxas")
    require(len(rows) == 4, f"the build log names {len(rows)} Hopper attention kernels, not 4")
    return rows


def kernel_ptxas(kernel: str, phase: str) -> list:
    """The registers, spills and stack of each instantiation of the kernel
    named ``kernel``, as ``-Xptxas -v`` printed them into this build's log;
    a line ``phase``."""
    from qa_tiger_tpu_torch.ops import _build

    rows, name = [], None
    for text in _build.build_log.read_text().splitlines():
        if "Compiling entry function" in text:
            name = text.split("'")[1] if kernel in text else None
        elif name and "spill stores" in text:
            nums = [int(w) for w in re.findall(r"(\d+) bytes", text)]
            rows.append({"function": name, "stack": nums[0], "spill_stores": nums[1],
                         "spill_loads": nums[2]})
        elif name and "Used" in text and "registers" in text:
            rows[-1]["registers"] = int(re.search(r"Used (\d+) registers", text).group(1))
            name = None
    print(json.dumps({"phase": phase, "instantiations": rows}), flush=True)
    return rows


def _grads(outs, inputs, cots):
    """Outputs followed by d(sum_i <outs_i, cots_i>)/d(inputs)."""
    import torch

    outs = [outs] if torch.is_tensor(outs) else list(outs)
    return outs + list(torch.autograd.grad(outs, inputs, cots))


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


def train_kernel_cases(dtype, B: int, rng, gen, T_: int = T):
    """One dict per train kernel pair at batch B (N = 2B AVQ rows, B*T
    frames): names, shape label, kernel and plain forward, the
    differentiated inputs (activations, then parameters), cotangents, an
    fp32 copy of the plain version on the same values (``plain32``: outputs
    and gradients), the bytes and flops of forward and backward, and the
    routes one forward launch must tally (``fwd_routes``: every product on
    gemm_tf32x3 in fp32, on gemm_sm90 in bf16)."""
    import copy

    import torch

    from qa_tiger_tpu_torch.models.modules import (
        AVQCrossAttn,
        PatchSelecter,
        make_avq_dropout_masks,
        make_patch_dropout_masks,
    )
    from qa_tiger_tpu_torch.ops import avq as AV
    from qa_tiger_tpu_torch.ops import patch_select as PS

    dev, D, heads = "cuda", 512, 8
    isz = torch.tensor([], dtype=dtype).element_size()
    mgen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))

    def rn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)

    def plain32(fn, module, acts, masks, cots):
        """fn's outputs and gradients in fp32 on the same (rounded) values."""
        m32 = copy.deepcopy(module).float()
        a32 = [_leaf(a.detach().float()) for a in acts]
        mk32 = {k: v.float() for k, v in masks.items()}
        outs = fn(m32, a32, mk32)
        return _grads(outs, a32 + list(m32.parameters()), [c.float() for c in cots])

    def case(fname, shape, module, acts, masks, cots, kernel, plain, gemm, attn, act_elems,
             products):
        params = list(module.parameters())
        wbytes = sum(p.numel() for p in params) * isz
        mbytes = sum(m.numel() for m in masks.values()) * isz
        fwd_bytes = act_elems * isz + wbytes + mbytes
        ins = acts + params
        return {"fwd": fname, "bwd": fname + "_bwd", "shape": shape,
                "kernel": lambda: kernel(module, acts, masks),
                "plain": lambda: plain(module, acts, masks),
                "ins": ins, "cots": cots,
                "plain32": lambda: plain32(plain, module, acts, masks, cots),
                # fwd: inputs, masks, weights read and the outputs written;
                # bwd: those again with the cotangents, the input gradients
                # and the fp32 parameter gradients written
                "fwd_bytes": fwd_bytes, "fwd_flops": gemm + attn,
                "fwd_routes": {"wgmma" if dtype == torch.bfloat16 else "tf32x3": products},
                "bwd_bytes": 2 * fwd_bytes + sum(p.numel() for p in params) * 4,
                "bwd_flops": 2 * gemm + 2 * attn}

    N, R, RS = 2 * B, 2 * B * T_, 2 * B * S
    avq = AVQCrossAttn(D, gen).to(dev, dtype)
    acts = [_leaf(rn(N, T_, D)), _leaf(rn(N, T_, D)), _leaf(rn(N, S, D))]
    masks = make_avq_dropout_masks(mgen, N, T_, S, D, nhead=heads, dropout_p=0.1, dtype=dtype)
    cases = [case("fused_avq_train", f"N{N} T{T_} S{S} D{D} h{heads}", avq, acts, masks,
                  [rn(N, T_, D)],
                  lambda m, a, mk: AV.fused_avq_train(*a, m, mk, heads),
                  lambda m, a, mk: AV.avq_sub_forward_masked(m, *a, mk, nhead=heads),
                  2 * R * D * D * 12 + 4 * RS * D * D, 4 * R * D * (S + 2 * T_),
                  3 * R * D + RS * D, 10)]

    BT = B * T_
    Rp, Q2 = BT * P, 2 * BT
    ps = PatchSelecter(D, gen).to(dev, dtype)
    acts = [_leaf(rn(B, T_, P, D)), _leaf(rn(B, T_, D)), _leaf(rn(B, T_, D))]
    masks = make_patch_dropout_masks(mgen, BT, P, D, nhead=heads, dropout_p=0.1, dtype=dtype)
    cases.append(case("fused_patch_select_train", f"patch[{B},{T_},{P},{D}] h{heads}", ps, acts,
                      masks, [rn(B, T_, D), rn(B, T_, D)],
                      lambda m, a, mk: PS.fused_patch_select_train(*a, m, mk, heads),
                      lambda m, a, mk: tuple(PS.patch_selecter_plain(m, *a, nhead=heads,
                                                                     masks=mk)),
                      2 * Rp * D * D * 6 + 2 * Q2 * D * D * 3,
                      4 * BT * P * P * D + 4 * Q2 * P * D, Rp * D + 4 * BT * D, 7))
    return cases


def backward_ms(fwd, ins, cots) -> float:
    """Device time of one backward through ``fwd``'s graph (built once and
    retained): for a train kernel its backward kernel and the Function
    around it, for a plain version autograd's kernels."""
    import torch

    outs = fwd()
    outs = [outs] if torch.is_tensor(outs) else list(outs)
    return cuda_ms(lambda: torch.autograd.grad(outs, ins, cots, retain_graph=True))


def check_train_kernels(rng, gen, entries: dict):
    """The train kernels: forward outputs and every input and parameter
    gradient against autograd of the plain version on the same masks, at a
    small fp32 shape and at the recipe shape in fp32 and in bf16; forward
    and backward timed at the recipe shape.

    The fp32 backward's bound is its operations over the tf32x3 peak (its
    products run on gemm_tf32x3), with the fp32 FMA peak's figure beside it
    (``bwd_bound_fma_ms``), and so is each forward's (``bound_fma_ms``);
    each forward's products must take the routes ``fwd_routes`` names; at
    the recipe shape in fp32 each kernel pair runs twice and every output
    and gradient must be bitwise the same.

    At the recipe shape in each dtype the keep-masked attention kernels
    run alone at the step's 12 calls (``check_keep_attention``).

    Tolerances: fp32, and bf16 forward outputs, max|k - p| <= tol *
    max(1, max|p|) as for the other kernels. bf16 gradients: both the kernel
    and the plain version in bf16 are held to the plain version in fp32 on
    the same values, and the kernel's error may not exceed the larger of
    twice the plain version's own and BF16_TOL * max(1, max|ref|): bf16
    rounding inside sums over thousands of rows moves both by up to ~20%
    of a gradient's largest element (PERF.md)."""
    import torch

    from qa_tiger_tpu_torch import ops

    for dtype, B, T_, label in ((torch.float32, 2, 6, "small"), (torch.float32, 32, T, "recipe"),
                                (torch.bfloat16, 32, T, "recipe")):
        bf16 = dtype == torch.bfloat16
        tol = BF16_TOL if bf16 else FP32_TOL
        dname = str(dtype).replace("torch.", "")
        for c in train_kernel_cases(dtype, B, rng, gen, T_=T_):
            ins, cots = c["ins"], c["cots"]
            fwd_fn = ops.KERNELS[c["fwd"]]
            fwd_fn.gemm_routes = {}
            got = _grads(c["kernel"](), ins, cots)
            fwd_routes = dict(fwd_fn.gemm_routes)
            want = _grads(c["plain"](), ins, cots)
            ref = c["plain32"]() if bf16 else None
            repeat = (all(torch.equal(g, h) for g, h in zip(got, _grads(c["kernel"](), ins, cots)))
                      if label == "recipe" and not bf16 else None)
            torch.cuda.synchronize()
            n_out = len(got) - len(ins)
            rows, ok = [], True
            for i, (gt, wt) in enumerate(zip(got, want)):
                err, scale = max_err(gt, wt)
                if bf16 and i >= n_out:
                    err, scale = max_err(gt, ref[i])
                    plain_err = max_err(wt, ref[i])[0]
                    limit = max(2 * plain_err, tol * max(1.0, scale))
                else:
                    plain_err, limit = None, tol * max(1.0, scale)
                rows.append((err / limit, i, err, scale, plain_err))
                ok &= err <= limit
            worst = max(rows)
            line = {"kernel": f"{c['fwd']}+bwd", "dtype": dname, "shape": c["shape"],
                    "tensors_compared": len(got), "worst_tensor": worst[1],
                    "max_abs_err": worst[2], "max_abs_ref": worst[3],
                    "plain_bf16_err": worst[4], "worst_err_over_limit": worst[0],
                    "bitwise_repeat": repeat, "fwd_gemm_routes": fwd_routes, "ok": ok}
            if label == "recipe":
                fwd_err = max(r[2] for r in rows[:n_out])
                bwd_err = max(r[2] for r in rows[n_out:])
                with torch.no_grad():
                    f_ms, pf_ms = cuda_ms(c["kernel"]), cuda_ms(c["plain"])
                b_ms = backward_ms(c["kernel"], ins, cots)
                pb_ms = backward_ms(c["plain"], ins, cots)
                fb, fby = bound(c["fwd_bytes"], c["fwd_flops"], "bfloat16" if bf16 else "tf32x3")
                bb, bby = bound(c["bwd_bytes"], c["bwd_flops"], "bfloat16" if bf16 else "tf32x3")
                line.update(ms=f_ms, plain_ms=pf_ms, bound_ms=fb, bound_by=fby, bwd_ms=b_ms,
                            plain_bwd_ms=pb_ms, bwd_bound_ms=bb, bwd_bound_by=bby)
                if not bf16:  # the recipe's dtype names the table entries
                    line["bwd_bound_fma_ms"] = bound(c["bwd_bytes"], c["bwd_flops"], dname)[0]
                    line["bound_fma_ms"] = bound(c["fwd_bytes"], c["fwd_flops"], dname)[0]
                    for name, ms, pms, bms, bby_, err in (
                            (c["fwd"], f_ms, pf_ms, fb, fby, fwd_err),
                            (c["bwd"], b_ms, pb_ms, bb, bby, bwd_err)):
                        entries[name] = {
                            "name": name, "route": "cuda", "source": SOURCES[name],
                            "replaces": REPLACES[name], "launches": 0, "shape": c["shape"],
                            "dtype": dname, "max_abs_err": err, "ms": ms, "plain_ms": pms,
                            "bound_ms": bms, "bound_by": bby_, "library_ms": None}
                    entries[c["bwd"]].update(bound_peak="tf32x3",
                                             bound_ms_fp32_fma=line["bwd_bound_fma_ms"])
                    entries[c["fwd"]].update(bound_peak="tf32x3",
                                             bound_ms_fp32_fma=line["bound_fma_ms"])
                    for name in (c["fwd"], c["bwd"]):  # their keep-masked attentions
                        entries[name].update(attn_route="mma_keep", attn_source=KEEP_SOURCE)
            print(json.dumps(line), flush=True)
            require(ok, f"{c['fwd']} {dname} {c['shape']}: tensor {worst[1]} max|k-p| "
                        f"{worst[2]:.3e} over its limit")
            require(repeat is not False, f"{c['fwd']} {dname} {c['shape']}: two runs of the "
                                         "kernel pair are not bitwise the same")
            require(fwd_routes == c["fwd_routes"],
                    f"{c['fwd']} {dname} {c['shape']}: its products took {fwd_routes}, "
                    f"expected {c['fwd_routes']}")
            del got, want, ref
        torch.cuda.empty_cache()
        if label == "recipe":
            check_keep_attention(dtype, rng, tol)
            torch.cuda.empty_cache()


# the keep-masked (dropout) attentions one recipe train step launches
# (B=32, 8 heads of 64 lanes): (label, problems' batch, Sq, Sk, q|k|v
# layout, backward, accumulate_kv); layout "packed" q, k, v column slices
# of one [.., 3D] projection, "kv" q alone and k, v slices of [.., 2D];
# the PatchSelecter's probability rounded first
KEEP_CALLS = [("avq_fwd_question", 64, T, S, "kv", False, False),
              ("avq_fwd_self", 64, T, T, "packed", False, False),
              ("avq_fwd_cross", 64, T, T, "kv", False, False),
              ("avq_bwd_question", 64, T, S, "kv", True, False),
              ("avq_bwd_self", 64, T, T, "packed", True, False),
              ("avq_bwd_cross", 64, T, T, "kv", True, False),
              ("ps_fwd_self", 32 * T, P, P, "packed", False, False),
              ("ps_fwd_cross_video", 32 * T, 1, P, "kv", False, False),
              ("ps_fwd_cross_audio", 32 * T, 1, P, "kv", False, False),
              ("ps_bwd_cross_video", 32 * T, 1, P, "kv", True, False),
              ("ps_bwd_cross_audio", 32 * T, 1, P, "kv", True, True),
              ("ps_bwd_self", 32 * T, P, P, "packed", True, False)]


def check_keep_attention(dtype, rng, tol: float) -> None:
    """The keep-masked tensor-core kernels (``ops.avq.attention_keep`` /
    ``attention_keep_bwd``, kernel "mma_keep") alone at the 12 calls of one
    recipe train step (KEEP_CALLS), in their layouts: each against its
    plain version on the same inputs within ``tol`` * max(1, max|p|) and
    twice bitwise the same; its plan (kernel, shared memory) the library's;
    timed (``ms``: the median of three readings, ``ms_all``; single readings
    on this card have jumped by 2-8x within one run) beside the plain
    version and the bound: bytes (forward q, k, v and ctx; backward q, k,
    v, g, dq, dk and dv, dk and dv read too where accumulated; the keep
    mask's used lanes; each once) over 3.35 TB/s, or 4 (forward) / 10
    (backward) Sq Sk hd operations a problem over the dtype's peak (3xTF32
    in fp32); a closing line sums the step's 12."""
    import torch

    from qa_tiger_tpu_torch.ops import attention as A
    from qa_tiger_tpu_torch.ops import avq as AV

    dname = str(dtype).replace("torch.", "")
    isz = torch.tensor([], dtype=dtype).element_size()
    D, heads, hd = 512, 8, 64
    peak = "bfloat16" if dtype == torch.bfloat16 else "tf32x3"
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}

    def rn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)

    for label, nb, sq, sk, layout, backward, accumulate in KEEP_CALLS:
        if layout == "packed":
            qkv = rn(nb, sq, 3 * D)
            q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        else:
            q, kv = rn(nb, sq, D), rn(nb, sk, 2 * D)
            k, v = kv[..., :D], kv[..., D:]
        lp = -(-heads * sk // 128) * 128
        drop = rng.random((nb * sq, lp)) < 0.1
        keep = torch.from_numpy(np.where(drop, 0.0, 1.0 / 0.9).astype(np.float32)).to("cuda",
                                                                                    dtype)
        rpf = label.startswith("ps_")
        plan_fn, lib_fn = ((A.attention_bwd_plan, A.library_bwd_plan) if backward
                           else (A.attention_plan, A.library_plan))
        plan = plan_fn(dtype, sq, sk, hd, has_keep=True, limit=A.smem_limit("cuda"))
        planned = lib_fn(dtype, sq, sk, hd, True)
        elems = nb * (2 * sq + 2 * sk) * D  # q, k, v and ctx
        if backward:
            g = rn(nb, sq, D)
            acc = (rn(nb, sk, D), rn(nb, sk, D)) if accumulate else None
            acc0 = tuple(t.clone() for t in acc) if accumulate else None

            def kernel(restore=False):
                # accumulate_kv: dk, dv from acc0 where ``restore`` (the
                # checks), else on whatever they hold (the timings)
                if restore and accumulate:
                    for t, t0 in zip(acc, acc0):
                        t.copy_(t0)
                return AV.attention_keep_bwd(q, k, v, g, keep, heads, rpf, acc)

            def plain():
                dq, dk, dv = AV.keep_attention_bwd(q, k, v, g, keep, heads, rpf)
                if accumulate:
                    dk = (acc0[0].float() + dk.float()).to(dtype)
                    dv = (acc0[1].float() + dv.float()).to(dtype)
                return dq, dk, dv

            # q, g, dq; k, v, dk, dv; dk, dv read too where accumulated
            elems = nb * (3 * sq + 4 * sk) * D + (2 * nb * sk * D if accumulate else 0)
            flops = 10 * nb * heads * sq * sk * hd
        else:
            def kernel(restore=False):
                return AV.attention_keep(q, k, v, keep, heads, rpf)

            def plain():
                return AV.keep_attention(q, k, v, keep, heads, rpf)

            flops = 4 * nb * heads * sq * sk * hd
        got = kernel(restore=True)
        got = [t.clone() for t in ([got] if torch.is_tensor(got) else got)]
        again = kernel(restore=True)
        again = [t.clone() for t in ([again] if torch.is_tensor(again) else again)]
        want = plain()
        torch.cuda.synchronize()
        err, scale = max_err(got, want)
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        nbytes = (elems + nb * sq * heads * sk) * isz  # the keep mask's used lanes
        b_ms, b_by = bound(nbytes, flops, peak)
        ok = (err <= tol * max(1.0, scale) and repeat and plan.kernel == "mma_keep"
              and planned == (plan.kernel, plan.smem_bytes))
        line = {"kernel": "attention_keep_bwd" if backward else "attention_keep",
                "call": label, "dtype": dname,
                "shape": f"q[{nb},{sq},{D}] kv[{nb},{sk},{D}] h{heads} {layout}",
                "route": plan.route, "attn_kernel": plan.kernel, "smem_bytes": plan.smem_bytes,
                "library_plan": list(planned), "max_abs_err": err, "max_abs_plain": scale,
                "tolerance": tol * max(1.0, scale), "bitwise_repeat": repeat}
        ms_all = [cuda_ms(kernel) for _ in range(3)]
        line.update(ms=statistics.median(ms_all), ms_all=ms_all, plain_ms=cuda_ms(plain),
                    library_ms=None, bound_ms=b_ms, bound_by=b_by, ok=ok)
        line["tflops"] = flops / line["ms"] * 1e-9
        for key in totals:
            totals[key] += line[key]
        print(json.dumps(line), flush=True)
        require(ok, f"keep-masked attention {label} {dname}: max|k-p| {err:.3e}, repeat "
                    f"{repeat}, plan {tuple(plan)} vs the library's {planned}")
        del got, again, want
    print(json.dumps({"phase": "keep_attention_step", "dtype": dname, "launches": len(KEEP_CALLS),
                      **{f"{k}_sum": v for k, v in totals.items()}}), flush=True)


def slice1_grad_cases(dtype, B: int, rng, gen):
    """(name, shape label, kernel fwd, plain fwd, differentiated inputs,
    cotangents) for the four slice-1 kernels and the key-bias attention
    (dq, dk, dv and dkey_bias; 150 keys, the tiled kernel), whose gradient
    on the card is the plain version's, recomputed."""
    import torch

    from qa_tiger_tpu_torch.models.clip_text import ResidualAttentionBlock, causal_mask
    from qa_tiger_tpu_torch.models.modules import PatchSelecter
    from qa_tiger_tpu_torch.ops import attention as A
    from qa_tiger_tpu_torch.ops import gaussian_moe as G
    from qa_tiger_tpu_torch.ops import patch_select as PS
    from qa_tiger_tpu_torch.ops import resblock as R

    dev = "cuda"

    def rn(*shape, scale=1.0):
        return _leaf(torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32))
                     .to(dev, dtype))

    cases = []
    blk = ResidualAttentionBlock(768, 12, gen).to(dev, dtype)
    x, mask = rn(B, S, 768), causal_mask(S, device=dev)
    cases.append(("fused_attn_ln2", f"x[{B},{S},768]",
                  lambda: R.fused_attn_ln2(x, blk, mask, 12),
                  lambda: R._attn_ln2_plain(blk, x, heads=12, mask=mask),
                  [x] + R._block_params(blk), [rn(B, S, 768), rn(B, S, 768)]))
    q, k, v = rn(2 * B, T, 512), rn(2 * B, S, 512), rn(2 * B, S, 512)
    cases.append(("attention_wide", f"q[{2 * B},{T},512] kv[{2 * B},{S},512]",
                  lambda: A.attention_wide(q, k, v, None, 0.125, 8),
                  lambda: A._wide_reference(q, k, v, None, 0.125, 8),
                  [q, k, v], [rn(2 * B, T, 512)]))
    ps = PatchSelecter(512, gen).to(dev, dtype)
    patch, audio, video = rn(B, T, P, 512), rn(B, T, 512), rn(B, T, 512)
    cases.append(("fused_patch_select", f"patch[{B},{T},{P},512]",
                  lambda: PS.fused_patch_select(patch, audio, video, ps, 8),
                  lambda: tuple(PS.patch_selecter_plain(ps, patch, audio, video, nhead=8)),
                  [patch, audio, video] + list(ps.parameters()),
                  [rn(B, T, 512), rn(B, T, 512)]))
    xm = rn(2 * B, T, 512)
    w1t, b1 = rn(7, 512, 256, scale=0.05), rn(7, 256, scale=0.1)
    w2t, b2 = rn(7, 256, 512, scale=0.05), rn(7, 512, scale=0.1)
    w = _leaf(torch.from_numpy(0.05 * rng.random((2 * B, 7, T), dtype=np.float32)).to(dev, dtype))
    cases.append(("fused_gaussian_moe", f"x[{2 * B},{T},512] E7 H256",
                  lambda: G.fused_gaussian_moe(xm, w1t, b1, w2t, b2, w),
                  lambda: G._reference_impl(xm, w1t, b1, w2t, b2, w),
                  [xm, w1t, b1, w2t, b2, w], [rn(2 * B, 512)]))
    qb, kb, vb = rn(2, 40, 512), rn(2, 150, 512), rn(2, 150, 512)
    bias = _leaf(torch.from_numpy(np.log(rng.integers(1, 41, (2, 150))).astype(np.float32))
                 .to(dev))
    cases.append(("attention_wide_key_bias", "q[2,40,512] kv[2,150,512] key_bias",
                  lambda: A.attention_wide_key_bias(qb, kb, vb, bias, 0.125, 8),
                  lambda: A._wide_reference(qb, kb, vb, None, 0.125, 8, bias),
                  [qb, kb, vb, bias], [rn(2, 40, 512)]))
    return cases


def op_grad_cases(dtype, B: int, rng, gen):
    """The same for the op-level kernels, whose gradient on the card is the
    JAX rule's plain version, recomputed (for fused_attention and
    fused_resblock not the forward's, from which it differs in bf16 only),
    and for a mask that requires grad: "mask" cases give the additive mask
    a finite value, and attention_wide, fused_attn_ln2, fused_attention and
    fused_attn_half give it a cotangent."""
    import torch

    from qa_tiger_tpu_torch.models.clip_text import ResidualAttentionBlock, causal_mask
    from qa_tiger_tpu_torch.ops import attention as A
    from qa_tiger_tpu_torch.ops import resblock as R

    dev = "cuda"

    def rn(*shape):
        return _leaf(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                     .to(dev, dtype))

    cases = []
    blk = ResidualAttentionBlock(768, 12, gen).to(dev, dtype)
    mask = causal_mask(S, device=dev)
    qm, km, vm, mm = rn(2 * B, T, 512), rn(2 * B, S, 512), rn(2 * B, S, 512), rn(T, S)
    cases.append(("attention_wide mask", f"q[{2 * B},{T},512] kv[{2 * B},{S},512] mask",
                  lambda: A.attention_wide(qm, km, vm, mm, 0.125, 8),
                  lambda: A._wide_reference(qm, km, vm, mm, 0.125, 8),
                  [qm, km, vm, mm], [rn(2 * B, T, 512)]))
    xl, m77 = rn(B, S, 768), rn(S, S)
    cases.append(("fused_attn_ln2 mask", f"x[{B},{S},768] mask",
                  lambda: R.fused_attn_ln2(xl, blk, m77, 12),
                  lambda: R._attn_ln2_plain(blk, xl, heads=12, mask=m77),
                  [xl, m77] + R._block_params(blk), [rn(B, S, 768), rn(B, S, 768)]))
    for label, bh, s_, m in (("", 12 * B, S, mask), (" mask", 8 * B * 6, P, rn(P, P))):
        qa, ka, va = rn(bh, s_, 64), rn(bh, s_, 64), rn(bh, s_, 64)
        cases.append(("fused_attention" + label, f"[{bh},{s_},64]" + (label or " causal"),
                      lambda qa=qa, ka=ka, va=va, m=m: A.fused_attention(qa, ka, va, m, 0.125),
                      lambda qa=qa, ka=ka, va=va, m=m: A._fused_attention_rule(
                          qa, ka, va, mask=m, scale=0.125),
                      [qa, ka, va] + ([m] if label else []), [rn(bh, s_, 64)]))
    xh = rn(B, S, 768)
    cases.append(("fused_attn_half mask", f"x[{B},{S},768] mask",
                  lambda: R.fused_attn_half(xh, blk, m77, 12),
                  lambda: R._attn_half_flat(xh, *R._attn_params(blk), heads=12, mask=m77),
                  [xh, m77] + R._attn_params(blk), [rn(B, S, 768)]))
    xr = rn(B, S, 768)
    cases.append(("fused_resblock", f"x[{B},{S},768] causal",
                  lambda: R.fused_resblock(xr, blk, mask, 12),
                  lambda: R._resblock_rule(xr, *R._resblock_params(blk), heads=12, mask=mask),
                  [xr] + R._resblock_params(blk), [rn(B, S, 768)]))
    return cases


def check_slice1_grads(rng, gen) -> None:
    """The slice-1, key-bias and op-level kernels' gradients on the card:
    every input and parameter gradient (and a mask's, where it requires
    grad) through the kernel's autograd Function against autograd of the
    plain version, at a small and at the train recipe's batch, fp32. The
    op-level cases draw from seeds of their own."""
    import torch

    op_rng, op_gen = np.random.default_rng(5), torch.Generator().manual_seed(5)
    for B in (2, 32):
        for name, shape, kernel, plain, ins, cots in (
                slice1_grad_cases(torch.float32, B, rng, gen)
                + op_grad_cases(torch.float32, B, op_rng, op_gen)):
            got, want = _grads(kernel(), ins, cots), _grads(plain(), ins, cots)
            torch.cuda.synchronize()
            errs = [max_err(g_, w_) for g_, w_ in zip(got, want)]
            ok = all(e <= FP32_TOL * max(1.0, sc) for e, sc in errs)
            err, scale = max(errs, key=lambda es: es[0] / max(1.0, es[1]))
            print(json.dumps({"kernel": f"{name} grad", "dtype": "float32", "shape": shape,
                              "tensors_compared": len(got), "max_abs_err": err,
                              "max_abs_plain": scale, "ok": ok}), flush=True)
            require(ok, f"{name} gradient at {shape}: max|k-p| {err:.3e} over tolerance")
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------

def make_tokens(rng, b: int) -> np.ndarray:
    """Token rows: SOT, ids, EOT (the largest id), zero pad."""
    quest = np.zeros((b, S), dtype=np.int64)
    for i in range(b):
        n = int(rng.integers(5, 30))
        quest[i, 0] = VOCAB - 2
        quest[i, 1:n] = rng.integers(1, VOCAB - 2, n - 1)
        quest[i, n] = VOCAB - 1
    return quest


def make_batch(rng, b: int) -> dict:
    """Token rows and features at the shipped widths, T=60 frames of P=14
    patches."""
    return {"quest": make_tokens(rng, b),
            "audio": rng.standard_normal((b, T, 128), dtype=np.float32),
            "video": rng.standard_normal((b, T, 768), dtype=np.float32),
            "patch": rng.standard_normal((b, T, P, 1024), dtype=np.float32)}


def check_slice(rng, entries: dict, profile_dir: Path | None) -> tuple[dict, float]:
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
    expected = {"fused_attn_ln2": 12, "fused_gaussian_moe": 2, "fused_patch_select": 1,
                "attention_wide_key_bias": 0, "fused_avq_train": 0, "fused_avq_train_bwd": 0,
                "fused_patch_select_train": 0, "fused_patch_select_train_bwd": 0,
                **dict.fromkeys(OP_KERNELS, 0)}
    print(json.dumps({"phase": "main_path_launches", **counts}), flush=True)
    for name, n in expected.items():
        require(counts[name] == n, f"{name}: {counts[name]} launches, expected {n}")
    require_wgmma("main_path_gemm_routes")
    require(counts["attention_wide"] >= 3, "attention_wide: fewer than 3 launches")
    attn = require_tensor_core_attention("main_path_attn_routes")
    require(sum(attn["attention_wide"].values()) == counts["attention_wide"]
            and sum(attn["fused_patch_select"].values()) == 2,
            f"main path: attention kernels read back {attn} for "
            f"{counts['attention_wide']} attention_wide launches and one fused_patch_select")
    for name in EVAL_KERNELS:
        entries[name]["launches"] = counts[name]
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
        profile_step(lambda: pred.logits(batch), profile_dir / "forward_bf16_b256.txt",
                     "profile")

    # (c) eight requests answered
    served = pred.answer(make_batch(rng, 8), topk=5)
    require(len(served) == 8, "answer() did not serve 8 requests")
    for i, row in enumerate(served):
        print(json.dumps({"request": i, "top5": [t["answer"] for t in row["topk"]],
                          "probs": [t["prob"] for t in row["topk"]]}), flush=True)
    return counts, 256 / median


# ---------------------------------------------------------------------------
# phase 5: the serving surface
# ---------------------------------------------------------------------------

SERVE_BATCH, SERVE_PADDED = 256, 100
# one served bf16 batch: the text tower's 12 blocks, AVQ's 7 attentions
SERVE_KERNELS = {"fused_attn_ln2": 12, "attention_wide": 7, "fused_patch_select": 1,
                 "fused_gaussian_moe": 2, "attention_wide_key_bias": 0, "fused_avq_train": 0,
                 "fused_avq_train_bwd": 0, "fused_patch_select_train": 0,
                 "fused_patch_select_train_bwd": 0, **dict.fromkeys(OP_KERNELS, 0)}


def host_batch(svc, rows) -> dict:
    """``rows`` assembled as the server assembles them, on the host in fp32:
    token ids and features stacked, padded to the batch with the first
    row's."""
    pad = svc.batch_size - len(rows)
    feats = [r["feats"] or svc.store.get(r["video"]) for r in rows] + \
        [rows[0]["feats"] or svc.store.get(rows[0]["video"])] * pad
    batch = {k: np.stack([f[k] for f in feats]) for k in feats[0]}
    batch["quest"] = np.stack([r["tokens"] for r in rows] + [rows[0]["tokens"]] * pad)
    return batch


def staging_ms(svc, rows) -> dict:
    """A full uncached batch's features to the card two ways, each ended by
    a synchronize: stacked in fp32 with numpy, copied from pageable memory
    and cast on the card (the JAX server's way); staged in bf16 into pinned
    memory and copied without waiting (the port's ``_dispatch``)."""
    import torch

    feats = [r["feats"] for r in rows]

    def pageable():
        for k in feats[0]:
            torch.from_numpy(np.stack([f[k] for f in feats])).to("cuda").to(svc.dtype)
        torch.cuda.synchronize()

    def pinned():
        for k in feats[0]:
            stage = torch.empty((len(feats), *feats[0][k].shape), dtype=svc.dtype,
                                pin_memory=True)
            for i, f in enumerate(feats):
                stage[i].copy_(torch.from_numpy(f[k]))
            stage.to("cuda", non_blocking=True)
        torch.cuda.synchronize()

    out = {}
    for name, fn in (("pageable_fp32_ms", pageable), ("pinned_bf16_ms", pinned)):
        fn()
        times = []
        for _ in range(3):
            start = time.perf_counter()
            fn()
            times.append((time.perf_counter() - start) * 1e3)
        out[name] = statistics.median(times)
    return out


def _reader(stream, lines: list) -> None:
    for line in stream:
        lines.append((time.perf_counter(), line.rstrip("\n")))


def _http(base: str, path: str, payload=None, timeout: float = 120.0):
    """(status, JSON body) of a GET, or of a POST when ``payload`` is given."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}")


def check_serve_http(config: Path, vocab: Path) -> dict:
    """(d) ``python -m qa_tiger_tpu_torch.serve`` as a subprocess on a free
    port: /health reaches 200, 8 concurrent /predict and one /predict_batch
    are answered, /stats counts them, an unknown video answers 404, SIGTERM
    ends it (exit 0). Returns its start-up seconds."""
    import os
    import signal
    import socket
    import threading

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, QA_TIGER_BPE_VOCAB=str(vocab), PYTHONPATH=str(ROOT))
    start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "qa_tiger_tpu_torch.serve", "--config", str(config),
         "--port", str(port), "--batch-size", str(SERVE_BATCH), "--dtype", "bfloat16",
         "--device-cache", "8"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: list = []
    reader = threading.Thread(target=_reader, args=(proc.stdout, lines), daemon=True)
    reader.start()
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 300
        while True:
            require(proc.poll() is None, "serve: the server died: "
                    + "\n".join(line for _, line in lines[-30:]))
            require(time.monotonic() < deadline, "serve: /health never answered 200")
            try:
                status, _ = _http(base, "/health", timeout=5)
            except OSError:
                status = None
            if status == 200:
                break
            time.sleep(0.1)
        healthy = time.perf_counter()
        items = [{"question": q, "video": f"v{i:02d}"} for i, q in
                 enumerate(["How many instruments are playing in the video?",
                            "Is the ukulele louder than the cello?"] * 4)]
        results = [None] * len(items)

        def worker(i):
            results[i] = _http(base, "/predict", {**items[i], "topk": 3})

        workers = [threading.Thread(target=worker, args=(i,)) for i in range(len(items))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        status, batch = _http(base, "/predict_batch", {"items": items, "topk": 3})
        _, stats = _http(base, "/stats")
        missing, _ = _http(base, "/predict", {"question": "q", "video": "nope"})
        ok = (all(r is not None and r[0] == 200 and len(r[1]["topk"]) == 3 for r in results)
              and status == 200 and len(batch["results"]) == len(items)
              and stats["served"] == 2 * len(items) and stats["batches"] >= 2
              and missing == 404)
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
        serving_line = next((t for t, line in lines if line.startswith('{"serving"')), None)
        out = {"phase": "serve_http", "requests": len(items), "batch_items": len(items),
               "stats": stats, "unknown_video_status": missing,
               "answers": [r[1]["answer"] for r in results if r is not None],
               "to_serving_line_s": None if serving_line is None else serving_line - start,
               "to_health_200_s": healthy - start, "sigterm_exit": code, "ok": ok}
        print(json.dumps(out), flush=True)
        require(ok and code == 0 and serving_line is not None,
                f"serve: the HTTP round trip failed: {out}")
        return out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        reader.join(timeout=10)
        proc.stdout.close()


def check_predict_cli(config: Path, vocab: Path) -> dict:
    """(d) ``python -m qa_tiger_tpu_torch.predict`` once (fp32, the card),
    against ``Predictor`` in fp32 on the same row in this process."""
    import os

    import torch

    from qa_tiger_tpu_torch.data.tokenizer import ClipTokenizer
    from qa_tiger_tpu_torch.predict import Predictor, load_features
    from qa_tiger_tpu_torch.utils.config import load_config_module

    question = "Where is the first sounding instrument?"
    env = dict(os.environ, QA_TIGER_BPE_VOCAB=str(vocab), PYTHONPATH=str(ROOT))
    start = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "qa_tiger_tpu_torch.predict", "--config",
                          str(config), "--video", "v03", "--question", question, "--topk", "5"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - start
    require(out.returncode == 0, f"predict: exit {out.returncode}: {out.stderr[-3000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    cfg = load_config_module(str(config))
    pred = Predictor.from_config(cfg, "cuda", torch.float32)
    batch = load_features(cfg, "v03")
    batch["quest"] = ClipTokenizer(vocab)(question, truncate=True)
    want = pred.answer(batch, topk=5)[0]
    err = max(abs(a["prob"] - b["prob"]) for a, b in zip(got["topk"], want["topk"]))
    ok = (got["answer"] == want["answer"] and err <= 1e-4
          and [t["answer"] for t in got["topk"]] == [t["answer"] for t in want["topk"]])
    print(json.dumps({"phase": "predict_cli", "seconds": seconds, "answer": got["answer"],
                      "topk": got["topk"], "max_prob_diff": err, "ok": ok}), flush=True)
    require(ok, f"predict: {got} differs from Predictor's {want}")
    del pred
    torch.cuda.empty_cache()
    return {"seconds": seconds}


def check_serve(slice_rate: float, profile_dir: Path | None) -> dict:
    """Phase 5: the serving surface over bench_serve's corpus (8 videos at
    the real shapes, fp32 features from a seed, a merges file learned from
    its questions) at configs/qa-tiger/vitl14.py's widths, bf16, B=256,
    seed weights. (a) a full and a padded batch through ``Service._dispatch``
    on the device-cache path and on the host path: the two bitwise equal,
    each within BF16_TOL of ``Predictor`` on the same rows assembled and
    padded the same way, the same top-1; one dispatch of each path under
    ``torch.cuda.set_sync_debug_mode("error")``; (b) the launch counters
    reset around two served batches: per batch 12 / 7 / 1 / 2 launches of the
    eval kernels, every product of fused_attn_ln2 and fused_patch_select on
    wgmma; (c) bench_serve's protocol at its defaults (4096 requests, 4
    threads, device cache 8), then over 1024 requests with the cache off;
    (d) the entry points as subprocesses. Returns (b)'s counts per batch."""
    import tempfile

    import torch

    from qa_tiger_tpu_torch import bench_serve, ops

    phase_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        config, vocab = bench_serve.build_corpus(Path(tmp))
        start = time.perf_counter()
        svc = bench_serve.start_service(config, vocab, SERVE_BATCH, "bfloat16", 8)
        print(json.dumps({"phase": "serve_start", "seconds": time.perf_counter() - start,
                          **svc.timings}), flush=True)
        try:
            # (a) the two paths against the Predictor
            items = bench_serve.requests(SERVE_BATCH)
            cached = [svc._make_row(it["question"], it["video"]) for it in items]
            require(all(r["slot"] is not None for r in cached), "serve: a row has no slot")
            host = [dict(r, slot=None, feats=svc.store.get(r["video"])) for r in cached]
            print(json.dumps({"phase": "serve_staging", "rows": SERVE_BATCH,
                              **staging_ms(svc, host)}), flush=True)
            for n in (SERVE_BATCH, SERVE_PADDED):
                before = svc.stats["cached_batches"]
                got_c = svc._step(cached[:n])
                got_h = svc._step(host[:n])
                want = torch.softmax(svc.predictor.logits(host_batch(svc, host[:n])).float(),
                                     -1).cpu().numpy()[:n]
                err = float(np.abs(got_h - want).max())
                same = bool(np.array_equal(got_c, got_h))
                top1 = bool((got_h.argmax(1) == want.argmax(1)).all())
                print(json.dumps({"phase": "serve_paths", "rows": n,
                                  "cached_batches": svc.stats["cached_batches"] - before,
                                  "cached_equals_host": same, "max_abs_err_vs_predictor": err,
                                  "top1_equal": top1}), flush=True)
                require(svc.stats["cached_batches"] == before + 1,
                        "serve: the cached path was not taken exactly once")
                require(same, f"serve: the cached and host paths differ at {n} rows")
                require(err <= BF16_TOL and top1,
                        f"serve: {n} rows differ from the Predictor (max {err:.3e})")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                handles = [svc._dispatch(cached[:SERVE_PADDED]), svc._dispatch(host)]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            require(all(np.isfinite(np.asarray(h)).all() for h in handles),
                    "serve: a dispatch under the sync check gave non-finite values")
            print(json.dumps({"phase": "serve_sync_check", "dispatches": len(handles),
                              "ok": True}), flush=True)

            # (b) launches per served batch
            torch.cuda.synchronize()
            ops.reset_launches()
            before = dict(svc.stats)
            svc.predict_many(bench_serve.requests(2 * SERVE_BATCH), topk=1)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            routes = {name: dict(ops.KERNELS[name].gemm_routes)
                      for name in ("fused_attn_ln2", "fused_patch_select", "fused_gaussian_moe")}
            n = svc.stats["batches"] - before["batches"]
            per_batch = {k: v // max(n, 1) for k, v in counts.items()}
            print(json.dumps({"phase": "serve_launches", "batches": n, "launches": counts,
                              "per_batch": per_batch, "gemm_routes": routes}), flush=True)
            require(n == 2, f"serve: {n} batches for 2 x {SERVE_BATCH} requests")
            for name, want_n in SERVE_KERNELS.items():
                require(counts[name] == want_n * n, f"serve: {name} launched {counts[name]} "
                        f"times in {n} batches, expected {want_n} per batch")
            for name in ("fused_attn_ln2", "fused_patch_select"):
                require(bool(routes[name]) and set(routes[name]) == {"wgmma"},
                        f"serve: {name}'s products took {routes[name]}, expected wgmma only")
            require(routes["fused_gaussian_moe"] == {"wgmma": 2 * n, "tf32x3": 2 * n},
                    f"serve: fused_gaussian_moe's products took {routes['fused_gaussian_moe']}")

            # (c) the rates, bench_serve's protocol
            rate = bench_serve.drive(svc, bench_serve.requests(4096), 4)
            print(json.dumps({"phase": "serve_cached", "qa_per_s": rate["value"],
                              "slice_bf16_b256_qa_per_s": slice_rate, **rate}), flush=True)
            if profile_dir is not None:
                window = bench_serve.requests(1024)
                profile_step(lambda: bench_serve.drive(svc, window, 4, server_side=False),
                             profile_dir / "serve_b256.txt", "profile_serve")
        finally:
            svc.shutdown()
        del svc
        torch.cuda.empty_cache()
        svc = bench_serve.start_service(config, vocab, SERVE_BATCH, "bfloat16", 0)
        try:
            rate = bench_serve.drive(svc, bench_serve.requests(1024), 4)
        finally:
            svc.shutdown()
        del svc
        torch.cuda.empty_cache()
        print(json.dumps({"phase": "serve_host", "qa_per_s": rate["value"],
                          "slice_bf16_b256_qa_per_s": slice_rate, **rate}), flush=True)
        require(rate["cached_batches"] == 0, "serve: the host path took the cache")

        # (d) the entry points as a user runs them
        check_serve_http(config, vocab)
        check_predict_cli(config, vocab)
    print(json.dumps({"phase": "serve_seconds", "seconds": time.perf_counter() - phase_start}),
          flush=True)
    return per_batch


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

TRAIN_LR = 1e-4
# the kernels whose every fp32 product takes gemm_tf32x3, and their products
# per train step: the two train kernels' backwards and forwards and the two
# TempMoE calls (each a hidden and an output product)
TRAIN_TF32X3_KERNELS = {"fused_patch_select_train_bwd": 14, "fused_avq_train_bwd": 20,
                        "fused_patch_select_train": 7, "fused_avq_train": 10,
                        "fused_gaussian_moe": 4}
# the keep-masked attention kernels inside the train kernels
KEEP_SOURCE = "qa_tiger_tpu_torch/csrc/attention_keep.cu"
# the train kernels whose launch runs three keep-masked attentions
TRAIN_KEEP_KERNELS = ("fused_avq_train", "fused_avq_train_bwd", "fused_patch_select_train",
                      "fused_patch_select_train_bwd")
TRAIN_KERNELS = {"fused_attn_ln2": 12, "fused_avq_train": 1, "fused_avq_train_bwd": 1,
                 "fused_patch_select_train": 1, "fused_patch_select_train_bwd": 1,
                 "fused_gaussian_moe": 2, "attention_wide": 0, "attention_wide_key_bias": 0,
                 "fused_patch_select": 0, **dict.fromkeys(OP_KERNELS, 0)}


class Batches:
    """The loader contract AVQARunner reads: len, iter, set_epoch."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def set_epoch(self, epoch):
        pass


def make_train_batch(rng, b: int) -> dict:
    batch = make_batch(rng, b)
    batch.update(label=rng.integers(0, 42, b), qtype_label=rng.integers(0, 9, b),
                 valid=np.ones(b, bool))
    return batch


def train_setup(**model_extra):
    """(the runner's config, the model's hyperparameters) of the recipe:
    configs/qa-tiger/vitl14.py, Adam at its betas, lr 1e-4."""
    from qa_tiger_tpu_torch.models import qa_tiger_config
    from qa_tiger_tpu_torch.utils.config import load_config_module

    conf = load_config_module(str(CONFIG))
    hp = conf["hyper_params"]
    cfg = {"log_interval": 1, "debug": False,
           "hyper_params": {"optim": dict(hp["optim"]), "sched": dict(hp["sched"])}}
    return cfg, qa_tiger_config(num_labels=42, **hp["model"], **model_extra)


def check_train(rng, entries: dict, profile_dir: Path | None) -> dict:
    import torch

    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch.training import AVQARunner

    # (a) one fp32 B=4 step with dropout off: the card against the CPU from
    # the same weights and batch (the tower in fp32 on both)
    cfg, mcfg = train_setup(encoder_dtype="float32")
    card = AVQARunner(cfg, mcfg, device="cuda", seed=0)
    state = {k: v.detach().cpu() for k, v in card.params.items()}
    cpu = AVQARunner(cfg, mcfg, device="cpu", init_params=state)
    batch = make_train_batch(rng, 4)
    loss_card = card.train_step(batch, TRAIN_LR)["total_loss"].item()
    loss_cpu = cpu.train_step(batch, TRAIN_LR)["total_loss"].item()
    card_params = dict(card.trainable())
    compared, worst_param, worst_grad = 0, 0.0, 0.0
    params_ok = True
    for name, p in cpu.trainable():
        g_cpu = p.grad.numpy()
        g_card = card_params[name].grad.float().cpu().numpy()
        worst_grad = max(worst_grad, float(np.abs(g_card - g_cpu).max()
                                           / max(np.abs(g_cpu).max(), 1e-12)))
        keep = np.abs(g_cpu) > 1e-6
        if not keep.any():
            continue
        got = card_params[name].detach().cpu().numpy()[keep]
        want = p.detach().numpy()[keep]
        params_ok &= bool(np.allclose(got, want, **LOGITS_TOL))
        worst_param = max(worst_param, float(np.abs(got - want).max()))
        compared += 1
    loss_ok = bool(np.isclose(loss_card, loss_cpu, **LOGITS_TOL))
    print(json.dumps({"phase": "train_fp32_b4", "loss_card": loss_card, "loss_cpu": loss_cpu,
                      "params_compared": compared, "params_max_abs_err": worst_param,
                      "grads_max_rel_err": worst_grad, **LOGITS_TOL,
                      "ok": loss_ok and params_ok}), flush=True)
    require(loss_ok and params_ok and compared > 50,
            f"the fp32 train step on the card differs from the CPU run (loss {loss_card} vs "
            f"{loss_cpu}, params max err {worst_param:.3e})")
    require(worst_grad < 1e-2, f"a gradient on the card differs from the CPU run by "
                               f"{worst_grad:.3e} of its largest element")
    del card, cpu, state, card_params
    torch.cuda.empty_cache()

    # (b) the recipe: fp32 B=32, dropout on, token ids through the bf16 tower
    cfg, mcfg = train_setup()
    runner = AVQARunner(cfg, mcfg, device="cuda", seed=0)
    batch = runner._device_batch(make_train_batch(rng, 32))
    gen = torch.Generator().manual_seed(1)  # seeds the dropout sites' generators on the card
    before = {n: p.detach().clone() for n, p in runner.trainable()}
    losses = [runner.train_step(batch, TRAIN_LR, gen)["total_loss"].item() for _ in range(3)]
    torch.cuda.synchronize()
    ops.reset_launches()
    losses.append(runner.train_step(batch, TRAIN_LR, gen)["total_loss"].item())
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(json.dumps({"phase": "train_step_launches", **counts}), flush=True)
    routes = {name: dict(ops.KERNELS[name].gemm_routes)
              for name in ("fused_attn_ln2", *TRAIN_TF32X3_KERNELS)}
    print(json.dumps({"phase": "train_step_gemm_routes", **routes}), flush=True)
    for name, n in TRAIN_TF32X3_KERNELS.items():  # every fp32 product on gemm_tf32x3
        require(routes[name] == {"tf32x3": n},
                f"train step: {name}'s products took {routes[name]}, expected tf32x3 x {n}")
    attn = {name: dict(ops.KERNELS[name].attn_routes) for name in TRAIN_KEEP_KERNELS}
    print(json.dumps({"phase": "train_step_attn_routes", **attn}), flush=True)
    for name in TRAIN_KEEP_KERNELS:  # every keep-masked attention on tensor cores
        require(attn[name] == {"mma_keep": 3},
                f"train step: {name}'s keep-masked attentions took {attn[name]}, expected "
                "mma_keep x 3")
    for name, n in TRAIN_KERNELS.items():
        require(counts[name] == n, f"train step: {name} launched {counts[name]} times, "
                                   f"expected {n}")
        if name not in EVAL_KERNELS + E2E_ONLY_KERNELS + OP_KERNELS:
            entries[name]["launches"] = n
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = runner.train_step(batch, TRAIN_LR, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
        losses.append(out["total_loss"].item())
    median = statistics.median(times)
    changed = sum(int(not torch.equal(before[n], p.detach())) for n, p in runner.trainable())
    print(json.dumps({"phase": "train_fp32_b32", "step_ms_median": median * 1e3,
                      "step_ms_all": [t * 1e3 for t in times],
                      "train_qa_pairs_per_s": 32 / median, "losses": losses,
                      "params_changed": changed, "params": len(before),
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
    require(all(np.isfinite(losses)), "a train loss is not finite")
    require(changed == len(before), f"only {changed} of {len(before)} parameters changed")

    if profile_dir is not None:
        profile_step(lambda: runner.train_step(batch, TRAIN_LR, gen),
                     profile_dir / "train_step_fp32_b32.txt", "profile_train")

    # (c) an evaluation pass over two batches, with the 9-way report
    loader = Batches([make_train_batch(rng, 32) for _ in range(2)])
    acc, loss = runner.evaluate(1, loader)
    print(json.dumps({"phase": "evaluate", "accuracy": acc, "loss": loss}), flush=True)
    require(np.isfinite(loss) and 0.0 <= acc <= 100.0, "evaluate returned no valid numbers")
    time_eval(runner, profile_dir)
    return counts, 32 / median


# one fp32 evaluation forward (eval_step, the tower in bf16): its launches
EVAL_FP32_KERNELS = {"fused_attn_ln2": 12, "attention_wide": 7, "fused_patch_select": 1,
                     "fused_gaussian_moe": 2}


def time_eval(runner, profile_dir: Path | None) -> dict:
    """Phase 6(c2), line ``eval_fp32_b32``: the forward that ``evaluate``
    (``test``, every epoch's validation) runs, ``AVQARunner.eval_step`` in
    the recipe's fp32 with the tower in bf16, at the eval batch B=32 (a
    seed of its own): after 3 warm-up calls the counters reset around one
    call (its launches; fused_patch_select's product routes, tf32x3 x 7,
    and every attention's kernel, none on an FMA kernel, as the launchers
    wrote them back), then the median wall of 10 calls, each between two
    synchronizes, and qa/s; with ``profile_dir`` one profiled call
    (``profile_eval``)."""
    import torch

    from qa_tiger_tpu_torch import ops

    batch = runner._device_batch(make_train_batch(np.random.default_rng(24), 32))
    for _ in range(3):
        runner.eval_step(batch)
    torch.cuda.synchronize()
    ops.reset_launches()
    runner.eval_step(batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    ps_routes = dict(ops.fused_patch_select.gemm_routes)
    attn = require_tensor_core_attention("eval_fp32_b32_attn_routes")
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        start = time.perf_counter()
        runner.eval_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    median = statistics.median(times)
    line = {"phase": "eval_fp32_b32", "eval_ms_median": median, "eval_ms_all": times,
            "qa_per_s": 32e3 / median, "launches": {k: n for k, n in counts.items() if n},
            "fused_patch_select_gemm_routes": ps_routes, "attn_routes": attn}
    print(json.dumps(line), flush=True)
    for name, n in EVAL_FP32_KERNELS.items():
        require(counts[name] == n, f"eval_fp32_b32: {name} launched {counts[name]} times, "
                                   f"expected {n}")
    require(ps_routes == {"tf32x3": 7}, f"eval_fp32_b32: fused_patch_select's products took "
                                        f"{ps_routes}, expected tf32x3 x 7")
    require(sum(attn["attention_wide"].values()) == 7
            and sum(attn["fused_patch_select"].values()) == 2,
            f"eval_fp32_b32: attention kernels read back {attn}")
    if profile_dir is not None:
        profile_step(lambda: runner.eval_step(batch), profile_dir / "eval_fp32_b32.txt",
                     "profile_eval")
    return line


def check_resume(rng) -> dict:
    """Phase 6(d): a train state and a best.npz written and read back on the
    card. Two fp32 B=4 steps with dropout from the runner's step generator;
    the state saved, then restored into a fresh runner (the same seed, so
    the same frozen tower) whose trainable weights and generator were
    scrambled; one more step on each: every trainable parameter must be
    bitwise equal. Then the stepped weights through best.npz into a
    Predictor: its fp32 logits on a B=4 batch bitwise equal to those of a
    Predictor given the same weights as a state_dict. The launch counters
    are reset just before and read just after; the train kernels must have
    run. Returns the counts."""
    import tempfile

    import torch

    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch.predict import Predictor
    from qa_tiger_tpu_torch.training import (
        AVQARunner,
        load_train_state,
        save_checkpoint,
        save_train_state,
    )

    cfg, mcfg = train_setup()
    batch = make_train_batch(rng, 4)
    query = make_batch(rng, 4)
    torch.cuda.synchronize()
    ops.reset_launches()
    first = AVQARunner(cfg, mcfg, device="cuda", seed=0)
    for _ in range(2):
        first.train_step(batch, TRAIN_LR, first._step_generator)
    with tempfile.TemporaryDirectory() as tmp:
        save_train_state(first.train_state(epoch=1, best_acc=12.5), Path(tmp) / "state")
        second = AVQARunner(cfg, mcfg, device="cuda", seed=0)
        with torch.no_grad():
            for _, p in second.trainable():
                p.add_(1.0)
        second._step_generator.manual_seed(12345)
        scalars = second.restore_train_state(load_train_state(Path(tmp) / "state"))
        for r in (first, second):
            r.train_step(batch, TRAIN_LR, r._step_generator)
        torch.cuda.synchronize()
        pairs = list(zip(first.trainable(), second.trainable()))
        differ = [n for (n, a), (_, b) in pairs if not torch.equal(a, b)]
        worst = max((a - b).abs().max().item() for (_, a), (_, b) in pairs)

        save_checkpoint(first.params, Path(tmp) / "best.npz")
        weights = {k: v.detach().float().cpu() for k, v in first.params.items()}
        direct = Predictor(CONFIG, device="cuda", dtype=torch.float32, weights=weights)
        loaded = Predictor(CONFIG, device="cuda", dtype=torch.float32,
                           weights=Path(tmp) / "best.npz")
        want, got = direct.logits(query), loaded.logits(query)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    logits_equal = bool(torch.equal(got, want)) and bool(torch.isfinite(got).all())
    print(json.dumps({"phase": "resume", "scalars": scalars, "params": len(pairs),
                      "params_differing": differ[:5], "max_abs_diff": worst,
                      "best_npz_logits_bitwise": logits_equal,
                      "logits_max_abs_diff": (got - want).abs().max().item(),
                      "ok": not differ and logits_equal}), flush=True)
    print(json.dumps({"phase": "resume_launches", **counts}), flush=True)
    require(scalars == {"epoch": 1, "best_acc": 12.5}, f"resume: scalars came back as {scalars}")
    require(not differ, f"resume: {len(differ)} parameters differ from the uninterrupted run "
                        f"(max {worst:.3e}), e.g. {differ[:3]}")
    require(logits_equal, "resume: logits through best.npz differ from the same weights given "
                          "directly")
    for name in ("fused_avq_train", "fused_avq_train_bwd", "fused_patch_select_train",
                 "fused_patch_select_train_bwd", *EVAL_KERNELS):
        require(counts[name] > 0, f"resume: {name} did not launch")
    return counts


# ---------------------------------------------------------------------------
# phase 6(f): steps_per_dispatch, the train step as a CUDA graph
# ---------------------------------------------------------------------------

GRAPH_K = 4
# JAX's own K-window tolerance (tests/test_training.py TestMultiStepDispatch)
WINDOW_TOL = dict(rtol=2e-4, atol=2e-5)


def graph_runner(capture: bool = True, k: int = GRAPH_K, seed: int = 0, grid=None, **hp):
    """An AVQARunner at the recipe with ``steps_per_dispatch`` = k (and any
    other ``hyper_params``), on ``grid`` where given; ``capture=False`` runs
    its static-input step eagerly on the card, the graph's twin."""
    from qa_tiger_tpu_torch.training import AVQARunner

    cfg, mcfg = train_setup()
    accum = hp.pop("grad_accum", None)
    if accum:
        cfg["hyper_params"]["optim"]["grad_accum"] = accum
    cfg["hyper_params"].update(steps_per_dispatch=k, **hp)
    runner = AVQARunner(cfg, mcfg, device="cuda", seed=seed, grid=grid)
    runner.graph_capture = capture
    return runner


def run_windows(runner, staged: list, k: int = GRAPH_K) -> list:
    """``staged`` through ``train_window`` in windows of k: each step's
    losses as one device vector (its keys in sorted order)."""
    out = []
    for i in range(0, len(staged), k):
        for losses in runner.train_window(staged[i:i + k], TRAIN_LR):
            out.append(torch_stack_losses(losses))
    return out


def torch_stack_losses(losses: dict):
    import torch

    return torch.stack([losses[key].float() for key in sorted(losses)])


def state_differences(a, b) -> list[str]:
    """What differs, bitwise, between two runners: trainable parameters,
    Adam's moments and step counts, the dropout stream's state."""
    import torch

    differ = []
    for (name, pa), (_, pb) in zip(a.trainable(), b.trainable()):
        if not torch.equal(pa, pb):
            differ.append(name)
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            # a parameter no step gave a gradient has no state (TSPM's unused norms)
            if (key in sa) != (key in sb) or (key in sa and not torch.equal(sa[key], sb[key])):
                differ.append(f"{name}:{key}")
    if not torch.equal(a._step_generator.get_state(), b._step_generator.get_state()):
        differ.append("_step_generator")
    return differ


def copy_train_state(dst, src) -> None:
    """Copies ``src``'s trainable parameters, Adam moments and step counts
    and dropout stream into ``dst``'s tensors in place (a captured graph of
    ``dst`` stays valid)."""
    import torch

    with torch.no_grad():
        for (_, pd), (_, ps) in zip(dst.trainable(), src.trainable()):
            pd.copy_(ps)
            sd, ss = dst.optimizer.state[pd], src.optimizer.state[ps]
            for key in ("exp_avg", "exp_avg_sq", "step"):
                sd[key].copy_(ss[key])
    dst._step_generator.set_state(src._step_generator.get_state())


def require_graph_equals_eager(label: str, graph, eager, g_losses: list, e_losses: list,
                               replays: int) -> dict:
    """The graph runner's losses and state bitwise those of its eager twin,
    after ``replays`` replays."""
    import torch

    differ = state_differences(graph, eager)
    losses_equal = all(torch.equal(a, b) for a, b in zip(g_losses, e_losses))
    line = {"phase": f"train_graph_{label}", "steps": len(g_losses),
            "replays": graph._step_graph.replays, "losses_bitwise": losses_equal,
            "state_differing": differ[:5], "n_differing": len(differ),
            "losses": [v.tolist() for v in g_losses[-2:]]}
    print(json.dumps(line), flush=True)
    require(graph._step_graph.replays == replays,
            f"train_graph {label}: {graph._step_graph.replays} replays, expected {replays}")
    require(losses_equal and not differ,
            f"train_graph {label}: the replayed steps differ from the eager ones: losses "
            f"{'equal' if losses_equal else 'differ'}, {len(differ)} tensors differ, e.g. "
            f"{differ[:3]}")
    return line


def time_graph_steps(runner, staged: list, eager_ms: float | None,
                     profile_dir: Path | None = None) -> dict:
    """The replayed step's times on a warm graph runner: the median wall of
    10 single replays, each between two synchronizes; a window of 8 replays
    back to back, timed as a whole, per step, under
    ``set_sync_debug_mode("error")`` (no host read inside the window);
    with ``profile_dir``, the device idle share of such a window."""
    import torch

    times = []
    for batch in (staged * 10)[:10]:
        torch.cuda.synchronize()
        start = time.perf_counter()
        runner.train_window([batch], TRAIN_LR)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    window = (staged * 8)[:8]
    torch.cuda.synchronize()
    start = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = runner.train_window(window, TRAIN_LR)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - start) * 1e3 / len(window)
    median = statistics.median(times) * 1e3
    line = {"phase": "train_graph_time", "replay_ms_median": median,
            "replay_ms_all": [t * 1e3 for t in times], "window_ms_per_step": window_ms,
            "eager_step_ms_median": eager_ms,
            "train_qa_pairs_per_s": 32e3 / window_ms,
            "last_loss": losses[-1]["total_loss"].item()}
    print(json.dumps(line), flush=True)
    require(np.isfinite(line["last_loss"]), "train_graph: a replayed loss is not finite")
    if profile_dir is not None:
        kernels = profile_step(lambda: runner.train_window(window, TRAIN_LR),
                               profile_dir / "train_graph_window_fp32_b32.txt",
                               "profile_train_graph")
        fma = sorted(k for k in kernels if re.search(r"\battention(_bwd)?_kernel<", k))
        require(not fma, f"train_graph: the replayed step ran FMA attention kernels {fma}")
    return line


def time_train_graph(rng, profile_dir: Path | None = None) -> dict:
    """``time_graph_steps`` on a fresh recipe runner (fp32 B=32, dropout,
    steps_per_dispatch 4) over 8 batches from ``rng``, after one window
    that warms up and captures."""
    runner = graph_runner()
    staged = [runner.stage_batch(make_train_batch(rng, 32)) for _ in range(8)]
    run_windows(runner, staged[:GRAPH_K])
    return time_graph_steps(runner, staged, None, profile_dir)


def check_train_graph(eager_ms: float, profile_dir: Path | None) -> dict:
    """Phase 6(f): ``hyper_params.steps_per_dispatch`` = 4 at the recipe
    (fp32 B=32, dropout on, token ids through the bf16 tower). (1) 11
    batches through a graph runner (warm-up, capture, 10 replays) and its
    eager twin (the same static-input step, capturable Adam and per-site
    seeding, run eagerly): losses, parameters, Adam's moments and the
    dropout stream bitwise equal; (2) against the default K=1 runner on the
    same batches, each replay (10) from the state the K=1 runner stepped
    from, copied in place: loss and parameters within rtol 2e-4 / atol
    2e-5, the largest gaps printed, beside the free-running gaps of (1)'s
    run, where the two Adams' rounding compounds; (3) the launch counters
    reset around one replay: TRAIN_KERNELS and TRAIN_TF32X3_KERNELS, as the
    eager step's; (4) the
    replay's times beside ``train_fp32_b32``'s eager median; (5) one window
    each with train_dtype bfloat16 and with grad_accum 2, bitwise against
    their eager twins; (6) a resume mid-run: the train state saved after
    three replays and restored into a runner that had captured a graph of
    its own, three more steps on each, bitwise equal. Returns (3)'s counts."""
    import tempfile

    import torch

    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch.training import load_train_state, save_train_state

    phase_start = time.perf_counter()
    rng = np.random.default_rng(20)
    host = [make_train_batch(rng, 32) for _ in range(11)]

    # (1) bitwise against the eager twin
    graph, eager = graph_runner(), graph_runner(capture=False)
    staged = [graph.stage_batch(b) for b in host]
    g_losses, e_losses = run_windows(graph, staged), run_windows(eager, staged)
    torch.cuda.synchronize()
    require_graph_equals_eager("fp32_b32", graph, eager, g_losses, e_losses, replays=10)
    require(graph.optimizer.param_groups[0]["capturable"],
            "train_graph: the graph runner's Adam is not capturable")

    # (2) against the default K=1 path. Free-running, the two Adams' rounding
    # compounds over the steps (printed); each replay is therefore also held
    # to a default step taken from the same state: the graph runner's
    # parameters, Adam state and dropout stream copied in place from the
    # default runner's before each step, so that the graph stays valid
    default, synced = graph_runner(k=1), graph_runner()
    run_windows(synced, staged[:2])  # warm-up and capture
    d_losses = [torch_stack_losses(default.train_step(staged[0], TRAIN_LR,
                                                      default._step_generator))]
    loss_gap, param_gap, close = 0.0, 0.0, True
    for batch in staged[1:]:
        copy_train_state(synced, default)
        d_losses.append(torch_stack_losses(default.train_step(batch, TRAIN_LR,
                                                              default._step_generator)))
        g_loss = torch_stack_losses(synced.train_window([batch], TRAIN_LR)[0])
        loss_gap = max(loss_gap, (g_loss - d_losses[-1]).abs().max().item())
        close &= bool(torch.allclose(g_loss, d_losses[-1], **WINDOW_TOL))
        for (_, pg), (_, pd) in zip(synced.trainable(), default.trainable()):
            param_gap = max(param_gap, (pg - pd).abs().max().item())
            close &= bool(torch.allclose(pg, pd, **WINDOW_TOL))
    free_gaps = [(a - b).abs().max().item() for a, b in zip(g_losses, d_losses)]
    free_params = max((pg - pd).abs().max().item()
                      for (_, pg), (_, pd) in zip(graph.trainable(), default.trainable()))
    print(json.dumps({"phase": "train_graph_vs_default", "steps": len(d_losses) - 1,
                      "replays": synced._step_graph.replays, "loss_max_abs_gap": loss_gap,
                      "params_max_abs_gap": param_gap, "within_tol": close, **WINDOW_TOL,
                      "free_running_loss_gaps": free_gaps,
                      "free_running_params_max_abs_gap": free_params}), flush=True)
    require(synced._step_graph.replays == len(staged),
            f"train_graph: {synced._step_graph.replays} replays against the K=1 path")
    require(close, f"train_graph: a replay differs from the K=1 path's step from the same "
                   f"state: loss by {loss_gap:.3e}, parameters by {param_gap:.3e}")
    del default, synced, d_losses

    # (3) launch counts and routes of one replay, beside one eager twin step
    counted = {}
    for label, runner in (("replay", graph), ("eager", eager)):
        torch.cuda.synchronize()
        ops.reset_launches()
        runner.train_window([staged[0]], TRAIN_LR)
        torch.cuda.synchronize()
        counted[label] = (ops.launch_counts(),
                          {name: dict(ops.KERNELS[name].gemm_routes)
                           for name in ("fused_attn_ln2", *TRAIN_TF32X3_KERNELS)})
    counts, routes = counted["replay"]
    print(json.dumps({"phase": "train_graph_launches", **counts}), flush=True)
    print(json.dumps({"phase": "train_graph_gemm_routes", **routes}), flush=True)
    require(counted["replay"] == counted["eager"],
            f"train_graph: a replay counted {counted['replay']}, an eager step "
            f"{counted['eager']}")
    for name, n in TRAIN_TF32X3_KERNELS.items():
        require(routes[name] == {"tf32x3": n},
                f"train_graph: {name}'s products took {routes[name]}, expected tf32x3 x {n}")
    for name, n in TRAIN_KERNELS.items():
        require(counts[name] == n, f"train_graph: {name} launched {counts[name]} times per "
                                   f"replay, expected {n}")
    del eager
    torch.cuda.empty_cache()

    # (4) times
    time_graph_steps(graph, staged[:8], eager_ms, profile_dir)
    del graph
    torch.cuda.empty_cache()

    # (5) bf16 compute and gradient accumulation, one window each
    for label, hp in (("bf16_b32", {"train_dtype": "bfloat16"}),
                      ("accum2_b32", {"grad_accum": 2})):
        graph, eager = graph_runner(**hp), graph_runner(capture=False, **hp)
        g_losses = run_windows(graph, staged[:GRAPH_K + 1])
        e_losses = run_windows(eager, staged[:GRAPH_K + 1])
        torch.cuda.synchronize()
        require_graph_equals_eager(label, graph, eager, g_losses, e_losses, replays=GRAPH_K)
        del graph, eager
        torch.cuda.empty_cache()

    # (6) resume mid-run: saved after 3 replays, restored into a runner with
    # a graph of its own, which restore_train_state must drop
    first, second = graph_runner(), graph_runner()
    run_windows(first, staged[:GRAPH_K])
    run_windows(second, staged[GRAPH_K:GRAPH_K + 2])
    require(second._step_graph is not None and second._step_graph.graph is not None,
            "train_graph resume: the second runner captured no graph")
    with tempfile.TemporaryDirectory() as tmp:
        save_train_state(first.train_state(epoch=1), Path(tmp) / "state")
        second.restore_train_state(load_train_state(Path(tmp) / "state"))
    require(second._step_graph is None, "train_graph resume: restore kept the captured graph")
    a = run_windows(first, staged[GRAPH_K:GRAPH_K + 3])
    b = run_windows(second, staged[GRAPH_K:GRAPH_K + 3])
    torch.cuda.synchronize()
    differ = state_differences(first, second)
    losses_equal = all(torch.equal(x, y) for x, y in zip(a, b))
    print(json.dumps({"phase": "train_graph_resume", "replays": [first._step_graph.replays,
                                                                 second._step_graph.replays],
                      "losses_bitwise": losses_equal, "state_differing": differ[:5],
                      "ok": losses_equal and not differ}), flush=True)
    require(losses_equal and not differ,
            f"train_graph resume: {len(differ)} tensors differ after the resume, e.g. "
            f"{differ[:3]}")
    print(json.dumps({"phase": "train_graph_seconds",
                      "seconds": time.perf_counter() - phase_start}), flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 6(e): the train and test entry points over a corpus on disk
# ---------------------------------------------------------------------------

CLI_SPLITS = {"train": (0, 70), "val": (70, 90), "test": (90, 110)}
CLI_FEATURES = {"vggish": (T, 128), "clip": (T, 768), "tome": (T, P, 1024)}
CLI_BATCH = 32
CLI_WARM_EPOCHS = 3
CLI_REPORT = re.compile(r"\]:(Test .* accuracy: .*)$")


def write_cli_corpus(root: Path) -> dict:
    """The first 110 questions of music_avqa_val.json in file order (70
    train, 20 val, 20 test: real text, types and answers, the real 42-answer
    vocabulary), fp32 features at the real shapes for each of their videos
    from numpy seed 0, and a merges file learned from the questions: the
    corpus the port's CLI tests write (tests/torch_corpus.py), at full size."""
    spec = importlib.util.spec_from_file_location("torch_corpus",
                                                  ROOT / "tests" / "torch_corpus.py")
    corpus = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(corpus)
    corpus.write_corpus(root, CLI_SPLITS, CLI_FEATURES)
    questions = corpus.val_questions()[:CLI_SPLITS["test"][1]]
    corpus.write_merges(root / "vocab.txt.gz", [q["question_content"] for q in questions])
    videos = {q["video_id"] for q in questions}
    nbytes = sum((root / sub / f"{vid}.npy").stat().st_size
                 for sub in CLI_FEATURES for vid in videos)
    return {"questions": len(questions), "videos": len(videos), "feature_bytes": nbytes}


def write_cli_config(path: Path, root: Path, **top) -> Path:
    """configs/qa-tiger/vitl14.py over the corpus: its model at full width,
    batch and eval batch 32, no platform (the card); ``top`` sets top-level
    keys, ``cache_qst_features`` and ``steps_per_dispatch`` go into
    hyper_params."""
    from qa_tiger_tpu_torch.utils.config import load_config_module

    cfg = load_config_module(str(CONFIG)).to_dict()
    cfg["data"].update(root=str(root), batch_size=CLI_BATCH, eval_batch_size=CLI_BATCH,
                       num_workers=0, train_annot="train.json", valid_annot="val.json",
                       test_annot="test.json", ans_quelen="answer2idx.json",
                       audio_feat="vggish", video_feat="clip", patch_feat="tome")
    cfg["hyper_params"]["cache_qst_features"] = top.pop("cache_qst_features", False)
    if "steps_per_dispatch" in top:
        cfg["hyper_params"]["steps_per_dispatch"] = top.pop("steps_per_dispatch")
    cfg.update({"epochs": 1, "output_dir": str(root / "out"), **top})
    path.write_text(f"config = {cfg!r}\n")
    return path


def report_lines(path: Path) -> list[str]:
    """A log's test report lines (per qtype, per modality, total) without
    their time and source prefix."""
    return [m.group(1) for line in path.read_text().splitlines()
            if (m := CLI_REPORT.search(line.rstrip()))]


def check_cli(recipe_rate: float) -> dict:
    """Phase 6(e): ``python -m qa_tiger_tpu_torch.train`` / ``.test``
    through their ``main(argv)`` over a corpus written to a temporary
    directory. (a) train, 1 epoch, no question cache, the launch counters
    reset just before and read just after: each train kernel 3 times (70 =
    32 + 32 + 6), the MoE 2 per step and 2 per eval forward, the eval
    kernels in evaluate and the final test; best.npz and last_state/
    written; every feature file read by the native loader. (b) test on
    (a)'s best.npz: its report lines equal (a)'s final test's. (c) train
    resumed from (a)'s last_state for epoch 2 with the question cache: one
    cache per split (the tower 12 launches per split, none per step), the
    best checkpoint carried over. (d) train for 1 + CLI_WARM_EPOCHS epochs
    and report the rate over the warm ones. (e) (d) again with
    ``steps_per_dispatch: 4``: every step but the first (the warm-up) a
    replay of the step's CUDA graph, the same launch counts as (d), the
    warm rate and loader wait beside (d)'s. Returns (a)'s counts."""
    import os
    import tempfile

    import torch

    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch import test as test_entry
    from qa_tiger_tpu_torch import train as train_entry
    from qa_tiger_tpu_torch.data import native_loader

    avqa = logging.getLogger("AVQA")
    propagate = avqa.propagate
    avqa.propagate = False  # the entry points log to stderr and their run files
    old_vocab = os.environ.get("QA_TIGER_BPE_VOCAB")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            start = time.perf_counter()
            corpus = write_cli_corpus(root)
            corpus["write_s"] = time.perf_counter() - start
            print(json.dumps({"phase": "cli_corpus", **corpus}), flush=True)
            os.environ["QA_TIGER_BPE_VOCAB"] = str(root / "vocab.txt.gz")
            n_steps = -(-(CLI_SPLITS["train"][1] - CLI_SPLITS["train"][0]) // CLI_BATCH)

            # the native reader's g++ build, once per checkout, outside every
            # timed epoch
            start = time.perf_counter()
            require(native_loader.native_available(), "cli: the native .npy loader did not build")
            print(json.dumps({"phase": "cli_native_build",
                              "seconds": time.perf_counter() - start}), flush=True)

            # (a) train
            cfg_a = write_cli_config(root / "train.py", root)
            torch.cuda.synchronize()
            ops.reset_launches()
            native_loader.reset_counts()
            start = time.perf_counter()
            summary = train_entry.main(["--config", str(cfg_a)])
            torch.cuda.synchronize()
            total_s = time.perf_counter() - start
            counts = ops.launch_counts()
            routes = {name: dict(ops.KERNELS[name].gemm_routes)
                      for name in ("fused_attn_ln2", "fused_patch_select", *TRAIN_TF32X3_KERNELS)}
            files = dict(native_loader.counts)
            epoch = summary["epochs"][0]
            run_a = Path(summary["run_dir"])
            n_train = CLI_SPLITS["train"][1] - CLI_SPLITS["train"][0]
            print(json.dumps({
                "phase": "cli_train", "steps": epoch["steps"], "epoch_wall_s": epoch["wall_s"],
                "train_qa_pairs_per_s": n_train / epoch["wall_s"],
                "recipe_train_qa_pairs_per_s": recipe_rate,
                "loader_wait_s": epoch["loader_wait_s"], "main_s": total_s,
                "val_accuracy": epoch["val_acc"], "test_accuracy": summary["tests"],
                "files_read": files, "native_available": native_loader.native_available(),
                "launches": counts}), flush=True)
            print(json.dumps({"phase": "cli_train_gemm_routes", **routes}), flush=True)
            for name, n in TRAIN_TF32X3_KERNELS.items():  # the routes of train_fp32_b32
                if name != "fused_gaussian_moe":
                    require(routes[name] == {"tf32x3": n * counts[name]},
                            f"cli train: {name}'s products took {routes[name]}, expected "
                            f"tf32x3 x {n} per launch")
            require(routes["fused_gaussian_moe"] == {"tf32x3": 2 * counts["fused_gaussian_moe"]},
                    f"cli train: fused_gaussian_moe's products took "
                    f"{routes['fused_gaussian_moe']}, expected tf32x3 x 2 per launch")
            require(epoch["steps"] == n_steps, f"cli train: {epoch['steps']} steps, expected "
                                               f"{n_steps}")
            for name in ("fused_avq_train", "fused_avq_train_bwd", "fused_patch_select_train",
                         "fused_patch_select_train_bwd"):
                require(counts[name] == n_steps, f"cli train: {name} launched {counts[name]} "
                                                 f"times, expected {n_steps}")
            eval_forwards = 2  # one val batch, one test batch
            require(counts["fused_gaussian_moe"] == 2 * n_steps + 2 * eval_forwards,
                    f"cli train: fused_gaussian_moe launched {counts['fused_gaussian_moe']} "
                    f"times, expected {2 * n_steps + 2 * eval_forwards}")
            for name in ("fused_attn_ln2", "attention_wide", "fused_patch_select"):
                require(counts[name] > 0, f"cli train: {name} did not launch")
            require((run_a / "best.npz").exists() and (run_a / "last_state" / "state.pt").exists(),
                    "cli train: best.npz or last_state/ not written")
            require(native_loader.native_available() and files["native"] > 0
                    and files["numpy"] == 0, f"cli train: the loader read {files}, not natively")

            # (b) test on (a)'s best.npz
            start = time.perf_counter()
            accs = test_entry.main(["--config", str(cfg_a), "--weight", str(run_a / "best.npz"),
                                    "--output_path", str(root / "eval")])
            torch.cuda.synchronize()
            want = report_lines(run_a / "log.txt")
            got = report_lines(root / "eval" / "best_result.txt")
            print(json.dumps({"phase": "cli_test", "seconds": time.perf_counter() - start,
                              "accuracy": accs, "report": got, "equal_to_train": got == want}),
                  flush=True)
            require(len(got) == 13 and got == want,
                    f"cli test: the report differs from the train run's final test: {got} vs "
                    f"{want}")

            # (c) resume for epoch 2, with the question cache
            cfg_c = write_cli_config(root / "resume.py", root, epochs=2, cache_qst_features=True,
                                     resume=str(run_a / "last_state"),
                                     output_dir=str(root / "out_resume"))
            torch.cuda.synchronize()
            ops.reset_launches()
            start = time.perf_counter()
            resumed = train_entry.main(["--config", str(cfg_c)])
            torch.cuda.synchronize()
            rcounts = ops.launch_counts()
            epoch = resumed["epochs"][0] if resumed["epochs"] else {}
            print(json.dumps({
                "phase": "cli_resume", "start_epoch": resumed["start_epoch"],
                "steps": epoch.get("steps"), "epoch_wall_s": epoch.get("wall_s"),
                "train_qa_pairs_per_s": n_train / epoch["wall_s"] if epoch else None,
                "loader_wait_s": epoch.get("loader_wait_s"),
                "main_s": time.perf_counter() - start, "val_accuracy": epoch.get("val_acc"),
                "test_accuracy": resumed["tests"], "question_caches": resumed["question_caches"],
                "carried_over": resumed["carried_over"], "launches": rcounts}), flush=True)
            require(resumed["start_epoch"] == 2 and [e["epoch"] for e in resumed["epochs"]] == [2],
                    f"cli resume: started at epoch {resumed['start_epoch']}, expected 2")
            require(resumed["question_caches"] == 3,
                    f"cli resume: {resumed['question_caches']} question caches, expected 3")
            require(rcounts["fused_attn_ln2"] == 12 * 3, f"cli resume: the tower launched "
                    f"{rcounts['fused_attn_ln2']} times, expected 12 per split and none per step")
            require(resumed["carried_over"] == str(run_a / "best.npz")
                    and (Path(resumed["run_dir"]) / "best.npz").exists(),
                    "cli resume: best.npz was not carried over")

            # (d) the rate through the entry point on warm epochs: (a)'s
            # config for 1 + CLI_WARM_EPOCHS epochs, the first of them (a new
            # runner's, Adam's state allocated in its first step) left out
            cfg_d = write_cli_config(root / "warm.py", root, epochs=1 + CLI_WARM_EPOCHS,
                                     save_state=False, output_dir=str(root / "out_warm"))
            torch.cuda.synchronize()
            ops.reset_launches()
            warm = train_entry.main(["--config", str(cfg_d)])
            torch.cuda.synchronize()
            wcounts = ops.launch_counts()
            epochs = warm["epochs"][1:]
            steps = sum(e["steps"] for e in epochs)
            wall_s = sum(e["wall_s"] for e in epochs)
            print(json.dumps({
                "phase": "cli_warm", "epochs": len(epochs), "steps": steps, "epoch_wall_s": wall_s,
                "train_qa_pairs_per_s": n_train * len(epochs) / wall_s,
                "recipe_train_qa_pairs_per_s": recipe_rate,
                "loader_wait_s": sum(e["loader_wait_s"] for e in epochs),
                "per_epoch": [{k: e[k] for k in ("epoch", "steps", "wall_s", "loader_wait_s")}
                              for e in warm["epochs"]],
                "val_accuracy": [e["val_acc"] for e in epochs], "test_accuracy": warm["tests"],
                "launches": wcounts}), flush=True)
            require(steps == n_steps * CLI_WARM_EPOCHS, f"cli warm: {steps} steps, expected "
                                                        f"{n_steps * CLI_WARM_EPOCHS}")
            for name in ("fused_avq_train", "fused_avq_train_bwd", "fused_patch_select_train",
                         "fused_patch_select_train_bwd"):
                require(wcounts[name] == n_steps * (1 + CLI_WARM_EPOCHS),
                        f"cli warm: {name} launched {wcounts[name]} times, expected "
                        f"{n_steps * (1 + CLI_WARM_EPOCHS)}")

            # (e) (d) through the step's CUDA graph, counting its replays
            cfg_e = write_cli_config(root / "graph.py", root, epochs=1 + CLI_WARM_EPOCHS,
                                     save_state=False, output_dir=str(root / "out_graph"),
                                     steps_per_dispatch=GRAPH_K)
            replays = [0]
            replay = torch.cuda.CUDAGraph.replay

            def counted_replay(graph):
                replays[0] += 1
                return replay(graph)

            torch.cuda.synchronize()
            ops.reset_launches()
            torch.cuda.CUDAGraph.replay = counted_replay
            try:
                graphed = train_entry.main(["--config", str(cfg_e)])
            finally:
                torch.cuda.CUDAGraph.replay = replay
            torch.cuda.synchronize()
            gcounts = ops.launch_counts()
            g_epochs = graphed["epochs"][1:]
            g_wall = sum(e["wall_s"] for e in g_epochs)
            total = n_steps * (1 + CLI_WARM_EPOCHS)
            print(json.dumps({
                "phase": "cli_warm_graph", "steps_per_dispatch": GRAPH_K, "epochs": len(g_epochs),
                "steps": sum(e["steps"] for e in g_epochs), "replays": replays[0],
                "epoch_wall_s": g_wall, "train_qa_pairs_per_s": n_train * len(g_epochs) / g_wall,
                "cli_warm_train_qa_pairs_per_s": n_train * len(epochs) / wall_s,
                "loader_wait_s": sum(e["loader_wait_s"] for e in g_epochs),
                "cli_warm_loader_wait_s": sum(e["loader_wait_s"] for e in epochs),
                "per_epoch": [{k: e[k] for k in ("epoch", "steps", "wall_s", "loader_wait_s")}
                              for e in graphed["epochs"]],
                "val_accuracy": [e["val_acc"] for e in g_epochs],
                "test_accuracy": graphed["tests"], "launches": gcounts}), flush=True)
            require(replays[0] == total - 1, f"cli graph: {replays[0]} replays, expected "
                                             f"{total - 1} (every step but the warm-up)")
            require(gcounts == wcounts, f"cli graph: launches {gcounts}, the eager run's "
                                        f"{wcounts}")
    finally:
        for handler in avqa.handlers:
            handler.close()
        avqa.handlers.clear()
        avqa.propagate = propagate
        if old_vocab is None:
            os.environ.pop("QA_TIGER_BPE_VOCAB", None)
        else:
            os.environ["QA_TIGER_BPE_VOCAB"] = old_vocab
    return counts


# ---------------------------------------------------------------------------
# phase 7: raw media to answer, and the extraction stages
# ---------------------------------------------------------------------------

SR = 16000
# one bf16 forward over B=2 videos of 60 frames: 24 CLIP image + 12 text
# blocks; 24 ToMe layers (23 with a key bias) + 7 in the QA-TIGER head
E2E_KERNELS = {"fused_attn_ln2": 36, "attention_wide": 31, "attention_wide_key_bias": 23,
               "fused_patch_select": 1, "fused_gaussian_moe": 2, "fused_avq_train": 0,
               "fused_avq_train_bwd": 0, "fused_patch_select_train": 0,
               "fused_patch_select_train_bwd": 0, **dict.fromkeys(OP_KERNELS, 0)}


def e2e_setup() -> dict:
    """The raw-media configuration: configs/qa-tiger/vitl14.py's model with
    CLIP ViT-L/14@336px, the ToMe vit_large_patch16_384 at r = [25]*23 and
    VGGish, as scripts/bench_e2e.py sets it up."""
    from qa_tiger_tpu_torch.models import qa_tiger_config
    from qa_tiger_tpu_torch.pipeline.e2e import e2e_config
    from qa_tiger_tpu_torch.utils.config import load_config_module

    hp = load_config_module(str(CONFIG))["hyper_params"]
    return e2e_config(qa_tiger_config(num_labels=42, **hp["model"]))


def _same_merge(a: dict, b: dict, i: int) -> list[int]:
    """Frame i's matching on two sides: [] when the unmerged set, the
    merged set and each merged token's destination agree, else the tokens
    where they differ."""
    import torch

    src_a, src_b = a["src"][i], b["src"][i]
    only = sorted(set(src_a.tolist()) ^ set(src_b.tolist()))
    if only or not torch.equal(a["unm"][i], b["unm"][i]):
        return only or sorted(set(a["unm"][i].tolist()) ^ set(b["unm"][i].tolist()))
    oa, ob = src_a.argsort(), src_b.argsort()
    differ = a["dst"][i][oa] != b["dst"][i][ob]
    return src_a[oa][differ].tolist()


def check_e2e_fp32(rng) -> None:
    """e2e_fp32_b1: the full-width towers with weights from seed 0, B=1
    video of T=2 frames from numpy, on the card against the same state on
    the CPU: the three feature streams and the logits within rtol 2e-3 /
    atol 5e-4, and every ToMe layer's matching equal. Also the size of the
    card's unordered scatter_add in a ToMe merge."""
    import copy

    import torch

    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch.models.vit import vit_forward
    from qa_tiger_tpu_torch.ops.tome import bipartite_soft_matching, merge_wavg
    from qa_tiger_tpu_torch.pipeline.e2e import e2e_forward, e2e_init, encode_media

    cfg = e2e_setup()
    cpu = e2e_init(cfg, seed=0, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    B, T_ = 1, 2
    media = [rng.standard_normal((B, T_, 336, 336, 3), dtype=np.float32),
             rng.standard_normal((B, T_, 384, 384, 3), dtype=np.float32),
             (0.1 * rng.standard_normal((B, T_, SR))).astype(np.float32)]
    toks = make_tokens(rng, B)

    @torch.inference_mode()
    def run(model, dev):
        clip, tome, pcm = (torch.from_numpy(a).to(dev) for a in media)
        feats = encode_media(model, clip, tome, pcm, cfg)
        feats["logits"] = e2e_forward(model, clip, tome, pcm, torch.from_numpy(toks).to(dev), cfg)
        merges = vit_forward(model.tome_vit, tome.flatten(0, 1), tome_r=cfg["tome_r"])["merges"]
        return ({k: v.float().cpu() for k, v in feats.items()},
                [{k: v.cpu() for k, v in m.items()} for m in merges])

    ops.reset_launches()
    got, got_m = run(card, "cuda")
    torch.cuda.synchronize()
    require_fp32_tensor_cores("e2e_fp32_b1")
    want, want_m = run(cpu, "cpu")
    errs = {k: (got[k] - want[k]).abs().max().item() for k in want}
    close = {k: bool(torch.allclose(got[k], want[k], **LOGITS_TOL)) for k in want}
    flips, gaps = [], []
    for layer, (gm, wm) in enumerate(zip(got_m, want_m)):
        r = wm["src"].shape[1]
        top = wm["score"].sort(dim=-1, descending=True).values
        gaps.append((top[:, r - 1] - top[:, r]).min().item())
        for i in range(wm["src"].shape[0]):
            tokens = _same_merge(gm, wm, i)
            if tokens:
                flips.append({"layer": layer, "frame": i, "a_tokens": tokens,
                              "card_scores": gm["score"][i, tokens].tolist(),
                              "cpu_scores": wm["score"][i, tokens].tolist()})

    # one ToMe merge at layer 1's shape: card twice, and card against CPU
    x = torch.from_numpy(rng.standard_normal((2 * T, 577, 1024), dtype=np.float32))
    metric = torch.from_numpy(rng.standard_normal((2 * T, 577, 64), dtype=np.float32))

    def merged(dev):
        merge, _ = bipartite_soft_matching(metric.to(dev), 25, class_token=True)
        return merge_wavg(merge, x.to(dev))[0].cpu()

    m1, m2, m_cpu = merged("cuda"), merged("cuda"), merged("cpu")
    ok = all(close.values()) and not flips and len(want_m) == 23
    print(json.dumps({"phase": "e2e_fp32_b1", "max_abs_err": errs, "allclose": close,
                      "max_abs_logit": want["logits"].abs().max().item(), **LOGITS_TOL,
                      "tome_layers_compared": len(want_m), "merge_flips": flips,
                      "min_boundary_score_gap": min(gaps),
                      "merge_scatter_add_card_run_to_run": (m1 - m2).abs().max().item(),
                      "merge_scatter_add_card_vs_cpu": (m1 - m_cpu).abs().max().item(),
                      "ok": ok}), flush=True)
    require(not flips, f"a ToMe matching differs between the card and the CPU: {flips[:3]}")
    require(ok, f"the fp32 raw-media forward on the card differs from the CPU run: {errs}")


def check_e2e_bf16(rng, profile_dir: Path | None) -> dict:
    """e2e_bf16_b2: scripts/bench_e2e.py's setting, B=2 videos x T=60
    frames, bf16 weights and pixels, fp32 PCM, one question per video,
    inputs made on the card from a seed. The launch counters are reset
    around one forward; then videos/s from the median of 10 forwards."""
    import torch

    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch.pipeline.e2e import e2e_forward, e2e_init

    cfg = e2e_setup()
    model = e2e_init(cfg, seed=0, dtype=torch.bfloat16)
    B, T_, bf = 2, T, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    clip = torch.randn(B, T_, 336, 336, 3, generator=g, device="cuda", dtype=bf)
    tome = torch.randn(B, T_, 384, 384, 3, generator=g, device="cuda", dtype=bf)
    pcm = 0.1 * torch.randn(B, T_, SR, generator=g, device="cuda")
    toks = torch.from_numpy(make_tokens(rng, B)).cuda()

    @torch.inference_mode()
    def forward():
        return e2e_forward(model, clip, tome, pcm, toks, cfg)

    forward()  # allocator and library warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    logits = forward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(json.dumps({"phase": "e2e_launches", **counts}), flush=True)
    for name, n in E2E_KERNELS.items():
        require(counts[name] == n, f"raw-media forward: {name} launched {counts[name]} times, "
                                   f"expected {n}")
    require_wgmma("e2e_gemm_routes")
    # the CLIP image tower's 24 blocks at 577 tokens (the text tower's 12 at
    # 77 read back nothing); ToMe's 24 layers (those past 128 tokens on the
    # Hopper kernel where its rule takes them), each named by its plan
    counts[SM90] = require_long_key_routes("e2e_bf16_b2", {
        "fused_attn_ln2": planned([(577, 577, 64, False)] * 24),
        "attention_wide": planned((n, n, 64, layer > 0) for layer, n in enumerate(TOME_TOKENS))})
    require(tuple(logits.shape) == (B, 42) and bool(torch.isfinite(logits).all()),
            "the bf16 raw-media logits are not finite [2, 42]")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        start = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    median = statistics.median(times)
    print(json.dumps({"phase": "e2e_bf16_b2", "forward_ms_median": median * 1e3,
                      "forward_ms_all": [t * 1e3 for t in times],
                      "videos_per_s": B / median, "frames_per_s": B * T_ / median,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
    if profile_dir is not None:
        profile_step(forward, profile_dir / "e2e_bf16_b2.txt", "profile_e2e")
    return counts


# the fp32 extraction stages' launches per call: the image towers' blocks
# and ToMe's 23 key-bias layers beside its first, the text tower's 12
# blocks a chunk of 256 texts
EXTRACT_LAUNCHES = {"clip": {"fused_attn_ln2": 24, "attention_wide": 0},
                    "tome": {"fused_attn_ln2": 0, "attention_wide": 24,
                             "attention_wide_key_bias": 23},
                    "questions": {"fused_attn_ln2": 12, "attention_wide": 0}}


def check_extract(rng, profile_dir: Path | None = None) -> None:
    """(c) The extraction stages' per-video encoders in fp32, through the
    stages' own model loading (random weights, the card), timed by
    ``chip_ab.time_extract`` (the code that times a parent checkout beside
    this one): ``clip`` (ViT-L/14@336px over one video's 60 frames),
    ``tome`` (ViT-L/16@384 with 23 merges of 25) and ``questions``
    (``encode_texts`` over 256 question texts), 2 warm-up calls, the median
    of 5, each between two synchronizes, and one profiled call each (its
    device busy time and idle share, ``extract_profile_<stage>``); the
    outputs' shapes ([60, 768], [60, 14, 1024], [256, 768]) and finiteness.
    After the warm-up the launch counters are reset around one call of each
    stage: its launches (``EXTRACT_LAUNCHES``), every fp32 product of
    fused_attn_ln2 on gemm_tf32x3 and no attention on an FMA kernel, as the
    launches read them back. Then the ``vggish`` stage's encoder on 60 s of
    PCM written to and read back from a wav."""
    import argparse
    import tempfile

    import torch
    from scipy.io import wavfile

    import chip_ab
    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch.pipeline import extract as E
    from qa_tiger_tpu_torch.pipeline.vggish import VGGish, vggish_embed_seconds

    def counted(name, fn):
        torch.cuda.synchronize()
        ops.reset_launches()
        fn()
        torch.cuda.synchronize()
        counts = {k: n for k, n in ops.launch_counts().items() if n}
        print(json.dumps({"phase": f"extract_{name}_launches", **counts}), flush=True)
        for kernel, n in EXTRACT_LAUNCHES[name].items():
            require(counts.get(kernel, 0) == n, f"extract {name}: {kernel} launched "
                                                f"{counts.get(kernel, 0)} times, expected {n}")
        require_fp32_tensor_cores(f"extract_{name}")

    with tempfile.TemporaryDirectory() as tmp:
        rows = chip_ab.time_extract(ROOT, profile_dir or Path(tmp), profile_step, counted)
    for name, shape in (("clip", [T, 768]), ("tome", [T, 14, 1024]),
                        ("questions", [chip_ab.EXTRACT_TEXTS, 768])):
        require(rows[name]["shape"] == shape and rows[name]["finite"],
                f"extract {name}: {rows[name]}, expected {shape}, finite")

    args = argparse.Namespace(weights=None, random_weights=True, device=None)
    with tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "video.wav"
        wavfile.write(wav, SR, (3000 * rng.standard_normal(SR * T)).astype(np.int16))
        model = E._load_params(args, VGGish)
        x = torch.from_numpy(E.read_seconds(wav, T)).cuda()
        with torch.inference_mode():
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = vggish_embed_seconds(model, x)
            torch.cuda.synchronize()
    line = {"phase": "extract", "vggish": {"shape": list(out.shape),
                                           "ms": (time.perf_counter() - start) * 1e3,
                                           "finite": bool(torch.isfinite(out).all())}}
    print(json.dumps(line), flush=True)
    require(tuple(out.shape) == (T, 128) and line["vggish"]["finite"],
            f"extract vggish: {line['vggish']}, expected {(T, 128)}, finite")


# ---------------------------------------------------------------------------
# phase 9: TSPM (configs/tspm/vitl14.py)
# ---------------------------------------------------------------------------

TSPM_CONFIG = ROOT / "configs" / "tspm" / "vitl14.py"
# attention_wide's calls per TSPM eval forward: AV_Attn's cross- and
# self-attention (one head of 512 over 60 frames, both directions as 2B
# rows), TokensAttn's self-attention (one head of 512 over 14 patches of the
# B x K selected frames), SpatioPerception's and QstTempGrd's two attn_ffn
# calls (4 heads of 128, one query); TemporalPerception asks for weights and
# runs the plain path
TSPM_ATTN_CALLS = 6
# (label, batch, Sq, Sk, width, heads) of those calls at B=256, and a
# 256-lane head over 577 keys
TSPM_ATTN_SHAPES = [("AV_Attn cross/self", 512, T, T, 512, 1),
                    ("TokensAttn self", 2560, P, P, 512, 1),
                    ("SpatioPerception attn_ffn", 2560, 1, P, 512, 4),
                    ("QstTempGrd attn_ffn", 256, 1, 10, 512, 4),
                    ("hd 256 over 577 keys", 120, 577, 577, 1024, 4)]
TSPM_LR = 1e-4


def tspm_attention_cases(dtype, rng):
    """attention_wide at TSPM's shapes: q, k and v as the model gives them
    (column slices of one packed qkv for the self-attentions, of a packed
    kv otherwise); SDPA on the same views. Bytes: q, k and v read once, the
    context written once."""
    import torch
    from torch.nn import functional as F

    from qa_tiger_tpu_torch.ops import attention as A

    isz = torch.tensor([], dtype=dtype).element_size()

    def rn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)

    cases = []
    for label, b, sq, sk, W, heads in TSPM_ATTN_SHAPES:
        hd = W // heads
        if sq == sk:
            buf = rn(b, sq, 3 * W)
            q, k, v = buf[..., :W], buf[..., W:2 * W], buf[..., 2 * W:]
        else:
            q, kv = rn(b, sq, W), rn(b, sk, 2 * W)
            k, v = kv[..., :W], kv[..., W:]
        sc = hd ** -0.5

        def sdpa(q=q, k=k, v=v, b=b, sq=sq, sk=sk, heads=heads, hd=hd, sc=sc):
            return F.scaled_dot_product_attention(
                q.view(b, sq, heads, hd).transpose(1, 2), k.view(b, sk, heads, hd).transpose(1, 2),
                v.view(b, sk, heads, hd).transpose(1, 2), scale=sc)

        cases.append(("attention_wide", f"{label}: q[{b},{sq},{W}] kv[{b},{sk},{W}] h{heads}",
                      lambda q=q, k=k, v=v, sc=sc, h=heads: A.attention_wide(q, k, v, None, sc, h),
                      lambda q=q, k=k, v=v, sc=sc, h=heads: A._wide_reference(q, k, v, None, sc, h),
                      sdpa, (2 * b * sq * W + 2 * b * sk * W) * isz, 4 * b * sq * sk * W,
                      {"attn": (sq, sk, hd), **attn_tally(dtype, sq, sk, hd, False),
                       **({"peak": "tf32x3"} if dtype == torch.float32 else {})}))
    return cases


# the kernels TSPM's attention calls must take, by dtype: in bf16 the wide
# tensor-core kernels (AV_Attn, the 577-key head: mma_wide; TokensAttn:
# mma_wide_short) and the short route (the four-head attn_ffn calls); in
# fp32 the lane split's 3xTF32 stages (the one-head calls and the 577-key
# head) and the keep-masked kernel without its keep mask (the four-head
# calls)
TSPM_ATTN_KERNELS = {"bfloat16": {"mma_wide", "mma_wide_short", "mma_short"},
                     "float32": {"lane_split", "mma_nokeep"}}


def check_tspm_attention(entries: dict) -> None:
    """Phase 9(a): attention_wide at TSPM's shapes in bf16 and fp32 against
    its plain version, timed beside its bound and SDPA, each line with the
    route and kernel the card's dispatch took (``TSPM_ATTN_KERNELS``) and
    the library's plan held to the Python one; plus one call with a causal
    mask and a key bias in each dtype (the wide-head kernel in fp32, the
    wide mma kernel in bf16), twice, bitwise the same. The lines go into
    attention_wide's table entry under ``tspm``."""
    import torch

    from qa_tiger_tpu_torch.ops import attention as A

    rng = np.random.default_rng(14)
    keys = ("shape", "dtype", "route", "attn_kernel", "smem_bytes", "max_abs_err", "ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by", "tflops")
    lines = []
    with torch.inference_mode():
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            for case in tspm_attention_cases(dtype, rng):
                line = run_kernel_case(case, dtype, tol, True, None)
                lines.append({k: line[k] for k in keys if k in line})
                if dtype == torch.float32:
                    require_repeat(case)
        b, sq, sk, W = 8, T, T, 512
        mask = torch.triu(torch.full((sq, sk), float("-inf"), device="cuda"), 1)
        kb = torch.from_numpy(np.log(rng.integers(1, 41, (b, sk))).astype(np.float32)).cuda()
        for dtype, tol, want in ((torch.float32, FP32_TOL, "wide"),
                                 (torch.bfloat16, BF16_TOL, "mma_wide")):
            q, k, v = (torch.from_numpy(rng.standard_normal((b, s, W), dtype=np.float32))
                       .to("cuda", dtype) for s in (sq, sk, sk))
            case = ("attention_wide", f"masked, key bias: q[{b},{sq},{W}] kv[{b},{sk},{W}] h1",
                    lambda q=q, k=k, v=v: A.attention_wide(q, k, v, mask, W ** -0.5, 1,
                                                           key_bias=kb),
                    lambda q=q, k=k, v=v: A._wide_reference(q, k, v, mask, W ** -0.5, 1, kb),
                    None, 0, 0, {"attn": (sq, sk, W), "attn_bias": True})
            line = run_kernel_case(case, dtype, tol, False, None)
            require(line["attn_kernel"] == want,
                    f"tspm attention, masked: kernel {line['attn_kernel']}, expected {want}")
            require_repeat(case)
    for dname, want in TSPM_ATTN_KERNELS.items():
        kernels = {ln["attn_kernel"] for ln in lines if ln["dtype"] == dname}
        require(want <= kernels, f"tspm attention {dname}: the kernels taken were {kernels}, "
                                 f"expected {sorted(want)}")
    entries["attention_wide"]["tspm"] = lines


def tspm_setup():
    """(the runner's config, TSPM's hyperparameters) of
    configs/tspm/vitl14.py: Adam at its betas, lr 1e-4."""
    from qa_tiger_tpu_torch.models import model_config
    from qa_tiger_tpu_torch.utils.config import load_config_module

    conf = load_config_module(str(TSPM_CONFIG))
    hp = conf["hyper_params"]
    cfg = {"log_interval": 1, "debug": False,
           "hyper_params": {"optim": dict(hp["optim"]), "sched": dict(hp["sched"])}}
    return cfg, model_config(hp["model_type"], hp["model"], num_labels=42)


def make_tspm_batch(rng, b: int, train: bool = False) -> dict:
    """Features at TSPM's widths: T=60 frames of P=14 patches, the question
    [B, 1, 768] and QA prompt [B, 768] as the text stages write them."""
    batch = {"audio": rng.standard_normal((b, T, 128), dtype=np.float32),
             "video": rng.standard_normal((b, T, 768), dtype=np.float32),
             "patch": rng.standard_normal((b, T, P, 1024), dtype=np.float32),
             "quest": rng.standard_normal((b, 1, 768), dtype=np.float32),
             "prompt": rng.standard_normal((b, 768), dtype=np.float32)}
    if train:
        batch.update(label=rng.integers(0, 42, b), qtype_label=rng.integers(0, 9, b),
                     valid=np.ones(b, bool))
    return batch


def check_tspm(profile_dir: Path | None) -> tuple[dict, dict]:
    """Phase 9(b)-(d). (b) tspm_fp32_b4: the eval forward at
    configs/tspm/vitl14.py's widths (weights from seed 0) on the card
    against the same state_dict through the plain versions on the CPU:
    logits within LOGITS_TOL, the top-K frames equal, and the smallest gap
    between the K-th and K+1-th temporal weight over the batch printed.
    (c) tspm_bf16_b256: ``bench``'s protocol (bf16, B=256, seed 0 weights
    and inputs, 3 warm-up calls, median of 3 repeats of 20 calls), the
    launch counters reset around one forward (attention_wide TSPM_ATTN_CALLS
    times, nothing else), the forward profiled with ``--profile``. (d)
    tspm_train_fp32_b32: the recipe (fp32, B=32, Adam, dropout on), the
    counters reset around one step (dropout sends every attention to the
    plain path: no kernel launches, as in the JAX package), the median of 10
    steps; then ``steps_per_dispatch`` 2 over 5 batches through the step's
    CUDA graph, bitwise the same static-input step run eagerly. Returns the
    counts of (c) and (d)."""
    import torch

    from qa_tiger_tpu_torch import bench, ops
    from qa_tiger_tpu_torch.models import TSPM
    from qa_tiger_tpu_torch.training import AVQARunner

    # (b) fp32 B=4, card against CPU
    cfg, mcfg = tspm_setup()
    card = TSPM(mcfg, seed=0).eval().cuda()
    cpu = TSPM(mcfg, seed=0).eval()
    batch = make_tspm_batch(np.random.default_rng(15), 4)
    with torch.inference_mode():
        ops.reset_launches()
        got = card({k: torch.from_numpy(v).cuda() for k, v in batch.items()}, aux=True)
        torch.cuda.synchronize()
        require_tensor_core_attention("tspm_fp32_b4_attn_routes")
        want = cpu({k: torch.from_numpy(v) for k, v in batch.items()}, aux=True)
    logits, ref = got["out"].float().cpu(), want["out"]
    err = (logits - ref).abs().max().item()
    idx_equal = torch.equal(got["topk_idx"].cpu(), want["topk_idx"])
    w = want["temporal_weights"][:, 0].sort(dim=-1, descending=True).values
    k = mcfg["topK"]
    gap = (w[:, k - 1] - w[:, k]).min().item()
    ok = bool(torch.allclose(logits, ref, **LOGITS_TOL)) and idx_equal
    print(json.dumps({"phase": "tspm_fp32_b4", "logits_max_abs_err": err,
                      "max_abs_logit": ref.abs().max().item(), **LOGITS_TOL,
                      "topk_equal": idx_equal, "smallest_topk_weight_gap": gap,
                      "argmax_equal": bool((logits.argmax(1) == ref.argmax(1)).all()),
                      "ok": ok}), flush=True)
    require(ok, f"tspm fp32: logits differ by {err:.3e} or the top-K frames differ "
                f"({idx_equal})")
    del card, cpu
    torch.cuda.empty_cache()

    # (c) bf16 B=256: bench's protocol, the counters around one forward
    net, dev_batch = bench.setup("tspm", "cuda")
    with torch.inference_mode():
        net(dev_batch)
        torch.cuda.synchronize()
        ops.reset_launches()
        out = net(dev_batch)["out"]
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(json.dumps({"phase": "tspm_launches", **counts}), flush=True)
    expected = dict.fromkeys(ops.KERNELS, 0)
    expected["attention_wide"] = TSPM_ATTN_CALLS
    require(counts == expected, f"tspm forward: launches {counts}, expected {expected}")
    require(tuple(out.shape) == (256, 42) and bool(torch.isfinite(out).all()),
            "tspm bf16 logits are not finite [256, 42]")
    torch.cuda.reset_peak_memory_stats()
    rate = bench.measure(net, dev_batch)
    print(json.dumps({"phase": "tspm_bf16_b256", "qa_per_s": rate["median"],
                      "qa_per_s_repeats": rate["rates"],
                      "forward_ms": 256 / rate["median"] * 1e3,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
    if profile_dir is not None:
        with torch.inference_mode():
            profile_step(lambda: net(dev_batch), profile_dir / "tspm_forward_bf16_b256.txt",
                         "profile_tspm")
    del net, dev_batch, out
    torch.cuda.empty_cache()

    # (d) the train recipe, fp32 B=32
    runner = AVQARunner(cfg, mcfg, device="cuda", seed=0)
    rng = np.random.default_rng(16)
    batch = runner.stage_batch(make_tspm_batch(rng, 32, train=True))
    gen = torch.Generator().manual_seed(1)
    before = {n: p.detach().clone() for n, p in runner.trainable()}
    losses = [runner.train_step(batch, TSPM_LR, gen)["total_loss"].item() for _ in range(3)]
    torch.cuda.synchronize()
    ops.reset_launches()
    losses.append(runner.train_step(batch, TSPM_LR, gen)["total_loss"].item())
    torch.cuda.synchronize()
    train_counts = ops.launch_counts()
    print(json.dumps({"phase": "tspm_train_step_launches", **train_counts}), flush=True)
    require(not any(train_counts.values()),
            f"tspm train step: kernel launches {train_counts}; dropout keeps every attention "
            "on the plain path")
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = runner.train_step(batch, TSPM_LR, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
        losses.append(out["total_loss"].item())
    median = statistics.median(times)
    changed = sum(int(not torch.equal(before[n], p.detach())) for n, p in runner.trainable())
    # no gradient reaches AV_Attn's two norms (no forward reads them), nor
    # TemporalPerception and input_qst_prompt (they only feed the discrete
    # top-K), as in the JAX model
    no_grad = sorted({n.rsplit(".", 1)[0] for n, p in runner.trainable() if p.grad is None})
    print(json.dumps({"phase": "tspm_train_fp32_b32", "step_ms_median": median * 1e3,
                      "step_ms_all": [t * 1e3 for t in times],
                      "train_qa_pairs_per_s": 32 / median, "losses": losses,
                      "params_changed": changed, "params": len(before),
                      "modules_without_gradient": no_grad,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
    require(all(np.isfinite(losses)), "a tspm train loss is not finite")
    n_no_grad = sum(p.grad is None for _, p in runner.trainable())
    require(changed == len(before) - n_no_grad and all(
        m.startswith(("AV_Attn.norm", "TemporalPerception.", "input_qst_prompt")) for m in no_grad),
        f"tspm: {changed} of {len(before)} parameters changed; without a gradient: {no_grad}")
    del runner, batch
    torch.cuda.empty_cache()

    # steps_per_dispatch 2: the graph against its eager twin, bitwise
    cfg["hyper_params"]["steps_per_dispatch"] = 2
    graph, eager = (AVQARunner(cfg, mcfg, device="cuda", seed=0) for _ in range(2))
    eager.graph_capture = False
    staged = [graph.stage_batch(make_tspm_batch(rng, 32, train=True)) for _ in range(5)]
    g_losses = run_windows(graph, staged, 2)
    e_losses = run_windows(eager, staged, 2)
    torch.cuda.synchronize()
    require_graph_equals_eager("tspm", graph, eager, g_losses, e_losses, len(staged) - 1)
    return counts, train_counts


def write_tspm_cli_config(path: Path, root: Path) -> Path:
    """configs/tspm/vitl14.py over the cli corpus and the features its text
    stages wrote: batch and eval batch 32, one epoch, no platform (the
    card)."""
    from qa_tiger_tpu_torch.utils.config import load_config_module

    cfg = load_config_module(str(TSPM_CONFIG)).to_dict()
    cfg["data"].update(root=str(root), batch_size=CLI_BATCH, eval_batch_size=CLI_BATCH,
                       num_workers=0, train_annot="train.json", valid_annot="val.json",
                       test_annot="test.json", ans_quelen="answer2idx.json",
                       audio_feat="vggish", video_feat="clip", patch_feat="tome",
                       quest_feat="qst", prompt_feat="prompt")
    cfg.update(epochs=1, output_dir=str(root / "out"))
    path.write_text(f"config = {cfg!r}\n")
    return path


def check_tspm_cli() -> dict:
    """Phase 9(e) tspm_cli, over the cli phase's corpus (the first 110 val
    questions, features at the real shapes, its learned merges file) in a
    temporary directory: the ``questions`` and ``prompts`` extraction stages
    (``python -m qa_tiger_tpu_torch.pipeline.extract`` through its
    ``main``, random CLIP-L/14@336px text weights, fp32 on the card) over
    each split's annotations, one [1, 768] feature per question_id, a
    second run writing nothing; then ``train.main`` for one epoch of TSPM
    and ``test.main`` on its best.npz, whose accuracy must be the train
    run's final test's. The launch counters are reset around the whole:
    fused_attn_ln2 12 per chunk of texts, attention_wide TSPM_ATTN_CALLS per
    eval forward (no train step launches one). Returns the counts."""
    import os
    import tempfile

    import torch

    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch import test as test_entry
    from qa_tiger_tpu_torch import train as train_entry
    from qa_tiger_tpu_torch.pipeline import extract as E

    avqa = logging.getLogger("AVQA")
    propagate = avqa.propagate
    avqa.propagate = False
    old_vocab = os.environ.get("QA_TIGER_BPE_VOCAB")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            write_cli_corpus(root)
            os.environ["QA_TIGER_BPE_VOCAB"] = str(root / "vocab.txt.gz")
            torch.cuda.synchronize()
            ops.reset_launches()
            line = {"phase": "tspm_cli"}
            start = time.perf_counter()
            chunks = 0
            for split, (lo, hi) in CLI_SPLITS.items():
                for stage, sub in (("questions", "qst"), ("prompts", "prompt")):
                    E.main([stage, "--annot", str(root / f"{split}.json"), "--dst",
                            str(root / sub), "--random-weights"])
                    chunks += -(-(hi - lo) // E.TEXT_CHUNK)
            torch.cuda.synchronize()
            line["stages_s"] = time.perf_counter() - start
            n_q = CLI_SPLITS["test"][1]
            for sub in ("qst", "prompt"):
                files = sorted((root / sub).glob("*.npy"))
                require(len(files) == n_q, f"tspm_cli: {len(files)} {sub} features, "
                                           f"expected {n_q}")
                arr = np.load(files[0])
                require(arr.shape == (1, 768) and bool(np.isfinite(arr).all()),
                        f"tspm_cli: a {sub} feature is {arr.shape}, expected finite [1, 768]")
            stamp = (root / "qst" / files[0].name).stat().st_mtime_ns
            E.main(["questions", "--annot", str(root / "train.json"), "--dst", str(root / "qst"),
                    "--random-weights"])
            require((root / "qst" / files[0].name).stat().st_mtime_ns == stamp,
                    "tspm_cli: the questions stage rewrote a feature it had written")

            cfg = write_tspm_cli_config(root / "tspm.py", root)
            start = time.perf_counter()
            summary = train_entry.main(["--config", str(cfg)])
            torch.cuda.synchronize()
            line["train_main_s"] = time.perf_counter() - start
            run = Path(summary["run_dir"])
            start = time.perf_counter()
            accs = test_entry.main(["--config", str(cfg), "--weight", str(run / "best.npz"),
                                    "--output_path", str(root / "eval")])
            torch.cuda.synchronize()
            line["test_main_s"] = time.perf_counter() - start
            counts = ops.launch_counts()
            epoch = summary["epochs"][0]
            n_steps = -(-(CLI_SPLITS["train"][1] - CLI_SPLITS["train"][0]) // CLI_BATCH)
            evals = 3  # validation, the final test, test.main
            line.update(chunks=chunks, steps=epoch["steps"], epoch_wall_s=epoch["wall_s"],
                        val_accuracy=epoch["val_acc"], test_accuracy=summary["tests"],
                        test_main_accuracy=accs, question_caches=summary["question_caches"],
                        launches=counts)
            print(json.dumps(line), flush=True)
            expected = dict.fromkeys(ops.KERNELS, 0)
            expected.update(fused_attn_ln2=12 * chunks,
                            attention_wide=TSPM_ATTN_CALLS * evals)
            require(counts == expected, f"tspm_cli: launches {counts}, expected {expected}")
            require(epoch["steps"] == n_steps, f"tspm_cli: {epoch['steps']} steps, expected "
                                               f"{n_steps}")
            require(accs == summary["tests"], f"tspm_cli: test.main gave {accs}, the train run's "
                                              f"final test {summary['tests']}")
    finally:
        avqa.propagate = propagate
        if old_vocab is None:
            os.environ.pop("QA_TIGER_BPE_VOCAB", None)
        else:
            os.environ["QA_TIGER_BPE_VOCAB"] = old_vocab
    return counts


# ---------------------------------------------------------------------------
# phase 8: the resblock micro-bench
# ---------------------------------------------------------------------------

BENCH_FNS = {"attn_half": "fused_attn_half", "attn_ln2": "fused_attn_ln2"}


def check_bench_resblock() -> dict:
    """``bench_resblock.main`` at its defaults for each ``--fn``, the launch
    counters reset just before and read just after each: its kernel
    launched once per layer of the warm-up chain and the timed ones, no
    other kernel. Returns the two runs' counts summed."""
    import torch

    from qa_tiger_tpu_torch import bench_resblock, ops

    total = dict.fromkeys(ops.KERNELS, 0)
    for fn, kernel in BENCH_FNS.items():
        torch.cuda.synchronize()
        ops.reset_launches()
        line = bench_resblock.main(["--fn", fn])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        expected = dict.fromkeys(ops.KERNELS, 0)
        expected[kernel] = (line["repeats"] + 1) * line["iters"]
        print(json.dumps({"phase": f"bench_resblock_{fn}_launches", **counts}), flush=True)
        require(counts == expected, f"bench_resblock --fn {fn}: launches {counts}, "
                                    f"expected {expected}")
        require(np.isfinite(line["value"]) and line["value"] > 0,
                f"bench_resblock --fn {fn}: no valid time")
        for name, n in counts.items():
            total[name] += n
    return total


# ---------------------------------------------------------------------------
# phase 10: the CLIP model surface
# ---------------------------------------------------------------------------

# path -> (encoder type, image pixels, fused_attn_ln2 launches per forward:
# the text tower's 12 blocks, and the ViT image tower's 24)
CLIP_CASES = {"clip_rn50": ("RN50", 224, 12), "clip_vitl336": ("ViT-L/14@336px", 336, 36)}
CLIP_FRAMES = 60  # one video's frames against its CLIP_PROMPTS answer prompts


def write_clip_checkpoint(encoder_type: str, path: Path, seed: int) -> None:
    """A CLIP ``.pt`` as the released archives hold one: OpenAI's names,
    fp16, the integer entries; the port's towers from ``seed``, an RN
    tower's BatchNorm statistics drawn at random (mean N(0, 0.1^2), var
    U(0.5, 1.5)) and its ``num_batches_tracked``."""
    import torch

    from qa_tiger_tpu_torch.models.clip_image import CLIPVisionTower
    from qa_tiger_tpu_torch.models.clip_resnet import CLIPResNetTower
    from qa_tiger_tpu_torch.models.clip_text import CLIPTextTower

    g = torch.Generator().manual_seed(seed)
    text = CLIPTextTower(encoder_type, g)
    resnet = encoder_type.startswith("RN")
    vision = (CLIPResNetTower if resnet else CLIPVisionTower)(encoder_type, seed=seed + 1)
    sd = {k: v.half() for k, v in text.state_dict().items()}
    for key, value in vision.state_dict().items():
        if key.endswith("running_mean"):
            value = 0.1 * torch.randn(value.shape, generator=g)
        elif key.endswith("running_var"):
            value = torch.rand(value.shape, generator=g) + 0.5
            sd["visual." + key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
        sd["visual." + key] = value.half()
    cfg = vision.cfg
    sd.update(input_resolution=torch.tensor(cfg["input_resolution"]),
              context_length=torch.tensor(S), vocab_size=torch.tensor(VOCAB))
    torch.save(sd, path)


def check_clip(profile_dir: Path | None) -> dict:
    """Phase 10, for RN50 (224 pixels, the 512-wide text tower) and
    ViT-L/14@336px: the seed towers written as a CLIP ``.pt``
    (``write_clip_checkpoint``) and read back by the entry points a user
    calls, ``models.clip.load`` and ``build_towers``. (a)
    ``<path>_fp32``: ``clip_forward`` on B=2 images x 4 texts on the card
    against the same state_dicts through the plain versions on the CPU,
    logits within LOGITS_TOL (TF32 off). (b) ``<path>_bf16``: one video's
    60 frames (drawn on the card) against 42 answer prompts, the launch
    counters reset around one forward (fused_attn_ln2 once per text and
    image block, its products on gemm_sm90, no other kernel), images/s from
    the median of 10 forwards, each between two synchronizes; profiled with
    ``--profile``. Returns each path's counts."""
    import tempfile

    import torch

    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch.models import clip

    paths = {}
    for path, (encoder_type, px, n_ln2) in CLIP_CASES.items():
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = Path(tmp) / "clip.pt"
            write_clip_checkpoint(encoder_type, ckpt, seed=0)
            text_sd, vision_sd, cfg = clip.load(str(ckpt))
        rng = np.random.default_rng(18)
        imgs = torch.from_numpy(rng.standard_normal((2, px, px, 3), dtype=np.float32))
        toks = torch.from_numpy(make_tokens(rng, 4))
        card = clip.build_towers(text_sd, vision_sd, encoder_type, device="cuda")
        cpu = clip.build_towers(text_sd, vision_sd, encoder_type, device="cpu")
        with torch.inference_mode():
            ops.reset_launches()
            got = clip.clip_forward(*card, imgs.cuda(), toks.cuda(), encoder_type=encoder_type)
            torch.cuda.synchronize()
            require_fp32_tensor_cores(f"{path}_fp32")
            want = clip.clip_forward(*cpu, imgs, toks, encoder_type=encoder_type)
        got, want = got[0].float().cpu(), want[0]
        err = (got - want).abs().max().item()
        ok = bool(torch.allclose(got, want, **LOGITS_TOL)) and tuple(got.shape) == (2, 4)
        print(json.dumps({"phase": f"{path}_fp32", "encoder_type": encoder_type,
                          "checkpoint_config": cfg, "logits_max_abs_err": err,
                          "max_abs_logit": want.abs().max().item(), **LOGITS_TOL,
                          "argmax_equal": bool((got.argmax(1) == want.argmax(1)).all()),
                          "ok": ok}), flush=True)
        require(ok, f"{path}: fp32 CLIP logits on the card differ from the CPU run by {err:.3e}")
        del card, cpu
        torch.cuda.empty_cache()

        towers = clip.build_towers(text_sd, vision_sd, encoder_type, device="cuda",
                                   dtype=torch.bfloat16)
        g = torch.Generator(device="cuda").manual_seed(19)
        frames = torch.randn(CLIP_FRAMES, px, px, 3, generator=g, device="cuda",
                             dtype=torch.bfloat16)
        prompts = torch.from_numpy(make_tokens(rng, CLIP_PROMPTS)).cuda()

        @torch.inference_mode()
        def forward():
            return clip.clip_forward(*towers, frames, prompts, encoder_type=encoder_type)

        forward()  # allocator and library warm-up
        torch.cuda.synchronize()
        ops.reset_launches()
        logits, _ = forward()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        routes = dict(ops.KERNELS["fused_attn_ln2"].gemm_routes)
        print(json.dumps({"phase": f"{path}_launches", **counts, "fused_attn_ln2_gemm_routes":
                          routes}), flush=True)
        expected = dict.fromkeys(ops.KERNELS, 0)
        expected["fused_attn_ln2"] = n_ln2
        require(counts == expected, f"{path}: launches {counts}, expected {expected}")
        require(routes == {"wgmma": 2 * n_ln2},
                f"{path}: fused_attn_ln2's products took {routes}, expected wgmma only")
        # ViT-L/14@336px's 24 image blocks at 577 tokens on the Hopper
        # kernel (the 12 text blocks at 77 read back nothing)
        counts[SM90] = require_long_key_routes(
            f"{path}_bf16", {"fused_attn_ln2": planned([(577, 577, 64, False)] * (n_ln2 - 12))})
        require(tuple(logits.shape) == (CLIP_FRAMES, CLIP_PROMPTS)
                and bool(torch.isfinite(logits).all()),
                f"{path}: bf16 logits are not finite [{CLIP_FRAMES}, {CLIP_PROMPTS}]")
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            start = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
        median = statistics.median(times)
        print(json.dumps({"phase": f"{path}_bf16", "forward_ms_median": median * 1e3,
                          "forward_ms_all": [t * 1e3 for t in times],
                          "images_per_s": CLIP_FRAMES / median,
                          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}),
              flush=True)
        if profile_dir is not None:
            profile_step(forward, profile_dir / f"{path}_bf16.txt", f"profile_{path}")
        paths[path] = counts
        del towers, frames
        torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# phase 11: the profiling and bench tools
# ---------------------------------------------------------------------------

def check_tools() -> None:
    """Each profiling and bench entry point once: ``python -m
    qa_tiger_tpu_torch.profile_stages --batch 256 --trace DIR`` in a process
    of its own (the sum of its stages beside FULL); ``trace_summary`` over
    that trace, whose launches by port kernel must equal the wrappers'
    ``launch_delta`` over the traced block (its JSON line), each launch with
    its device kernels in the trace (attention_wide's regions count the
    key-bias launches too, so attention_wide_key_bias has no row of its
    own); ``bench_avq`` at its defaults, the train kernels launched;
    ``bench_e2e --iters 2 --repeats 1``, these two through their ``main``.
    profile_stages runs apart because the profiler drops the first device
    events of a session, more the older the process (PERF.md §7): a fresh
    process's trace holds them all."""
    import tempfile

    import torch

    from qa_tiger_tpu_torch import bench_avq, bench_e2e, ops, profile_stages, trace_summary

    with tempfile.TemporaryDirectory() as tmp:
        seconds, out = run_entry(["-m", "qa_tiger_tpu_torch.profile_stages", "--batch", "256",
                                  "--trace", tmp], {})
        line = json.loads(out.strip().splitlines()[-1])
        summary = trace_summary.summarize(Path(tmp) / profile_stages.TRACE_FILE)
    traced = {name: [e["launches"], e["traced"]] for name, e in
              summary["port_launches"].items()}
    wrappers = {k: n for k, n in line["trace_launches"].items()
                if k != "attention_wide_key_bias"}
    print(json.dumps({"phase": "tools_profile_stages", "seconds": seconds,
                      "full_ms": line["full_ms"],
                      "sum_of_stages_ms": line["sum_ms"], "stages_ms": line["stages_ms"],
                      "wrapper_launches": line["trace_launches"],
                      "trace_summary_launches": traced,
                      "trace_busy_ms": summary["busy_ms"], "trace_window_ms": summary["window_ms"],
                      "trace_idle_share": summary["idle_share"]}), flush=True)
    require(bool(wrappers), "profile_stages --trace: no kernel launched in the traced block")
    for name in sorted(set(wrappers) | set(traced)):
        n = wrappers.get(name, 0)
        require(traced.get(name) == [n, n],
                f"tools: trace_summary holds {traced.get(name, [0, 0])} (regions, regions with "
                f"device kernels) of {name}, whose wrapper launched {n} times")

    torch.cuda.synchronize()
    ops.reset_launches()
    avq = bench_avq.main([])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(json.dumps({"phase": "tools_bench_avq", **avq,
                      "launches": {k: n for k, n in counts.items() if n}}), flush=True)
    require(counts["fused_avq_train"] > 0 and counts["fused_avq_train_bwd"] > 0
            and np.isfinite(avq["value"]) and avq["value"] > 0,
            f"bench_avq: no valid time or no train kernel launched ({counts})")
    e2e = bench_e2e.main(["--iters", "2", "--repeats", "1"])
    print(json.dumps({"phase": "tools_bench_e2e", **e2e}), flush=True)
    require(np.isfinite(e2e["value"]) and e2e["value"] > 0, "bench_e2e: no valid rate")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: data parallelism over torch.distributed, and the v2 config
# ---------------------------------------------------------------------------

DP_WORLD = 2
# the pair phase's train steps (3 up to PR 24: cut to pay for the Hopper
# attention kernel's build and lines in the run's time limit)
DP_STEPS = 2
DP_BATCH = 32      # the global batch, DP_BATCH // DP_WORLD rows per rank
# the eval set: 33 rows for rank 0 (batches of 16, 16, 1) and 32 for rank 1,
# whose third batch is all padding
DP_EVAL_N = 2 * 16 * 2 + 1
# dropout "off" with the train kernels on: keep = 1 - 1e-300 rounds to 1.0,
# so every mask of the AVQ and PatchSelecter sites is all ones (the two
# attention-dropout sites of QstGrounding and TempMoE are set to 0 apart)
DROPOUT_OFF = 1e-300
DP_TRAIN_KERNELS = ("fused_avq_train", "fused_avq_train_bwd", "fused_patch_select_train",
                    "fused_patch_select_train_bwd")
V2_CONFIG = ROOT / "configs" / "qa-tiger" / "vitl14_v2.py"
V2_SPLITS = ("test_balance.json", "test_bias.json")
V2_QUESTIONS = 64  # the first of each split


def _dp_entry(rank: int, world: int, tmp: str, fn, args) -> None:
    """A spawned rank: card 0 (NCCL refuses two ranks on one card, so the
    ranks share it over gloo), ``fn(rank, *args)``, its result saved for
    the parent."""
    import traceback

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        out = fn(rank, *args)
    except Exception:
        out = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{tmp}/rank{rank}.pt")


def dp_spawn(fn, *args, world: int = DP_WORLD, meanwhile=None):
    """``fn(rank, *args)`` on ``world`` ranks spawned on the card over gloo;
    their results in rank order. A rank that raised fails the phase. With
    ``meanwhile``, this process calls it while the ranks run (their
    collectives go through the host, so the card has room) and returns
    (the ranks' results, its result)."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    side = None
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_dp_entry, args=(world, tmp, fn, args), nprocs=world,
                                 join=False, start_method="spawn")
        try:
            side = meanwhile() if meanwhile is not None else None
        finally:
            while not ctx.join():
                pass
        outs = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(world)]
    for r, out in enumerate(outs):
        error = out.get("error") if isinstance(out, dict) else None
        require(error is None, f"rank {r} of {world} failed:\n{error}")
    return outs if meanwhile is None else (outs, side)


class ArrayDataset:
    """Rows of host arrays: what BatchLoader reads from a dataset, without
    files."""

    def __init__(self, arrays: dict):
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays["label"])

    def __getitem__(self, i: int) -> dict:
        return {k: v[i] for k, v in self.arrays.items()}


def dp_data() -> tuple[list, dict]:
    """DP_STEPS global train batches of DP_BATCH rows and the DP_EVAL_N eval
    rows, at the shipped widths, from numpy seed 20 (every process draws
    the same)."""
    rng = np.random.default_rng(20)
    train = [make_train_batch(rng, DP_BATCH) for _ in range(DP_STEPS)]
    evals = make_train_batch(rng, DP_EVAL_N)
    del evals["valid"]
    return train, evals


def dp_runner():
    """The recipe's runner (configs/qa-tiger/vitl14.py, fp32, the tower in
    bf16) from seed 0, ``gather_mode="paper"`` (no row's forward reads
    another's), dropout off with the train kernels on (DROPOUT_OFF)."""
    from qa_tiger_tpu_torch.models import modules
    from qa_tiger_tpu_torch.training import AVQARunner

    modules.ATTN_DROPOUT = 0.0
    cfg, mcfg = train_setup(gather_mode="paper")
    return AVQARunner(cfg, {**mcfg, "dropout": DROPOUT_OFF}, device="cuda", seed=0)


def dp_run(rank: int | None) -> dict:
    """``_run_eval`` over the eval rows (this rank's shard at 16 rows per
    batch, or the whole set at 32), then DP_STEPS train steps (this rank's
    rows of each global batch, or all of them) with the counters reset
    around each step: the eval counters, the losses, the per-step launches
    and milliseconds, the trainable parameters and their last gradients on
    the host. ``rank`` None: one process."""
    import torch

    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch.data import BatchLoader

    world = 1 if rank is None else DP_WORLD
    shard = 0 if rank is None else rank
    train, evals = dp_data()
    runner = dp_runner()
    loader = BatchLoader(ArrayDataset(evals), 2 * 16 // world, shard_id=shard, num_shards=world)
    torch.cuda.synchronize()
    ops.reset_launches()
    loss, cor, tot, cor9, tot9 = runner._run_eval(loader, debug=False)
    torch.cuda.synchronize()
    out = {"eval": [loss, cor, tot, [int(x) for x in cor9], [int(x) for x in tot9]],
           "eval_batches": len(loader), "eval_launches": ops.launch_counts(),
           "losses": [], "launches": [], "step_ms": []}
    for batch in train:
        rows = {k: v[shard::world] for k, v in batch.items()}
        torch.cuda.synchronize()
        ops.reset_launches()
        start = time.perf_counter()
        losses = runner.train_step(rows, TRAIN_LR, runner._step_generator)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - start) * 1e3)
        out["launches"].append(ops.launch_counts())
        out["losses"].append(losses["total_loss"].item())
    out["params"] = {n: p.detach().cpu() for n, p in runner.trainable()}
    out["grads"] = {n: p.grad.detach().cpu() for n, p in runner.trainable() if p.grad is not None}
    return out


def check_dp(pair: dict) -> tuple[dict, dict]:
    """Phases ``dp_eval`` and ``dp_train``: two ranks spawned on the card
    over gloo (which reduces CUDA tensors through the host: their times are
    no figure for NCCL) against one process on the same global batches.
    dp_eval: the all-reduced counters equal one process's, integers exactly,
    the loss within LOGITS_TOL, rank 1's last batch all padding. dp_train:
    the ranks' parameters bitwise equal; their losses and parameters (where
    the last gradient is above 1e-6) within LOGITS_TOL of the one process's
    DP_STEPS steps; each rank's launches per step those of the one process's
    step, each train kernel once (with the attention dropout off,
    QstGrounding's and TempMoE's attentions take ``attention_wide``: 4 per
    step where the dropout-on step of ``train_step_launches`` has 0).
    Returns (rank 0's eval counts, its last step's). The ranks' runs and
    one process's come from ``pair`` (``check_pair``)."""
    import torch

    ranks, single, dp_s = [r["dp"] for r in pair["ranks"]], pair["single"]["dp"], pair["seconds"]

    evals = [r["eval"] for r in ranks]
    loss, cor, tot, cor9, tot9 = single["eval"]
    eval_ok = all(e[1:] == [cor, tot, cor9, tot9] for e in evals) and tot == DP_EVAL_N
    loss_ok = all(np.isclose(e[0], loss, **LOGITS_TOL) for e in evals)
    print(json.dumps({"phase": "dp_eval", "world": DP_WORLD, "backend": "gloo",
                      "rows": DP_EVAL_N, "batches_per_rank": [r["eval_batches"] for r in ranks],
                      "ranks": evals, "single": single["eval"], "counters_equal": eval_ok,
                      "loss_close": loss_ok, **LOGITS_TOL}), flush=True)
    require(eval_ok and loss_ok, f"dp_eval: the ranks' counters {evals} differ from one "
                                 f"process's {single['eval']}")
    require(all(r["eval_batches"] == 3 for r in ranks), "dp_eval: the ranks' batch counts differ")

    r0, r1 = ranks
    bitwise = all(torch.equal(v, r1["params"][n]) for n, v in r0["params"].items())
    compared, worst = 0, 0.0
    params_ok = True
    for name, value in r0["params"].items():
        keep = single["grads"][name].abs() > 1e-6 if name in single["grads"] else None
        if keep is None or not keep.any():
            continue
        got, want = value[keep].numpy(), single["params"][name][keep].numpy()
        params_ok &= bool(np.allclose(got, want, **LOGITS_TOL))
        worst = max(worst, float(np.abs(got - want).max()))
        compared += 1
    losses_ok = all(np.allclose(r["losses"], single["losses"], **LOGITS_TOL) for r in ranks)
    print(json.dumps({"phase": "dp_train", "world": DP_WORLD, "backend": "gloo",
                      "global_batch": DP_BATCH, "steps": DP_STEPS,
                      "losses": [r["losses"] for r in ranks], "single_losses": single["losses"],
                      "ranks_bitwise_equal": bitwise, "params_compared": compared,
                      "params_max_abs_err": worst, **LOGITS_TOL,
                      "step_ms": [r["step_ms"] for r in ranks],
                      "single_step_ms": single["step_ms"], "spawn_and_run_s": dp_s}), flush=True)
    for rank, r in enumerate(ranks):
        print(json.dumps({"phase": "dp_train_launches", "rank": rank,
                          "per_step": r["launches"]}), flush=True)
        require(r["launches"] == single["launches"],
                f"dp_train: rank {rank} launched {r['launches']} per step, one process "
                f"{single['launches']}")
    for name in DP_TRAIN_KERNELS:
        require(all(c[name] == 1 for c in single["launches"]),
                f"dp_train: {name} did not launch once per step")
    require(bitwise, "dp_train: the ranks' parameters differ")
    require(losses_ok and params_ok and compared > 50,
            f"dp_train: the ranks differ from one process (losses {r0['losses']} vs "
            f"{single['losses']}, params max err {worst:.3e} over {compared})")
    return r0["eval_launches"], r0["launches"][-1]


def check_dp_graph() -> dict:
    """Phase ``dp_graph``: the recipe's graph step (``steps_per_dispatch``
    4, fp32 B=32, dropout on) in this process, plain and under an NCCL
    process group of world 1 (its graph holds the count and gradient
    all-reduces): two runners from seed 0 over the same staged batches, a
    warm-up window of 2 (the eager step, the capture) and then windows of 8
    replays timed per step, plain / group / plain; the two runners' losses
    over their first 10 steps bitwise equal. Returns the group runner's
    launches over one replay."""
    import tempfile

    import torch
    import torch.distributed as dist

    from qa_tiger_tpu_torch import ops, parallel

    rng = np.random.default_rng(21)
    plain = graph_runner()
    staged = [plain.stage_batch(make_train_batch(rng, 32)) for _ in range(10)]

    def window(runner, batches) -> tuple[float, list]:
        torch.cuda.synchronize()
        start = time.perf_counter()
        losses = runner.train_window(batches, TRAIN_LR)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3 / len(batches), losses

    _, p_losses = window(plain, staged[:2])
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1, device_id=torch.device("cuda", 0))
        try:
            require(parallel.backend() == "nccl", "dp_graph: no NCCL process group")
            grouped = graph_runner()
            _, g_losses = window(grouped, staged[:2])
            ms = {"plain": [], "nccl_world1": []}
            for runner, key, out in ((plain, "plain", p_losses), (grouped, "nccl_world1", g_losses),
                                     (plain, "plain", None)):
                t, losses = window(runner, staged[2:])
                ms[key].append(t)
                if out is not None:
                    out += losses
            torch.cuda.synchronize()
            ops.reset_launches()
            grouped.train_window(staged[:1], TRAIN_LR)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
        finally:
            dist.destroy_process_group()
    bitwise = all(torch.equal(a[k], b[k]) for a, b in zip(p_losses, g_losses) for k in a)
    print(json.dumps({"phase": "dp_graph", "steps_per_dispatch": GRAPH_K,
                      "window_ms_per_step": ms, "replays": grouped._step_graph.replays,
                      "losses_bitwise_equal": bitwise, "steps_compared": len(g_losses),
                      "launches": counts}), flush=True)
    require(bitwise and len(g_losses) == 10, "dp_graph: the group's graph step differs from "
                                             "the plain one")
    for name, n in TRAIN_KERNELS.items():
        require(counts[name] == n, f"dp_graph: a replay launched {name} {counts[name]} times, "
                                   f"expected {n}")
    del plain, grouped
    return counts


def run_entry(args: list, env: dict, timeout: float = 600) -> tuple[float, str]:
    """One entry point in a process of its own from the checkout's root;
    its seconds and its standard output. Fails the phase on a non-zero
    exit, with its stderr's end."""
    import os

    start = time.perf_counter()
    out = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout, env={**os.environ, "PYTHONPATH": str(ROOT), **env})
    require(out.returncode == 0, f"{' '.join(args[:4])} exited {out.returncode}:\n"
                                 f"{out.stderr[-3000:]}")
    return time.perf_counter() - start, out.stdout


def run_main(main, argv: list, env: dict) -> float:
    """An entry point's ``main(argv)`` in this process with ``env`` set, its
    log kept off this script's output; its seconds."""
    import os

    avqa = logging.getLogger("AVQA")
    propagate, saved = avqa.propagate, {k: os.environ.get(k) for k in env}
    avqa.propagate = False
    os.environ.update(env)
    start = time.perf_counter()
    try:
        main(argv)
    finally:
        for handler in avqa.handlers:
            handler.close()
        avqa.handlers.clear()
        avqa.propagate = propagate
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    return time.perf_counter() - start


def check_dp_cli() -> None:
    """Phase ``dp_cli``: over the cli corpus at the recipe's widths and
    ``steps_per_dispatch`` 4, ``python -m torch.distributed.run
    --nproc-per-node 1 -m qa_tiger_tpu_torch.train --distributed`` (NCCL at
    world 1: the captured step holds the NCCL all-reduces), then ``test
    --distributed`` on its best.npz, then the same train without
    ``--distributed`` through ``train.main`` in this process (no process
    group): the final test's report lines of all three equal, and the
    data-parallel run wrote exactly one best.npz."""
    import socket
    import tempfile

    from qa_tiger_tpu_torch import train as train_entry

    def torchrun(module: str, *args: str) -> list:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        return ["-m", "torch.distributed.run", "--nproc-per-node", "1", "--master-addr",
                "localhost", "--master-port", str(port), "-m", module, *args, "--distributed"]

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_cli_corpus(root)
        env = {"QA_TIGER_BPE_VOCAB": str(root / "vocab.txt.gz")}
        seconds = {}
        cfg_dp = write_cli_config(root / "dp.py", root, steps_per_dispatch=GRAPH_K,
                                  output_dir=str(root / "out_dp"))
        seconds["train_dp"] = run_entry(torchrun("qa_tiger_tpu_torch.train", "--config",
                                                 str(cfg_dp)), env)[0]
        bests = sorted((root / "out_dp").rglob("best.npz"))
        require(len(bests) == 1, f"dp_cli: {len(bests)} best.npz written, expected 1")
        seconds["test_dp"] = run_entry(torchrun(
            "qa_tiger_tpu_torch.test", "--config", str(cfg_dp), "--weight", str(bests[0]),
            "--output_path", str(root / "eval_dp")), env)[0]
        cfg_one = write_cli_config(root / "one.py", root, steps_per_dispatch=GRAPH_K,
                                   output_dir=str(root / "out_one"))
        seconds["train_single_in_process"] = run_main(train_entry.main, ["--config", str(cfg_one)],
                                                      env)
        dp_lines = report_lines(bests[0].parent / "log.txt")
        test_lines = report_lines(root / "eval_dp" / "best_result.txt")
        one_lines = report_lines(next((root / "out_one").rglob("log.txt")))
        print(json.dumps({"phase": "dp_cli", "world": 1, "backend": "nccl",
                          "steps_per_dispatch": GRAPH_K, "seconds": seconds,
                          "report": dp_lines[-1:], "test_report": test_lines[-1:],
                          "single_report": one_lines[-1:],
                          "equal": dp_lines == test_lines == one_lines}), flush=True)
        require(len(dp_lines) == 13 and dp_lines == test_lines == one_lines,
                f"dp_cli: the reports differ: {dp_lines[-1:]}, {test_lines[-1:]}, "
                f"{one_lines[-1:]}")


def write_v2_corpus(root: Path) -> list[str]:
    """The first V2_QUESTIONS of each MUSIC-AVQA-v2.0 test split with its
    own answer vocabulary, fp32 features at the real shapes for their videos
    from numpy seed 0, a merges file learned from the questions; returns the
    video ids."""
    spec = importlib.util.spec_from_file_location("torch_corpus",
                                                  ROOT / "tests" / "torch_corpus.py")
    corpus = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(corpus)
    src, dst = ROOT / "data" / "annots" / "music_avqa_v2", root / "annots" / "music_avqa_v2"
    dst.mkdir(parents=True)
    questions = []
    for name in V2_SPLITS:
        part = json.loads((src / name).read_text())[:V2_QUESTIONS]
        (dst / name).write_text(json.dumps(part))
        questions += part
    (dst / "answer2idx.json").write_text((src / "answer2idx.json").read_text())
    corpus.write_merges(root / "vocab.txt.gz", [q["question_content"] for q in questions])
    rng = np.random.default_rng(0)
    videos = sorted({q["video_id"] for q in questions})
    shapes = {"feats/vggish": (T, 128), "feats/clip_feats/1fps": (T, 768),
              "feats/visual_tome14_60": (T, P, 1024)}
    for rel, shape in shapes.items():
        (root / rel).mkdir(parents=True)
        for vid in videos:
            np.save(root / rel / f"{vid}.npy", rng.standard_normal(shape, dtype=np.float32))
    return videos


def check_cli_v2() -> dict:
    """Phase ``cli_v2``: the port's ``test`` entry point with
    configs/qa-tiger/vitl14_v2.py as shipped (its model at full width, batch
    32, weights from the seed), over the first V2_QUESTIONS of both of its
    test splits, the counters reset around it: each split's accuracy, the
    seconds; every eval kernel launched."""
    import os
    import tempfile

    import torch

    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch import test as test_entry

    avqa = logging.getLogger("AVQA")
    propagate = avqa.propagate
    avqa.propagate = False
    old_vocab = os.environ.get("QA_TIGER_BPE_VOCAB")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            videos = write_v2_corpus(root)
            os.environ["QA_TIGER_BPE_VOCAB"] = str(root / "vocab.txt.gz")
            cfg = root / "v2.py"
            cfg.write_text(
                "import importlib.util\n"
                f"_spec = importlib.util.spec_from_file_location('v2', {str(V2_CONFIG)!r})\n"
                "_mod = importlib.util.module_from_spec(_spec)\n"
                "_spec.loader.exec_module(_mod)\n"
                "config = _mod.config\n"
                f"config['data'].update(root={str(root)!r}, num_workers=0)\n")
            torch.cuda.synchronize()
            ops.reset_launches()
            start = time.perf_counter()
            accs = test_entry.main(["--config", str(cfg), "--output_path", str(root / "eval")])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            counts = ops.launch_counts()
            lines = report_lines(root / "eval" / "_result.txt")
    finally:
        for handler in avqa.handlers:
            handler.close()
        avqa.handlers.clear()
        avqa.propagate = propagate
        if old_vocab is None:
            os.environ.pop("QA_TIGER_BPE_VOCAB", None)
        else:
            os.environ["QA_TIGER_BPE_VOCAB"] = old_vocab
    print(json.dumps({"phase": "cli_v2", "config": str(V2_CONFIG.relative_to(ROOT)),
                      "splits": list(V2_SPLITS), "questions_per_split": V2_QUESTIONS,
                      "videos": len(videos), "accuracy": accs, "seconds": seconds,
                      "launches": counts}), flush=True)
    require(len(accs) == len(V2_SPLITS) and len(lines) == 13 * len(V2_SPLITS)
            and all(np.isfinite(a) and 0 <= a <= 100 for a in accs),
            f"cli_v2: {len(accs)} splits and {len(lines)} report lines")
    for name in EVAL_KERNELS:
        require(counts[name] > 0, f"cli_v2: {name} did not launch")
    return counts


# ---------------------------------------------------------------------------
# phase 13: tensor parallelism of the eval forward
# ---------------------------------------------------------------------------

TP_SIZES = (2, 4)
# one rank's launches per eval forward under dp1 x tp2: one process's
TP_KERNELS = {"fused_attn_ln2": 12, "attention_wide": 7, "fused_patch_select": 1,
              "fused_gaussian_moe": 2}
# per rank and forward: 12 blocks x (partial, post); PatchSelecter's six
# stages once; the two MoE partials
TP_STAGE_COUNTS = {"fused_attn_ln2_partial": 12, "fused_attn_ln2_post": 12,
                   "fused_patch_select_tp_self": 1, "fused_patch_select_tp_self_post": 1,
                   "fused_patch_select_tp_cross": 1, "fused_patch_select_tp_cross_post": 1,
                   "fused_patch_select_tp_mlp": 1, "fused_patch_select_tp_out": 1,
                   "fused_gaussian_moe_partial": 2}
TP_EVAL_B = (4, 256)  # fp32, bf16


def _repeat_equal(fn) -> bool:
    import torch

    a, b = fn(), fn()
    a = [a] if torch.is_tensor(a) else list(a)
    b = [b] if torch.is_tensor(b) else list(b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _tp_stage(case, dtype, tol, timed: bool, lines: list):
    """One stage on one rank against its plain version (``run_kernel_case``);
    timed on one rank per shape, where it must also repeat bitwise. Returns
    the kernel's output."""
    import torch

    line = run_kernel_case(case, dtype, tol, timed, None)
    if timed:
        require(_repeat_equal(case[2]), f"{case[0]} {case[1]}: two launches differ")
        lines.append({k: line[k] for k in ("kernel", "dtype", "shape", "max_abs_err", "ms",
                                           "plain_ms", "library_ms", "bound_ms", "bound_by",
                                           "gemm_route", "route") if k in line})
    out = case[2]()
    torch.cuda.synchronize()
    return out


def _tp_sum(parts: list):
    """The partials summed in rank order, as a model group's all-reduce
    leaves them."""
    total = parts[0].clone()
    for part in parts[1:]:
        total += part
    return total


def _tp_against_tp1(name: str, tp: int, dtype, tol: float, got, want, tp1_ms: float | None,
                    lines: list) -> None:
    err, scale = max_err(got, want)
    ok = err <= tol * max(1.0, scale)
    line = {"phase": "tp_chain", "kernel": name, "tp": tp,
            "dtype": str(dtype).replace("torch.", ""), "max_abs_err_vs_tp1": err,
            "max_abs_tp1": scale, "tolerance": tol * max(1.0, scale), "ok": ok,
            "tp1_ms": tp1_ms, "stages": lines}
    print(json.dumps(line), flush=True)
    require(ok, f"{name} tp{tp} {line['dtype']}: the summed shards differ from the single-rank "
                f"kernel by {err:.3e}")


def tp_attn_ln2(tp: int, dtype, B: int, tol: float, timed: bool, rng, gen) -> dict:
    """fused_attn_ln2 at the text tower's block (x[B, 77, 768], 12 heads,
    causal) split over tp ranks: each rank's partial against its plain
    version, the partials summed, the post-reduce launch against its plain
    version and then (y, h) against the single-rank kernel."""
    import torch

    from qa_tiger_tpu_torch.models.clip_text import ResidualAttentionBlock, causal_mask
    from qa_tiger_tpu_torch.ops import resblock as R
    from qa_tiger_tpu_torch.ops.epilogue import reduce_epilogue_plain
    from qa_tiger_tpu_torch.nn.core import layer_norm
    from qa_tiger_tpu_torch.parallel import Grid, shard_module_

    W, H = 768, 12
    Wl, heads, M = W // tp, H // tp, B * S
    isz = torch.tensor([], dtype=dtype).element_size()
    blk = ResidualAttentionBlock(W, 12, gen).to("cuda", dtype)
    x = torch.from_numpy(rng.standard_normal((B, S, W), dtype=np.float32)).to("cuda", dtype)
    mask = causal_mask(S, device="cuda")
    want = R.fused_attn_ln2(x, blk, mask, H)
    tp1_ms = cuda_ms(lambda: R.fused_attn_ln2(x, blk, mask, H)) if timed else None
    lines, parts = [], []
    for r in range(tp):
        shard = shard_module_(copy.deepcopy(blk), Grid(model_rank=r, model_size=tp))
        params = [shard.ln_1.weight, shard.ln_1.bias, shard.attn.in_proj_weight,
                  shard.attn.in_proj_bias, shard.attn.out_proj.weight]
        case = ("fused_attn_ln2_partial", f"x[{B},{S},{W}] causal tp{tp} rank{r} h{heads}",
                lambda s=shard: R.fused_attn_ln2_partial(x, s, mask, heads),
                lambda p=params: R._attn_partial_flat(x, *p, heads=heads, mask=mask), None,
                (M * W + 2 * W + 4 * Wl * W + 3 * Wl) * isz + M * W * 4 + S * S * 4,
                2 * M * 3 * Wl * W + 2 * B * Wl * S * (S + 1) + 2 * M * W * Wl,
                {"attn": (S, S, Wl // heads), "attn_bias": True,
                 "gemm": [(M, 3 * Wl, W), (M, W, Wl)]})
        parts.append(_tp_stage(case, dtype, tol, timed and r == 0, lines))
    total = _tp_sum(parts)

    def plain_post():
        y = reduce_epilogue_plain(total, blk.attn.out_proj.bias, res=x, dtype=dtype)
        return y, layer_norm(y, blk.ln_2.weight, blk.ln_2.bias)

    case = ("fused_attn_ln2_post", f"x[{B},{S},{W}] tp{tp}",
            lambda: R.fused_attn_ln2_post(x, total, blk), plain_post, None,
            M * W * 4 + 3 * M * W * isz + 3 * W * isz, 0, {})
    got = _tp_stage(case, dtype, tol, timed, lines)
    _tp_against_tp1("fused_attn_ln2", tp, dtype, tol, got, want, tp1_ms, lines)
    return {"stages": lines, "tp1_ms": tp1_ms}


def tp_patch_select(tp: int, dtype, B: int, tol: float, timed: bool, rng, gen) -> dict:
    """fused_patch_select (patch[B, 60, 14, 512], 8 heads) split over tp
    ranks in its three stages and their epilogues, each against its plain
    version, then (a, v) against the single-rank kernel."""
    import torch
    from torch.nn import functional as F

    from qa_tiger_tpu_torch.models.modules import PatchSelecter
    from qa_tiger_tpu_torch.nn.core import layer_norm, linear
    from qa_tiger_tpu_torch.ops import patch_select as PS
    from qa_tiger_tpu_torch.ops.epilogue import reduce_epilogue_plain
    from qa_tiger_tpu_torch.parallel import Grid, shard_module_

    D, H = 512, 8
    Wl, Hl, heads = D // tp, D // 2 // tp, H // tp
    BT = B * T
    M, Q = BT * P, 2 * BT
    isz = torch.tensor([], dtype=dtype).element_size()
    # every stage's products, planned as the single-rank kernel's
    route = "tf32x3" if dtype == torch.float32 else "wgmma"

    def rn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)

    ps = PatchSelecter(D, gen).to("cuda", dtype)
    patch, audio, video = rn(B, T, P, D), rn(B, T, D), rn(B, T, D)
    want = PS.fused_patch_select(patch, audio, video, ps, H)
    tp1_ms = cuda_ms(lambda: PS.fused_patch_select(patch, audio, video, ps, H)) if timed else None
    shards = [shard_module_(copy.deepcopy(ps), Grid(model_rank=r, model_size=tp))
              for r in range(tp)]
    lines = []
    label = f"patch[{B},{T},{P},{D}] tp{tp}"
    attn_w = (4 * Wl * D + 3 * Wl) * isz

    def stage(name, kernel, plain, nbytes, flops, extra):
        parts = [_tp_stage((name, f"{label} rank{r} h{heads}", lambda s=s: kernel(s),
                            lambda s=s: plain(s), None, nbytes, flops, extra),
                           dtype, tol, timed and r == 0, lines)
                 for r, s in enumerate(shards)]
        return _tp_sum(parts)

    def post(name, kernel, plain, nbytes):
        return _tp_stage((name, label, kernel, plain, None, nbytes, 0, {}), dtype, tol, timed,
                         lines)

    total = stage("fused_patch_select_tp_self",
                  lambda s: PS.fused_patch_select_tp_self(patch, s.slf_attn, heads),
                  lambda s: PS._tp_self_plain(patch, s.slf_attn.in_proj_weight,
                                              s.slf_attn.in_proj_bias,
                                              s.slf_attn.out_proj.weight, heads),
                  M * D * isz + attn_w + M * D * 4,
                  2 * M * 3 * Wl * D + 4 * BT * P * P * Wl + 2 * M * D * Wl,
                  {"attn": (P, P, Wl // heads), "want_route": short_route(dtype),
                   "tally": PS.fused_patch_select_tp_self,
                   "want_tally": {"gemm_routes": {route: 2},
                                  "attn_routes": {short_route(dtype): 1}}})
    bias = ps.slf_attn.out_proj.bias
    x1 = post("fused_patch_select_tp_self_post",
              lambda: PS.fused_patch_select_tp_self_post(total, patch, bias),
              lambda: reduce_epilogue_plain(total, bias, res=patch, dtype=dtype),
              M * D * 4 + 2 * M * D * isz + D * isz)
    total = stage("fused_patch_select_tp_cross",
                  lambda s: PS.fused_patch_select_tp_cross(x1, audio, video, s.crs_attn, heads),
                  lambda s: PS._tp_cross_plain(x1, audio, video, s.crs_attn.in_proj_weight,
                                               s.crs_attn.in_proj_bias,
                                               s.crs_attn.out_proj.weight, heads),
                  (M * D + Q * D) * isz + attn_w + Q * D * 4,
                  2 * M * 2 * Wl * D + 2 * Q * Wl * D + 4 * Q * P * Wl + 2 * Q * D * Wl,
                  {"attn": (2, P, Wl // heads), "want_route": short_route(dtype),
                   "tally": PS.fused_patch_select_tp_cross,
                   "want_tally": {"gemm_routes": {route: 3},
                                  "attn_routes": {short_route(dtype): 1}}})
    bias = ps.crs_attn.out_proj.bias
    crs = post("fused_patch_select_tp_cross_post",
               lambda: PS.fused_patch_select_tp_cross_post(total, bias, dtype),
               lambda: reduce_epilogue_plain(total, bias, dtype=dtype),
               Q * D * 4 + Q * D * isz + D * isz)
    total = stage("fused_patch_select_tp_mlp",
                  lambda s: PS.fused_patch_select_tp_mlp(crs, s.mlp),
                  lambda s: F.linear(torch.relu(linear(crs, s.mlp[0].weight, s.mlp[0].bias))
                                     .float(), s.mlp[2].weight.float()),
                  (Q * D + 2 * Hl * D + Hl) * isz + Q * D * 4, 4 * Q * Hl * D,
                  {"tally": PS.fused_patch_select_tp_mlp,
                   "want_tally": {"gemm_routes": {route: 2}}})

    def plain_out():
        out = total + ps.mlp[2].bias.float()
        return (layer_norm(out[:, :, 1], ps.anorm.weight, ps.anorm.bias).to(dtype),
                layer_norm(out[:, :, 0], ps.vnorm.weight, ps.vnorm.bias).to(dtype))

    got = post("fused_patch_select_tp_out",
               lambda: PS.fused_patch_select_tp_out(total.clone(), ps.mlp[2].bias, ps.anorm,
                                                    ps.vnorm, dtype),
               plain_out, Q * D * 4 + Q * D * isz + 5 * D * isz)
    _tp_against_tp1("fused_patch_select", tp, dtype, tol, got, want, tp1_ms, lines)
    return {"stages": lines, "tp1_ms": tp1_ms}


def tp_moe(tp: int, dtype, b: int, tol: float, timed: bool, rng) -> dict:
    """fused_gaussian_moe (x[b, 60, 512], E 7, H 256) split over tp ranks'
    hidden columns (H/tp each; at tp 4 E*H/tp = 448 leaves a ragged
    128-column tile): each rank's fp32 partial (no b2 term) against its
    plain version, then the sum plus b2's term rounded once against the
    single-rank kernel."""
    import torch

    from qa_tiger_tpu_torch.ops import gaussian_moe as G

    D, E, H = 512, 7, 256
    Hl = H // tp
    isz = torch.tensor([], dtype=dtype).element_size()

    def rn(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape, dtype=np.float32))).to("cuda", dtype)

    w1t, b1 = rn(E, D, H, scale=0.05), rn(E, H, scale=0.1)
    w2t, b2 = rn(E, H, D, scale=0.05), rn(E, D, scale=0.1)
    xm = rn(b, T, D)
    w = torch.from_numpy(0.05 * rng.random((b, E, T), dtype=np.float32)).to("cuda", dtype)
    want = G.fused_gaussian_moe(xm, w1t, b1, w2t, b2, w)
    tp1_ms = cuda_ms(lambda: G.fused_gaussian_moe(xm, w1t, b1, w2t, b2, w)) if timed else None
    lines, parts = [], []
    peak = "tf32x3" if dtype == torch.float32 else "bfloat16"
    for r in range(tp):
        cols = slice(r * Hl, (r + 1) * Hl)
        shard = (w1t[:, :, cols].contiguous(), b1[:, cols].contiguous(),
                 w2t[:, cols].contiguous())
        case = ("fused_gaussian_moe_partial", f"x[{b},{T},{D}] E{E} H{Hl} tp{tp} rank{r}",
                lambda s=shard: G.fused_gaussian_moe_partial(xm, *s, w),
                lambda s=shard: G._partial_f32(xm, *s, w), None,
                (b * T * D + b * E * T + 2 * E * D * Hl + E * Hl) * isz + b * D * 4,
                2 * b * T * E * D * Hl + 2 * b * E * T * Hl + 2 * b * E * Hl * D,
                {"routes": sorted({G.moe_route(dtype, D), "tf32x3"}), "peak": peak})
        parts.append(_tp_stage(case, dtype, tol, timed and r == 0, lines))
    # b2's term added after the sum, on every rank alike
    got = (_tp_sum(parts) + G.bias_term(b2, w)).to(dtype)
    _tp_against_tp1("fused_gaussian_moe", tp, dtype, tol, got, want, tp1_ms, lines)
    return {"stages": lines, "tp1_ms": tp1_ms}


def check_tp_kernels(entries: dict) -> None:
    """The tensor-parallel forms of fused_attn_ln2, fused_patch_select and
    fused_gaussian_moe at full width, tp 2 and 4, in bf16 at the serving
    shapes (timed; the MoE at the visual streams' x[512]) and in fp32 at a
    small batch: each stage on each rank against its plain version, the
    shards summed in rank order, the epilogue, and the result against the
    single-rank kernel (BF16_TOL / FP32_TOL). The timed lines go into each
    kernel's table entry under ``tp``."""
    import torch

    rng = np.random.default_rng(18)
    gen = torch.Generator().manual_seed(18)
    with torch.inference_mode():
        for dtype, B, tol, timed in ((torch.float32, 2, FP32_TOL, False),
                                     (torch.bfloat16, 256, BF16_TOL, True)):
            for tp in TP_SIZES:
                runs = {"fused_attn_ln2": tp_attn_ln2(tp, dtype, B, tol, timed, rng, gen),
                        "fused_patch_select": tp_patch_select(tp, dtype, B, tol, timed, rng,
                                                              gen),
                        "fused_gaussian_moe": tp_moe(tp, dtype, 2 * B, tol, timed, rng)}
                if timed:
                    for name, run in runs.items():
                        entries[name].setdefault("tp", {})[f"tp{tp}"] = run
            torch.cuda.empty_cache()


def tp_model(grid, dtype):
    """The vitl14 QA-TIGER from seed 0 (gather_mode "paper"), this rank's
    shards under ``grid`` (whole without one), on the card in ``dtype``."""
    import torch

    from qa_tiger_tpu_torch.models import QATiger
    from qa_tiger_tpu_torch.parallel import shard_module_

    _, mcfg = train_setup(gather_mode="paper")
    model = QATiger(mcfg, seed=0).eval()
    if grid is not None:
        shard_module_(model, grid)
    return model.to("cuda", dtype)


def tp_forward(grid) -> dict:
    """The eval forward at fp32 B=4 and bf16 B=256 (one model, cast to bf16
    after the fp32 forward; features from numpy seed 21, the same in every
    process), the launch counters reset around each: the logits on the
    host, the launches and the stage launches."""
    import torch

    from qa_tiger_tpu_torch import ops

    out = {}
    model = tp_model(grid, torch.float32)
    for dtype, B in zip((torch.float32, torch.bfloat16), TP_EVAL_B):
        model = model.to(dtype)
        batch = {k: torch.from_numpy(v).to(device="cuda",
                                            dtype=dtype if v.dtype == np.float32 else None)
                 for k, v in make_batch(np.random.default_rng(21), B).items()}
        kw = {} if grid is None else {"grid": grid}
        with torch.no_grad():
            model(batch, **kw)  # warm-up
            torch.cuda.synchronize()
            ops.reset_launches()
            start = time.perf_counter()
            logits = model(batch, **kw)["out"]
            torch.cuda.synchronize()
        out[str(dtype).replace("torch.", "")] = {
            "logits": logits.float().cpu(), "launches": ops.launch_counts(),
            "stages": ops.stage_counts(), "ms": (time.perf_counter() - start) * 1e3,
            "routes": {n: dict(f.gemm_routes) for n, f in ops.TP_STAGES.items()
                       if getattr(f, "gemm_routes", None)}}
    del model
    torch.cuda.empty_cache()
    return out


def tp_grid_rank(rank: int) -> dict:
    """A spawned rank of ``tp_grid``: dp2 x tp2, ``_run_eval`` over the
    DP_EVAL_N rows, this data rank's shard at 32 // data_size rows per
    batch."""
    import torch

    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch.data import BatchLoader
    from qa_tiger_tpu_torch.parallel import make_grid

    grid = make_grid(2)
    _, evals = dp_data()
    cfg, mcfg = train_setup(gather_mode="paper")
    from qa_tiger_tpu_torch.training import AVQARunner

    runner = AVQARunner(cfg, mcfg, device="cuda", seed=0, grid=grid)
    loader = BatchLoader(ArrayDataset(evals), 32 // grid.data_size, **grid.loader_shard)
    torch.cuda.synchronize()
    ops.reset_launches()
    loss, cor, tot, cor9, tot9 = runner._run_eval(loader, debug=False)
    torch.cuda.synchronize()
    return {"eval": [loss, cor, tot, [int(x) for x in cor9], [int(x) for x in tot9]],
            "batches": len(loader), "launches": ops.launch_counts(),
            "grid": [grid.data_rank, grid.data_size, grid.model_rank, grid.model_size]}


def check_tp_eval(pair: dict) -> dict:
    """Phases ``tp_eval`` and ``tp_grid``: ranks spawned on the one card over
    gloo (NCCL refuses two ranks on one card; gloo sums CUDA tensors through
    the host, so the times say nothing of tensor parallelism's speed).
    tp_eval, dp1 x tp2 (the ``eval`` part of ``pair``, ``check_pair``'s
    ranks and one process) at the vitl14 config from seed 0: (a) fp32 B=4, the
    logits within LOGITS_TOL of one process, the two ranks bitwise equal;
    (b) bf16 B=256, one forward, within BF16_TOL of one process, each
    rank's launches those of one process (12 / 7 / 1 / 2) and its stage
    launches TP_STAGE_COUNTS. tp_grid, dp2 x tp2 (four ranks), fp32:
    ``_run_eval`` over DP_EVAL_N rows, the counters equal one process's
    exactly. Returns rank 0's launches of (b)."""
    import torch

    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch.data import BatchLoader
    from qa_tiger_tpu_torch.training import AVQARunner

    ranks, spawn_s = [r["eval"] for r in pair["ranks"]], pair["seconds"]
    single = pair["single"]["eval"]
    for dname, tol in (("float32", None), ("bfloat16", BF16_TOL)):
        want = single[dname]["logits"]
        r0, r1 = (r[dname] for r in ranks)
        err = (r0["logits"] - want).abs().max().item()
        scale = want.abs().max().item()
        close = (bool(torch.allclose(r0["logits"], want, **LOGITS_TOL)) if tol is None
                 else err <= tol * max(1.0, scale))
        bitwise = torch.equal(r0["logits"], r1["logits"])
        line = {"phase": "tp_eval", "grid": "dp1xtp2", "backend": "gloo", "dtype": dname,
                "batch": tuple(want.shape)[0], "logits_max_abs_err": err,
                "max_abs_logit": scale, "ranks_bitwise_equal": bitwise, "close": close,
                "tolerance": LOGITS_TOL if tol is None else tol * max(1.0, scale),
                "argmax_equal": bool((r0["logits"].argmax(1) == want.argmax(1)).all()),
                "launches": [r[dname]["launches"] for r in ranks],
                "single_launches": single[dname]["launches"],
                "stages": [r[dname]["stages"] for r in ranks],
                "stage_routes": ranks[0][dname]["routes"],
                "forward_ms": [r[dname]["ms"] for r in ranks],
                "single_forward_ms": single[dname]["ms"], "spawn_and_run_s": spawn_s}
        print(json.dumps(line), flush=True)
        require(close, f"tp_eval {dname}: the ranks' logits differ from one process's by "
                       f"{err:.3e}")
        require(bitwise, f"tp_eval {dname}: the two ranks' logits differ")
        for r, rank in enumerate(ranks):
            got = rank[dname]
            require(got["launches"] == single[dname]["launches"],
                    f"tp_eval {dname}: rank {r} launched {got['launches']}, one process "
                    f"{single[dname]['launches']}")
            for name, n in TP_KERNELS.items():
                require(got["launches"][name] == n, f"tp_eval: {name} launched "
                                                    f"{got['launches'][name]} times, not {n}")
            stages = {k: v for k, v in got["stages"].items() if v}
            require(stages == TP_STAGE_COUNTS,
                    f"tp_eval {dname}: rank {r}'s stage launches {stages}")
            if dname == "bfloat16":
                require(all(set(routes) == {"wgmma"} for routes in got["routes"].values()),
                        f"tp_eval: a bf16 stage product left gemm_sm90: {got['routes']}")
    torch.cuda.empty_cache()

    start = time.perf_counter()
    def single_eval():
        _, evals = dp_data()
        cfg, mcfg = train_setup(gather_mode="paper")
        runner = AVQARunner(cfg, mcfg, device="cuda", seed=0)
        ops.reset_launches()
        one = runner._run_eval(BatchLoader(ArrayDataset(evals), 32), debug=False)
        torch.cuda.synchronize()
        return ([one[0], one[1], one[2], [int(x) for x in one[3]], [int(x) for x in one[4]]],
                ops.launch_counts())

    grid_ranks, (one, one_launches) = dp_spawn(tp_grid_rank, world=4, meanwhile=single_eval)
    grid_s = time.perf_counter() - start
    torch.cuda.empty_cache()
    equal = all(r["eval"][1:] == one[1:] for r in grid_ranks) and one[2] == DP_EVAL_N
    loss_ok = all(np.isclose(r["eval"][0], one[0], **LOGITS_TOL) for r in grid_ranks)
    print(json.dumps({"phase": "tp_grid", "grid": "dp2xtp2", "backend": "gloo", "rows": DP_EVAL_N,
                      "ranks": [r["eval"] for r in grid_ranks], "single": one,
                      "grids": [r["grid"] for r in grid_ranks],
                      "batches_per_rank": [r["batches"] for r in grid_ranks],
                      "counters_equal": equal, "loss_close": loss_ok,
                      "launches": [r["launches"] for r in grid_ranks],
                      "single_launches": one_launches, "spawn_and_run_s": grid_s}), flush=True)
    require(equal and loss_ok, f"tp_grid: the ranks' counters {[r['eval'] for r in grid_ranks]} "
                               f"differ from one process's {one}")
    return ranks[0]["bfloat16"]["launches"]


# ---------------------------------------------------------------------------
# the train step under a data x model grid (A7b.2)
# ---------------------------------------------------------------------------

TP_TRAIN_B = 32  # the recipe's batch, fp32 and bf16
# per stage of each train op: the buffers it reads and writes (the bound's
# bytes: each once), by the names of ops.avq.BUFFERS / patch_select's
AVQ_STAGE_IO = {
    "tp_attn": ("src", "val", "wrd", "m_qst", "m_slf", "m_crs", "qst_w", "qst_b", "qst_ow",
                "slf_w", "slf_b", "slf_ow", "crs_w", "crs_b", "crs_ow", "qq", "kvq", "qkv",
                "qc", "kvc", "qctx", "sctx", "cctx", "part"),
    "tp_mid": ("total", "src", "m_d_slf", "m_d_crs", "m_d_qst", "m_ffn1", "slf_ob", "crs_ob",
               "qst_ob", "n1_w", "n1_b", "l1_w", "l1_b", "l2_w", "x1", "h1", "hr", "hdp",
               "part"),
    "tp_out": ("total", "h1", "m_ffn2", "l2_b", "n2_w", "n2_b", "x2", "out"),
    "bwd_tp_ffn": ("g", "x2", "n2_w", "m_ffn2", "l2_w", "hr", "hdp", "m_ffn1", "l1_w", "h1",
                   "gf", "g_ffn", "g_pre", "part", "g_l1_w", "g_l1_b", "g_l2_w", "g_l2_b",
                   "g_n2_w", "g_n2_b"),
    "bwd_tp_attn": ("total", "x1", "n1_w", "m_d_slf", "m_d_crs", "m_d_qst", "m_qst", "m_slf",
                    "m_crs", "qq", "kvq", "qkv", "qc", "kvc", "qctx", "sctx", "cctx", "src",
                    "val", "wrd", "qst_w", "qst_ow", "slf_w", "slf_ow", "crs_w", "crs_ow",
                    "g_out_s", "g_out_c", "g_out_q", "g_ctx", "g_qq", "g_kvq", "g_qkv", "g_qc",
                    "g_kvc", "part", "g_qst_w", "g_qst_b", "g_qst_ow", "g_qst_ob", "g_slf_w",
                    "g_slf_b", "g_slf_ow", "g_slf_ob", "g_crs_w", "g_crs_b", "g_crs_ow",
                    "g_crs_ob", "g_n1_w", "g_n1_b"),
}
PS_STAGE_IO = {
    "tp_self": ("patch", "m_slf", "slf_w", "slf_b", "slf_ow", "qkv", "sctx", "part"),
    "tp_cross": ("total", "patch", "video", "audio", "m_crs_v", "m_crs_a", "slf_ob", "crs_w",
                 "crs_b", "crs_ow", "x1", "kv", "src2", "q", "ctx", "part"),
    "tp_mlp": ("total", "crs_ob", "m_out_v", "m_out_a", "mlp_w1", "mlp_b1", "mlp_w2", "crs_d",
               "hid", "part"),
    "tp_out": ("total", "mlp_b2", "an_w", "an_b", "vn_w", "vn_b", "outf", "a_out", "v_out"),
    "bwd_tp_mlp": ("ga", "gv", "outf", "an_w", "vn_w", "mlp_w2", "hid", "mlp_w1", "crs_d",
                   "g_rel", "g_pre1", "part", "g_mlp_w1", "g_mlp_b1", "g_mlp_w2", "g_mlp_b2",
                   "g_an_w", "g_an_b", "g_vn_w", "g_vn_b"),
    "bwd_tp_cross": ("total", "m_out_v", "m_out_a", "crs_ow", "ctx", "q", "kv", "m_crs_v",
                     "m_crs_a", "src2", "x1", "crs_w", "g_crs_o", "g_ctx", "g_qc", "g_kv", "part",
                     "g_crs_w", "g_crs_b", "g_crs_ow", "g_crs_ob"),
    "bwd_tp_self": ("total", "slf_ow", "sctx", "qkv", "m_slf", "patch", "slf_w", "g_x1",
                    "gvideo", "gaudio", "g_slf", "g_qkv", "part", "g_slf_w", "g_slf_b",
                    "g_slf_ow", "g_slf_ob"),
}


def _flat(out) -> list:
    """A stage's result as a list of tensors: a tensor, a tuple of tensors
    and {index: gradient} dicts (in index order)."""
    import torch

    if torch.is_tensor(out):
        return [out]
    flat = []
    for item in out:
        flat += [item[k] for k in sorted(item)] if isinstance(item, dict) else _flat(item)
    return flat


def _io_bytes(bufs: dict, keys) -> int:
    return sum(bufs[k].numel() * bufs[k].element_size() for k in keys
               if bufs.get(k) is not None)


def _stage_flops(shapes, attn: float = 0.0) -> float:
    return sum(2.0 * m * n * k for m, n, k in shapes) + attn


class TrainChain:
    """One train op's tensor-parallel stages on every rank of tp, three
    states per rank: the kernels (``k``), the plain versions (each stage's
    ``plain``) in the same dtype (``p``) and, in bf16, the plain versions in
    fp32 on the same values (``p32``). Each stage runs on each rank in all
    three, fed the same summed partials (the kernels', in rank order);
    ``stage`` holds the
    kernel to its plain version as ``check_train_kernels`` does (bf16
    gradients: against the fp32 plain version, within the larger of twice
    the bf16 plain version's own error and BF16_TOL) and times the fp32
    stage on rank 0."""

    def __init__(self, op: str, tp: int, dtype, make_state, timed: bool, lines: list):
        import torch

        self.op, self.tp, self.dtype, self.timed, self.lines = op, tp, dtype, timed, lines
        self.bf16 = dtype == torch.bfloat16
        self.tol = BF16_TOL if self.bf16 else FP32_TOL
        self.k = [make_state(r, dtype) for r in range(tp)]
        self.p = [make_state(r, dtype) for r in range(tp)]
        self.p32 = [make_state(r, torch.float32) for r in range(tp)] if self.bf16 else None

    def stage(self, fn, name: str, args, backward: bool, io: dict, flops: float,
              scale_args=None):
        """``fn(state, *args(r, dtype))`` on every rank; returns the kernel's
        results by rank."""
        import torch

        outs = []
        for r in range(self.tp):
            fn.attn_routes = {}
            got = fn(self.k[r], *args(r, self.dtype))
            attn = dict(fn.attn_routes)  # this launch's keep-masked attentions
            want = fn.plain(self.p[r], *args(r, self.dtype))
            torch.cuda.synchronize()
            g, w = _flat(got), _flat(want)
            if self.bf16 and backward:
                ref = _flat(fn.plain(self.p32[r], *args(r, torch.float32)))
                err, scale = max_err(g, ref)
                limit = max(2 * max_err(w, ref)[0], self.tol * max(1.0, scale))
            else:
                if self.bf16:
                    fn.plain(self.p32[r], *args(r, torch.float32))  # its state follows the chain
                err, scale = max_err(g, w)
                limit = self.tol * max(1.0, scale)
            line = {"phase": "tp_train_chain", "kernel": f"{self.op}_{name}", "tp": self.tp,
                    "rank": r, "dtype": str(self.dtype).replace("torch.", ""),
                    "tensors": len(g), "max_abs_err": err, "max_abs_ref": scale,
                    "limit": limit, "attn_routes": attn,
                    "ok": err <= limit and set(attn) <= {"mma_keep"}}
            if self.timed and r == 0:
                nbytes = _io_bytes(self.k[0].bufs, io[name])
                b_ms, b_by = bound(nbytes, flops, "tf32x3")
                line.update(ms=cuda_ms(lambda: fn(self.k[0], *args(0, self.dtype))),
                            plain_ms=cuda_ms(lambda: fn.plain(self.p[0], *args(0, self.dtype))),
                            bound_ms=b_ms, bound_by=b_by,
                            gemm_routes=dict(getattr(fn, "gemm_routes", {})))
            print(json.dumps(line), flush=True)
            require(line["ok"], f"{self.op} {name} tp{self.tp} rank {r} "
                                f"{line['dtype']}: {err:.3e} over {limit:.3e}, or keep-masked "
                                f"attentions off the tensor cores ({attn})")
            self.lines.append(line)
            outs.append(got)
        return outs


def _against_tp1(op: str, tp: int, dtype, got: list, want: list, ref32: list | None,
                 tp1: dict, lines: list, n_out: int) -> None:
    """The summed shards (output, then every input and parameter gradient)
    against the single-rank train kernel's on the same inputs and masks:
    fp32 within FP32_TOL; bf16 outputs within BF16_TOL, bf16 gradients
    against the fp32 plain version within the larger of twice the
    single-rank kernel's own error and BF16_TOL."""
    worst, ok = (0.0, -1, 0.0, 0.0), True
    for i, (g, w) in enumerate(zip(got, want)):
        if ref32 is not None and i >= n_out:
            err, scale = max_err(g, ref32[i])
            limit = max(2 * max_err(w, ref32[i])[0], BF16_TOL * max(1.0, scale))
        else:
            err, scale = max_err(g, w)
            limit = (BF16_TOL if ref32 is not None else FP32_TOL) * max(1.0, scale)
        ok &= err <= limit
        worst = max(worst, (err / limit, i, err, scale))
    line = {"phase": "tp_train_chain", "kernel": op, "tp": tp,
            "dtype": str(dtype).replace("torch.", ""), "tensors_compared": len(got),
            "worst_tensor": worst[1], "max_abs_err_vs_tp1": worst[2], "max_abs_ref": worst[3],
            "worst_err_over_limit": worst[0], "ok": ok, **tp1,
            "stages": [{k: v for k, v in ln.items() if k not in ("phase", "tp")}
                       for ln in lines if "ms" in ln]}
    print(json.dumps(line), flush=True)
    require(ok, f"{op} tp{tp} {line['dtype']}: tensor {worst[1]} of the summed shards differs "
                f"from the single-rank kernel by {worst[2]:.3e}")


def avq_tp_setup(tp: int, dtype, rng, gen):
    """fused_avq_train at the recipe (N = 2 x 32 rows, T 60, S 77, D 512, 8
    heads): the module, its activations (leaves), a dropout realization, a
    cotangent, and ``make_state(rank, dtype)``: a rank's stage state over
    its shards and its share of the masks."""
    import torch

    from qa_tiger_tpu_torch.models.modules import AVQCrossAttn, make_avq_dropout_masks
    from qa_tiger_tpu_torch.ops import avq as AV
    from qa_tiger_tpu_torch.parallel import Grid, shard_module_

    D, H, N = 512, 8, 2 * TP_TRAIN_B

    def rn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)

    avq = AVQCrossAttn(D, gen).to("cuda", dtype)
    acts = [_leaf(rn(N, T, D)), _leaf(rn(N, T, D)), _leaf(rn(N, S, D))]
    mgen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    masks = make_avq_dropout_masks(mgen, N, T, S, D, nhead=H, dropout_p=0.1, dtype=dtype)
    cot = rn(N, T, D)
    shards = [shard_module_(copy.deepcopy(avq), Grid(model_rank=r, model_size=tp))
              for r in range(tp)]
    shares = [AV.shard_avq_masks(masks, H, S, T, r, tp) for r in range(tp)]

    def make_state(r, dt):
        ws = [w.detach().to(dt).contiguous() for w in AV._weights(shards[r])]
        return AV._AVQState(*[a.detach().to(dt) for a in acts], ws,
                            {k: v.to(dt).contiguous() for k, v in shares[r].items()}, H // tp)

    return avq, acts, masks, cot, make_state


def tp_train_avq(tp: int, dtype, rng, gen, tp1: dict) -> list:
    """fused_avq_train's five stages at the recipe (``avq_tp_setup``) on tp
    ranks; the output and every gradient against the single-rank kernel
    pair. Returns the timed stage lines."""
    import torch

    from qa_tiger_tpu_torch.ops import avq as AV
    from qa_tiger_tpu_torch.parallel.tensor import merge_shards, tp_spec

    D, H, N = 512, 8, 2 * TP_TRAIN_B
    R, heads = N * T, H // tp
    avq, acts, masks, cot, make_state = avq_tp_setup(tp, dtype, rng, gen)
    params = list(avq.parameters())
    want = _grads(AV.fused_avq_train(*acts, avq, masks, H), acts + params, [cot])
    ref32 = None
    if dtype == torch.bfloat16:
        m32 = copy.deepcopy(avq).float()
        a32 = [_leaf(a.detach().float()) for a in acts]
        ref32 = _grads(AV.avq_sub_forward_masked(m32, *a32, {k: v.float() for k, v in
                                                               masks.items()}, nhead=H),
                       a32 + list(m32.parameters()), [cot.float()])

    lines = []
    ch = TrainChain("fused_avq_train", tp, dtype, make_state, dtype == torch.float32, lines)
    shapes = ch.k[0].shapes
    hd = D // H
    attn = 4.0 * N * heads * hd * T * (S + 2 * T)
    none = lambda r, dt: ()  # noqa: E731
    parts = ch.stage(AV.fused_avq_train_tp_attn, "tp_attn", none, False, AVQ_STAGE_IO,
                     _stage_flops(shapes["tp_attn"], attn))
    totals = _tp_sum(parts)
    parts = ch.stage(AV.fused_avq_train_tp_mid, "tp_mid", lambda r, dt: (totals,), False,
                     AVQ_STAGE_IO, _stage_flops(shapes["tp_mid"]))
    total2 = _tp_sum(parts)
    outs = ch.stage(AV.fused_avq_train_tp_out, "tp_out", lambda r, dt: (total2,), False,
                    AVQ_STAGE_IO, 0.0)
    ffn = ch.stage(AV.fused_avq_train_bwd_tp_ffn, "bwd_tp_ffn",
                   lambda r, dt: (cot.to(dt), r == 0), True, AVQ_STAGE_IO,
                   _stage_flops(shapes["bwd_tp_ffn"]))
    gh1 = _tp_sum([part for part, _ in ffn])
    attn_b = ch.stage(AV.fused_avq_train_bwd_tp_attn, "bwd_tp_attn",
                      lambda r, dt: (gh1, r == 0), True, AVQ_STAGE_IO,
                      _stage_flops(shapes["bwd_tp_attn"], 2 * attn))
    g_in = AV.round_sum(_tp_sum([part for part, _ in attn_b]), dtype)
    got = [outs[0], g_in[:R].reshape(N, T, D), g_in[R:2 * R].reshape(N, T, D),
           g_in[2 * R:].reshape(N, S, D)]
    for pname, p in avq.named_parameters():
        widx = [j for j, w in enumerate(AV._weights(avq)) if w is p][0]
        rank_grads = [{**f[1], **a[1]}[widx] for f, a in zip(ffn, attn_b)]
        spec = tp_spec(pname, p.shape, tp)
        if not spec:
            require(all(torch.equal(g, rank_grads[0]) for g in rank_grads),
                    f"fused_avq_train tp{tp}: the ranks' {pname} gradients differ")
        got.append((merge_shards(rank_grads, spec) if spec else rank_grads[0]).to(dtype))
    _against_tp1("fused_avq_train", tp, dtype, got, want, ref32, tp1, lines, 1)
    return [ln for ln in lines if "ms" in ln]


def patch_tp_setup(tp: int, dtype, rng, gen):
    """fused_patch_select_train at the recipe (patch[32, 60, 14, 512], 8
    heads): the module, its activations (leaves), a dropout realization,
    the two outputs' cotangents and ``make_state(rank, dtype)``."""
    import torch

    from qa_tiger_tpu_torch.models.modules import PatchSelecter, make_patch_dropout_masks
    from qa_tiger_tpu_torch.ops import patch_select as PS
    from qa_tiger_tpu_torch.parallel import Grid, shard_module_

    D, H, B = 512, 8, TP_TRAIN_B

    def rn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)

    ps = PatchSelecter(D, gen).to("cuda", dtype)
    acts = [_leaf(rn(B, T, P, D)), _leaf(rn(B, T, D)), _leaf(rn(B, T, D))]
    mgen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    masks = make_patch_dropout_masks(mgen, B * T, P, D, nhead=H, dropout_p=0.1, dtype=dtype)
    cots = [rn(B, T, D), rn(B, T, D)]
    shards = [shard_module_(copy.deepcopy(ps), Grid(model_rank=r, model_size=tp))
              for r in range(tp)]
    shares = [PS.shard_patch_masks(masks, H, P, r, tp) for r in range(tp)]

    def make_state(r, dt):
        ws = [w.detach().to(dt).contiguous() for w in PS._weights(shards[r])]
        return PS._PSState(*[a.detach().to(dt) for a in acts], ws,
                           {k: v.to(dt).contiguous() for k, v in shares[r].items()}, H // tp)

    return ps, acts, masks, cots, make_state


def tp_train_patch(tp: int, dtype, rng, gen, tp1: dict) -> list:
    """fused_patch_select_train's seven stages at the recipe
    (``patch_tp_setup``) on tp ranks; the outputs and every gradient
    against the single-rank kernel pair. Returns the timed stage lines."""
    import torch

    from qa_tiger_tpu_torch.ops import patch_select as PS
    from qa_tiger_tpu_torch.parallel.tensor import merge_shards, tp_spec

    D, H, B = 512, 8, TP_TRAIN_B
    BT, heads = B * T, H // tp
    ps, acts, masks, cots, make_state = patch_tp_setup(tp, dtype, rng, gen)
    params = list(ps.parameters())
    want = _grads(PS.fused_patch_select_train(*acts, ps, masks, H), acts + params, cots)
    ref32 = None
    if dtype == torch.bfloat16:
        m32 = copy.deepcopy(ps).float()
        a32 = [_leaf(a.detach().float()) for a in acts]
        ref32 = _grads(tuple(PS.patch_selecter_plain(
            m32, *a32, nhead=H, masks={k: v.float() for k, v in masks.items()})),
            a32 + list(m32.parameters()), [c.float() for c in cots])

    lines = []
    ch = TrainChain("fused_patch_select_train", tp, dtype, make_state, dtype == torch.float32,
                    lines)
    shapes = ch.k[0].shapes
    hd = D // H
    self_attn, cross_attn = 4.0 * BT * heads * hd * P * P, 4.0 * 2 * BT * heads * hd * P
    none = lambda r, dt: ()  # noqa: E731
    total1 = _tp_sum(ch.stage(PS.fused_patch_select_train_tp_self, "tp_self", none, False,
                              PS_STAGE_IO, _stage_flops(shapes["tp_self"], self_attn)))
    total2 = _tp_sum(ch.stage(PS.fused_patch_select_train_tp_cross, "tp_cross",
                              lambda r, dt: (total1,), False, PS_STAGE_IO,
                              _stage_flops(shapes["tp_cross"], cross_attn)))
    total3 = _tp_sum(ch.stage(PS.fused_patch_select_train_tp_mlp, "tp_mlp",
                              lambda r, dt: (total2,), False, PS_STAGE_IO,
                              _stage_flops(shapes["tp_mlp"])))
    outs = ch.stage(PS.fused_patch_select_train_tp_out, "tp_out", lambda r, dt: (total3,),
                    False, PS_STAGE_IO, 0.0)
    mlp = ch.stage(PS.fused_patch_select_train_bwd_tp_mlp, "bwd_tp_mlp",
                   lambda r, dt: (cots[0].to(dt), cots[1].to(dt)), True, PS_STAGE_IO,
                   _stage_flops(shapes["bwd_tp_mlp"]))
    t_mlp = _tp_sum([m[0] for m in mlp])
    cross = ch.stage(PS.fused_patch_select_train_bwd_tp_cross, "bwd_tp_cross",
                     lambda r, dt: (t_mlp,), True, PS_STAGE_IO,
                     _stage_flops(shapes["bwd_tp_cross"], 2 * cross_attn))
    t_cross = _tp_sum([c[0] for c in cross])
    selves = ch.stage(PS.fused_patch_select_train_bwd_tp_self, "bwd_tp_self",
                      lambda r, dt: (t_cross,), True, PS_STAGE_IO,
                      _stage_flops(shapes["bwd_tp_self"], 2 * self_attn))
    g_x1, g_video, g_audio = selves[0][:3]
    gpatch = PS.patch_grad_epilogue(_tp_sum([s_[3] for s_ in selves]), g_x1)
    got = [*outs[0], gpatch, g_audio, g_video]
    for pname, p in ps.named_parameters():
        widx = [j for j, w in enumerate(PS._weights(ps)) if w is p][0]
        rank_grads = [{**m[1], **c[1], **s_[4]}[widx] for m, c, s_ in zip(mlp, cross, selves)]
        spec = tp_spec(pname, p.shape, tp)
        if not spec:
            require(all(torch.equal(g, rank_grads[0]) for g in rank_grads),
                    f"fused_patch_select_train tp{tp}: the ranks' {pname} gradients differ")
        got.append((merge_shards(rank_grads, spec) if spec else rank_grads[0]).to(dtype))
    _against_tp1("fused_patch_select_train", tp, dtype, got, want, ref32, tp1, lines, 2)
    return [ln for ln in lines if "ms" in ln]


def check_tp_train_chain(entries: dict) -> None:
    """Phase ``tp_train_chain``: the tensor-parallel stages of the two train
    kernels, forward and backward, at the recipe's widths and batch (B=32)
    at tp 2 and 4, in fp32 and bf16 (``TrainChain``, ``_against_tp1``); the
    fp32 stages on rank 0 timed beside their bounds (3xTF32 peak) and the
    single-rank kernels' times of ``check_train_kernels``, the timed lines
    kept under ``tp`` in the four train kernels' table entries."""
    import torch

    rng = np.random.default_rng(19)
    gen = torch.Generator().manual_seed(19)
    tp1 = {op: {"tp1_ms": entries[op]["ms"], "tp1_bwd_ms": entries[op + "_bwd"]["ms"]}
           for op in ("fused_avq_train", "fused_patch_select_train")}
    for dtype in (torch.float32, torch.bfloat16):
        for tp in TP_SIZES:
            for op, fn in (("fused_avq_train", tp_train_avq),
                           ("fused_patch_select_train", tp_train_patch)):
                lines = fn(tp, dtype, rng, gen, tp1[op])
                if dtype == torch.float32:
                    for name in (op, op + "_bwd"):
                        entries[name].setdefault("tp", {})[f"tp{tp}"] = [
                            {k: ln[k] for k in ("kernel", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "max_abs_err")}
                            for ln in lines if ("_bwd_" in ln["kernel"]) == name.endswith("_bwd")]
                torch.cuda.empty_cache()


TP_TRAIN_STEPS = 2  # 3 up to PR 24, cut as DP_STEPS
# the tower's dtype in the two tp_train runs: fp32, where the first step's
# gradients are compared, and the recipe's bf16
TP_TRAIN_TOWERS = ("float32", "bfloat16")
# the most hidden units of TempMoE's experts, and as many of the AVQ FFN's,
# whose ReLU may fall on the other side of its kink in the ranks' first step
# (each shown to lie within the rounding bound of 0 in both runs)
TP_TRAIN_MAX_KINKS = 8
# the bf16 tower's losses against one process's, relative: the first step's
# (the same weights; measured 7.6e-5 on the H100) and the later steps'
# (measured 1.9e-3)
TP_TRAIN_BF16_LOSS_RTOL = (5e-4, 1e-2)
# one rank's train-step launches under dp1 x tp2 (dropout on): one process's
TP_TRAIN_STAGE_COUNTS = {"fused_attn_ln2_partial": 12, "fused_attn_ln2_post": 12,
                         "fused_gaussian_moe_partial": 2, "fused_avq_train_tp_attn": 1,
                         "fused_avq_train_tp_mid": 1, "fused_avq_train_tp_out": 1,
                         "fused_avq_train_bwd_tp_ffn": 1, "fused_avq_train_bwd_tp_attn": 1,
                         "fused_patch_select_train_tp_self": 1,
                         "fused_patch_select_train_tp_cross": 1,
                         "fused_patch_select_train_tp_mlp": 1,
                         "fused_patch_select_train_tp_out": 1,
                         "fused_patch_select_train_bwd_tp_mlp": 1,
                         "fused_patch_select_train_bwd_tp_cross": 1,
                         "fused_patch_select_train_bwd_tp_self": 1}


@contextlib.contextmanager
def step_probe(model, record: dict, kinks: list | None = None,
               avq_kinks: list | None = None):
    """While open: the frozen tower's output (``record["tower"]``: pooled,
    words) and each MoE call's stream and first Linear (``record["moe"]``:
    x, w1t, b1, in call order) recorded on the host, the MoE entry points
    (``modules.fused_gaussian_moe`` / ``_partial``) wrapped for that; and
    each AVQ train forward's FFN input, hidden ReLU side and linear1
    (``record["avq"]``: h1 [R, D], hr > 0 [R, H] over this process's hidden
    units, w1 [H, D], b1 [H]), as the kernel's forward saved them for its
    backward (one process: ``modules.fused_avq_train``'s saved tensors; a
    model rank: its ``_AVQState``, whose hidden columns are its linear1
    shard). With ``kinks`` (per call a [B, T, E, H] tensor of -1, 0 or +1)
    the MoE call's hidden ReLU takes the other side of its kink where the
    entry is not 0: the output is unchanged, and the backward adds (+1) or
    drops (-1) those hidden units' gradient, as a run whose ReLU fell on
    that side would. ``avq_kinks`` (per AVQ call an [R, D] tensor of -1, 0
    or +1) does the same for one process's AVQ FFN: the saved ReLU output
    its backward reads as the side is set to the smallest normal (+1) or 0
    (-1) at those units after the forward, which is unchanged."""
    import torch

    from qa_tiger_tpu_torch.models import modules
    from qa_tiger_tpu_torch.ops import avq as AV

    saved = modules.fused_gaussian_moe, modules.fused_gaussian_moe_partial
    saved_avq, saved_state = modules.fused_avq_train, AV._AVQState
    record["moe"], record["avq"], states = [], [], []
    l1w, l1b = AV.WEIGHT_NAMES.index("l1_w"), AV.WEIGHT_NAMES.index("l1_b")
    # where _AVQTrain's saved tensors (src, val, wrd, the weights, SAVED)
    # hold LN1's output h1 and the ReLU's output hr, whose sign the backward
    # reads as the ReLU's side
    h1_at, hr_at = (3 + len(AV.WEIGHT_NAMES) + AV.SAVED.index(k) for k in ("h1", "hr"))

    def avq(src, val, wrd, params, masks, nhead):
        out = saved_avq(src, val, wrd, params, masks, nhead)
        i = len(record["avq"])
        h1, hr = (out.grad_fn.saved_tensors[j] for j in (h1_at, hr_at))
        record["avq"].append([h1.detach().cpu(), (hr > 0).cpu(),
                              params.linear1.weight.detach().cpu(),
                              params.linear1.bias.detach().cpu()])
        if avq_kinks is not None and avq_kinks[i].any():
            side = avq_kinks[i].to(hr.device)
            hr.data[side > 0] = torch.finfo(hr.dtype).tiny
            hr.data[side < 0] = 0
        return out

    class RecordedState(saved_state):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            states.append(self)

    def wrap(fn):
        def call(x, w1t, b1, w2t, *rest):
            i = len(record["moe"])
            record["moe"].append([t.detach().cpu() for t in (x, w1t, b1)])
            out = fn(x, w1t, b1, w2t, *rest)
            if kinks is not None and kinks[i].any():
                side = kinks[i].to(x.device)
                pre = torch.einsum("btd,edh->bteh", x.float(), w1t.float()) + b1.float()
                s = torch.einsum("bet,bteh->beh", rest[-1].float(), side * pre)
                extra = torch.einsum("beh,ehd->bd", s, w2t.float())
                out = out + (extra - extra.detach()).to(out.dtype)
            return out
        return call

    hook = model.quest_encoder.register_forward_hook(
        lambda _m, _a, out: record.__setitem__("tower", [t.detach().cpu() for t in out]))
    modules.fused_gaussian_moe, modules.fused_gaussian_moe_partial = map(wrap, saved)
    modules.fused_avq_train, AV._AVQState = avq, RecordedState
    try:
        yield
    finally:
        modules.fused_gaussian_moe, modules.fused_gaussian_moe_partial = saved
        modules.fused_avq_train, AV._AVQState = saved_avq, saved_state
        hook.remove()
    for st in states:
        record["avq"].append([st.bufs["h1"].detach().cpu(), (st.bufs["hr"] > 0).cpu(),
                              st.weights[l1w].detach().cpu(), st.weights[l1b].detach().cpu()])


def tp_train_run(rank: int | None, tower: str = "float32", kinks: list | None = None,
                 steps: int = TP_TRAIN_STEPS, avq_kinks: list | None = None) -> dict:
    """``steps`` ``train_step`` calls at the recipe (fp32, the tower in
    ``tower``, B=32, dropout on, the global batches of ``dp_data``) from
    seed 0 and the runner's own step generator, on a dp1 x tp2 grid
    (``rank``) or in one process (None), the launch counters reset around
    each step: the losses, the per-step launches, stage launches and
    milliseconds, the first step's gradients gathered whole and its
    ``step_probe`` record (``kinks`` and ``avq_kinks`` passed to it), and
    after the last step
    the replicated parameters as this rank holds them."""
    import torch

    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch.parallel import gather_state_dict, make_grid, tp_spec
    from qa_tiger_tpu_torch.training import AVQARunner

    grid = None if rank is None else make_grid(2)
    train, _ = dp_data()
    cfg, mcfg = train_setup(gather_mode="paper", encoder_dtype=tower)
    runner = AVQARunner(cfg, mcfg, device="cuda", seed=0, grid=grid)
    out = {"losses": [], "launches": [], "stages": [], "step_ms": [], "probe": {}}
    for i, batch in enumerate(train[:steps]):
        probe = (step_probe(runner.model, out["probe"], kinks, avq_kinks) if i == 0
                 else contextlib.nullcontext())
        with probe:
            torch.cuda.synchronize()
            ops.reset_launches()
            start = time.perf_counter()
            losses = runner.train_step(batch, TRAIN_LR, runner._step_generator)
            torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - start) * 1e3)
        out["launches"].append(ops.launch_counts())
        out["stages"].append(ops.stage_counts())
        out["losses"].append({k: v.item() for k, v in losses.items()})
        if i == 0:
            grads = {n: p.grad.detach() for n, p in runner.trainable() if p.grad is not None}
            if grid is not None:
                grads = gather_state_dict(grads, grid, runner._whole_shapes)
            out["grads"] = {n: g.cpu() for n, g in grads.items()}
    if grid is not None:
        out["replicated"] = {n: p.detach().cpu() for n, p in runner.trainable()
                             if not tp_spec(n, runner._whole_shapes[n], 2)}
        out["sharded"] = sum(1 for n, _ in runner.trainable()
                             if tp_spec(n, runner._whole_shapes[n], 2))
    return out


def relu_kinks(single: list, ranks: list) -> tuple[list, list]:
    """The hidden units of TempMoE's experts whose ReLU the ranks' backward
    and one process's take on different sides: each recomputes x W1 + b1 in
    fp32 from its own recorded stream, as the plain versions it
    differentiates (``_reference_f32``, ``_partial_f32``) do, a rank over
    its hidden columns. Returns (per MoE call the [B, T, E, H] tensor of the
    ranks' mask minus one process's; each such unit with its fp64
    pre-activation in both runs beside ``bound``: gamma_D (sum |x w| + |b|)
    for one process's stream plus sum |dx| |w| for the streams' difference,
    the most that fp32 rounding of a D-term dot product and the runs'
    inputs can move it)."""
    import torch

    def pre(x, w1t, b1):
        return (torch.einsum("btd,edh->bteh", x.cuda().float(), w1t.cuda().float())
                + b1.cuda().float())

    sides, kinks = [], []
    for c, (xs, w1t, b1) in enumerate(single):
        m_one = pre(xs, w1t, b1) > 0
        m_tp = torch.cat([pre(*r[c]) > 0 for r in ranks], dim=-1)
        side = (m_tp.float() - m_one.float()).cpu()
        sides.append(side)
        cols = w1t.shape[-1] // len(ranks)
        d = xs.shape[-1]
        gamma = d * 2.0 ** -24 / (1 - d * 2.0 ** -24)
        for b, t, e, h in side.nonzero().tolist():
            w = w1t[e, :, h].double()
            bias = float(b1[e, h])
            x1, xt = xs[b, t].double(), ranks[h // cols][c][0][b, t].double()
            p_one, p_tp = float(x1 @ w) + bias, float(xt @ w) + bias
            bound = (gamma * (float(x1.abs() @ w.abs()) + abs(bias))
                     + float((x1 - xt).abs() @ w.abs()))
            kinks.append({"call": c, "sample": b, "t": t, "expert": e, "unit": h,
                          "ranks_side": int(side[b, t, e, h]), "pre_one": p_one,
                          "pre_ranks": p_tp, "terms_abs": float(x1.abs() @ w.abs()) + abs(bias),
                          "bound": bound,
                          "within": max(abs(p_one), abs(p_tp)) <= bound})
    return sides, kinks


def avq_relu_kinks(single: list, ranks: list) -> tuple[list, list]:
    """The hidden units of the AVQ train forward's FFN whose ReLU the ranks'
    kernels and one process's took on different sides, as each forward
    saved it for its backward (``step_probe``'s ``avq`` records: hr > 0; a
    rank over its linear1 columns). Returns (per AVQ call the [R, D] tensor
    of the ranks' side minus one process's; each such unit with its fp64
    pre-activation h1 w + b in both runs beside ``bound``: (gamma_D +
    2^-21) (sum |h1 w| + |b|) for one process's h1, gamma_D the fp32
    rounding of a D-term sum and 2^-21 what 3xTF32's dropped lo*lo term and
    tf32 splits can add per term, plus sum |dh1| |w| for the runs' inputs'
    difference)."""
    import torch

    sides, kinks = [], []
    for c, (h1, on_one, w1, b1) in enumerate(single):
        side = torch.cat([r[c][1] for r in ranks], dim=-1).float() - on_one.float()
        sides.append(side)
        cols = w1.shape[0] // len(ranks)
        d = h1.shape[-1]
        gamma = d * 2.0 ** -24 / (1 - d * 2.0 ** -24) + 2.0 ** -21
        for row, h in side.nonzero().tolist():
            w = w1[h].double()
            bias = float(b1[h])
            x1, xt = h1[row].double(), ranks[h // cols][c][0][row].double()
            p_one, p_tp = float(x1 @ w) + bias, float(xt @ w) + bias
            terms = float(x1.abs() @ w.abs()) + abs(bias)
            bound = gamma * terms + float((x1 - xt).abs() @ w.abs())
            kinks.append({"call": c, "row": int(row), "unit": int(h),
                          "ranks_side": int(side[row, h]), "pre_one": p_one, "pre_ranks": p_tp,
                          "terms_abs": terms, "bound": bound,
                          "within": max(abs(p_one), abs(p_tp)) <= bound})
    return sides, kinks


def grad_rows(got: dict, want: dict) -> list:
    """Per tensor of ``want``: (error over its own largest element, name,
    that largest element, the error, the count of elements past 1e-4 of
    it, its size), the worst first."""
    rows = []
    for name, w in want.items():
        diff = (got[name] - w).abs()
        err, own = float(diff.max()), max(float(w.abs().max()), 1e-30)
        rows.append((err / own, name, own, err, int((diff > 1e-4 * own).sum()), w.numel()))
    return sorted(rows, reverse=True)


def tower_diff(one: list, ranks: list) -> dict:
    """The frozen tower's output (pooled, words) on a rank against one
    process's: the elements that differ and the largest difference."""
    out = {}
    for name, a, b in zip(("pooled", "words"), one, ranks):
        diff = (a.float() - b.float()).abs()
        out[name] = {"differing": int((diff > 0).sum()), "elements": a.numel(),
                     "max_abs": float(diff.max()), "max_abs_ref": float(a.float().abs().max())}
    return out


def check_tp_train(pair: dict) -> dict:
    """Phase ``tp_train``: dp1 x tp2, two ranks spawned on the card over gloo
    (the ``train`` part of ``pair``; NCCL refuses two ranks on one card, and
    gloo's host round trips make the times no figure for tensor
    parallelism's speed), against one
    process: TP_TRAIN_STEPS B=32 steps with dropout on from the same step
    generator, with the tower in fp32 and in the recipe's bf16. In both, the
    ranks' replicated parameters bitwise equal after the last step, each
    rank's launches per step one process's and its stage launches
    TP_TRAIN_STAGE_COUNTS. fp32 tower: each step's losses within rtol 1e-5;
    the first step's gradients, gathered whole, within 1e-4 of each tensor's
    own largest element against one process's first step with TempMoE's
    and the AVQ FFN's hidden ReLUs on the ranks' side at the units where
    the two runs' sides differ (``relu_kinks``, ``avq_relu_kinks``: at most
    TP_TRAIN_MAX_KINKS each, each within the rounding bound of 0 in both
    runs; ``step_probe``). bf16 tower: the
    losses within TP_TRAIN_BF16_LOSS_RTOL. Both print the first step's
    tower output against one process's (``tower_diff``). Returns rank 0's
    launches of its last fp32-tower step."""
    import torch

    ranks, spawn_s = [r["train"] for r in pair["ranks"]], pair["seconds"]
    single = pair["single"]["train"]
    one, tps = single["float32"], [r["float32"] for r in ranks]
    sides, kinks = relu_kinks(one["probe"]["moe"], [r["probe"]["moe"] for r in tps])
    avq_sides, avq_kinks = avq_relu_kinks(one["probe"]["avq"], [r["probe"]["avq"] for r in tps])
    aligned = tp_train_run(None, "float32", kinks=sides, steps=1, avq_kinks=avq_sides)
    torch.cuda.empty_cache()
    lines = []
    for tower in TP_TRAIN_TOWERS:
        one, tps = single[tower], [r[tower] for r in ranks]
        rtol = (1e-5, 1e-5) if tower == "float32" else TP_TRAIN_BF16_LOSS_RTOL
        loss_err = [max(abs(r["losses"][i][k] - want[k]) / abs(want[k])
                        for r in tps for k in want) for i, want in enumerate(one["losses"])]
        loss_ok = all(err <= rtol[min(i, 1)] for i, err in enumerate(loss_err))
        r0, r1 = tps
        bitwise = (set(r0["replicated"]) == set(r1["replicated"])
                   and all(torch.equal(v, r1["replicated"][n])
                           for n, v in r0["replicated"].items()))
        line = {"phase": "tp_train", "grid": "dp1xtp2", "backend": "gloo", "dtype": "float32",
                "tower": tower, "batch": DP_BATCH, "steps": TP_TRAIN_STEPS,
                "losses": [[ln["total_loss"] for ln in r["losses"]] for r in tps],
                "single_losses": [ln["total_loss"] for ln in one["losses"]],
                "loss_max_rel_err_by_step": loss_err, "loss_rtol_first_later": rtol,
                "losses_close": loss_ok,
                "tower_diff": [tower_diff(one["probe"]["tower"], r["probe"]["tower"])
                               for r in tps],
                "replicated_params": len(r0["replicated"]), "sharded_params": r0["sharded"],
                "replicated_bitwise_equal": bitwise,
                "step_ms": [r["step_ms"] for r in tps], "single_step_ms": one["step_ms"]}
        if tower == "float32":
            rows = [grad_rows(r["grads"], aligned["grads"]) for r in tps]
            worst = max(row[0][0] for row in rows)
            line.update(
                relu_kinks=kinks, avq_relu_kinks=avq_kinks,
                kinks_within_bound=all(k["within"] for k in kinks + avq_kinks),
                grads_compared=len(aligned["grads"]), grad_max_err_over_own_max=worst,
                grads_close=worst <= 1e-4,
                grad_worst=[{"param": n, "err_over_own_max": q, "own_max_abs": m, "err": e,
                             "elements_past_1e-4_of_own_max": k, "elements": numel}
                            for q, n, m, e, k, numel in sorted(set(sum(rows, [])),
                                                               reverse=True)[:6]],
                grad_worst_unaligned=[
                    {"param": n, "err_over_own_max": q, "elements_past_1e-4_of_own_max": k}
                    for q, n, _, _, k, _ in sorted(set(sum(
                        [grad_rows(r["grads"], one["grads"]) for r in tps], [])),
                        reverse=True)[:6]],
                aligned_losses=[ln["total_loss"] for ln in aligned["losses"]])
        line.update(spawn_and_run_s=spawn_s,
                    note="gloo through the host on one card: no figure for tensor parallelism")
        print(json.dumps(line), flush=True)
        lines.append(line)
        for rank, r in enumerate(tps):
            print(json.dumps({"phase": "tp_train_launches", "tower": tower, "rank": rank,
                              "per_step": r["launches"], "stages_per_step": r["stages"]}),
                  flush=True)
            require(r["launches"] == one["launches"],
                    f"tp_train ({tower} tower): rank {rank} launched {r['launches']}, one "
                    f"process {one['launches']}")
            for stages in r["stages"]:
                got = {k: v for k, v in stages.items() if v}
                require(got == TP_TRAIN_STAGE_COUNTS,
                        f"tp_train ({tower} tower): rank {rank}'s stages {got}")
        for name in DP_TRAIN_KERNELS:
            require(all(c[name] == 1 for c in one["launches"]),
                    f"tp_train: {name} did not launch once per step")
        require(line["losses_close"], f"tp_train ({tower} tower): the ranks' losses "
                                      f"{line['losses']} differ from one process's "
                                      f"{line['single_losses']} by {loss_err}")
        require(bitwise, f"tp_train ({tower} tower): the ranks' replicated parameters differ")
    fp32 = lines[0]
    require(len(kinks) <= TP_TRAIN_MAX_KINKS and len(avq_kinks) <= TP_TRAIN_MAX_KINKS,
            f"tp_train: {len(kinks)} hidden ReLUs of TempMoE and {len(avq_kinks)} of the AVQ "
            "FFN fall on other sides")
    require(fp32["kinks_within_bound"], "tp_train: a hidden ReLU whose side differs is not "
                                        f"within the rounding bound of 0: {kinks + avq_kinks}")
    require(fp32["grads_close"], f"tp_train: a first-step gradient differs by "
                                 f"{fp32['grad_max_err_over_own_max']:.3e} of its own largest "
                                 "element")
    return ranks[0]["float32"]["launches"][-1]


# ---------------------------------------------------------------------------
# TSPM under the grid and the model-axis step graph (A7b.3)
# ---------------------------------------------------------------------------

# the one-head calls of TSPM split by lanes, at B=256: (label, problems, Sq, Sk)
TP_TSPM_SHAPES = (("AV_Attn", 2 * 256, T, T), ("TokensAttn", 256 * 10, P, P))
# per rank and TSPM bf16 forward: AV_Attn's two and TokensAttn's one
# one-head calls split by lanes (the four-head calls keep attention_wide)
TP_TSPM_STAGE_COUNTS = {"attention_wide_tp_scores": 3, "attention_wide_tp_pv": 3}
TP_TSPM_EVAL_B, TP_TSPM_TRAIN_B = 256, 32
# the most samples of the bf16 B=256 forward whose top-K frames may differ
# from one process's, each with its K-th / (K+1)-th weight gap within
# TP_TSPM_GAP_ULPS bf16 ulps of the K-th weight
TP_TSPM_MAX_FLIPS, TP_TSPM_GAP_ULPS = 4, 2
# the ranks' bf16 B=256 logits against one process's, in bf16 ulps of the
# largest logit: set from the readings of 1 ulp (0.001953125 of 0.314453125)
TP_TSPM_LOGIT_ULPS = 4


def bmm_f32(a, b):
    """The library yardstick of a product with an fp32 output: ``torch.bmm``
    (fp32 operands; TF32 is off), for bf16 its ``out_dtype`` overload; None
    where this PyTorch has no such overload on the card."""
    import torch

    if a.dtype == torch.float32:
        return lambda: torch.bmm(a, b)
    try:
        torch.bmm(a[:1], b[:1], out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return None
    return lambda: torch.bmm(a, b, out_dtype=torch.float32)


def tp_tspm_lanes(tp: int, dtype, label: str, b: int, sq: int, sk: int, tol: float,
                  rng) -> dict:
    """One-head attention_wide over a 512-lane head split over tp ranks (q,
    k and v the rank's lanes of one packed [q; k; v], as the model projects
    them): each rank's partial scores against their plain version, the
    partials summed in rank order, each rank's context lanes against their
    plain version, and the ranks' lanes against the single-rank kernel on
    the whole head. Rank 0's stages timed beside their bounds."""
    import torch

    from qa_tiger_tpu_torch.ops import attention as A

    W, wl = 512, 512 // tp
    isz = torch.tensor([], dtype=dtype).element_size()
    dname = str(dtype).replace("torch.", "")
    buf = torch.from_numpy(rng.standard_normal((b, sq, 3 * W), dtype=np.float32)).to("cuda",
                                                                                   dtype)
    q, k, v = buf[..., :W], buf[..., W:2 * W], buf[..., 2 * W:]
    scale = W ** -0.5
    want = A.attention_wide(q, k, v, None, scale, 1)
    tp1_ms = cuda_ms(lambda: A.attention_wide(q, k, v, None, scale, 1))
    lanes = [slice(r * wl, (r + 1) * wl) for r in range(tp)]
    lines, parts = [], []
    for r, c in enumerate(lanes):
        case = ("attention_wide_tp_scores", f"{label}: q[{b},{sq},{wl}] k[{b},{sk},{wl}] "
                f"tp{tp} rank{r}",
                lambda c=c: A.attention_wide_tp_scores(q[..., c], k[..., c]),
                lambda c=c: A.tp_partial_scores(q[..., c], k[..., c]),
                bmm_f32(q[..., c], k[..., c].mT),
                b * (sq + sk) * wl * isz + b * sq * sk * 4, 2 * b * sq * sk * wl, {})
        parts.append(_tp_stage(case, dtype, FP32_TOL, r == 0, lines))
        if r == 0:
            lines[-1]["route"] = A.tp_scores_route(dtype, sq, sk)
    scores = _tp_sum(parts)
    outs = []
    for r, c in enumerate(lanes):
        case = ("attention_wide_tp_pv", f"{label}: scores[{b},{sq},{sk}] v[{b},{sk},{wl}] "
                f"tp{tp} rank{r}",
                lambda c=c: A.attention_wide_tp_pv(scores, v[..., c], None, scale),
                lambda c=c: A._tp_pv_plain(scores, v[..., c], mask=None, scale=scale), None,
                b * sq * sk * 4 + b * sk * wl * isz + b * sq * wl * isz, 2 * b * sq * sk * wl,
                {})
        outs.append(_tp_stage(case, dtype, tol, r == 0, lines))
        if r == 0:
            lines[-1]["route"] = A.tp_scores_route(dtype, sq, sk)  # both stages' rule
    got = torch.cat(outs, dim=-1)
    _tp_against_tp1(f"attention_wide {label} (one head by lanes)", tp, dtype, tol, got, want,
                    tp1_ms, lines)
    return {"shape": label, "dtype": dname, "stages": lines, "tp1_ms": tp1_ms}


def check_tp_tspm_chain(entries: dict) -> None:
    """Phase ``tp_tspm_chain``: attention_wide's two stages for one head
    split by lanes (``attention_wide_tp_scores``, ``attention_wide_tp_pv``)
    at TSPM's one-head shapes (AV_Attn q/k/v [512, 60, 512], TokensAttn
    [2560, 14, 512]), tp 2 and 4, bf16 and fp32 (``tp_tspm_lanes``): fp32
    within FP32_TOL, bf16 within BF16_TOL, as ``check_tspm_attention``
    holds the single-rank kernel. The lines go into attention_wide's table
    entry under ``tp``."""
    import torch

    rng = np.random.default_rng(20)
    runs: dict = {}
    with torch.inference_mode():
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, FP32_TOL)):
            for tp in TP_SIZES:
                for label, b, sq, sk in TP_TSPM_SHAPES:
                    runs.setdefault(f"tp{tp}", []).append(
                        tp_tspm_lanes(tp, dtype, label, b, sq, sk, tol, rng))
            torch.cuda.empty_cache()
    entries["attention_wide"]["tp"] = runs


def tspm_tp_forward(grid) -> dict:
    """TSPM at configs/tspm/vitl14.py from seed 0 (this rank's shards under
    ``grid``, whole without one), bf16, one B=256 eval forward (features
    from numpy seed 22) after a warm-up, the launch counters reset around
    it: the logits, the temporal weights and top-K frames, the launches and
    the stage launches."""
    import torch

    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch.models import TSPM
    from qa_tiger_tpu_torch.parallel import shard_module_

    _, mcfg = tspm_setup()
    model = TSPM(mcfg, seed=0).eval()
    if grid is not None:
        shard_module_(model, grid)
    model = model.to("cuda", torch.bfloat16)
    batch = {k: torch.from_numpy(v).to("cuda", torch.bfloat16)
             for k, v in make_tspm_batch(np.random.default_rng(22), TP_TSPM_EVAL_B).items()}
    kw = {} if grid is None else {"grid": grid}
    with torch.no_grad():
        model(batch, **kw)
        torch.cuda.synchronize()
        ops.reset_launches()
        start = time.perf_counter()
        out = model(batch, aux=True, **kw)
        torch.cuda.synchronize()
    result = {"logits": out["out"].float().cpu(), "weights": out["temporal_weights"].float().cpu(),
              "topk": out["topk_idx"].cpu(), "launches": ops.launch_counts(),
              "stages": ops.stage_counts(), "ms": (time.perf_counter() - start) * 1e3}
    del model, batch, out
    torch.cuda.empty_cache()
    return result


@contextlib.contextmanager
def ffn_probe(record: dict, kinks: list | None = None):
    """While open: each TSPM FFN call (``models.tspm._ffn``, five per
    forward) recorded on the host in call order (``record["ffn"]``: its
    input, its first Linear's pre-activation as the call computes it (under
    a grid the rank's columns), that Linear's weight and bias). With
    ``kinks`` (one process only; per call a tensor of -1, 0 or +1 shaped as
    the pre-activation) the hidden ReLU takes the other side of its kink
    where the entry is not 0: the output is unchanged, and the backward
    adds (+1) or drops (-1) those hidden units' gradient, as a run whose
    ReLU fell on that side would."""
    import torch

    from qa_tiger_tpu_torch.models import tspm
    from qa_tiger_tpu_torch.nn.core import dropout

    saved = tspm._ffn
    record["ffn"] = []

    def call(x, lin1, lin2, dp, gen, grid=None):
        i = len(record["ffn"])
        with torch.no_grad():
            pre = lin1(x)
        record["ffn"].append([t.detach().cpu() for t in (x, pre, lin1.weight, lin1.bias)])
        if kinks is None:
            return saved(x, lin1, lin2, dp, gen, grid)
        pre = lin1(x)
        hid = torch.relu(pre)
        side = kinks[i].to(pre.device)
        if side.any():
            extra = side * pre
            hid = hid + (extra - extra.detach())
        return lin2(dropout(hid, dp, gen))

    tspm._ffn = call
    try:
        yield
    finally:
        tspm._ffn = saved


def ffn_kinks(single: list, ranks: list) -> tuple[list, list]:
    """The hidden units of TSPM's FFNs whose ReLU the ranks' step and one
    process's take on different sides, from the ``ffn_probe`` records: per
    call the ranks' pre-activation (concatenated over their columns where
    the call's linear1 splits, rank 0's where it is whole) against one
    process's. Returns (per call the tensor of the ranks' side minus one
    process's; each such unit with both pre-activations beside ``bound``:
    gamma_D (sum |x w| + |b|) for one process's input plus sum |dx| |w| for
    the inputs' difference, the most fp32 rounding of a D-term dot product
    and the runs' inputs can move it)."""
    import torch

    sides, kinks = [], []
    for c, (x1, pre1, w, b) in enumerate(single):
        pres = [r[c][1] for r in ranks]
        pre_tp = pres[0] if pres[0].shape[-1] == pre1.shape[-1] else torch.cat(pres, dim=-1)
        side = (pre_tp > 0).float() - (pre1 > 0).float()
        sides.append(side)
        xt = ranks[0][c][0]
        d = x1.shape[-1]
        gamma = d * 2.0 ** -24 / (1 - d * 2.0 ** -24)
        for *row, h in side.nonzero().tolist():
            wh = w[h].double()
            a, t = x1[tuple(row)].double(), xt[tuple(row)].double()
            terms = float(a.abs() @ wh.abs()) + abs(float(b[h]))
            bound = gamma * terms + float((a - t).abs() @ wh.abs())
            p1, pt = float(pre1[tuple(row)][h]), float(pre_tp[tuple(row)][h])
            kinks.append({"call": c, "row": row, "unit": h, "ranks_side": int(side[tuple(row)][h]),
                          "pre_one": p1, "pre_ranks": pt, "terms_abs": terms, "bound": bound,
                          "within": max(abs(p1), abs(pt)) <= bound})
    return sides, kinks


def tspm_tp_train(grid, kinks: list | None = None, steps: int = TP_TRAIN_STEPS) -> dict:
    """TSPM's recipe (fp32, B=32, Adam, dropout on) from seed 0 on ``grid``
    or in one process: ``steps`` ``train_step`` calls from the runner's step
    generator over batches from numpy seed 23, the launch counters reset
    around each: the losses, launches and stage launches per step, the
    first step's gradients gathered whole and its ``ffn_probe`` record
    (``kinks`` passed to it), and the replicated parameters after the last
    step."""
    import torch

    from qa_tiger_tpu_torch import ops
    from qa_tiger_tpu_torch.parallel import gather_state_dict, tp_spec
    from qa_tiger_tpu_torch.training import AVQARunner

    cfg, mcfg = tspm_setup()
    runner = AVQARunner(cfg, mcfg, device="cuda", seed=0, grid=grid)
    rng = np.random.default_rng(23)
    batches = [make_tspm_batch(rng, TP_TSPM_TRAIN_B, train=True) for _ in range(steps)]
    out = {"losses": [], "launches": [], "stages": [], "step_ms": [], "probe": {}}
    for i, batch in enumerate(batches):
        probe = ffn_probe(out["probe"], kinks) if i == 0 else contextlib.nullcontext()
        with probe:
            torch.cuda.synchronize()
            ops.reset_launches()
            start = time.perf_counter()
            losses = runner.train_step(batch, TSPM_LR, runner._step_generator)
            torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - start) * 1e3)
        out["launches"].append(ops.launch_counts())
        out["stages"].append(ops.stage_counts())
        out["losses"].append({k: v.item() for k, v in losses.items()})
        if i == 0:
            grads = {n: p.grad.detach() for n, p in runner.trainable() if p.grad is not None}
            if grid is not None:
                grads = gather_state_dict(grads, grid, runner._whole_shapes)
            out["grads"] = {n: g.cpu() for n, g in grads.items()}
    if grid is not None:
        out["replicated"] = {n: p.detach().cpu() for n, p in runner.trainable()
                             if not tp_spec(n, runner._whole_shapes[n], 2)}
        out["sharded"] = sum(1 for n, _ in runner.trainable()
                             if tp_spec(n, runner._whole_shapes[n], 2))
    del runner
    torch.cuda.empty_cache()
    return out


def pair_parts(rank: int | None) -> dict:
    """The runs of ``check_pair`` on one of its two ranks, or (``rank``
    None) in one process: ``dp_run`` (world 2 of data parallelism, the
    attention dropout off and then back), then on a dp1 x tp2 grid (none in
    one process) QA-TIGER's eval forwards (``tp_forward``), its train steps
    with each tower (``tp_train_run``), TSPM's bf16 forward and its train
    recipe."""
    import torch

    from qa_tiger_tpu_torch.models import modules
    from qa_tiger_tpu_torch.parallel import make_grid

    attn_dropout = modules.ATTN_DROPOUT
    try:
        out = {"dp": dp_run(rank)}
    finally:
        modules.ATTN_DROPOUT = attn_dropout
    torch.cuda.empty_cache()
    grid = None if rank is None else make_grid(2)
    out["eval"] = tp_forward(grid)
    torch.cuda.empty_cache()
    out["train"] = {tower: tp_train_run(rank, tower) for tower in TP_TRAIN_TOWERS}
    torch.cuda.empty_cache()
    out["tspm"] = {"forward": tspm_tp_forward(grid), "train": tspm_tp_train(grid)}
    torch.cuda.empty_cache()
    return out


def check_pair() -> dict:
    """Phase ``pair_spawn``: the one spawn of two ranks on the card over
    gloo that ``dp``, ``tp_eval``, ``tp_train`` and ``tp_tspm`` share
    (``pair_parts``), with one process's runs of the same parts made here
    while the ranks run: {"ranks", "single", "seconds"}."""
    start = time.perf_counter()
    ranks, single = dp_spawn(pair_parts, world=2, meanwhile=lambda: pair_parts(None))
    return {"ranks": ranks, "single": single, "seconds": time.perf_counter() - start}


def topk_gaps(weights, k: int):
    """Per sample the K-th and (K+1)-th largest temporal weight [B, 2]."""
    w = weights[:, 0].sort(dim=-1, descending=True).values
    return w[:, k - 1:k + 1]


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 bits of significand)."""
    return float(2.0 ** (np.floor(np.log2(abs(x))) - 7)) if x else 2.0 ** -133


def check_tp_tspm(pair: dict) -> dict:
    """Phase ``tp_tspm``: TSPM under dp1 x tp2 (the ``tspm`` part of
    ``pair``) against one process. (a) The bf16 B=256 eval forward: the
    ranks' logits, weights and frames bitwise equal; the top-K frames one
    process's, but for at most TP_TSPM_MAX_FLIPS samples whose K-th /
    (K+1)-th weight gap in one process is within TP_TSPM_GAP_ULPS bf16
    ulps (the weights' rounding; the smallest gap over the batch printed);
    the logits of the other samples within TP_TSPM_LOGIT_ULPS bf16 ulps of
    one process's largest logit; each rank's launches one process's
    (attention_wide 6) and its stage launches TP_TSPM_STAGE_COUNTS. (b) The fp32 B=32 recipe, dropout on, TP_TRAIN_STEPS steps:
    losses within rtol 1e-5; the first step's gradients within 1e-4 of each
    tensor's own largest element against one process's first step with the
    FFNs' hidden ReLUs on the ranks' side at the units where the two runs'
    sides differ (``ffn_kinks``: at most TP_TRAIN_MAX_KINKS, each within
    the rounding bound of 0 in both runs; ``ffn_probe``); the replicated
    parameters bitwise equal on the ranks; no kernel launch (dropout keeps
    TSPM's attention on the plain path, as in the JAX package). Returns
    rank 0's launches of (a)."""
    import torch

    ranks, spawn_s = [r["tspm"] for r in pair["ranks"]], pair["seconds"]
    one = pair["single"]["tspm"]
    k = tspm_setup()[1]["topK"]
    fwd, r0 = one["forward"], ranks[0]["forward"]
    ranks_equal = all(torch.equal(r["forward"][key], r0[key]) for r in ranks[1:]
                      for key in ("logits", "weights", "topk"))
    same = (r0["topk"] == fwd["topk"]).all(dim=1)
    gaps = topk_gaps(fwd["weights"], k)
    flips = []
    for i in (~same).nonzero().flatten().tolist():
        kth, nxt = gaps[i].tolist()
        flips.append({"sample": i, "kth": kth, "next": nxt, "gap": kth - nxt,
                      "bound": TP_TSPM_GAP_ULPS * bf16_ulp(kth),
                      "within": kth - nxt <= TP_TSPM_GAP_ULPS * bf16_ulp(kth)})
    err = (r0["logits"][same] - fwd["logits"][same]).abs().max().item()
    scale = fwd["logits"].abs().max().item()
    tol = TP_TSPM_LOGIT_ULPS * bf16_ulp(scale)
    close = err <= tol
    stages = [{n: c for n, c in r["forward"]["stages"].items() if c} for r in ranks]
    line = {"phase": "tp_tspm", "grid": "dp1xtp2", "backend": "gloo", "dtype": "bfloat16",
            "batch": TP_TSPM_EVAL_B, "logits_max_abs_err": err, "max_abs_logit": scale,
            "tolerance": tol, "close": close,
            "ranks_bitwise_equal": ranks_equal, "topk_equal_samples": int(same.sum()),
            "topk_flips": flips, "smallest_topk_weight_gap": (gaps[:, 0] - gaps[:, 1]).min().item(),
            "weights_max_abs_err": (r0["weights"] - fwd["weights"]).abs().max().item(),
            "launches": [r["forward"]["launches"] for r in ranks],
            "single_launches": fwd["launches"], "stages": stages,
            "forward_ms": [r["forward"]["ms"] for r in ranks], "single_forward_ms": fwd["ms"],
            "spawn_and_run_s": spawn_s}
    print(json.dumps(line), flush=True)
    require(ranks_equal, "tp_tspm: the two ranks' logits, weights or frames differ")
    require(len(flips) <= TP_TSPM_MAX_FLIPS and all(f["within"] for f in flips),
            f"tp_tspm: top-K frames differ from one process's beyond the weights' rounding: "
            f"{flips}")
    require(close, f"tp_tspm: the ranks' logits differ from one process's by {err:.3e}")
    for rank, r in enumerate(ranks):
        require(r["forward"]["launches"] == fwd["launches"],
                f"tp_tspm: rank {rank} launched {r['forward']['launches']}, one process "
                f"{fwd['launches']}")
        require(stages[rank] == TP_TSPM_STAGE_COUNTS,
                f"tp_tspm: rank {rank}'s stage launches {stages[rank]}")
    require(fwd["launches"]["attention_wide"] == TSPM_ATTN_CALLS,
            f"tp_tspm: one process launched attention_wide {fwd['launches']['attention_wide']} "
            f"times, not {TSPM_ATTN_CALLS}")

    tr, trs = one["train"], [r["train"] for r in ranks]
    loss_err = [max(abs(r["losses"][i][key] - want[key]) / abs(want[key])
                    for r in trs for key in want) for i, want in enumerate(tr["losses"])]
    sides, kinks = ffn_kinks(tr["probe"]["ffn"], [r["probe"]["ffn"] for r in trs])
    aligned = tspm_tp_train(None, kinks=sides, steps=1)
    rows = [grad_rows(r["grads"], aligned["grads"]) for r in trs]
    worst = max(row[0][0] for row in rows)
    unaligned = sorted(set(sum([grad_rows(r["grads"], tr["grads"]) for r in trs], [])),
                       reverse=True)
    bitwise = all(torch.equal(v, trs[1]["replicated"][n]) for n, v in trs[0]["replicated"].items())
    launched = [sum(sum(c.values()) for c in r["launches"]) for r in trs + [tr]]
    line = {"phase": "tp_tspm_train", "grid": "dp1xtp2", "backend": "gloo", "dtype": "float32",
            "batch": TP_TSPM_TRAIN_B, "steps": TP_TRAIN_STEPS,
            "losses": [[ln["total_loss"] for ln in r["losses"]] for r in trs],
            "single_losses": [ln["total_loss"] for ln in tr["losses"]],
            "loss_max_rel_err_by_step": loss_err, "grads_compared": len(tr["grads"]),
            "grad_max_err_over_own_max": worst,
            "relu_kinks": kinks, "kinks_within_bound": all(k["within"] for k in kinks),
            "aligned_losses": [ln["total_loss"] for ln in aligned["losses"]],
            "grad_worst": [{"param": n, "err_over_own_max": q, "own_max_abs": m}
                           for q, n, m, *_ in sorted(set(sum(rows, [])), reverse=True)[:4]],
            "grad_worst_unaligned": [{"param": n, "err_over_own_max": q, "own_max_abs": m}
                                     for q, n, m, *_ in unaligned[:4]],
            "replicated_params": len(trs[0]["replicated"]), "sharded_params": trs[0]["sharded"],
            "replicated_bitwise_equal": bitwise, "kernel_launches": launched,
            "step_ms": [r["step_ms"] for r in trs], "single_step_ms": tr["step_ms"]}
    print(json.dumps(line), flush=True)
    require(all(e <= 1e-5 for e in loss_err), f"tp_tspm train: losses differ by {loss_err}")
    require(len(kinks) <= TP_TRAIN_MAX_KINKS and all(k["within"] for k in kinks),
            f"tp_tspm train: FFN ReLUs on other sides beyond the rounding bound of 0: {kinks}")
    require(worst <= 1e-4, f"tp_tspm train: a first-step gradient differs by {worst:.3e} of its "
                           "own largest element")
    require(bitwise, "tp_tspm train: the ranks' replicated parameters differ")
    require(not any(launched), f"tp_tspm train: kernel launches {launched}; dropout keeps "
                               "TSPM's attention on the plain path")
    return r0["launches"]


def tp_graph_chain(rng, gen):
    """The chain of ``tp_graph`` (a) on the card, tp 2, every rank in this
    process, the partials summed by local adds in rank order: the train
    stages of ``tp_train_chain`` at the recipe in fp32 (fused_avq_train's
    five, fused_patch_select_train's seven, forward then backward) and the
    two one-head stages split by lanes at AV_Attn's bf16 shape. Returns a
    function that runs it and returns its outputs, flat."""
    import torch

    from qa_tiger_tpu_torch.ops import attention as A
    from qa_tiger_tpu_torch.ops import avq as AV
    from qa_tiger_tpu_torch.ops import patch_select as PS

    tp, f32 = 2, torch.float32
    _, _, _, cot, make_avq = avq_tp_setup(tp, f32, rng, gen)
    av = [make_avq(r, f32) for r in range(tp)]
    _, _, _, cots, make_ps = patch_tp_setup(tp, f32, rng, gen)
    ps = [make_ps(r, f32) for r in range(tp)]
    b, W, wl = TP_TSPM_SHAPES[0][1], 512, 512 // tp
    qkv = torch.from_numpy(rng.standard_normal((b, T, 3 * W), dtype=np.float32)).to(
        "cuda", torch.bfloat16)
    lanes = [slice(r * wl, (r + 1) * wl) for r in range(tp)]

    def chain() -> list:
        outs = []
        t1 = _tp_sum([AV.fused_avq_train_tp_attn(st) for st in av])
        t2 = _tp_sum([AV.fused_avq_train_tp_mid(st, t1) for st in av])
        outs += [AV.fused_avq_train_tp_out(st, t2) for st in av]
        ffn = [AV.fused_avq_train_bwd_tp_ffn(st, cot, r == 0) for r, st in enumerate(av)]
        gh1 = _tp_sum([part for part, _ in ffn])
        att = [AV.fused_avq_train_bwd_tp_attn(st, gh1, r == 0) for r, st in enumerate(av)]
        outs += [_tp_sum([part for part, _ in att])] + _flat([g for _, g in ffn + att])
        s1 = _tp_sum([PS.fused_patch_select_train_tp_self(st) for st in ps])
        s2 = _tp_sum([PS.fused_patch_select_train_tp_cross(st, s1) for st in ps])
        s3 = _tp_sum([PS.fused_patch_select_train_tp_mlp(st, s2) for st in ps])
        outs += _flat([PS.fused_patch_select_train_tp_out(st, s3) for st in ps])
        mlp = [PS.fused_patch_select_train_bwd_tp_mlp(st, *cots) for st in ps]
        m = _tp_sum([x[0] for x in mlp])
        crs = [PS.fused_patch_select_train_bwd_tp_cross(st, m) for st in ps]
        c = _tp_sum([x[0] for x in crs])
        slf = [PS.fused_patch_select_train_bwd_tp_self(st, c) for st in ps]
        outs += _flat(mlp) + _flat(crs) + _flat(slf)
        scores = _tp_sum([A.attention_wide_tp_scores(qkv[..., c], qkv[..., W + c.start:W + c.stop])
                          for c in lanes])
        outs += [scores] + [A.attention_wide_tp_pv(scores, qkv[..., 2 * W + c.start:2 * W + c.stop],
                                                   None, W ** -0.5) for c in lanes]
        return outs

    return chain


def tp_graph_fake(rng) -> dict | None:
    """``tp_graph`` (b): one process at dp1 x tp2 over PyTorch's fake
    process group (``torch.testing._internal.distributed.fake_pg``: its
    collectives do nothing, so rank 0's sums are its own partials: the
    capture is shown, not a tensor-parallel step's numbers). Two QA-TIGER
    runners from seed 0 at the recipe with ``steps_per_dispatch`` GRAPH_K
    over the same 9 staged batches: the graph runner's windows (a warm-up,
    a capture, 8 replays of rank 0's whole step) bitwise its eager twin's
    static-input step; the launch counters reset around one more eager step
    (its stages the TP step's, TP_TRAIN_STAGE_COUNTS) and one more replay
    (the same launches). None where this PyTorch has no fake process
    group."""
    import torch
    import torch.distributed as dist

    from qa_tiger_tpu_torch import ops, parallel
    from qa_tiger_tpu_torch.parallel import make_grid

    if importlib.util.find_spec("torch.testing._internal.distributed.fake_pg") is None:
        return None
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        require(parallel.backend() == "fake", "tp_graph: no fake process group")
        grid = make_grid(2)
        graph, eager = (graph_runner(capture, grid=grid) for capture in (True, False))
        staged = [graph.stage_batch(make_train_batch(rng, 32)) for _ in range(9)]
        g_losses = run_windows(graph, staged)
        e_losses = run_windows(eager, staged)
        torch.cuda.synchronize()
        line = require_graph_equals_eager("tp_fake", graph, eager, g_losses, e_losses,
                                          len(staged) - 1)
        ops.reset_launches()
        eager.train_window(staged[:1], TRAIN_LR)
        torch.cuda.synchronize()
        eager_counts, stages = ops.launch_counts(), ops.stage_counts()
        ops.reset_launches()
        graph.train_window(staged[:1], TRAIN_LR)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        dist.destroy_process_group()
    line.update(launches=counts, eager_launches=eager_counts,
                eager_stages={n: c for n, c in stages.items() if c})
    return line


def check_tp_graph() -> dict | None:
    """Phase ``tp_graph``: the model-axis step under a CUDA graph on the one
    card (NCCL refuses two ranks on one card, so the capture of the model
    group across ranks cannot run here). (a) ``tp_graph_chain`` run eagerly,
    then warmed up on a side stream, captured in one CUDA graph and
    replayed 3 times: each replay bitwise the eager run; the eager chain and
    a replay timed. (b) ``tp_graph_fake``. Returns (b)'s launches over one
    replay, or None without a fake process group."""
    import torch

    from qa_tiger_tpu_torch import ops

    rng = np.random.default_rng(24)
    gen = torch.Generator().manual_seed(24)
    chain = tp_graph_chain(rng, gen)
    with torch.no_grad():
        eager = [t.clone() for t in chain()]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            chain()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_state()
        with torch.cuda.graph(graph):
            static = chain()
        delta = ops.launch_delta(before, ops.launch_state())
        ops.restore_launches(before)
        equal = []
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            equal.append(all(torch.equal(a, b) for a, b in zip(static, eager)))
        eager_ms, replay_ms = cuda_ms(chain, iters=5), cuda_ms(graph.replay, iters=5)
    line = {"phase": "tp_graph_chain", "tp": 2, "tensors": len(eager),
            "replays_bitwise_equal": equal, "launches_per_replay": {n: c for n, (c, _) in
                                                                    delta.items()},
            "eager_ms": eager_ms, "replay_ms": replay_ms}
    print(json.dumps(line), flush=True)
    require(len(eager) == len(static) and all(equal),
            f"tp_graph: a replay of the captured stage chain differs from the eager chain "
            f"({equal})")
    del graph, static, eager, chain
    torch.cuda.empty_cache()
    fake = tp_graph_fake(rng)
    print(json.dumps({"phase": "tp_graph_fake", **(fake or {"skipped": "no fake process "
                                                                        "group in this PyTorch"}),
                      "note": "collectives do nothing: the capture, not a TP step's numbers"}),
          flush=True)
    if fake is None:
        return None
    require(fake["eager_stages"] == TP_TRAIN_STAGE_COUNTS,
            f"tp_graph: the eager twin's step ran the stages {fake['eager_stages']}, not the "
            "TP step's")
    require(fake["launches"] == fake["eager_launches"],
            f"tp_graph: a replay launched {fake['launches']}, the eager step "
            f"{fake['eager_launches']}")
    return fake["launches"]


PHASE_SECONDS: dict[str, float] = {}


def timed(name: str, fn, *args):
    """``fn(*args)``, its wall seconds printed as a line of their own and
    kept in PHASE_SECONDS under ``name``."""
    start = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - start
        print(json.dumps({"phase_seconds": name, "seconds": PHASE_SECONDS[name]}), flush=True)


def profile_step(fn, path: Path, phase: str) -> dict:
    """A torch.profiler table of one call of ``fn`` written to ``path``, and
    its wall time, device busy time and idle share. A line before them
    (``<phase>_kernels``) sets the profiler's count of each device kernel
    by name beside the wrappers' launch counts over the same call
    (``ops.launch_delta``): whether the table holds every launch. The
    profiler is ``utils.profiling.trace``, whose Chrome trace (in a
    temporary directory) ``trace_summary`` reads: a line ``<phase>_trace``
    sets its launches by port kernel (launcher regions, and those whose
    device kernels the trace holds), its device events and its busy time
    beside the wrappers' and the table's. Returns the profiler's count of
    each device kernel by name."""
    import tempfile

    import torch
    from torch.autograd import DeviceType

    from qa_tiger_tpu_torch import ops, trace_summary
    from qa_tiger_tpu_torch.utils.profiling import trace

    path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, f"{phase}.json") as prof:
            torch.cuda.synchronize()
            before = ops.launch_state()
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            launched = ops.launch_delta(before, ops.launch_state())
        summary = trace_summary.summarize(Path(tmp) / f"{phase}.json")
    events = prof.key_averages()
    kernel_counts = {e.key: e.count for e in events
                     if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
    wrappers = {name: n for name, (n, _) in launched.items()}
    print(json.dumps({"phase": f"{phase}_kernels", "wrapper_launches": wrappers,
                      "profiler_kernels": kernel_counts,
                      "profiler_kernel_events": sum(kernel_counts.values())}), flush=True)
    port = summary["port_launches"]
    print(json.dumps({
        "phase": f"{phase}_trace", "wrapper_launches": wrappers,
        "trace_launches": {name: [e["launches"], e["traced"]] for name, e in port.items()},
        "trace_kernels_by_port_kernel": {name: e["kernels"] for name, e in port.items()},
        "trace_device_events": sum(n for n, _ in summary["kernels"].values()),
        "profiler_device_events": sum(kernel_counts.values()),
        "trace_busy_ms": summary["busy_ms"], "trace_window_ms": summary["window_ms"],
        "trace_idle_share": summary["idle_share"]}), flush=True)
    # names wide enough to tell a kernel's template instances apart
    table = events.table(sort_by="self_cuda_time_total", row_limit=60,
                         max_name_column_width=110)
    path.write_text(table)
    print(table, flush=True)
    # kernel time only, as the table's "Self CUDA time total" counts it
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    print(json.dumps({"phase": phase, "wall_ms": wall * 1e3, "device_busy_ms": busy,
                      "idle_share": 1 - busy / (wall * 1e3)}), flush=True)
    return kernel_counts


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
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)

    run_start = time.perf_counter()
    try:
        card = gpu_line()
        print(card, flush=True)
        print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__,
                          "cuda": torch.version.cuda,
                          "device": torch.cuda.get_device_name(0)}), flush=True)
        start = time.perf_counter()
        _build.library()
        PHASE_SECONDS["build"] = time.perf_counter() - start
        print(json.dumps({"phase": "build", "seconds": PHASE_SECONDS["build"],
                          "log": str(_build.build_log)}), flush=True)

        rng = np.random.default_rng(0)
        gen = torch.Generator().manual_seed(0)
        entries = timed("kernels", check_kernels, rng, gen)
        timed("e2e_kernels", check_e2e_kernels, rng, gen, entries)
        timed("sm90_sweep", check_sm90_sweep, np.random.default_rng(26), entries)
        timed("op_kernels", check_op_kernels, entries)
        timed("clip_text_kernel", check_clip_text_kernel, entries)
        timed("tp_chain", check_tp_kernels, entries)
        timed("tp_tspm_chain", check_tp_tspm_chain, entries)
        timed("gemms", check_gemms)
        timed("tf32x3_gemms", check_tf32x3_gemms)
        timed("slice1_grads", check_slice1_grads, rng, gen)
        timed("train_kernels", check_train_kernels, rng, gen, entries)
        timed("tp_train_chain", check_tp_train_chain, entries)
        paths = {}
        paths["serving"], slice_rate = timed("serving", check_slice, rng, entries, args.profile)
        torch.cuda.empty_cache()
        paths["serve"] = timed("serve", check_serve, slice_rate, args.profile)
        torch.cuda.empty_cache()
        paths["train"], recipe_rate = timed("train", check_train, rng, entries, args.profile)
        torch.cuda.empty_cache()
        paths["resume"] = timed("resume", check_resume, np.random.default_rng(10))
        torch.cuda.empty_cache()
        paths["train_graph"] = timed("train_graph", check_train_graph, 32e3 / recipe_rate,
                                     args.profile)
        torch.cuda.empty_cache()
        paths["cli"] = timed("cli", check_cli, recipe_rate)
        torch.cuda.empty_cache()
        timed("e2e_fp32", check_e2e_fp32, rng)
        torch.cuda.empty_cache()
        paths["e2e"] = timed("e2e_bf16", check_e2e_bf16, rng, args.profile)
        torch.cuda.empty_cache()
        timed("extract", check_extract, rng, args.profile)
        torch.cuda.empty_cache()
        timed("tspm_attention", check_tspm_attention, entries)
        torch.cuda.empty_cache()
        paths["tspm"], paths["tspm_train"] = timed("tspm", check_tspm, args.profile)
        torch.cuda.empty_cache()
        paths["tspm_cli"] = timed("tspm_cli", check_tspm_cli)
        torch.cuda.empty_cache()
        paths["bench_resblock"] = timed("bench_resblock", check_bench_resblock)
        torch.cuda.empty_cache()
        paths.update(timed("clip", check_clip, args.profile))
        timed("tools", check_tools)
        pair = timed("pair_spawn", check_pair)
        paths["dp_eval"], paths["dp_train"] = timed("dp", check_dp, pair)
        torch.cuda.empty_cache()
        paths["dp_graph"] = timed("dp_graph", check_dp_graph)
        torch.cuda.empty_cache()
        timed("dp_cli", check_dp_cli)
        torch.cuda.empty_cache()
        paths["tp_eval"] = timed("tp_eval", check_tp_eval, pair)
        torch.cuda.empty_cache()
        paths["tp_train"] = timed("tp_train", check_tp_train, pair)
        torch.cuda.empty_cache()
        paths["tp_tspm"] = timed("tp_tspm", check_tp_tspm, pair)
        torch.cuda.empty_cache()
        tp_graph = timed("tp_graph", check_tp_graph)
        if tp_graph is not None:
            paths["tp_graph"] = tp_graph
        torch.cuda.empty_cache()
        paths["cli_v2"] = timed("cli_v2", check_cli_v2)
        for name in (*E2E_ONLY_KERNELS, SM90):
            entries[name]["launches"] = paths["e2e"][name]
        for name in OP_KERNELS:
            entries[name]["launches"] = paths["bench_resblock"][name]
        for name, entry in entries.items():
            # the Hopper kernel's launches are read back on the bf16 paths
            # that reach it (e2e, clip_*) and on no other
            entry["launches_by_path"] = {path: c[name] for path, c in paths.items()
                                         if name != SM90 or SM90 in c}
        require(set(entries) == {*ops.KERNELS, SM90}, "a kernel is missing from the table")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"phase": "seconds", "total": time.perf_counter() - run_start,
                      "by_phase": PHASE_SECONDS}), flush=True)
    print(card)
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
