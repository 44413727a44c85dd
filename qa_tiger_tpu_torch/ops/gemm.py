"""The GEMM routines under the fused kernels, as the card's dispatch picks them.

``fused_attn_ln2``, ``fused_attn_half``, ``fused_resblock`` and
``fused_patch_select`` run their projections on one of two device routines
(``csrc/gemm_sm90.cuh``): ``gemm_sm90``, a bf16 Hopper GEMM (TMA loads into
a ring of shared-memory stages, ``wgmma`` products), for every bf16 product
whose N and K are multiples of 8; ``gemm_tile`` (``csrc/common.cuh``)
otherwise, on WMMA in bf16 and on an FMA loop in fp32. The planned launches
are the forward and the backward of both train kernels
(``fused_avq_train``, ``fused_patch_select_train``): each checks its
products against the plan its wrapper built (``gemm_plan``) and writes into
it, product by product, the routine it took. Their fp32 products all run on
``gemm_tf32x3`` (``csrc/gemm_tf32x3.cuh``: 3xTF32 on a Hopper kernel, TMA
loads of the raw fp32 slabs and ``wgmma``, B split into K-major hi/lo tiles
once a block; split-K for the backwards' weight gradients), as do the fp32
products of ``fused_patch_select``, ``fused_attn_ln2``, ``fused_attn_half``
and the MoE's second Linear; in bf16 the forwards' products take
``gemm_sm90`` as above and the backwards' ``gemm_tile``'s WMMA loop.
``gemm_route`` names the routine an unplanned product takes.
``gemm_sm90`` and ``gemm_tf32x3`` here call a routine alone, so that it can
be checked and timed by itself; no model path calls them.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from qa_tiger_tpu_torch.ops import _build

ROUTES = {0: "fma", 1: "wmma", 2: "wgmma", 3: "tf32x3"}
EPILOGUES = {"bias": 0, "residual": 1, "f32": 2}
# gemm_tf32x3's output tile (BM, BN) and K slab (csrc/gemm_tf32x3.cuh TF_BM,
# TF_BN, TF_BK; the routine refuses a chunk that is not a multiple of the
# slab), and the fewest slabs a split-K chunk holds
TF32X3_TILE = (128, 128, 32)
MIN_SPLIT_SLABS = 16


def gemm_route(dtype: torch.dtype, m: int, n: int, k: int) -> str:
    """The routine a fused kernel's [m, k] x [n, k] product takes on the
    card: "wgmma" (``gemm_sm90``), "wmma" or "fma" (``gemm_tile``). Asks the
    kernel library, so it builds it on first use."""
    return _route(_build.dtype_code(dtype), m, n, k)


@functools.lru_cache(maxsize=None)
def _route(code: int, m: int, n: int, k: int) -> str:
    return ROUTES[_build.library().qt_gemm_route(code, m, n, k)]


def attn_gemm_shapes(rows: int, width: int) -> list:
    """(M, N, K) of the two products of one attention half over ``rows``
    token rows of ``width``: the ln_1-fused qkv projection, out_proj."""
    return [(rows, 3 * width, width), (rows, width, width)]


def mlp_gemm_shapes(rows: int, width: int) -> list:
    """(M, N, K) of the two products of one MLP half (``fused_resblock``)
    over ``rows`` token rows of ``width``: c_fc (ln_2 staged or in the A
    load), c_proj."""
    return [(rows, 4 * width, width), (rows, width, 4 * width)]


def patch_select_gemm_shapes(frames: int, patches: int, width: int) -> list:
    """(M, N, K) of the seven products of one PatchSelecter launch, eval or
    train forward, in launch order: over the patch rows the
    self-attention's qkv and out_proj and the cross attention's k|v; over
    the 2 query rows per frame the query projection, out_proj and the MLP's
    two layers."""
    rows, queries = frames * patches, 2 * frames
    return [(rows, 3 * width, width), (rows, width, width), (rows, 2 * width, width),
            (queries, width, width), (queries, width, width),
            (queries, width // 2, width), (queries, width, width // 2)]


def patch_select_train_bwd_gemm_shapes(frames: int, patches: int, width: int) -> list:
    """(M, N, K) of the 14 products of one ``fused_patch_select_train``
    backward (``csrc/patch_select_train.cu``), in launch order, a weight
    gradient's M its output rows and K the rows it sums over: the MLP's
    two layers (dgrad, dW each), the cross out_proj (dgrad, dW), the cross
    in_proj's query half (dW, dgrad into video and audio) and k|v half
    (dgrad into x1, dW) over the 2 query rows per frame and the patch rows,
    the self out_proj (dgrad, dW) and in_proj (dW, dgrad into the patches)."""
    rows, queries, d, dh = frames * patches, 2 * frames, width, width // 2
    return [(queries, dh, d), (d, dh, queries), (queries, d, dh), (dh, d, queries),
            (queries, d, d), (d, d, queries), (d, d, queries), (queries, d, d),
            (rows, d, 2 * d), (2 * d, d, rows), (rows, d, d), (d, d, rows),
            (3 * d, d, rows), (rows, d, 3 * d)]


def avq_train_fwd_gemm_shapes(n: int, t: int, s: int, width: int) -> list:
    """(M, N, K) of the ten products of one ``fused_avq_train`` forward
    (``csrc/avq.cu``) over n batch rows of t frames and s words, in launch
    order: the question block's q over the rows and k|v over the words, the
    self block's packed qkv, the cross block's q and k|v (over the other
    stream's rows), the three out_projs (self, cross, question), linear1 and
    linear2."""
    rows, words, d = n * t, n * s, width
    return ([(rows, d, d), (words, 2 * d, d), (rows, 3 * d, d), (rows, d, d), (rows, 2 * d, d)]
            + [(rows, d, d)] * 5)


def avq_train_bwd_gemm_shapes(n: int, t: int, s: int, width: int) -> list:
    """(M, N, K) of the 20 products of one ``fused_avq_train`` backward
    (``csrc/avq.cu``) over n batch rows of t frames and s words, in launch
    order: linear2 and linear1 (dgrad, dW each); then per attention block
    (question-guided, self, cross) its out_proj (dgrad, dW) and in_proj
    (the question block: q dW, k|v dW over the words, dgrads into src and
    the words; self: qkv dW, dgrad into src; cross: q dW, k|v dW, dgrads
    into src and the other stream)."""
    rows, words, d = n * t, n * s, width
    out_proj = [(rows, d, d), (d, d, rows)]
    return ([(rows, d, d), (d, d, rows), (rows, d, d), (d, d, rows)]
            + out_proj + [(d, d, rows), (2 * d, d, words), (rows, d, d), (words, d, 2 * d)]
            + out_proj + [(3 * d, d, rows), (rows, d, 3 * d)]
            + out_proj + [(d, d, rows), (2 * d, d, rows), (rows, d, d), (rows, d, 2 * d)])


def avq_train_tp_gemm_shapes(n: int, t: int, s: int, width: int, local: int) -> dict:
    """(M, N, K) of the products of each tensor-parallel stage of
    ``fused_avq_train`` (``csrc/avq.cu``) on one model rank, in launch
    order, ``local`` = width / tp the rank's head columns and its share of
    linear1 / linear2:

    - ``tp_attn``: the question block's q and k|v, the self block's qkv,
      the cross block's q and k|v over the rank's heads, then the three
      out_proj partials (self, cross, question) over K = local;
    - ``tp_mid``: linear1's column shard, linear2's row partial;
    - ``bwd_tp_ffn``: linear2's dgrad and dW, linear1's dgrad partial and
      dW;
    - ``bwd_tp_attn``: per block (question, self, cross) its out_proj
      dgrad and dW, then its in_proj's dW and the dgrad partials into src,
      the words and the other stream, as ``avq_train_bwd_gemm_shapes``
      orders them."""
    rows, words, d, w = n * t, n * s, width, local
    out_proj = [(rows, w, d), (d, w, rows)]
    return {"tp_attn": [(rows, w, d), (words, 2 * w, d), (rows, 3 * w, d), (rows, w, d),
                        (rows, 2 * w, d)] + [(rows, d, w)] * 3,
            "tp_mid": [(rows, w, d), (rows, d, w)],
            "bwd_tp_ffn": [(rows, w, d), (d, w, rows), (rows, d, w), (w, d, rows)],
            "bwd_tp_attn": (out_proj + [(w, d, rows), (2 * w, d, words), (rows, d, w),
                                        (words, d, 2 * w)]
                            + out_proj + [(3 * w, d, rows), (rows, d, 3 * w)]
                            + out_proj + [(w, d, rows), (2 * w, d, rows), (rows, d, w),
                                          (rows, d, 2 * w)])}


def patch_select_train_tp_gemm_shapes(frames: int, patches: int, width: int,
                                      local: int) -> dict:
    """(M, N, K) of the products of each tensor-parallel stage of
    ``fused_patch_select_train`` (``csrc/patch_select_train.cu``) on one
    model rank, in launch order, ``local`` = width / tp the rank's head
    columns (its MLP hidden share is local / 2); the eval stages
    (``csrc/patch_select.cu``: ``fused_patch_select_tp_self``, ``_tp_cross``,
    ``_tp_mlp``) launch the forward's three:

    - ``tp_self``: the self-attention's qkv over the rank's heads, its
      out_proj partial;
    - ``tp_cross``: the cross k|v over the patch rows, the query
      projection, the out_proj partial;
    - ``tp_mlp``: mlp.0's column shard, mlp.2's row partial;
    - ``bwd_tp_mlp``: mlp.2's dgrad and dW, mlp.0's dgrad partial and dW;
    - ``bwd_tp_cross``: the cross out_proj's dgrad and dW, the query
      half's dW and dgrad partial into the two streams, the k|v half's
      dgrad partial into x1 and dW;
    - ``bwd_tp_self``: the self out_proj's dgrad and dW, the qkv dW and
      the dgrad partial into the patches."""
    rows, queries, d, w, h = frames * patches, 2 * frames, width, local, local // 2
    return {"tp_self": [(rows, 3 * w, d), (rows, d, w)],
            "tp_cross": [(rows, 2 * w, d), (queries, w, d), (queries, d, w)],
            "tp_mlp": [(queries, h, d), (queries, d, h)],
            "bwd_tp_mlp": [(queries, h, d), (d, h, queries), (queries, d, h), (h, d, queries)],
            "bwd_tp_cross": [(queries, w, d), (d, w, queries), (w, d, queries), (queries, d, w),
                             (rows, d, 2 * w), (2 * w, d, rows)],
            "bwd_tp_self": [(rows, w, d), (d, w, rows), (3 * w, d, rows), (rows, d, 3 * w)]}


def note_routes(kernel, dtype: torch.dtype, shapes) -> None:
    """Adds one to ``kernel.gemm_routes[route]`` for the route each of a
    launch's products takes, so that a run can show which routine its
    calls went through (``ops.reset_launches`` clears it)."""
    tally_routes(kernel, (gemm_route(dtype, m, n, k) for m, n, k in shapes))


def note_plan_routes(kernel, plan: torch.Tensor) -> None:
    """``note_routes`` for a planned launch: the routes it wrote into its
    plan (``gemm_plan``) as it launched each product."""
    tally_routes(kernel, (ROUTES[code] for code in plan[:, 4].tolist()))


def tally_routes(kernel, routes) -> None:
    """Adds one to ``kernel.gemm_routes[route]`` for each route named."""
    for route in routes:
        kernel.gemm_routes[route] = kernel.gemm_routes.get(route, 0) + 1


class SplitK(NamedTuple):
    """How ``gemm_tf32x3`` cuts K: ``splits`` chunks of ``chunk`` rows (a
    multiple of the K slab; the last may be shorter), ``workspace`` fp32
    partials [splits, M, N] (0 without a split)."""
    splits: int
    chunk: int
    workspace: int


def splitk_request(m: int, n: int, k: int, sms: int) -> int:
    """The chunks a planned product asks for on a card of ``sms`` SMs: 1
    where the output's 128 x 128 tiles fill the SMs once; else, counting up
    over the counts that leave each chunk at least MIN_SPLIT_SLABS K slabs,
    each count whose waves of blocks (one per SM) per chunk,
    ceil(tiles S / sms) / S, are at least 5% fewer than the last one taken:
    1536 x 512 (48 tiles) over 26,880 rows takes 8 chunks in 3 waves (0.375
    of K per SM), not 2 in one wave of 96 blocks (0.5), and 512 x 512 takes
    8 in one wave, not 33 in 4 for 3% less."""
    bm, bn, bk = TF32X3_TILE
    tiles = -(-m // bm) * -(-n // bn)
    if sms <= 0 or tiles >= sms:
        return 1
    best, best_waves = 1, 1
    for s in range(2, -(-k // bk) // MIN_SPLIT_SLABS + 1):
        waves = -(-tiles * s // sms)
        if waves * best * 20 < best_waves * s * 19:
            best, best_waves = s, waves
    return best


def splitk_plan(m: int, n: int, k: int, sms: int, want: int | None = None) -> SplitK:
    """K cut into at most ``want`` chunks of whole slabs (default:
    ``splitk_request``), as the routine cuts it."""
    bk = TF32X3_TILE[2]
    want = splitk_request(m, n, k, sms) if want is None else want
    slabs = -(-k // bk)
    want = max(1, min(want, slabs))
    per = -(-slabs // want)
    splits = -(-slabs // per)
    return SplitK(splits, per * bk, splits * m * n if splits > 1 else 0)


def gemm_plan(dtype: torch.dtype, shapes, sms: int) -> torch.Tensor:
    """The plan a planned launch (a train kernel's forward or backward)
    takes: one int32 row (M, N, K, chunk, route) per product, in
    launch order; chunk from ``splitk_plan`` in fp32 (0 in bf16, whose
    products do not split), route -1 until the kernel writes the ``ROUTES``
    code of the routine it launched. The kernel refuses a product the plan
    does not name and a plan with rows left over."""
    rows, _ = _gemm_plan(dtype == torch.float32, tuple(shapes), sms)
    return torch.tensor(rows, dtype=torch.int32).reshape(-1, 5)


def plan_workspace(dtype: torch.dtype, shapes, sms: int) -> int:
    """Floats of split-K workspace one planned launch needs: the largest
    plan of its products (they run in order on one stream and share it);
    0 in bf16, whose products do not split."""
    return _gemm_plan(dtype == torch.float32, tuple(shapes), sms)[1]


@functools.lru_cache(maxsize=64)
def _gemm_plan(fp32: bool, shapes: tuple, sms: int) -> tuple:
    """(rows, workspace floats) of ``gemm_plan``, computed once per launch
    shape: a launch adds no planning to the host's share."""
    plans = [splitk_plan(m, n, k, sms) for m, n, k in shapes]
    rows = [(m, n, k, plan.chunk if fp32 else 0, -1) for (m, n, k), plan in zip(shapes, plans)]
    return rows, (max((plan.workspace for plan in plans), default=0) if fp32 else 0)


def launch_plan(dtype: torch.dtype, shapes, attns, device) -> tuple:
    """The plan of one planned launch: (GEMM plan rows, ``gemm_plan`` of
    ``shapes``; attention rows, ``keep_rows`` of ``attns``; the C launcher's
    plan arguments; the split-K workspace or None). The arguments carry the
    workspace, allocated here where the plan splits a product."""
    from qa_tiger_tpu_torch.ops.attention import keep_rows

    sms = sm_count(device)
    plan = gemm_plan(dtype, shapes, sms)
    ws_floats = plan_workspace(dtype, shapes, sms)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=device) if ws_floats else None
    rows = keep_rows(attns)
    args = [plan.data_ptr(), len(shapes), rows.data_ptr(), len(rows), _build.ptr(ws), ws_floats]
    return plan, rows, args, ws


def note_launch_plan(kernel, plan: torch.Tensor, rows: torch.Tensor) -> None:
    """Tallies the routes a planned launch wrote into its plan
    (``gemm_routes``) and attention rows (``attn_routes``)."""
    from qa_tiger_tpu_torch.ops.attention import note_keep_routes

    note_plan_routes(kernel, plan)
    note_keep_routes(kernel, rows)


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` where a 16-byte load (TMA, cp.async) can read it (a 16-byte
    aligned base), else an aligned contiguous copy: alignment never decides
    a route or makes a fused kernel or a train backward raise."""
    return t.clone(memory_format=torch.contiguous_format) if t.data_ptr() % 16 else t


def tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` where TMA can read it (a 16-byte aligned base), else an
    aligned contiguous copy: alignment never decides a route or makes a call
    raise. Only bf16 tensors feed TMA."""
    return aligned16(t) if t.dtype == torch.bfloat16 else t


def gemm_plain(a, b, *, epilogue: str = "bias", bias=None, res=None, relu: bool = False):
    """Plain version: C = a b^T summed in fp32, then the epilogue as the
    kernels' functors apply it: "bias" round(act(C + bias)); "residual"
    res + round(C + bias), summed in fp32 and rounded; "f32" C + bias in
    fp32."""
    acc = a.float() @ b.float().t()
    if bias is not None:
        acc = acc + bias.float()
    if epilogue == "bias":
        return (acc.relu() if relu else acc).to(a.dtype)
    if epilogue == "residual":
        return (res.float() + acc.to(a.dtype).float()).to(a.dtype)
    if epilogue == "f32":
        return acc
    raise ValueError(f"unknown epilogue {epilogue!r}")


def gemm_sm90(a: torch.Tensor, b: torch.Tensor, *, epilogue: str = "bias",
              bias: torch.Tensor | None = None, res: torch.Tensor | None = None,
              relu: bool = False) -> torch.Tensor:
    """C = a [M, K] b [N, K]^T through one epilogue (``gemm_plain`` says
    which), bf16 in, on ``gemm_sm90`` for CUDA tensors and ``gemm_plain``
    for CPU tensors. ``a`` needs unit stride along K, ``b`` and ``res``
    contiguous."""
    if a.device.type == "cpu":
        return gemm_plain(a, b, epilogue=epilogue, bias=bias, res=res, relu=relu)
    M, K = a.shape
    N = b.shape[0]
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or a.stride(1) != 1:
        raise ValueError("gemm_sm90 takes bf16 a with unit stride along K and bf16 b")
    if tuple(b.shape) != (N, K) or gemm_route(a.dtype, M, N, K) != "wgmma":
        raise ValueError(f"gemm_sm90 does not take [{M}, {K}] x {tuple(b.shape)}")
    if epilogue == "f32" and bias is None:
        raise ValueError("the f32 epilogue needs a bias")
    if epilogue == "residual" and (res is None or tuple(res.shape) != (M, N)):
        raise ValueError(f"the residual epilogue needs res [{M}, {N}]")
    b = tma_ready(b.contiguous())
    if a.data_ptr() % 16 or a.stride(0) % 8:
        a = a.clone(memory_format=torch.contiguous_format)
    bias = None if bias is None else bias.to(torch.bfloat16).contiguous()
    res = None if res is None else res.to(torch.bfloat16).contiguous()
    out = torch.empty(M, N, device=a.device,
                      dtype=torch.float32 if epilogue == "f32" else torch.bfloat16)
    _build.launch("qt_gemm_sm90", EPILOGUES[epilogue], a.data_ptr(), a.stride(0),
                  b.data_ptr(), b.stride(0), out.data_ptr(), out.stride(0),
                  _build.ptr(bias), _build.ptr(res), N, int(relu), M, N, K)
    gemm_sm90.launches += 1
    return out


gemm_sm90.launches = 0


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo as ``gemm_tf32x3`` splits an fp32 operand: hi = x with
    its 13 low mantissa bits rounded away (to nearest, ties away from zero,
    as cvt.rna.tf32.f32), lo = the same rounding of x - hi. hi + lo is x to
    within 2^-22 of |x|; ±0 and ±inf keep their value in hi (lo of ±inf is
    NaN, inf - inf, as on the card)."""
    hi = _round_tf32(x.float())
    return hi, _round_tf32(x.float() - hi)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    # half of the lowest kept bit added to the magnitude, the 13 bits cleared
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), x, rounded)


def gemm_tf32x3_plain(a: torch.Tensor, b: torch.Tensor, *, a_col_major: bool = False,
                      b_nk: bool = False) -> torch.Tensor:
    """Plain version of ``gemm_tf32x3``: both operands split by
    ``tf32_split``, then lo·hi + hi·lo + hi·hi as three fp32 products (each
    hi·hi or lo·hi term is exact in fp32; TF32 off)."""
    am = a.t() if a_col_major else a
    bm = b.t() if b_nk else b
    ah, al = tf32_split(am)
    bh, bl = tf32_split(bm)
    return (al @ bh + ah @ bl) + ah @ bh


def gemm_tf32x3(a: torch.Tensor, b: torch.Tensor, *, a_col_major: bool = False,
                b_nk: bool = False, splits: int | None = None) -> torch.Tensor:
    """C [M, N] = A B in fp32 on ``gemm_tf32x3`` for CUDA tensors and
    ``gemm_tf32x3_plain`` for CPU tensors. ``a`` holds A as [M, K] or, with
    ``a_col_major``, as [K, M] (A = a^T); ``b`` holds B as [K, N] or, with
    ``b_nk``, as [N, K]. Both need unit stride along their last dimension;
    the routine also needs 16-byte aligned bases and row strides that are
    multiples of 4, and raises on others. K is cut into at most ``splits``
    chunks (default: ``splitk_request``), as ``splitk_plan``
    plans them."""
    if a.device.type == "cpu":
        return gemm_tf32x3_plain(a, b, a_col_major=a_col_major, b_nk=b_nk)
    if b.device != a.device:
        raise ValueError(f"gemm_tf32x3: a is on {a.device}, b on {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("gemm_tf32x3 takes float32 operands")
    if a.dim() != 2 or b.dim() != 2 or a.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError("gemm_tf32x3 takes 2-d operands with unit stride along the last dim")
    m, k = (a.shape[1], a.shape[0]) if a_col_major else tuple(a.shape)
    n, kb = tuple(b.shape) if b_nk else (b.shape[1], b.shape[0])
    if kb != k:
        raise ValueError(f"gemm_tf32x3: A has K = {k}, B has {kb}")
    plan = splitk_plan(m, n, k, sm_count(a.device), splits)
    ws = torch.empty(plan.workspace, device=a.device) if plan.workspace else None
    out = torch.empty(m, n, device=a.device)
    _build.launch("qt_gemm_tf32x3", a.data_ptr(), a.stride(0), int(a_col_major), b.data_ptr(),
                  b.stride(0), int(b_nk), out.data_ptr(), n, m, n, k, plan.chunk,
                  _build.ptr(ws), plan.workspace)
    gemm_tf32x3.launches += 1
    return out


gemm_tf32x3.launches = 0
