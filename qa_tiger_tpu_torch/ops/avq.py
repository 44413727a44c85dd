"""The train-mode AVQ sub-forward as one fused operation with its backward.

Port of ``qa_tiger_tpu/ops/pallas/avq.py:fused_avq_train`` (:638): one
direction of AVQCrossAttn over the 2B batch rows (question-guided, self and
cross attention under probability dropout, three residual dropouts, LN1, an
FFN with two dropouts, LN2), the dropout realization given as eight explicit
masks (``models.modules.make_avq_dropout_masks``).

A CUDA tensor runs the forward kernel and, under autograd, the backward
kernel of ``csrc/avq.cu`` inside one ``torch.autograd.Function``; a CPU
tensor runs the plain version ``avq_sub_forward_masked``, which autograd
differentiates. Both launches are planned (``ops.gemm.gemm_plan``): the
forward's ten products run on ``gemm_tf32x3`` in fp32 and ``gemm_sm90`` in
bf16, the backward's 20 on ``gemm_tf32x3`` in fp32; each tallies the routes
its products took in ``fused_avq_train.gemm_routes`` /
``fused_avq_train_bwd.gemm_routes``.

Under tensor parallelism (``parallel/tensor.py``) ``fused_avq_train_tp``
runs the op on one model rank's shards in five stages, split where the
all-reduces fall (``csrc/avq.cu``): forward ``fused_avq_train_tp_attn``
(three fp32 out_proj partials), ``_tp_mid`` (the residual chain, LN1, the
FFN's partial), ``_tp_out`` (LN2); backward ``fused_avq_train_bwd_tp_ffn``
(the partial of g_h1) and ``_bwd_tp_attn`` (the partials of the three input
gradients). One ``torch.autograd.Function`` sums each partial over the
model group between two stages (``Grid.reduce_model``) and rounds the input
gradients once after the last sum. Each stage has a plain version, which a
CPU tensor runs: the forward stages written out, the backward stages as
the vjp of their forward part recomputed under autograd. The first forward
stage counts a ``fused_avq_train`` launch and the first backward stage a
``fused_avq_train_bwd`` launch, so a rank counts what one process counts;
each stage counts its own and tallies its products' routes.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from qa_tiger_tpu_torch.nn.core import layer_norm, linear
from qa_tiger_tpu_torch.ops import _build
from qa_tiger_tpu_torch.ops.attention import (
    attention_bwd_plan,
    attention_plan,
    keep_rows,
    note_keep_routes,
    smem_limit,
)
from qa_tiger_tpu_torch.ops.epilogue import launch_epilogue, tp_stage
from qa_tiger_tpu_torch.ops.gemm import (
    aligned16,
    avq_train_bwd_gemm_shapes,
    avq_train_fwd_gemm_shapes,
    avq_train_tp_gemm_shapes,
    gemm_plan,
    note_plan_routes,
    plan_workspace,
    sm_count,
)

MASK_KEYS = ("qst", "slf", "crs", "d_slf", "d_crs", "d_qst", "ffn1", "ffn2")


def avq_sub_forward_masked(params, src_q: torch.Tensor, src_v: torch.Tensor,
                           query: torch.Tensor, masks: dict, *, nhead: int = 8) -> torch.Tensor:
    """The plain version (the JAX package's ``avq_sub_forward_masked``):
    ``mha`` with the probability masks as ``prob_mask``, then the residual,
    FFN and LayerNorm chain with the explicit multiplicative masks."""
    # nn.attention imports ops.attention, so ops imports it when called
    from qa_tiger_tpu_torch.nn.attention import mha

    N, T, D = src_q.shape
    S = query.shape[1]

    def pm(m, Sk):
        return m[:, :nhead * Sk].reshape(N, T, nhead, Sk).transpose(1, 2)

    def rd(m):
        return m.reshape(N, T, D).to(src_q.dtype)

    qst_out, _ = mha(params.qst_attn, src_q, query, query, num_heads=nhead,
                     need_weights=False, prob_mask=pm(masks["qst"], S))
    slf, _ = mha(params.slf_attn, src_q, src_q, src_q, num_heads=nhead,
                 need_weights=False, prob_mask=pm(masks["slf"], T))
    crs, _ = mha(params.crs_attn, src_q, src_v, src_v, num_heads=nhead,
                 need_weights=False, prob_mask=pm(masks["crs"], T))
    x = src_q + rd(masks["d_slf"]) * slf + rd(masks["d_crs"]) * crs \
        + rd(masks["d_qst"]) * qst_out
    x = layer_norm(x, params.norm1.weight, params.norm1.bias)
    h = torch.relu(linear(x, params.linear1.weight, params.linear1.bias)) * rd(masks["ffn1"])
    ffn = linear(h, params.linear2.weight, params.linear2.bias)
    x = x + rd(masks["ffn2"]) * ffn
    return layer_norm(x, params.norm2.weight, params.norm2.bias)


def _weights(params) -> list:
    """The 20 parameters in the Pallas kernels' packed order (avq.py:237),
    each in the module's own [out, in] layout."""
    out = []
    for attn in (params.qst_attn, params.slf_attn, params.crs_attn):
        out += [attn.in_proj_weight, attn.in_proj_bias, attn.out_proj.weight,
                attn.out_proj.bias]
    for mod in (params.linear1, params.linear2, params.norm1, params.norm2):
        out += [mod.weight, mod.bias]
    return out


WEIGHT_NAMES = ("qst_w", "qst_b", "qst_ow", "qst_ob", "slf_w", "slf_b", "slf_ow", "slf_ob",
                "crs_w", "crs_b", "crs_ow", "crs_ob", "l1_w", "l1_b", "l2_w", "l2_b",
                "n1_w", "n1_b", "n2_w", "n2_b")
SAVED = ("qq", "kvq", "qkv", "qc", "kvc", "qctx", "sctx", "cctx", "x1", "h1", "hr", "hdp", "x2")
# the pointer table of csrc/avq.cu, in its enum's order
BUFFERS = (("src", "val", "wrd") + tuple(f"m_{k}" for k in MASK_KEYS) + WEIGHT_NAMES
           + ("out",) + SAVED + ("g", "gsrc", "gval", "gwrd")
           + tuple(f"g_{n}" for n in WEIGHT_NAMES)
           + ("gf", "gsrc32", "stats", "g_ffn", "g_pre", "g_out_s", "g_out_c", "g_out_q",
              "g_ctx", "g_qq", "g_kvq", "g_qkv", "g_qc", "g_kvc", "ws", "total", "part"))


def _attn_shapes(T: int, S: int) -> list:
    """(Sq, Sk) of the three keep-masked attentions one launch runs, forward
    or backward: question-guided, self, cross."""
    return [(T, S), (T, T), (T, T)]


def _shapes(N, T, S, D):
    return {"qq": (N * T, D), "kvq": (N * S, 2 * D), "qkv": (N * T, 3 * D), "qc": (N * T, D),
            "kvc": (N * T, 2 * D)}


class _AVQTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, nhead, masks, src, val, wrd, *weights):
        N, T, D = src.shape
        S = wrd.shape[1]
        dev, dt = src.device, src.dtype
        # the operands gemm_tf32x3 and gemm_sm90 read in 16-byte chunks
        src, val, wrd = aligned16(src), aligned16(val), aligned16(wrd)
        weights = [aligned16(w) for w in weights]
        bufs = dict(src=src, val=val, wrd=wrd, out=torch.empty_like(src))
        for key in SAVED:
            shape = _shapes(N, T, S, D).get(key, (N * T, D))
            bufs[key] = torch.empty(shape, dtype=dt, device=dev)
        bufs.update({f"m_{k}": masks[k] for k in MASK_KEYS})
        bufs.update(zip(WEIGHT_NAMES, weights))
        shapes = avq_train_fwd_gemm_shapes(N, T, S, D)
        sms = sm_count(dev)
        plan = gemm_plan(dt, shapes, sms)
        ws_floats = plan_workspace(dt, shapes, sms)
        if ws_floats:
            bufs["ws"] = torch.empty(ws_floats, dtype=torch.float32, device=dev)
        rows = keep_rows(_attn_shapes(T, S))
        _build.launch_table("qt_avq_train_fwd", "qt_avq_num_buffers", BUFFERS, bufs,
                            N, T, S, D, nhead, plan.data_ptr(), len(shapes), rows.data_ptr(),
                            len(rows), ws_floats)
        fused_avq_train.launches += 1
        note_plan_routes(fused_avq_train, plan)
        note_keep_routes(fused_avq_train, rows)
        ctx.nhead, ctx.masks = nhead, masks
        ctx.save_for_backward(src, val, wrd, *weights, *[bufs[k] for k in SAVED])
        return bufs["out"]

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        src, val, wrd = saved[:3]
        weights = saved[3:3 + len(WEIGHT_NAMES)]
        bufs = dict(zip(SAVED, saved[3 + len(WEIGHT_NAMES):]))
        gsrc, gval, gwrd, gws = fused_avq_train_bwd(src, val, wrd, weights, bufs, ctx.masks, g,
                                                    ctx.nhead)
        return (None, None, gsrc, gval, gwrd, *[gw.to(w.dtype) for gw, w in zip(gws, weights)])


def fused_avq_train_bwd(src, val, wrd, weights, saved: dict, masks: dict, g, nhead: int):
    """Launch the backward kernel: (gsrc, gval, gwrd, 20 fp32 parameter
    gradients in the module's [out, in] layout)."""
    N, T, D = src.shape
    S = wrd.shape[1]
    R = N * T
    dev, dt = src.device, src.dtype
    f32 = torch.float32

    def e(*shape, dtype=dt):
        return torch.empty(*shape, dtype=dtype, device=dev)

    shapes = avq_train_bwd_gemm_shapes(N, T, S, D)
    sms = sm_count(dev)
    plan = gemm_plan(dt, shapes, sms)
    ws_floats = plan_workspace(dt, shapes, sms)
    if dt == f32:  # the operands gemm_tf32x3 reads in 16-byte chunks
        src, val, wrd = aligned16(src), aligned16(val), aligned16(wrd)
        weights = [aligned16(w) for w in weights]
    grads = [torch.empty(w.shape, dtype=f32, device=dev) for w in weights]
    bufs = dict(src=src, val=val, wrd=wrd, **saved, g=g.to(dt).contiguous(),
                gsrc=torch.empty_like(src), gval=torch.empty_like(val), gwrd=torch.empty_like(wrd),
                gf=e(R, D, dtype=f32), gsrc32=e(R, D, dtype=f32), stats=e(2, R, dtype=f32),
                g_ffn=e(R, D), g_pre=e(R, D), g_out_s=e(R, D), g_out_c=e(R, D), g_out_q=e(R, D),
                g_ctx=e(R, D), g_qq=e(R, D), g_kvq=e(N * S, 2 * D), g_qkv=e(R, 3 * D),
                g_qc=e(R, D), g_kvc=e(R, 2 * D),
                ws=e(ws_floats, dtype=f32) if ws_floats else None)
    bufs.update({f"m_{k}": masks[k] for k in MASK_KEYS})
    bufs.update(zip(WEIGHT_NAMES, weights))
    bufs.update(zip((f"g_{n}" for n in WEIGHT_NAMES), grads))
    rows = keep_rows(_attn_shapes(T, S))
    _build.launch_table("qt_avq_train_bwd", "qt_avq_num_buffers", BUFFERS, bufs,
                        N, T, S, D, nhead, plan.data_ptr(), len(shapes), rows.data_ptr(),
                        len(rows), ws_floats)
    fused_avq_train_bwd.launches += 1
    note_plan_routes(fused_avq_train_bwd, plan)
    note_keep_routes(fused_avq_train_bwd, rows)
    return bufs["gsrc"], bufs["gval"], bufs["gwrd"], grads


fused_avq_train_bwd.launches = 0
fused_avq_train_bwd.gemm_routes = {}  # the GEMM routine of each product launched
fused_avq_train_bwd.attn_routes = {}  # the kernel of each attention backward launched


def fused_avq_train(src: torch.Tensor, val: torch.Tensor, wrd: torch.Tensor, params,
                    masks: dict, nhead: int = 8) -> torch.Tensor:
    """Train-mode AVQ sub-forward: src/val [N, T, D], wrd [N, S, D] ->
    [N, T, D]. ``params`` holds qst_attn, slf_attn, crs_attn, linear1,
    linear2, norm1, norm2; ``masks`` the eight realizations of
    ``make_avq_dropout_masks`` (probability masks [N*T, Lp], lane h*Sk + key;
    the others [N*T, D]), pre-scaled by 1/(1-p).

    On CUDA one forward kernel and, under autograd, one backward kernel,
    which returns the input gradients and fp32 parameter gradients."""
    if src.device.type == "cpu":
        return avq_sub_forward_masked(params, src, val, wrd, masks, nhead=nhead)
    if src.device.type != "cuda":
        raise ValueError(f"fused_avq_train runs on cpu or cuda, not {src.device}")
    N, T, D = src.shape
    S = wrd.shape[1]
    if D % nhead:
        raise ValueError(f"width {D} does not split into {nhead} heads")
    weights = _weights(params)
    shapes = [(3 * D, D), (3 * D,), (D, D), (D,)] * 3 + [(D, D), (D,)] * 2 + [(D,)] * 4
    named = [("src", src, (N, T, D)), ("val", val, (N, T, D)), ("wrd", wrd, (N, S, D))]
    named += [(n, w, s) for n, w, s in zip(WEIGHT_NAMES, weights, shapes)]
    for name, t, shape in named:
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape}, got {tuple(t.shape)}")
        if t.dtype != src.dtype or t.device != src.device:
            raise ValueError(f"{name} must match src's dtype and device")
    pad = lambda n: -(-n // 128) * 128  # noqa: E731
    want = {"qst": (N * T, pad(nhead * S)), "slf": (N * T, pad(nhead * T)),
            "crs": (N * T, pad(nhead * T))}
    dev_masks = {}
    for key in MASK_KEYS:
        m = masks[key]
        shape = want.get(key, (N * T, D))
        if tuple(m.shape) != shape:
            raise ValueError(f"mask {key} must be {shape}, got {tuple(m.shape)}")
        dev_masks[key] = m.to(src.device, src.dtype).contiguous()
    return _AVQTrain.apply(nhead, dev_masks, src, val, wrd, *weights)


fused_avq_train.launches = 0
fused_avq_train.gemm_routes = {}  # the GEMM routine of each product launched
fused_avq_train.attn_routes = {}  # the kernel of each keep-masked attention launched


# ---------------------------------------------------------------------------
# tensor-parallel stages (one model rank's shards; Wl = D / tp columns)
# ---------------------------------------------------------------------------

# the masks cut to a rank's share: by heads (the probability masks), by
# linear1's columns (ffn1); the others are whole on every rank
HEAD_MASKS = ("qst", "slf", "crs")


def shard_avq_masks(masks: dict, nhead: int, S: int, T: int, rank: int, tp: int) -> dict:
    """Model rank ``rank``'s share of ``make_avq_dropout_masks``' whole
    realization: the probability masks' lanes of its nhead/tp heads
    (re-padded to 128 lanes), ffn1's columns of its linear1 shard, the
    others whole."""
    from qa_tiger_tpu_torch.parallel.tensor import column_shard, head_lanes

    keys = {"qst": S, "slf": T, "crs": T}
    out = {k: head_lanes(masks[k], nhead, keys[k], rank, tp) for k in HEAD_MASKS}
    out["ffn1"] = column_shard(masks["ffn1"], rank, tp)
    out.update({k: masks[k] for k in ("d_slf", "d_crs", "d_qst", "ffn2")})
    return out


def _keep_heads(keep, N: int, Sq: int, Sk: int, heads: int) -> torch.Tensor:
    """A probability mask [N*Sq, >= heads*Sk] (lane h*Sk + key) as fp32
    [N, heads, Sq, Sk]."""
    return keep[:, :heads * Sk].reshape(N, Sq, heads, Sk).transpose(1, 2).float()


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    N, S, W = t.shape
    return t.reshape(N, S, heads, W // heads).float()


def _keep_probs(q, k, heads: int, round_p_first: bool) -> torch.Tensor:
    """JAX's ``_attn_fwd`` probabilities: the fp32 product q kᵀ, scaled after
    it, the fp32 softmax -> [N, heads, Sq, Sk]; rounded to q's dtype (and
    back to fp32) with ``round_p_first``, as ``_packed_heads_attn`` does."""
    scale = 1.0 / math.sqrt(q.shape[-1] // heads)
    s = torch.einsum("nqhd,nkhd->nhqk", _split_heads(q, heads), _split_heads(k, heads)) * scale
    p = torch.softmax(s, dim=-1)
    return p.to(q.dtype).float() if round_p_first else p


def keep_attention(q, k, v, keep, heads: int, round_p_first: bool = False):
    """The keep-masked attention's plain version (the kernel's, and the TP
    stages' on the CPU): q [N, Sq, W], k/v [N, Sk, W], ``keep`` [N*Sq, Lp]
    (lane h*Sk + key) -> ctx [N, Sq, W] in q's dtype, rounded where JAX's
    ``_attn_fwd`` (AVQ) and, with ``round_p_first``, ``_packed_heads_attn
    (keep2d=)`` (PatchSelecter) round: the fp32 probability (or its
    rounding) times keep, rounded; the context summed in fp32, rounded."""
    N, Sq, W = q.shape
    p = _keep_probs(q, k, heads, round_p_first)
    pd = (p * _keep_heads(keep, N, Sq, k.shape[1], heads)).to(q.dtype).float()
    ctx = torch.einsum("nhqk,nkhd->nqhd", pd, _split_heads(v, heads))
    return ctx.to(q.dtype).reshape(N, Sq, W)


def keep_score_grads(q, k, v, g, keep, heads: int, round_p_first: bool = False) -> tuple:
    """The backward's rounded intermediates (pd, dS) [N, heads, Sq, Sk], as
    JAX's ``_attn_bwd`` forms them from the probabilities recomputed as
    ``keep_attention`` does (P the fp32 probability, or its rounding with
    ``round_p_first``): dPd = g vᵀ, dP = dPd keep, dS = round(P (dP -
    rowsum(dP P)))."""
    N, Sq, _ = q.shape
    Sk, dt = k.shape[1], q.dtype
    p = _keep_probs(q, k, heads, round_p_first)
    kp = _keep_heads(keep, N, Sq, Sk, heads)
    dp = torch.einsum("nqhd,nkhd->nhqk", _split_heads(g, heads), _split_heads(v, heads)) * kp
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).float()
    return (p * kp).to(dt).float(), ds


def keep_attention_bwd(q, k, v, g, keep, heads: int, round_p_first: bool = False):
    """The backward's plain version, JAX's ``_attn_bwd``: from
    ``keep_score_grads``' pd and dS, dq = round(scale dS k), dk =
    round(scale dSᵀ q), dv = round(pdᵀ g) -> (dq, dk, dv) in q's dtype,
    each in its operand's [N, S, W] layout."""
    N, Sq, W = q.shape
    Sk, dt = k.shape[1], q.dtype
    scale = 1.0 / math.sqrt(W // heads)
    pd, ds = keep_score_grads(q, k, v, g, keep, heads, round_p_first)
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, _split_heads(k, heads)) * scale
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, _split_heads(q, heads)) * scale
    dv = torch.einsum("nhqk,nqhd->nkhd", pd, _split_heads(g, heads))
    return dq.to(dt).reshape(N, Sq, W), dk.to(dt).reshape(N, Sk, W), dv.to(dt).reshape(N, Sk, W)


def _keep_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the keep-masked kernels' 16-byte ``cp.async`` copies can
    read it (a 16-byte aligned base, batch and row strides whole 16 bytes),
    else a contiguous copy; the route does not change."""
    per = 16 // t.element_size()
    if t.data_ptr() % 16 or t.stride(0) % per or t.stride(1) % per:
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _keep_args(q, k, v, keep, heads: int, backward: bool):
    """Checks a keep-masked call for the card (q [N, Sq, W], k/v [N, Sk, W]
    with unit lane stride, keep [N*Sq, >= heads*Sk] with unit lane stride,
    all of one dtype and device) and that ``attention_bwd_plan`` /
    ``attention_plan`` give it the keep-masked kernel; returns the
    operands as the kernel reads them and the head size."""
    N, Sq, W = q.shape
    Sk = k.shape[1]
    for name, t, S in (("q", q, Sq), ("k", k, Sk), ("v", v, Sk)):
        if t.dim() != 3 or tuple(t.shape) != (N, S, W) or t.stride(2) != 1:
            raise ValueError(f"{name} must be [{N}, {S}, {W}] with unit lane stride, "
                             f"got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
    if W % heads:
        raise ValueError(f"width {W} does not split into {heads} heads")
    if (keep.dim() != 2 or keep.shape[0] != N * Sq or keep.shape[1] < heads * Sk
            or keep.stride(1) != 1 or keep.dtype != q.dtype or keep.device != q.device):
        raise ValueError(f"keep must be [{N * Sq}, >= {heads * Sk}] in q's dtype and device "
                         f"with unit lane stride, got {tuple(keep.shape)} {keep.dtype}")
    hd = W // heads
    plan = (attention_bwd_plan if backward else attention_plan)(
        q.dtype, Sq, Sk, hd, has_keep=True, limit=smem_limit(q.device))
    if plan.kernel != "mma_keep":
        raise ValueError(f"the keep-masked tensor-core kernel does not take Sq={Sq}, Sk={Sk}, "
                         f"head size {hd} ({q.dtype}); the train kernels run it on "
                         f"{plan.kernel}")
    return [_keep_operand(t) for t in (q, k, v)], hd


def _strided(t: torch.Tensor) -> tuple:
    return t.data_ptr(), t.stride(0), t.stride(1)


def attention_keep(q, k, v, keep, heads: int, round_p_first: bool = False) -> torch.Tensor:
    """The keep-masked attention kernel by itself (``qt_attention_keep``,
    csrc/attention_keep.cu: the forward the train kernels launch for their
    dropout attentions), for its checks and timing; a CPU tensor runs
    ``keep_attention``. Counts its launches in ``attention_keep.launches``
    (no model path calls it)."""
    if q.device.type == "cpu":
        return keep_attention(q, k, v, keep, heads, round_p_first)
    (q, k, v), hd = _keep_args(q, k, v, keep, heads, False)
    N, Sq, W = q.shape
    out = torch.empty(N, Sq, W, dtype=q.dtype, device=q.device)
    _build.launch("qt_attention_keep", _build.dtype_code(q), *_strided(q), *_strided(k),
                  *_strided(v), *_strided(out), keep.data_ptr(), keep.stride(0), N, Sq,
                  k.shape[1], heads, hd, 1.0 / math.sqrt(hd), int(round_p_first))
    attention_keep.launches += 1
    return out


attention_keep.launches = 0


def attention_keep_bwd(q, k, v, g, keep, heads: int, round_p_first: bool = False,
                       accumulate_kv: tuple | None = None) -> tuple:
    """The keep-masked attention backward kernel by itself
    (``qt_attention_keep_bwd``) -> (dq, dk, dv); a CPU tensor runs
    ``keep_attention_bwd``. ``accumulate_kv`` = (dk0, dv0) adds the new dk
    and dv to them as the PatchSelecter's second query stream does, out =
    round(out + round(new)), and returns them updated in place. Counts its
    launches in ``attention_keep_bwd.launches`` (no model path calls it)."""
    if q.device.type == "cpu":
        dq, dk, dv = keep_attention_bwd(q, k, v, g, keep, heads, round_p_first)
        if accumulate_kv is not None:
            dk = accumulate_kv[0].copy_((accumulate_kv[0].float() + dk.float()).to(dk.dtype))
            dv = accumulate_kv[1].copy_((accumulate_kv[1].float() + dv.float()).to(dv.dtype))
        return dq, dk, dv
    (q, k, v), hd = _keep_args(q, k, v, keep, heads, True)
    if tuple(g.shape) != tuple(q.shape) or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g must be like q {tuple(q.shape)}, got {tuple(g.shape)}")
    g = _keep_operand(g)
    N, Sq, W = q.shape
    Sk = k.shape[1]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if accumulate_kv is None:
        dk = torch.empty(N, Sk, W, dtype=q.dtype, device=q.device)
        dv = torch.empty_like(dk)
    else:
        dk, dv = accumulate_kv
        if any(tuple(t.shape) != (N, Sk, W) or not t.is_contiguous() or t.dtype != q.dtype
               for t in (dk, dv)):
            raise ValueError(f"accumulate_kv needs two contiguous [{N}, {Sk}, {W}] tensors")
    _build.launch("qt_attention_keep_bwd", _build.dtype_code(q), *_strided(q), *_strided(k),
                  *_strided(v), *_strided(g), *_strided(dq), *_strided(dk), *_strided(dv),
                  keep.data_ptr(), keep.stride(0), N, Sq, Sk, heads, hd, 1.0 / math.sqrt(hd),
                  int(round_p_first), int(accumulate_kv is not None))
    attention_keep_bwd.launches += 1
    return dq, dk, dv


attention_keep_bwd.launches = 0


def _tp_attn_plain(src, val, wrd, w, masks, nhead):
    """Plain ``fused_avq_train_tp_attn``: fp32 [3, N, T, D] out_proj
    partials (self, cross, question) over the rank's heads, no bias."""
    Wl = w[0].shape[0] // 3

    def proj(x, wi, bi, rows):
        return linear(x, w[wi][rows], w[bi][rows])

    qq = proj(src, 0, 1, slice(0, Wl))
    kq, vq = proj(wrd, 0, 1, slice(Wl, 3 * Wl)).split(Wl, dim=-1)
    qs, ks, vs = proj(src, 4, 5, slice(None)).split(Wl, dim=-1)
    qc = proj(src, 8, 9, slice(0, Wl))
    kc, vc = proj(val, 8, 9, slice(Wl, 3 * Wl)).split(Wl, dim=-1)
    ctx = {"qst": keep_attention(qq, kq, vq, masks["qst"], nhead),
           "slf": keep_attention(qs, ks, vs, masks["slf"], nhead),
           "crs": keep_attention(qc, kc, vc, masks["crs"], nhead)}
    return torch.stack([F.linear(ctx["slf"].float(), w[6].float()),
                        F.linear(ctx["crs"].float(), w[10].float()),
                        F.linear(ctx["qst"].float(), w[2].float())])


def _tp_mid_plain(total, src, w, masks):
    """Plain ``fused_avq_train_tp_mid``: (linear2's fp32 partial, h1)."""
    N, T, D = src.shape
    dt = src.dtype

    def rd(m):
        return m.reshape(N, T, -1).to(dt)

    x = src
    for i, (key, ob) in enumerate((("d_slf", 7), ("d_crs", 11), ("d_qst", 3))):
        x = x + rd(masks[key]) * (total[i] + w[ob].float()).to(dt)
    h1 = layer_norm(x, w[16], w[17])
    h = torch.relu(linear(h1, w[12], w[13])) * rd(masks["ffn1"])
    return F.linear(h.float(), w[14].float()), h1


def _tp_out_plain(total, h1, w, masks):
    """Plain ``fused_avq_train_tp_out``: LN2(h1 + ffn2 * round(total + b2))."""
    ffn = (total + w[15].float()).to(h1.dtype)
    return layer_norm(h1 + masks["ffn2"].reshape(h1.shape).to(h1.dtype) * ffn, w[18], w[19])


def _leaves(*tensors):
    return [t.detach().requires_grad_(True) for t in tensors]


def _bwd_tp_ffn_plain(g, h1, total2, w, masks, residual: bool):
    """Plain ``fused_avq_train_bwd_tp_ffn``: (the fp32 partial of g_h1, the
    gradients of l1, l2 and n2 by weight index), the vjp of the stages
    after LN1 recomputed on the rank's shards."""
    with torch.enable_grad():
        t2, res = _leaves(total2, h1)
        wl = dict(zip((15, 18, 19), _leaves(w[15], w[18], w[19])))
        wo = [wl.get(i, x) for i, x in enumerate(w)]
        out = _tp_out_plain(t2, res, wo, masks)
        g_t2, g_res, *g_out = torch.autograd.grad(out, [t2, res, *wl.values()], g)
        h, l1w, l1b, l2w = _leaves(h1, w[12], w[13], w[14])
        hid = torch.relu(linear(h, l1w, l1b)) * masks["ffn1"].reshape(*h.shape[:2], -1).to(h.dtype)
        part = F.linear(hid.float(), l2w.float())
        g_h, *g_ffn = torch.autograd.grad(part, [h, l1w, l1b, l2w], g_t2)
    partial = g_h.float() + g_res.float() if residual else g_h.float()
    return partial, dict(zip((15, 18, 19, 12, 13, 14), g_out + g_ffn))


_ATTN_WEIGHTS = (0, 1, 2, 4, 5, 6, 8, 9, 10)  # in_proj_weight, in_proj_bias, out_proj.weight
_OUT_BIASES = (7, 11, 3)  # slf, crs, qst out_proj.bias: the residual order


def _bwd_tp_attn_plain(gh1, src, val, wrd, totals, w, masks, nhead: int, residual: bool):
    """Plain ``fused_avq_train_bwd_tp_attn``: (the fp32 partials of gsrc,
    gval and gwrd, rows stacked [2R + RS, D]; the gradients of the three
    blocks' weights, the out_proj biases and n1 by weight index)."""
    D = src.shape[-1]
    with torch.enable_grad():
        tot, res = _leaves(totals, src)
        wl = dict(zip(_OUT_BIASES + (16, 17), _leaves(*[w[i] for i in _OUT_BIASES + (16, 17)])))
        wo = [wl.get(i, x) for i, x in enumerate(w)]
        x = res
        for i, (key, ob) in enumerate(zip(("d_slf", "d_crs", "d_qst"), _OUT_BIASES)):
            x = x + masks[key].reshape(src.shape).to(src.dtype) * (tot[i] + wo[ob].float()).to(
                src.dtype)
        h1 = layer_norm(x, wo[16], wo[17])
        g_tot, g_res, *g_ln = torch.autograd.grad(h1, [tot, res, *wl.values()],
                                                  gh1.reshape(h1.shape).to(h1.dtype))
        ins = _leaves(src, val, wrd)
        wa = dict(zip(_ATTN_WEIGHTS, _leaves(*[w[i] for i in _ATTN_WEIGHTS])))
        parts = _tp_attn_plain(*ins, [wa.get(i, x) for i, x in enumerate(w)], masks, nhead)
        g_src, g_val, g_wrd, *g_attn = torch.autograd.grad(parts, [*ins, *wa.values()], g_tot)
    g_src = g_src.float() + g_res.float() if residual else g_src.float()
    partial = torch.cat([g_src.reshape(-1, D), g_val.float().reshape(-1, D),
                         g_wrd.float().reshape(-1, D)])
    return partial, dict(zip(_OUT_BIASES + (16, 17) + _ATTN_WEIGHTS, g_ln + g_attn))


def _stage_launch(stage, name: str, bufs: dict, dims: tuple, products, residual: bool = False,
                  attn=()):
    """One tensor-parallel stage's launch (``qt_avq_train_<name>``) against
    the plan of its products and keep-masked attentions (Sq, Sk) ``attn``;
    counts it and tallies their routes."""
    dev, dt = bufs["src"].device, bufs["src"].dtype
    sms = sm_count(dev)
    plan = gemm_plan(dt, products, sms)
    ws_floats = plan_workspace(dt, products, sms)
    bufs["ws"] = torch.empty(ws_floats, dtype=torch.float32, device=dev) if ws_floats else None
    rows = keep_rows(attn)
    _build.launch_table(f"qt_avq_train_{name}", "qt_avq_num_buffers", BUFFERS, bufs, *dims,
                        int(residual), plan.data_ptr(), len(products), rows.data_ptr(),
                        len(rows), ws_floats)
    stage.launches += 1
    note_plan_routes(stage, plan)
    note_keep_routes(stage, rows)


class _AVQState:
    """What the stages of one tensor-parallel forward share and keep for the
    backward: the inputs, the rank's weights and masks, the reduced sums
    and, on the card, the pointer table's intermediates."""

    def __init__(self, src, val, wrd, weights, masks, nhead):
        self.src, self.val, self.wrd = src, val, wrd
        self.weights, self.masks, self.nhead = list(weights), masks, nhead
        N, T, D = src.shape
        self.Wl = weights[0].shape[0] // 3
        self.dims = (N, T, wrd.shape[1], D, self.Wl, nhead)
        self.shapes = avq_train_tp_gemm_shapes(N, T, wrd.shape[1], D, self.Wl)
        self.bufs: dict = {}
        if self.cuda:
            self.bufs = dict(src=src, val=val, wrd=wrd, **{f"m_{k}": masks[k] for k in MASK_KEYS})
            self.bufs.update(zip(WEIGHT_NAMES, self.weights))

    @property
    def cuda(self) -> bool:
        return self.src.device.type == "cuda"

    def empty(self, *shape, dtype=None):
        return torch.empty(*shape, dtype=dtype or self.src.dtype, device=self.src.device)


def _attn_plain(st: _AVQState) -> torch.Tensor:
    return _tp_attn_plain(st.src, st.val, st.wrd, st.weights, st.masks, st.nhead)


def _mid_plain(st: _AVQState, totals: torch.Tensor) -> torch.Tensor:
    st.totals = totals
    part, st.h1 = _tp_mid_plain(totals, st.src, st.weights, st.masks)
    return part


def _out_plain(st: _AVQState, total2: torch.Tensor) -> torch.Tensor:
    st.total2 = total2
    return _tp_out_plain(total2, st.h1, st.weights, st.masks)


def _bwd_ffn_plain(st: _AVQState, g: torch.Tensor, residual: bool):
    return _bwd_tp_ffn_plain(g, st.h1, st.total2, st.weights, st.masks, residual)


def _bwd_attn_plain(st: _AVQState, gh1: torch.Tensor, residual: bool):
    return _bwd_tp_attn_plain(gh1, st.src, st.val, st.wrd, st.totals, st.weights, st.masks,
                              st.nhead, residual)


@tp_stage(_attn_plain)
def fused_avq_train_tp_attn(st: _AVQState) -> torch.Tensor:
    """Forward stage 1: the fp32 [3, N, T, D] out_proj partials of the
    self, cross and question attentions over the rank's heads."""
    N, T, S, D, Wl, _ = st.dims
    R, RS = N * T, N * S
    widths = {"qq": Wl, "qkv": 3 * Wl, "qc": Wl, "kvc": 2 * Wl, "qctx": Wl, "sctx": Wl,
              "cctx": Wl}
    st.bufs.update({k: st.empty(R, n) for k, n in widths.items()}, kvq=st.empty(RS, 2 * Wl),
                   part=st.empty(3, N, T, D, dtype=torch.float32))
    _stage_launch(fused_avq_train_tp_attn, "tp_attn", st.bufs, st.dims,
                  st.shapes["tp_attn"], attn=_attn_shapes(T, S))
    fused_avq_train.launches += 1
    return st.bufs["part"]


@tp_stage(_mid_plain)
def fused_avq_train_tp_mid(st: _AVQState, totals: torch.Tensor) -> torch.Tensor:
    """Forward stage 2 on the summed partials ``totals`` [3, N, T, D]: x1,
    LN1, the FFN over the rank's linear1 columns -> linear2's fp32 [N, T, D]
    partial."""
    st.totals = totals
    N, T, _, D, Wl, _ = st.dims
    R = N * T
    st.bufs.update(total=totals, x1=st.empty(R, D), h1=st.empty(R, D), hr=st.empty(R, Wl),
                   hdp=st.empty(R, Wl), part=st.empty(N, T, D, dtype=torch.float32))
    _stage_launch(fused_avq_train_tp_mid, "tp_mid", st.bufs, st.dims, st.shapes["tp_mid"])
    return st.bufs["part"]


@tp_stage(_out_plain)
def fused_avq_train_tp_out(st: _AVQState, total2: torch.Tensor) -> torch.Tensor:
    """Forward stage 3 on linear2's summed partial: x2 and LN2 -> [N, T, D]."""
    st.total2 = total2
    N, T, _, D, _, _ = st.dims
    st.bufs.update(total=total2, x2=st.empty(N * T, D), out=st.empty(N, T, D))
    _stage_launch(fused_avq_train_tp_out, "tp_out", st.bufs, st.dims, [])
    return st.bufs["out"]


def _weight_grads(st: _AVQState, names) -> None:
    for n in names:
        st.bufs[f"g_{n}"] = torch.empty(st.bufs[n].shape, dtype=torch.float32,
                                        device=st.src.device)


@tp_stage(_bwd_ffn_plain)
def fused_avq_train_bwd_tp_ffn(st: _AVQState, g: torch.Tensor, residual: bool):
    """Backward stage 1 on the output's gradient: (the fp32 [N, T, D]
    partial of g_h1, model rank 0's with the residual g_x2; {weight index:
    gradient} of linear1, linear2 and norm2)."""
    N, T, _, D, Wl, _ = st.dims
    R = N * T
    names = ("l1_w", "l1_b", "l2_w", "l2_b", "n2_w", "n2_b")
    _weight_grads(st, names)
    st.bufs.update(g=g.to(st.src.dtype).contiguous(), gf=st.empty(R, D, dtype=torch.float32),
                   stats=st.empty(2, R, dtype=torch.float32), g_ffn=st.empty(R, D),
                   g_pre=st.empty(R, Wl), part=st.empty(N, T, D, dtype=torch.float32))
    _stage_launch(fused_avq_train_bwd_tp_ffn, "bwd_tp_ffn", st.bufs, st.dims,
                  st.shapes["bwd_tp_ffn"], residual)
    fused_avq_train_bwd.launches += 1
    return st.bufs["part"], {WEIGHT_NAMES.index(n): st.bufs[f"g_{n}"] for n in names}


@tp_stage(_bwd_attn_plain)
def fused_avq_train_bwd_tp_attn(st: _AVQState, gh1: torch.Tensor, residual: bool):
    """Backward stage 2 on the summed g_h1: (the fp32 partials of gsrc,
    gval and gwrd as rows [2R + RS, D], model rank 0's gsrc with the
    residual g_x1; {weight index: gradient} of the three blocks, their
    out_proj biases and norm1)."""
    N, T, S, D, Wl, _ = st.dims
    R, RS = N * T, N * S
    names = [n for i, n in enumerate(WEIGHT_NAMES) if i in _ATTN_WEIGHTS + _OUT_BIASES + (16, 17)]
    _weight_grads(st, names)
    st.bufs.update(total=gh1, stats=st.empty(2, R, dtype=torch.float32),
                   g_out_s=st.empty(R, D), g_out_c=st.empty(R, D), g_out_q=st.empty(R, D),
                   g_ctx=st.empty(R, Wl), g_qq=st.empty(R, Wl), g_kvq=st.empty(RS, 2 * Wl),
                   g_qkv=st.empty(R, 3 * Wl), g_qc=st.empty(R, Wl), g_kvc=st.empty(R, 2 * Wl),
                   part=st.empty(2 * R + RS, D, dtype=torch.float32))
    _stage_launch(fused_avq_train_bwd_tp_attn, "bwd_tp_attn", st.bufs, st.dims,
                  st.shapes["bwd_tp_attn"], residual, attn=_attn_shapes(T, S))
    return st.bufs["part"], {WEIGHT_NAMES.index(n): st.bufs[f"g_{n}"] for n in names}


TP_STAGES = (fused_avq_train_tp_attn, fused_avq_train_tp_mid, fused_avq_train_tp_out,
             fused_avq_train_bwd_tp_ffn, fused_avq_train_bwd_tp_attn)
for _stage in TP_STAGES:
    _stage.launches = 0
    _stage.gemm_routes = {}
    _stage.attn_routes = {}


def round_sum(total: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A reduced fp32 sum rounded once to ``dtype`` (``qt_reduce_epilogue``
    without bias or residual on the card)."""
    if total.device.type == "cpu" or dtype == torch.float32:
        return total.to(dtype)
    out = torch.empty(total.shape, dtype=dtype, device=total.device)
    launch_epilogue(total, None, None, out, dtype=dtype)
    return out


class _AVQTrainTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, nhead, masks, src, val, wrd, *weights):
        st = _AVQState(src, val, wrd, weights, masks, nhead)
        totals = grid.reduce_model(fused_avq_train_tp_attn(st))
        total2 = grid.reduce_model(fused_avq_train_tp_mid(st, totals))
        out = fused_avq_train_tp_out(st, total2)
        ctx.st, ctx.grid = st, grid
        return out

    @staticmethod
    def backward(ctx, g):
        st, grid = ctx.st, ctx.grid
        residual = grid.model_rank == 0
        part, grads = fused_avq_train_bwd_tp_ffn(st, g, residual)
        gh1 = grid.reduce_model(part)
        parts, more = fused_avq_train_bwd_tp_attn(st, gh1, residual)
        grads.update(more)
        g_in = round_sum(grid.reduce_model(parts), st.src.dtype)
        N, T, S, D = *st.src.shape[:2], st.wrd.shape[1], st.src.shape[2]
        R = N * T
        gsrc, gval, gwrd = g_in[:R], g_in[R:2 * R], g_in[2 * R:]
        return (None, None, None, gsrc.reshape(N, T, D), gval.reshape(N, T, D),
                gwrd.reshape(N, S, D),
                *[grads[i].to(w.dtype) for i, w in enumerate(st.weights)])


def fused_avq_train_tp(src: torch.Tensor, val: torch.Tensor, wrd: torch.Tensor, params,
                       masks: dict, nhead: int, grid) -> torch.Tensor:
    """``fused_avq_train`` on one model rank of ``grid``: ``params`` holds
    the rank's shards (in_proj rows [3 Wl, D] of its heads, out_proj columns
    [D, Wl], linear1 rows [Wl, D], linear2 columns [D, Wl]; biases and
    norms whole), ``masks`` its share (``shard_avq_masks``), ``nhead`` its
    heads. src/val/wrd and the output are whole on every rank, and so are
    their gradients: the stages' partials are summed over the model group
    between them."""
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_avq_train_tp runs on cpu or cuda, not {src.device}")
    weights = _weights(params)
    if src.device.type == "cuda":
        N, T, D = src.shape
        S = wrd.shape[1]
        Wl = weights[0].shape[0] // 3
        if Wl % nhead or Wl * grid.model_size != D:
            raise ValueError(f"the rank's {Wl} columns do not hold {nhead} heads of d_model {D}")
        weights = [aligned16(w.contiguous()) for w in weights]
        pad = lambda n: -(-n // 128) * 128  # noqa: E731
        want = {"qst": (N * T, pad(nhead * S)), "slf": (N * T, pad(nhead * T)),
                "crs": (N * T, pad(nhead * T)), "ffn1": (N * T, Wl)}
        dev_masks = {}
        for key in MASK_KEYS:
            m = masks[key]
            shape = want.get(key, (N * T, D))
            if tuple(m.shape) != shape:
                raise ValueError(f"mask {key} must be {shape}, got {tuple(m.shape)}")
            dev_masks[key] = m.to(src.device, src.dtype).contiguous()
        masks = dev_masks
        src, val, wrd = (aligned16(t.contiguous()) for t in (src, val, wrd))
    return _AVQTrainTP.apply(grid, nhead, masks, src, val, wrd, *weights)
