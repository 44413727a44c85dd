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
"""
from __future__ import annotations

import torch

from qa_tiger_tpu_torch.nn.core import layer_norm, linear
from qa_tiger_tpu_torch.ops import _build
from qa_tiger_tpu_torch.ops.gemm import (
    aligned16,
    avq_train_bwd_gemm_shapes,
    avq_train_fwd_gemm_shapes,
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
              "g_ctx", "g_qq", "g_kvq", "g_qkv", "g_qc", "g_kvc", "ws"))


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
        _build.launch_table("qt_avq_train_fwd", "qt_avq_num_buffers", BUFFERS, bufs,
                            N, T, S, D, nhead, plan.data_ptr(), len(shapes), ws_floats)
        fused_avq_train.launches += 1
        note_plan_routes(fused_avq_train, plan)
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
    _build.launch_table("qt_avq_train_bwd", "qt_avq_num_buffers", BUFFERS, bufs,
                        N, T, S, D, nhead, plan.data_ptr(), len(shapes), ws_floats)
    fused_avq_train_bwd.launches += 1
    note_plan_routes(fused_avq_train_bwd, plan)
    return bufs["gsrc"], bufs["gval"], bufs["gwrd"], grads


fused_avq_train_bwd.launches = 0
fused_avq_train_bwd.gemm_routes = {}  # the GEMM routine of each product launched


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
