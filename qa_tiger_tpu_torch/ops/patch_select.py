"""The whole PatchSelecter as one fused operation, eval and train.

Port of ``qa_tiger_tpu/ops/pallas/patch_select.py``: per frame,
self-attention over its P patches with residual, then the frame's video and
audio vectors as two queries attending those patches, out_proj, MLP and one
LayerNorm per stream.

- ``fused_patch_select`` (eval, ``fused_patch_select`` :1022): the CUDA
  kernel in ``csrc/patch_select.cu``; its gradient is the plain version's,
  recomputed, as the JAX ``custom_vjp`` does. Its seven products run
  against a plan from ``ops.gemm.gemm_plan`` as the train kernels' do (in
  fp32 on ``gemm_tf32x3``, in bf16 on ``gemm_sm90``), and its two
  attentions report the kernel they took in its attention rows; it tallies
  both in ``gemm_routes`` and ``attn_routes``, and so do its
  tensor-parallel stages.
- ``fused_patch_select_train`` (``fused_patch_select_train`` :961): the
  same module under three explicit dropout masks
  (``models.modules.make_patch_dropout_masks``), a CUDA forward and a CUDA
  backward kernel (``csrc/patch_select_train.cu``) in one
  ``torch.autograd.Function``. Both launch their products against a plan
  from ``ops.gemm.gemm_plan``: in fp32 all on ``gemm_tf32x3``, in bf16 the
  forward's on ``gemm_sm90``; each tallies the routes its products took in
  its own ``gemm_routes``.

A CPU tensor takes the plain version ``patch_selecter_plain`` (the port of
``patch_selecter_jnp``, its ``masks=`` path included), which autograd
differentiates.

Under tensor parallelism the train op runs on one model rank's shards as
``fused_patch_select_train_tp``: seven stages of
``csrc/patch_select_train.cu``, split where the all-reduces fall, four
forward (``fused_patch_select_train_tp_self``, ``_tp_cross``, ``_tp_mlp``,
``_tp_out``) and three backward (``fused_patch_select_train_bwd_tp_mlp``,
``_bwd_tp_cross``, ``_bwd_tp_self``), each but the last of a direction
ending in an fp32 partial that one ``torch.autograd.Function`` sums over
the model group before the next stage rounds it. Each stage has a plain
version, which a CPU tensor runs (the backward stages as the vjp of their
forward part, recomputed). The first forward stage counts a
``fused_patch_select_train`` launch and the first backward stage a
``fused_patch_select_train_bwd`` launch.

Under tensor parallelism (``parallel/tensor.py``) the eval module splits at
its three row products into stages (``csrc/patch_select.cu``), each rank's
partial summed over the model ranks by the caller between them:
``fused_patch_select_tp_self`` -> ``_tp_self_post`` (x1), ``_tp_cross`` ->
``_tp_cross_post`` (the cross output), ``_tp_mlp`` -> ``_tp_out`` (the two
normalised streams). ``fused_patch_select`` counts one launch per such
forward (at its first stage); each stage counts its own. Each stage's
gradient is its plain version's, recomputed, as the whole kernel's is: a
train step without dropout runs them under autograd.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
from torch.nn import functional as F

from qa_tiger_tpu_torch.nn.core import layer_norm, linear, mlp2
from qa_tiger_tpu_torch.ops import _build, _grad
from qa_tiger_tpu_torch.ops.epilogue import launch_epilogue, reduce_epilogue_plain, tp_stage
from qa_tiger_tpu_torch.ops.attention import _wide_reference, keep_rows, note_keep_routes
from qa_tiger_tpu_torch.ops.gemm import (
    aligned16,
    gemm_plan,
    launch_plan,
    note_launch_plan,
    note_plan_routes,
    patch_select_gemm_shapes,
    patch_select_train_bwd_gemm_shapes,
    patch_select_train_tp_gemm_shapes,
    plan_workspace,
    sm_count,
)


def patch_selecter_plain(params, patch, audio, video, *, nhead: int = 8,
                         masks: dict | None = None):
    """All B*T frames as one batch of attention problems -> [a, v], each
    [B, T, D]. ``params`` holds slf_attn, crs_attn, mlp, anorm, vnorm.

    The port of ``patch_selecter_jnp``. Without ``masks`` its two ``mha``
    calls are written out (packed qkv for the self-attention, q and fused kv
    for the cross one) so that this version reaches no kernel. With
    ``masks`` (``make_patch_dropout_masks``) it is the masked oracle: the
    probability masks enter ``mha`` as ``prob_mask`` (its plain path) and the
    pre-MLP masks multiply the cross output."""
    # nn.attention imports ops.attention, so ops imports it when called
    from qa_tiger_tpu_torch.nn.attention import mha

    B, T, P, D = patch.shape
    BT = B * T
    patch_bt = patch.reshape(BT, P, D)
    if masks is None:
        scale = 1.0 / math.sqrt(D // nhead)
        slf_p, crs_p = params.slf_attn, params.crs_attn
        q, k, v = linear(patch_bt, slf_p.in_proj_weight,
                         slf_p.in_proj_bias).chunk(3, dim=-1)
        slf = linear(_wide_reference(q, k, v, None, scale, nhead),
                     slf_p.out_proj.weight, slf_p.out_proj.bias)
        patch_bt = patch_bt + slf
        query = torch.cat([video.reshape(BT, 1, D), audio.reshape(BT, 1, D)],
                          dim=1)  # video first
        w, b = crs_p.in_proj_weight, crs_p.in_proj_bias
        q = linear(query, w[:D], b[:D])
        k, v = linear(patch_bt, w[D:], b[D:]).chunk(2, dim=-1)
        crs = linear(_wide_reference(q, k, v, None, scale, nhead),
                     crs_p.out_proj.weight, crs_p.out_proj.bias)
    else:
        L = nhead * P
        pm_slf = masks["slf"][:, :L].reshape(BT, P, nhead, P).transpose(1, 2)
        pm_crs = torch.stack([masks["crs_v"][:, :L].reshape(BT, nhead, P),
                              masks["crs_a"][:, :L].reshape(BT, nhead, P)], dim=2)
        slf, _ = mha(params.slf_attn, patch_bt, patch_bt, patch_bt, num_heads=nhead,
                     need_weights=False, prob_mask=pm_slf)
        patch_bt = patch_bt + slf
        query = torch.cat([video.reshape(BT, 1, D), audio.reshape(BT, 1, D)], dim=1)
        crs, _ = mha(params.crs_attn, query, patch_bt, patch_bt, num_heads=nhead,
                     need_weights=False, prob_mask=pm_crs)
        crs = crs * torch.stack([masks["out_v"], masks["out_a"]], dim=1).to(crs.dtype)
    out = mlp2(crs, params.mlp)
    v_rel, a_rel = out[:, 0], out[:, 1]
    return [layer_norm(a_rel.reshape(B, T, D), params.anorm.weight,
                       params.anorm.bias),
            layer_norm(v_rel.reshape(B, T, D), params.vnorm.weight,
                       params.vnorm.bias)]


def _weights(params):
    slf, crs, mlp = params.slf_attn, params.crs_attn, params.mlp
    return [slf.in_proj_weight, slf.in_proj_bias, slf.out_proj.weight,
            slf.out_proj.bias, crs.in_proj_weight, crs.in_proj_bias,
            crs.out_proj.weight, crs.out_proj.bias, mlp[0].weight,
            mlp[0].bias, mlp[2].weight, mlp[2].bias, params.anorm.weight,
            params.anorm.bias, params.vnorm.weight, params.vnorm.bias]


def _params(w):
    """The 16 tensors of ``_weights`` as the attribute tree the plain
    version reads."""
    ns = SimpleNamespace

    def attn(i):
        return ns(in_proj_weight=w[i], in_proj_bias=w[i + 1],
                  out_proj=ns(weight=w[i + 2], bias=w[i + 3]))

    return ns(slf_attn=attn(0), crs_attn=attn(4),
              mlp={0: ns(weight=w[8], bias=w[9]), 2: ns(weight=w[10], bias=w[11])},
              anorm=ns(weight=w[12], bias=w[13]), vnorm=ns(weight=w[14], bias=w[15]))


def _plain_flat(patch, audio, video, *weights, nhead, masks=None):
    return tuple(patch_selecter_plain(_params(weights), patch, audio, video,
                                      nhead=nhead, masks=masks))


def _check(patch, audio, video, weights, nhead):
    if patch.device.type != "cuda":
        raise ValueError(f"the PatchSelecter kernels run on cpu or cuda, not {patch.device}")
    B, T, P, D = patch.shape
    if D % nhead or D % 2:
        raise ValueError(f"width {D} does not split into {nhead} heads")
    shapes = [(3 * D, D), (3 * D,), (D, D), (D,), (3 * D, D), (3 * D,),
              (D, D), (D,), (D // 2, D), (D // 2,), (D, D // 2), (D,),
              (D,), (D,), (D,), (D,)]
    named = [("patch", patch, (B, T, P, D)), ("audio", audio, (B, T, D)),
             ("video", video, (B, T, D))]
    named += [(f"weight {i}", w, s) for i, (w, s) in enumerate(zip(weights, shapes))]
    for name, t, shape in named:
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape}, got {tuple(t.shape)}")
        if t.dtype != patch.dtype or t.device != patch.device:
            raise ValueError(f"{name} must match patch's dtype and device")


def fused_patch_select(patch: torch.Tensor, audio: torch.Tensor,
                       video: torch.Tensor, params, nhead: int = 8):
    """(a_final, v_final) = PatchSelecter(patch [B,T,P,D], audio/video
    [B,T,D]); returns two [B, T, D]."""
    if patch.device.type == "cpu":
        return tuple(patch_selecter_plain(params, patch, audio, video,
                                          nhead=nhead))
    weights = _weights(params)
    _check(patch, audio, video, weights, nhead)
    return _grad.KernelWithPlainGrad.apply(_launch_eval, _plain_flat, dict(nhead=nhead),
                                           patch, audio, video, *weights)


def _launch_eval(patch, audio, video, *weights, nhead):
    B, T, P, D = patch.shape
    # the operands the products read in 16-byte chunks (TMA in bf16,
    # cp.async in fp32)
    patch, weights = aligned16(patch), [aligned16(w) for w in weights]
    BT = B * T
    dev, dt = patch.device, patch.dtype
    a_out = torch.empty(B, T, D, dtype=dt, device=dev)
    v_out = torch.empty(B, T, D, dtype=dt, device=dev)
    scratch = [torch.empty(BT * P, 3 * D, dtype=dt, device=dev),  # qkv
               torch.empty(BT * P, D, dtype=dt, device=dev),      # self ctx
               torch.empty(BT * P, D, dtype=dt, device=dev),      # x + slf
               torch.empty(BT * P, 2 * D, dtype=dt, device=dev),  # cross k|v
               torch.empty(2 * BT, D, dtype=dt, device=dev),      # queries
               torch.empty(2 * BT, D, dtype=dt, device=dev),      # cross ctx
               torch.empty(2 * BT, D, dtype=dt, device=dev),      # out_proj
               torch.empty(2 * BT, D // 2, dtype=dt, device=dev),  # MLP hidden
               torch.empty(2 * BT, D, dtype=torch.float32, device=dev)]  # MLP out
    plan, rows, args, _ws = launch_plan(dt, patch_select_gemm_shapes(BT, P, D),
                                        [(P, P), (2, P)], dev)
    _build.launch("qt_patch_select", _build.dtype_code(patch),
                  patch.data_ptr(), video.data_ptr(), audio.data_ptr(),
                  *[w.data_ptr() for w in weights],
                  a_out.data_ptr(), v_out.data_ptr(),
                  *[s.data_ptr() for s in scratch], BT, P, D, nhead, *args)
    fused_patch_select.launches += 1
    note_launch_plan(fused_patch_select, plan, rows)
    return a_out, v_out


fused_patch_select.launches = 0
fused_patch_select.gemm_routes = {}  # the GEMM routine of each product launched
fused_patch_select.attn_routes = {}  # the kernel of each of its two attentions

# ---------------------------------------------------------------------------
# tensor-parallel stages of the eval module
# ---------------------------------------------------------------------------


def _stage_check(name: str, acts: list, weights: list, shapes: list) -> None:
    """Raise on what a stage kernel does not take: activations and weights
    contiguous on one CUDA device, of one type (``acts[0]``'s), weights of
    the given shapes."""
    x = acts[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    for t in acts + weights:
        if not t.is_contiguous() or t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: every input must be contiguous, of x's dtype and device")
    for w, shape in zip(weights, shapes):
        if tuple(w.shape) != shape:
            raise ValueError(f"{name}: expected a weight of {shape}, got {tuple(w.shape)}")


def _tp_self_plain(patch, w, b, ow, nhead):
    B, T, P, D = patch.shape
    q, k, v = linear(patch.reshape(B * T, P, D), w, b).chunk(3, dim=-1)
    ctx = _wide_reference(q, k, v, None, 1.0 / math.sqrt(w.shape[0] // 3 // nhead), nhead)
    return F.linear(ctx.float(), ow.float()).reshape(B, T, P, D)


def fused_patch_select_tp_self(patch: torch.Tensor, slf, nhead: int) -> torch.Tensor:
    """Stage 1 on one model rank: patch [B, T, P, D] -> the fp32 [B, T, P,
    D] partial of the self-attention's out_proj over the rank's ``nhead``
    heads (``slf`` holds its in_proj rows [3 Wl, D] and out_proj columns
    [D, Wl]), no bias."""
    w, b, ow = slf.in_proj_weight, slf.in_proj_bias, slf.out_proj.weight
    if patch.device.type == "cpu":
        return _tp_self_plain(patch, w, b, ow, nhead)
    D = patch.shape[-1]
    Wl = w.shape[0] // 3
    _stage_check("fused_patch_select_tp_self", [patch], [w, b, ow],
                 [(3 * Wl, D), (3 * Wl,), (D, Wl)])
    return _grad.KernelWithPlainGrad.apply(_launch_tp_self, _tp_self_plain, dict(nhead=nhead),
                                           patch, w, b, ow)


def _launch_tp_self(patch, w, b, ow, nhead):
    B, T, P, D = patch.shape
    Wl = w.shape[0] // 3
    patch, w, b, ow = (aligned16(t) for t in (patch, w, b, ow))
    BT, dev, dt = B * T, patch.device, patch.dtype
    part = torch.empty(B, T, P, D, dtype=torch.float32, device=dev)
    qkv = torch.empty(BT * P, 3 * Wl, dtype=dt, device=dev)
    ctx = torch.empty(BT * P, Wl, dtype=dt, device=dev)
    shapes = patch_select_train_tp_gemm_shapes(BT, P, D, Wl)["tp_self"]
    plan, rows, args, _ws = launch_plan(dt, shapes, [(P, P)], dev)
    _build.launch("qt_patch_select_tp_self", _build.dtype_code(patch), patch.data_ptr(),
                  w.data_ptr(), b.data_ptr(), ow.data_ptr(), part.data_ptr(), qkv.data_ptr(),
                  ctx.data_ptr(), BT, P, D, Wl, nhead, *args)
    fused_patch_select.launches += 1
    fused_patch_select_tp_self.launches += 1
    note_launch_plan(fused_patch_select_tp_self, plan, rows)
    return part


def _self_post_plain(total, patch, bias):
    return reduce_epilogue_plain(total, bias, res=patch, dtype=patch.dtype)


def _launch_self_post(total, patch, bias):
    x1 = torch.empty_like(patch)
    launch_epilogue(total, bias, patch, x1)
    fused_patch_select_tp_self_post.launches += 1
    return x1


def fused_patch_select_tp_self_post(total: torch.Tensor, patch: torch.Tensor,
                                    bias: torch.Tensor) -> torch.Tensor:
    """x1 = patch + round(total + slf out_proj.bias), ``total`` the stage-1
    partials summed over the model ranks."""
    if patch.device.type == "cpu":
        return _self_post_plain(total, patch, bias)
    return _grad.KernelWithPlainGrad.apply(_launch_self_post, _self_post_plain, {}, total,
                                           patch, bias)


def _tp_cross_plain(x1, audio, video, w, b, ow, nhead):
    B, T, P, D = x1.shape
    Wl = w.shape[0] // 3
    query = torch.cat([video.reshape(B * T, 1, D), audio.reshape(B * T, 1, D)], dim=1)
    q = linear(query, w[:Wl], b[:Wl])
    k, v = linear(x1.reshape(B * T, P, D), w[Wl:], b[Wl:]).chunk(2, dim=-1)
    ctx = _wide_reference(q, k, v, None, 1.0 / math.sqrt(Wl // nhead), nhead)
    return F.linear(ctx.float(), ow.float()).reshape(B, T, 2, D)


def fused_patch_select_tp_cross(x1: torch.Tensor, audio: torch.Tensor, video: torch.Tensor,
                                crs, nhead: int) -> torch.Tensor:
    """Stage 2 on one model rank: keys and values from x1 [B, T, P, D], the
    (video, audio) queries [B, T, D] -> the fp32 [B, T, 2, D] partial of
    the cross-attention's out_proj (video row first) over the rank's heads,
    no bias."""
    w, b, ow = crs.in_proj_weight, crs.in_proj_bias, crs.out_proj.weight
    if x1.device.type == "cpu":
        return _tp_cross_plain(x1, audio, video, w, b, ow, nhead)
    B, T, P, D = x1.shape
    Wl = w.shape[0] // 3
    _stage_check("fused_patch_select_tp_cross", [x1, audio, video], [w, b, ow],
                 [(3 * Wl, D), (3 * Wl,), (D, Wl)])
    if audio.shape != video.shape or tuple(video.shape) != (B, T, D):
        raise ValueError(f"audio and video must be [{B}, {T}, {D}]")
    return _grad.KernelWithPlainGrad.apply(_launch_tp_cross, _tp_cross_plain,
                                           dict(nhead=nhead), x1, audio, video, w, b, ow)


def _launch_tp_cross(x1, audio, video, w, b, ow, nhead):
    B, T, P, D = x1.shape
    Wl = w.shape[0] // 3
    x1, w, ow = aligned16(x1), aligned16(w), aligned16(ow)
    BT, dev, dt = B * T, x1.device, x1.dtype
    part = torch.empty(B, T, 2, D, dtype=torch.float32, device=dev)
    kv = torch.empty(BT * P, 2 * Wl, dtype=dt, device=dev)
    q = torch.empty(2 * BT, Wl, dtype=dt, device=dev)
    ctx2 = torch.empty(2 * BT, D, dtype=dt, device=dev)
    shapes = patch_select_train_tp_gemm_shapes(BT, P, D, Wl)["tp_cross"]
    plan, rows, args, _ws = launch_plan(dt, shapes, [(2, P)], dev)
    _build.launch("qt_patch_select_tp_cross", _build.dtype_code(x1), x1.data_ptr(),
                  video.data_ptr(), audio.data_ptr(), w.data_ptr(), b.data_ptr(),
                  ow.data_ptr(), part.data_ptr(), kv.data_ptr(), q.data_ptr(), ctx2.data_ptr(),
                  BT, P, D, Wl, nhead, *args)
    fused_patch_select_tp_cross.launches += 1
    note_launch_plan(fused_patch_select_tp_cross, plan, rows)
    return part


def _cross_post_plain(total, bias, dtype):
    return reduce_epilogue_plain(total, bias, dtype=dtype)


def _launch_cross_post(total, bias, dtype):
    out = torch.empty(total.shape, dtype=dtype, device=total.device)
    launch_epilogue(total, bias, None, out)
    fused_patch_select_tp_cross_post.launches += 1
    return out


def fused_patch_select_tp_cross_post(total: torch.Tensor, bias: torch.Tensor,
                                     dtype: torch.dtype) -> torch.Tensor:
    """The cross output round(total + crs out_proj.bias) in ``dtype``,
    ``total`` the stage-2 partials summed over the model ranks."""
    if total.device.type == "cpu":
        return _cross_post_plain(total, bias, dtype)
    return _grad.KernelWithPlainGrad.apply(_launch_cross_post, _cross_post_plain,
                                           dict(dtype=dtype), total, bias)


def _tp_mlp_plain(crs, w1, b1, w2):
    return F.linear(torch.relu(linear(crs, w1, b1)).float(), w2.float())


def fused_patch_select_tp_mlp(crs: torch.Tensor, mlp) -> torch.Tensor:
    """Stage 3 on one model rank: the cross output [B, T, 2, D] -> the fp32
    partial of mlp.2 over the rank's hidden columns (mlp.0 rows [Hl, D]
    with ReLU, mlp.2 columns [D, Hl]), no bias."""
    w1, b1, w2 = mlp[0].weight, mlp[0].bias, mlp[2].weight
    if crs.device.type == "cpu":
        return _tp_mlp_plain(crs, w1, b1, w2)
    D = crs.shape[-1]
    Hl = w1.shape[0]
    _stage_check("fused_patch_select_tp_mlp", [crs], [w1, b1, w2], [(Hl, D), (Hl,), (D, Hl)])
    return _grad.KernelWithPlainGrad.apply(_launch_tp_mlp, _tp_mlp_plain, {}, crs, w1, b1, w2)


def _launch_tp_mlp(crs, w1, b1, w2):
    B, T, _, D = crs.shape
    Hl = w1.shape[0]
    crs, w1, w2 = aligned16(crs), aligned16(w1), aligned16(w2)
    Q = 2 * B * T
    part = torch.empty(B, T, 2, D, dtype=torch.float32, device=crs.device)
    hid = torch.empty(Q, Hl, dtype=crs.dtype, device=crs.device)
    # the MLP's products run over the query rows alone: any patch count
    shapes = patch_select_train_tp_gemm_shapes(B * T, 1, D, 2 * Hl)["tp_mlp"]
    plan, rows, args, _ws = launch_plan(crs.dtype, shapes, [], crs.device)
    _build.launch("qt_patch_select_tp_mlp", _build.dtype_code(crs), crs.data_ptr(),
                  w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), part.data_ptr(), hid.data_ptr(),
                  Q, D, Hl, *args)
    fused_patch_select_tp_mlp.launches += 1
    note_launch_plan(fused_patch_select_tp_mlp, plan, rows)
    return part


def _tp_out_plain(total, bias, an_w, an_b, vn_w, vn_b, dtype, inplace=False):
    out = total + bias.float()
    return (layer_norm(out[:, :, 1], an_w, an_b).to(dtype),
            layer_norm(out[:, :, 0], vn_w, vn_b).to(dtype))


def _launch_tp_out(total, bias, an_w, an_b, vn_w, vn_b, dtype, inplace):
    B, T, _, D = total.shape
    params = [bias, an_w, an_b, vn_w, vn_b]
    if total.dtype != torch.float32 or not total.is_contiguous() or any(
            tuple(p.shape) != (D,) or p.dtype != dtype or p.device != total.device
            for p in params):
        raise ValueError("fused_patch_select_tp_out takes a contiguous fp32 sum and [D] "
                         "parameters of the output dtype")
    outf = total if inplace else total.clone()
    a_out = torch.empty(B, T, D, dtype=dtype, device=total.device)
    v_out = torch.empty(B, T, D, dtype=dtype, device=total.device)
    _build.launch("qt_patch_select_tp_out", _build.dtype_code(dtype), outf.data_ptr(),
                  *[p.data_ptr() for p in params], a_out.data_ptr(), v_out.data_ptr(),
                  2 * B * T, D)
    fused_patch_select_tp_out.launches += 1
    return a_out, v_out


def fused_patch_select_tp_out(total: torch.Tensor, bias: torch.Tensor, anorm, vnorm,
                              dtype: torch.dtype) -> tuple:
    """(a, v), each [B, T, D] in ``dtype``: LayerNorm of total + mlp.2's
    bias in fp32 per stream, ``total`` [B, T, 2, D] the stage-3 partials
    summed over the model ranks (overwritten on the card unless autograd
    keeps it for the backward)."""
    tensors = (total, bias, anorm.weight, anorm.bias, vnorm.weight, vnorm.bias)
    if total.device.type == "cpu":
        return _tp_out_plain(*tensors, dtype)
    recording = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    return _grad.KernelWithPlainGrad.apply(_launch_tp_out, _tp_out_plain,
                                           dict(dtype=dtype, inplace=not recording), *tensors)


for _stage in (fused_patch_select_tp_self, fused_patch_select_tp_self_post,
               fused_patch_select_tp_cross, fused_patch_select_tp_cross_post,
               fused_patch_select_tp_mlp, fused_patch_select_tp_out):
    _stage.launches = 0
for _stage in (fused_patch_select_tp_self, fused_patch_select_tp_cross,
               fused_patch_select_tp_mlp):
    _stage.gemm_routes = {}
for _stage in (fused_patch_select_tp_self, fused_patch_select_tp_cross):
    _stage.attn_routes = {}

# ---------------------------------------------------------------------------
# train mode
# ---------------------------------------------------------------------------

MASK_KEYS = ("slf", "crs_v", "crs_a", "out_v", "out_a")
WEIGHT_NAMES = ("slf_w", "slf_b", "slf_ow", "slf_ob", "crs_w", "crs_b", "crs_ow", "crs_ob",
                "mlp_w1", "mlp_b1", "mlp_w2", "mlp_b2", "an_w", "an_b", "vn_w", "vn_b")
SAVED = ("qkv", "sctx", "x1", "kv", "src2", "q", "ctx", "crs_d", "hid", "outf")
# the pointer table of csrc/patch_select_train.cu, in its enum's order
TRAIN_BUFFERS = (("patch", "video", "audio") + tuple(f"m_{k}" for k in MASK_KEYS)
                 + WEIGHT_NAMES + ("a_out", "v_out") + SAVED
                 + ("ga", "gv", "gpatch", "gvideo", "gaudio")
                 + tuple(f"g_{n}" for n in WEIGHT_NAMES)
                 + ("g_rel", "stats", "g_pre1", "g_crs_o", "g_ctx", "g_qc", "g_kv", "g_x1",
                    "g_slf", "g_qkv", "ws", "total", "part"))


class _PatchSelectTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, nhead, masks, patch, audio, video, *weights):
        B, T, P, D = patch.shape
        BT, R = B * T, B * T * P
        dev, dt = patch.device, patch.dtype

        def e(*shape, dtype=dt):
            return torch.empty(*shape, dtype=dtype, device=dev)

        bufs = dict(patch=patch, video=video, audio=audio, a_out=e(B, T, D), v_out=e(B, T, D),
                    qkv=e(R, 3 * D), sctx=e(R, D), x1=e(R, D), kv=e(R, 2 * D), src2=e(2 * BT, D),
                    q=e(2 * BT, D), ctx=e(2 * BT, D), crs_d=e(2 * BT, D),
                    hid=e(2 * BT, D // 2), outf=e(2 * BT, D, dtype=torch.float32))
        bufs.update({f"m_{k}": masks[k] for k in MASK_KEYS})
        # the operands gemm_tf32x3 and gemm_sm90 read in 16-byte chunks
        patch, weights = aligned16(patch), [aligned16(w) for w in weights]
        bufs.update(zip(WEIGHT_NAMES, weights), patch=patch)
        shapes = patch_select_gemm_shapes(BT, P, D)
        sms = sm_count(dev)
        plan = gemm_plan(dt, shapes, sms)
        ws_floats = plan_workspace(dt, shapes, sms)
        if ws_floats:
            bufs["ws"] = e(ws_floats, dtype=torch.float32)
        rows = keep_rows([(P, P), (1, P), (1, P)])
        _build.launch_table("qt_patch_select_train_fwd", "qt_patch_select_train_num_buffers",
                            TRAIN_BUFFERS, bufs, BT, P, D, nhead, plan.data_ptr(), len(shapes),
                            rows.data_ptr(), len(rows), ws_floats)
        fused_patch_select_train.launches += 1
        note_plan_routes(fused_patch_select_train, plan)
        note_keep_routes(fused_patch_select_train, rows)
        ctx.nhead, ctx.masks = nhead, masks
        ctx.save_for_backward(patch, audio, video, *weights, *[bufs[k] for k in SAVED])
        return bufs["a_out"], bufs["v_out"]

    @staticmethod
    def backward(ctx, ga, gv):
        saved = ctx.saved_tensors
        patch, audio, video = saved[:3]
        weights = saved[3:3 + len(WEIGHT_NAMES)]
        bufs = dict(zip(SAVED, saved[3 + len(WEIGHT_NAMES):]))
        gpatch, gaudio, gvideo, gws = fused_patch_select_train_bwd(
            patch, audio, video, weights, bufs, ctx.masks, ga, gv, ctx.nhead)
        return (None, None, gpatch, gaudio, gvideo,
                *[g.to(w.dtype) for g, w in zip(gws, weights)])


def fused_patch_select_train_bwd(patch, audio, video, weights, saved: dict, masks: dict,
                                 ga, gv, nhead: int):
    """Launch the backward kernel: (gpatch, gaudio, gvideo, 16 fp32
    parameter gradients in the module's [out, in] layout)."""
    B, T, P, D = patch.shape
    BT, R = B * T, B * T * P
    dev, dt = patch.device, patch.dtype

    def e(*shape, dtype=dt):
        return torch.empty(*shape, dtype=dtype, device=dev)

    f32 = torch.float32
    shapes = patch_select_train_bwd_gemm_shapes(BT, P, D)
    sms = sm_count(dev)
    plan = gemm_plan(dt, shapes, sms)
    ws_floats = plan_workspace(dt, shapes, sms)
    if dt == f32:  # the operands gemm_tf32x3 reads in 16-byte chunks
        patch = aligned16(patch)
        weights = [aligned16(w) for w in weights]
    grads = [torch.empty(w.shape, dtype=f32, device=dev) for w in weights]
    bufs = dict(patch=patch, video=video, audio=audio, **saved,
                ga=ga.to(dt).contiguous(), gv=gv.to(dt).contiguous(),
                gpatch=e(B, T, P, D), gvideo=e(B, T, D), gaudio=e(B, T, D),
                g_rel=e(2 * BT, D, dtype=f32), stats=e(2, 2 * BT, dtype=f32),
                g_pre1=e(2 * BT, D // 2, dtype=f32), g_crs_o=e(2 * BT, D), g_ctx=e(2 * BT, D),
                g_qc=e(2 * BT, D), g_kv=e(R, 2 * D), g_x1=e(R, D), g_slf=e(R, D),
                g_qkv=e(R, 3 * D), ws=e(ws_floats, dtype=f32) if ws_floats else None)
    bufs.update({f"m_{k}": masks[k] for k in MASK_KEYS})
    bufs.update(zip(WEIGHT_NAMES, weights))
    bufs.update(zip((f"g_{n}" for n in WEIGHT_NAMES), grads))
    rows = keep_rows([(1, P), (1, P), (P, P)])
    _build.launch_table("qt_patch_select_train_bwd", "qt_patch_select_train_num_buffers",
                        TRAIN_BUFFERS, bufs, BT, P, D, nhead, plan.data_ptr(), len(shapes),
                        rows.data_ptr(), len(rows), ws_floats)
    fused_patch_select_train_bwd.launches += 1
    note_plan_routes(fused_patch_select_train_bwd, plan)
    note_keep_routes(fused_patch_select_train_bwd, rows)
    return bufs["gpatch"], bufs["gaudio"], bufs["gvideo"], grads


fused_patch_select_train_bwd.launches = 0
fused_patch_select_train_bwd.gemm_routes = {}  # the GEMM routine of each product launched
fused_patch_select_train_bwd.attn_routes = {}  # the kernel of each attention backward launched


def fused_patch_select_train(patch: torch.Tensor, audio: torch.Tensor, video: torch.Tensor,
                             params, masks: dict, nhead: int = 8):
    """Train-mode PatchSelecter under explicit dropout masks -> (a, v), each
    [B, T, D]. ``masks`` holds ``slf`` [B*T*P, Lp], ``crs_v``/``crs_a``
    [B*T, Lp] (lane h*P + key, Lp = H*P padded to 128) and ``out_v``/``out_a``
    [B*T, D], pre-scaled by 1/(1-p) (``make_patch_dropout_masks``).

    On CUDA one forward kernel and, under autograd, one backward kernel,
    which returns the input gradients and fp32 parameter gradients."""
    if patch.device.type == "cpu":
        return tuple(patch_selecter_plain(params, patch, audio, video, nhead=nhead,
                                          masks=masks))
    weights = _weights(params)
    _check(patch, audio, video, weights, nhead)
    B, T, P, D = patch.shape
    Lp = -(-nhead * P // 128) * 128
    want = {"slf": (B * T * P, Lp), "crs_v": (B * T, Lp), "crs_a": (B * T, Lp),
            "out_v": (B * T, D), "out_a": (B * T, D)}
    dev_masks = {}
    for key, shape in want.items():
        m = masks[key]
        if tuple(m.shape) != shape:
            raise ValueError(f"mask {key} must be {shape}, got {tuple(m.shape)}")
        dev_masks[key] = m.to(patch.device, patch.dtype).contiguous()
    return _PatchSelectTrain.apply(nhead, dev_masks, patch, audio, video, *weights)


fused_patch_select_train.launches = 0
fused_patch_select_train.gemm_routes = {}  # the GEMM routine of each product launched
fused_patch_select_train.attn_routes = {}  # the kernel of each keep-masked attention launched


# ---------------------------------------------------------------------------
# tensor-parallel stages of the train op (one model rank's shards)
# ---------------------------------------------------------------------------

HEAD_MASKS = ("slf", "crs_v", "crs_a")  # cut to the rank's heads; out_v/out_a whole


def shard_patch_masks(masks: dict, nhead: int, P: int, rank: int, tp: int) -> dict:
    """Model rank ``rank``'s share of ``make_patch_dropout_masks``' whole
    realization: the probability masks' lanes of its nhead/tp heads
    (re-padded to 128 lanes), the pre-MLP masks whole."""
    from qa_tiger_tpu_torch.parallel.tensor import head_lanes

    out = {k: head_lanes(masks[k], nhead, P, rank, tp) for k in HEAD_MASKS}
    out.update(out_v=masks["out_v"], out_a=masks["out_a"])
    return out


def _tp_train_self_plain(patch, w, b, ow, masks, nhead):
    """Plain ``fused_patch_select_train_tp_self``: the self-attention's fp32
    out_proj partial [B*T*P, D] over the rank's heads, no bias."""
    from qa_tiger_tpu_torch.ops.avq import keep_attention

    B, T, P, D = patch.shape
    q, k, v = linear(patch.reshape(B * T, P, D), w, b).chunk(3, dim=-1)
    ctx = keep_attention(q, k, v, masks["slf"], nhead)
    return F.linear(ctx.float(), ow.float()).reshape(B * T * P, D)


def _tp_train_x1_plain(total, patch, ob):
    return reduce_epilogue_plain(total.reshape(patch.shape), ob, res=patch, dtype=patch.dtype)


def _tp_train_cross_plain(x1, audio, video, w, b, ow, masks, nhead):
    """The cross attention over the rank's heads from x1 -> its fp32 out_proj
    partial [2 B*T, D], video rows first."""
    from qa_tiger_tpu_torch.ops.avq import keep_attention

    B, T, P, D = x1.shape
    BT, Wl = B * T, w.shape[0] // 3
    query = torch.cat([video.reshape(BT, 1, D), audio.reshape(BT, 1, D)], dim=1)
    q = linear(query, w[:Wl], b[:Wl])
    k, v = linear(x1.reshape(BT, P, D), w[Wl:], b[Wl:]).chunk(2, dim=-1)
    ctx = torch.cat([keep_attention(q[:, s:s + 1], k, v, masks[key], nhead)
                     for s, key in enumerate(("crs_v", "crs_a"))])
    return F.linear(ctx.float(), ow.float()).reshape(2 * BT, D)


def _tp_train_crs_plain(total, ob, masks):
    """round(round(total + ob) * out_s) [2 B*T, D], video rows first."""
    crs = reduce_epilogue_plain(total, ob, dtype=ob.dtype)
    return crs * torch.cat([masks["out_v"], masks["out_a"]]).to(crs.dtype)


def _tp_train_mlp_plain(crs_d, w1, b1, w2):
    return F.linear(torch.relu(linear(crs_d, w1, b1)).float(), w2.float())


def _tp_train_out_plain(total, b2, an_w, an_b, vn_w, vn_b, B, T):
    """(a, v) [B, T, D]: the per-stream LayerNorms of total + b2 in fp32."""
    out = total + b2.float()
    BT, D = B * T, total.shape[-1]
    return (layer_norm(out[BT:], an_w, an_b).to(b2.dtype).reshape(B, T, D),
            layer_norm(out[:BT], vn_w, vn_b).to(b2.dtype).reshape(B, T, D))


def _leaves(*tensors):
    return [t.detach().requires_grad_(True) for t in tensors]


def _bwd_tp_mlp_plain(ga, gv, total3, crs_d, w, B, T):
    """Plain ``fused_patch_select_train_bwd_tp_mlp``: (the fp32 partial of
    crs_d's gradient [2 B*T, D]; {weight index: gradient} of the MLP and the
    norms)."""
    with torch.enable_grad():
        t3, *norms = _leaves(total3, w[11], w[12], w[13], w[14], w[15])
        a, v = _tp_train_out_plain(t3, *norms, B, T)
        g_t3, *g_norms = torch.autograd.grad([a, v], [t3, *norms], [ga, gv])
        x, w1, b1, w2 = _leaves(crs_d, w[8], w[9], w[10])
        g_x, *g_mlp = torch.autograd.grad(_tp_train_mlp_plain(x, w1, b1, w2), [x, w1, b1, w2],
                                          g_t3)
    return g_x.float(), dict(zip((11, 12, 13, 14, 15, 8, 9, 10), g_norms + g_mlp))


def _bwd_tp_cross_plain(total, x1, audio, video, total2, w, masks, nhead):
    """Plain ``fused_patch_select_train_bwd_tp_cross``: (the fp32 partials of
    g_x1 and of the two streams' gradients, rows [R + 2 B*T, D]; {weight
    index: gradient} of the cross attention)."""
    D = x1.shape[-1]
    g_crs = (total * torch.cat([masks["out_v"], masks["out_a"]]).float()).to(x1.dtype)
    with torch.enable_grad():
        t2, ob = _leaves(total2, w[7])
        g_t2, g_ob = torch.autograd.grad(reduce_epilogue_plain(t2, ob, dtype=ob.dtype), [t2, ob],
                                         g_crs)
        ins = _leaves(x1, audio, video)
        wc = _leaves(w[4], w[5], w[6])
        part = _tp_train_cross_plain(*ins, *wc, masks, nhead)
        g_x1, g_a, g_v, *g_w = torch.autograd.grad(part, [*ins, *wc], g_t2)
    partial = torch.cat([g_x1.float().reshape(-1, D), g_v.float().reshape(-1, D),
                         g_a.float().reshape(-1, D)])
    return partial, dict(zip((7, 4, 5, 6), [g_ob, *g_w]))


def _bwd_tp_self_plain(g_x1, patch, total1, w, masks, nhead):
    """Plain ``fused_patch_select_train_bwd_tp_self`` on the rounded g_x1:
    (the fp32 partial of gpatch's attention term [R, D]; {weight index:
    gradient} of the self-attention)."""
    with torch.enable_grad():
        t1, ob = _leaves(total1, w[3])
        g_t1, g_ob = torch.autograd.grad(_tp_train_x1_plain(t1, patch, ob), [t1, ob], g_x1)
        p, *ws = _leaves(patch, w[0], w[1], w[2])
        g_p, *g_w = torch.autograd.grad(_tp_train_self_plain(p, *ws, masks, nhead), [p, *ws],
                                        g_t1)
    return g_p.float().reshape(-1, patch.shape[-1]), dict(zip((3, 0, 1, 2), [g_ob, *g_w]))


class _PSState:
    """What the stages of one tensor-parallel PatchSelecter forward share and
    keep for the backward (``avq._AVQState``'s counterpart)."""

    def __init__(self, patch, audio, video, weights, masks, nhead):
        self.patch, self.audio, self.video = patch, audio, video
        self.weights, self.masks, self.nhead = list(weights), masks, nhead
        B, T, P, D = patch.shape
        self.B, self.T = B, T
        self.Wl = weights[0].shape[0] // 3
        self.dims = (B * T, P, D, self.Wl, nhead)
        self.shapes = patch_select_train_tp_gemm_shapes(B * T, P, D, self.Wl)
        self.bufs: dict = {}
        if self.cuda:
            self.bufs = dict(patch=patch, video=video, audio=audio,
                             **{f"m_{k}": masks[k] for k in MASK_KEYS})
            self.bufs.update(zip(WEIGHT_NAMES, self.weights))

    @property
    def cuda(self) -> bool:
        return self.patch.device.type == "cuda"

    def empty(self, *shape, dtype=None):
        return torch.empty(*shape, dtype=dtype or self.patch.dtype, device=self.patch.device)

    def launch(self, stage, name: str, part_rows: int | None = None, attn=(), **bufs) -> None:
        """Launch ``qt_patch_select_train_<name>`` with ``bufs`` added and,
        when ``part_rows`` is given, a fresh fp32 partial of that many
        rows; counts it and tallies its products' routes and those of the
        keep-masked attentions (Sq, Sk) ``attn`` it runs."""
        self.bufs.update(bufs)
        if part_rows is not None:
            self.bufs["part"] = self.empty(part_rows, self.dims[2], dtype=torch.float32)
        dev, dt = self.patch.device, self.patch.dtype
        products = self.shapes.get(name, [])
        sms = sm_count(dev)
        plan = gemm_plan(dt, products, sms)
        ws_floats = plan_workspace(dt, products, sms)
        self.bufs["ws"] = (torch.empty(ws_floats, dtype=torch.float32, device=dev)
                           if ws_floats else None)
        rows = keep_rows(attn)
        _build.launch_table(f"qt_patch_select_train_{name}", "qt_patch_select_train_num_buffers",
                            TRAIN_BUFFERS, self.bufs, *self.dims, 0, plan.data_ptr(),
                            len(products), rows.data_ptr(), len(rows), ws_floats)
        stage.launches += 1
        note_plan_routes(stage, plan)
        note_keep_routes(stage, rows)


def _self_plain(st: _PSState) -> torch.Tensor:
    w = st.weights
    return _tp_train_self_plain(st.patch, w[0], w[1], w[2], st.masks, st.nhead)


def _cross_plain(st: _PSState, total1: torch.Tensor) -> torch.Tensor:
    st.total1, w = total1, st.weights
    st.x1 = _tp_train_x1_plain(total1, st.patch, w[3])
    return _tp_train_cross_plain(st.x1, st.audio, st.video, w[4], w[5], w[6], st.masks, st.nhead)


def _mlp_plain(st: _PSState, total2: torch.Tensor) -> torch.Tensor:
    st.total2, w = total2, st.weights
    st.crs_d = _tp_train_crs_plain(total2, w[7], st.masks)
    return _tp_train_mlp_plain(st.crs_d, w[8], w[9], w[10])


def _out_plain(st: _PSState, total3: torch.Tensor) -> tuple:
    st.total3, w = total3, st.weights
    return _tp_train_out_plain(total3, w[11], w[12], w[13], w[14], w[15], st.B, st.T)


def _bwd_mlp_plain(st: _PSState, ga, gv):
    return _bwd_tp_mlp_plain(ga, gv, st.total3, st.crs_d, st.weights, st.B, st.T)


def _bwd_cross_plain(st: _PSState, total: torch.Tensor):
    return _bwd_tp_cross_plain(total, st.x1, st.audio, st.video, st.total2, st.weights,
                               st.masks, st.nhead)


def _bwd_self_plain(st: _PSState, total: torch.Tensor):
    dt, B, T, D = st.patch.dtype, st.B, st.T, st.patch.shape[-1]
    R, BT = total.shape[0] - 2 * B * T, B * T
    g_x1 = total[:R].reshape(st.patch.shape).to(dt)
    g_video = total[R:R + BT].reshape(B, T, D).to(dt)
    g_audio = total[R + BT:].reshape(B, T, D).to(dt)
    part, grads = _bwd_tp_self_plain(g_x1, st.patch, st.total1, st.weights, st.masks, st.nhead)
    return g_x1, g_video, g_audio, part, grads


@tp_stage(_self_plain)
def fused_patch_select_train_tp_self(st: _PSState) -> torch.Tensor:
    """Forward stage 1: the self-attention's fp32 out_proj partial [R, D]
    over the rank's heads."""
    R, Wl = st.dims[0] * st.dims[1], st.Wl
    P = st.dims[1]
    st.launch(fused_patch_select_train_tp_self, "tp_self", R, attn=[(P, P)],
              qkv=st.empty(R, 3 * Wl), sctx=st.empty(R, Wl))
    fused_patch_select_train.launches += 1
    return st.bufs["part"]


@tp_stage(_cross_plain)
def fused_patch_select_train_tp_cross(st: _PSState, total1: torch.Tensor) -> torch.Tensor:
    """Forward stage 2 on the summed self partial: x1, then the cross
    attention's fp32 out_proj partial [2 B*T, D] over the rank's heads."""
    st.total1 = total1
    BT, P, D, Wl, _ = st.dims
    R = BT * P
    st.launch(fused_patch_select_train_tp_cross, "tp_cross", 2 * BT, attn=[(1, P)] * 2,
              total=total1,
              x1=st.empty(R, D), kv=st.empty(R, 2 * Wl), src2=st.empty(2 * BT, D),
              q=st.empty(2 * BT, Wl), ctx=st.empty(2 * BT, Wl))
    return st.bufs["part"]


@tp_stage(_mlp_plain)
def fused_patch_select_train_tp_mlp(st: _PSState, total2: torch.Tensor) -> torch.Tensor:
    """Forward stage 3 on the summed cross partial: the dropped cross output,
    then mlp.2's fp32 partial [2 B*T, D] over the rank's hidden columns."""
    st.total2 = total2
    BT, _, D, Wl, _ = st.dims
    st.launch(fused_patch_select_train_tp_mlp, "tp_mlp", 2 * BT, total=total2,
              crs_d=st.empty(2 * BT, D), hid=st.empty(2 * BT, Wl // 2))
    return st.bufs["part"]


@tp_stage(_out_plain)
def fused_patch_select_train_tp_out(st: _PSState, total3: torch.Tensor) -> tuple:
    """Forward stage 4 on the summed MLP partial: (a, v), each [B, T, D]."""
    st.total3 = total3
    BT, _, D, _, _ = st.dims
    st.launch(fused_patch_select_train_tp_out, "tp_out", total=total3,
              outf=st.empty(2 * BT, D, dtype=torch.float32), a_out=st.empty(st.B, st.T, D),
              v_out=st.empty(st.B, st.T, D))
    return st.bufs["a_out"], st.bufs["v_out"]


def _weight_grads(st: _PSState, indices) -> dict:
    for i in indices:
        st.bufs[f"g_{WEIGHT_NAMES[i]}"] = torch.empty(st.weights[i].shape, dtype=torch.float32,
                                                      device=st.patch.device)
    return {i: st.bufs[f"g_{WEIGHT_NAMES[i]}"] for i in indices}


@tp_stage(_bwd_mlp_plain)
def fused_patch_select_train_bwd_tp_mlp(st: _PSState, ga, gv):
    """Backward stage 1: (the fp32 partial [2 B*T, D] of the dropped cross
    output's gradient; {weight index: gradient} of the MLP and the norms)."""
    BT, _, D, Wl, _ = st.dims
    f32 = torch.float32
    grads = _weight_grads(st, (8, 9, 10, 11, 12, 13, 14, 15))
    st.launch(fused_patch_select_train_bwd_tp_mlp, "bwd_tp_mlp", 2 * BT,
              ga=ga.to(st.patch.dtype).contiguous(), gv=gv.to(st.patch.dtype).contiguous(),
              g_rel=st.empty(2 * BT, D, dtype=f32), stats=st.empty(2, 2 * BT, dtype=f32),
              g_pre1=st.empty(2 * BT, Wl // 2, dtype=f32))
    fused_patch_select_train_bwd.launches += 1
    return st.bufs["part"], grads


@tp_stage(_bwd_cross_plain)
def fused_patch_select_train_bwd_tp_cross(st: _PSState, total: torch.Tensor):
    """Backward stage 2 on the summed partial of stage 1: (the fp32 partials
    of g_x1 and of the video and audio streams' gradients, rows [R + 2 B*T,
    D]; {weight index: gradient} of the cross attention)."""
    BT, P, D, Wl, _ = st.dims
    R = BT * P
    grads = _weight_grads(st, (4, 5, 6, 7))
    st.launch(fused_patch_select_train_bwd_tp_cross, "bwd_tp_cross", R + 2 * BT,
              attn=[(1, P)] * 2, total=total,
              g_crs_o=st.empty(2 * BT, D), g_ctx=st.empty(2 * BT, Wl),
              g_qc=st.empty(2 * BT, Wl), g_kv=st.empty(R, 2 * Wl))
    return st.bufs["part"], grads


@tp_stage(_bwd_self_plain)
def fused_patch_select_train_bwd_tp_self(st: _PSState, total: torch.Tensor):
    """Backward stage 3 on the summed partials of stage 2: (g_x1, the video
    and audio gradients, each rounded once; the fp32 partial [R, D] of
    gpatch's attention term; {weight index: gradient} of the
    self-attention)."""
    BT, P, D, Wl, _ = st.dims
    R = BT * P
    grads = _weight_grads(st, (0, 1, 2, 3))
    st.launch(fused_patch_select_train_bwd_tp_self, "bwd_tp_self", R, attn=[(P, P)],
              total=total, g_x1=st.empty(*st.patch.shape), gvideo=st.empty(st.B, st.T, D),
              gaudio=st.empty(st.B, st.T, D), g_slf=st.empty(R, Wl),
              g_qkv=st.empty(R, 3 * Wl))
    b = st.bufs
    return b["g_x1"], b["gvideo"], b["gaudio"], b["part"], grads


TP_TRAIN_STAGES = (fused_patch_select_train_tp_self, fused_patch_select_train_tp_cross,
                   fused_patch_select_train_tp_mlp, fused_patch_select_train_tp_out,
                   fused_patch_select_train_bwd_tp_mlp, fused_patch_select_train_bwd_tp_cross,
                   fused_patch_select_train_bwd_tp_self)
for _stage in TP_TRAIN_STAGES:
    _stage.launches = 0
    _stage.gemm_routes = {}
    _stage.attn_routes = {}


def patch_grad_epilogue(total: torch.Tensor, g_x1: torch.Tensor) -> torch.Tensor:
    """gpatch = g_x1 + round(total): EpiResidual's rounding on the summed
    partials of ``fused_patch_select_train_bwd_tp_self`` (``qt_reduce_epilogue``
    on the card)."""
    total = total.reshape(g_x1.shape)
    if g_x1.device.type == "cpu":
        return reduce_epilogue_plain(total, None, res=g_x1, dtype=g_x1.dtype)
    gpatch = torch.empty_like(g_x1)
    launch_epilogue(total, None, g_x1, gpatch, dtype=g_x1.dtype)
    return gpatch


class _PatchSelectTrainTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, nhead, masks, patch, audio, video, *weights):
        st = _PSState(patch, audio, video, weights, masks, nhead)
        total1 = grid.reduce_model(fused_patch_select_train_tp_self(st))
        total2 = grid.reduce_model(fused_patch_select_train_tp_cross(st, total1))
        total3 = grid.reduce_model(fused_patch_select_train_tp_mlp(st, total2))
        a, v = fused_patch_select_train_tp_out(st, total3)
        ctx.st, ctx.grid = st, grid
        return a, v

    @staticmethod
    def backward(ctx, ga, gv):
        st, grid = ctx.st, ctx.grid
        part, grads = fused_patch_select_train_bwd_tp_mlp(st, ga, gv)
        part, more = fused_patch_select_train_bwd_tp_cross(st, grid.reduce_model(part))
        grads.update(more)
        g_x1, g_video, g_audio, part, more = fused_patch_select_train_bwd_tp_self(
            st, grid.reduce_model(part))
        grads.update(more)
        gpatch = patch_grad_epilogue(grid.reduce_model(part), g_x1)
        return (None, None, None, gpatch, g_audio, g_video,
                *[grads[i].to(w.dtype) for i, w in enumerate(st.weights)])


def fused_patch_select_train_tp(patch: torch.Tensor, audio: torch.Tensor, video: torch.Tensor,
                                params, masks: dict, nhead: int, grid) -> tuple:
    """``fused_patch_select_train`` on one model rank of ``grid``: ``params``
    holds the rank's shards (in_proj rows [3 Wl, D] of its heads, out_proj
    columns [D, Wl], mlp.0 rows [Wl/2, D], mlp.2 columns [D, Wl/2]; biases
    and norms whole), ``masks`` its share (``shard_patch_masks``), ``nhead``
    its heads. The inputs, the outputs (a, v) and their gradients are whole
    on every rank."""
    weights = _weights(params)
    if patch.device.type == "cpu":
        return _PatchSelectTrainTP.apply(grid, nhead, masks, patch, audio, video, *weights)
    if patch.device.type != "cuda":
        raise ValueError(f"fused_patch_select_train_tp runs on cpu or cuda, not {patch.device}")
    B, T, P, D = patch.shape
    Wl = weights[0].shape[0] // 3
    if Wl % nhead or Wl * grid.model_size != D:
        raise ValueError(f"the rank's {Wl} columns do not hold {nhead} heads of d_model {D}")
    shapes = [(3 * Wl, D), (3 * Wl,), (D, Wl), (D,), (3 * Wl, D), (3 * Wl,), (D, Wl), (D,),
              (Wl // 2, D), (Wl // 2,), (D, Wl // 2), (D,), (D,), (D,), (D,), (D,)]
    _stage_check("fused_patch_select_train_tp", [patch, audio, video], weights, shapes)
    Lp = -(-nhead * P // 128) * 128
    want = {"slf": (B * T * P, Lp), "crs_v": (B * T, Lp), "crs_a": (B * T, Lp),
            "out_v": (B * T, D), "out_a": (B * T, D)}
    dev_masks = {}
    for key, shape in want.items():
        m = masks[key]
        if tuple(m.shape) != shape:
            raise ValueError(f"mask {key} must be {shape}, got {tuple(m.shape)}")
        dev_masks[key] = m.to(patch.device, patch.dtype).contiguous()
    patch, weights = aligned16(patch), [aligned16(w) for w in weights]
    return _PatchSelectTrainTP.apply(grid, nhead, dev_masks, patch, audio, video, *weights)
