"""The whole eval PatchSelecter as one fused operation.

Port of ``qa_tiger_tpu/ops/pallas/patch_select.py:fused_patch_select``:
per frame, self-attention over its P patches with residual, then the
frame's video and audio vectors as two queries attending those patches,
out_proj, MLP and one LayerNorm per stream. The CUDA kernel in
``csrc/patch_select.cu`` runs for CUDA tensors, the plain version
``patch_selecter_plain`` (the port of ``patch_selecter_jnp``) for CPU
tensors.
"""
from __future__ import annotations

import math

import torch

from qa_tiger_tpu_torch.nn.core import layer_norm, linear, mlp2
from qa_tiger_tpu_torch.ops import _build
from qa_tiger_tpu_torch.ops.attention import _wide_reference


def patch_selecter_plain(params, patch, audio, video, *, nhead: int = 8):
    """All B*T frames as one batch of attention problems -> [a, v], each
    [B, T, D]. ``params`` holds slf_attn, crs_attn, mlp, anorm, vnorm.

    The port of ``patch_selecter_jnp``: its two ``mha`` calls are written out
    (packed qkv for the self-attention, q and fused kv for the cross one) so
    that this version reaches no kernel."""
    B, T, P, D = patch.shape
    BT = B * T
    scale = 1.0 / math.sqrt(D // nhead)
    slf_p, crs_p = params.slf_attn, params.crs_attn
    patch_bt = patch.reshape(BT, P, D)
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


def fused_patch_select(patch: torch.Tensor, audio: torch.Tensor,
                       video: torch.Tensor, params, nhead: int = 8):
    """(a_final, v_final) = PatchSelecter(patch [B,T,P,D], audio/video
    [B,T,D]); returns two [B, T, D]."""
    if patch.device.type == "cpu":
        return tuple(patch_selecter_plain(params, patch, audio, video,
                                          nhead=nhead))
    if patch.device.type != "cuda":
        raise ValueError(f"fused_patch_select runs on cpu or cuda, not {patch.device}")
    B, T, P, D = patch.shape
    if D % nhead or D % 2:
        raise ValueError(f"width {D} does not split into {nhead} heads")
    weights = _weights(params)
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
    _build.launch("qt_patch_select", _build.dtype_code(patch),
                  patch.data_ptr(), video.data_ptr(), audio.data_ptr(),
                  *[w.data_ptr() for w in weights],
                  a_out.data_ptr(), v_out.data_ptr(),
                  *[s.data_ptr() for s in scratch], BT, P, D, nhead)
    fused_patch_select.launches += 1
    return a_out, v_out


fused_patch_select.launches = 0
