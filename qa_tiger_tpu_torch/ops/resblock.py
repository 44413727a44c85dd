"""The attention half of a CLIP pre-LN block plus the MLP half's ln_2 input.

Port of ``qa_tiger_tpu/ops/pallas/resblock.py:fused_attn_ln2``:

    y = x + out_proj(attn(ln_1(x)))      h = ln_2(y)

The CUDA kernel in ``csrc/resblock.cu`` runs for CUDA tensors, the plain
version ``_attn_ln2_plain`` for CPU tensors. On CUDA its gradient is that of
the plain version, recomputed (``ops/_grad.py``), the JAX ``custom_vjp`` rule
(resblock.py:649-682).
"""
from __future__ import annotations

import math

import torch

from qa_tiger_tpu_torch.nn.core import layer_norm, linear
from qa_tiger_tpu_torch.ops import _build, _grad
from qa_tiger_tpu_torch.ops.attention import _wide_reference


def _block_params(block) -> list:
    return [block.ln_1.weight, block.ln_1.bias, block.attn.in_proj_weight,
            block.attn.in_proj_bias, block.attn.out_proj.weight,
            block.attn.out_proj.bias, block.ln_2.weight, block.ln_2.bias]


def _attn_ln2_flat(x, ln1w, ln1b, wqkv, bqkv, wout, bout, ln2w, ln2b, *, heads, mask):
    """Plain version: ln_1, the packed qkv projection, ``_wide_reference``,
    out_proj, residual, ln_2 (the JAX package's ``_attn_ln2_jnp``)."""
    h = layer_norm(x, ln1w, ln1b)
    q, k, v = linear(h, wqkv, bqkv).chunk(3, dim=-1)
    ctx = _wide_reference(q, k, v, mask, 1.0 / math.sqrt(x.shape[-1] // heads), heads)
    y = x + linear(ctx, wout, bout)
    return y, layer_norm(y, ln2w, ln2b)


def _attn_ln2_plain(block, x, *, heads, mask):
    return _attn_ln2_flat(x, *_block_params(block), heads=heads, mask=mask)


def fused_attn_ln2(x: torch.Tensor, block, mask: torch.Tensor | None,
                   heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, ln_2(y)) for x [B, S, W]; ``block`` holds ``ln_1``, ``attn``
    (packed in_proj + out_proj) and ``ln_2``; ``mask`` is an additive [S, S]
    mask or None."""
    if x.device.type == "cpu":
        return _attn_ln2_plain(block, x, heads=heads, mask=mask)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attn_ln2 runs on cpu or cuda, not {x.device}")
    B, S, W = x.shape
    if W % heads:
        raise ValueError(f"width {W} does not split into {heads} heads")
    params = _block_params(block)
    shapes = [(W,), (W,), (3 * W, W), (3 * W,), (W, W), (W,), (W,), (W,)]
    for p, shape in zip([x] + params, [(B, S, W)] + shapes):
        if tuple(p.shape) != shape or not p.is_contiguous():
            raise ValueError(f"expected a contiguous {shape}, got {tuple(p.shape)}")
        if p.dtype != x.dtype or p.device != x.device:
            raise ValueError("parameters must match x's dtype and device")
    if mask is not None:
        if tuple(mask.shape) != (S, S):
            raise ValueError(f"mask must be [{S}, {S}], got {tuple(mask.shape)}")
        mask = mask.to(device=x.device, dtype=torch.float32).contiguous()
    return _grad.KernelWithPlainGrad.apply(_launch, _attn_ln2_flat,
                                           dict(heads=heads, mask=mask), x, *params)


def _launch(x, *params, heads, mask):
    B, S, W = x.shape
    y = torch.empty_like(x)
    h = torch.empty_like(x)
    qkv = torch.empty(B * S, 3 * W, dtype=x.dtype, device=x.device)
    ctx = torch.empty(B * S, W, dtype=x.dtype, device=x.device)
    stats = torch.empty(2, B * S, dtype=torch.float32, device=x.device)
    _build.launch("qt_attn_ln2", _build.dtype_code(x), x.data_ptr(),
                  *[p.data_ptr() for p in params], _build.ptr(mask),
                  y.data_ptr(), h.data_ptr(), qkv.data_ptr(), ctx.data_ptr(),
                  stats.data_ptr(), B, S, W, heads)
    fused_attn_ln2.launches += 1
    return y, h


fused_attn_ln2.launches = 0
