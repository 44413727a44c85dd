"""The residual halves of a CLIP pre-LN block:

    y = x + out_proj(attn(ln_1(x)))                  attention half
    y = x + c_proj(QuickGELU(c_fc(ln_2(x))))         MLP half

Port of ``qa_tiger_tpu/ops/pallas/resblock.py``: ``fused_attn_ln2`` (the
attention half and the MLP half's input ``ln_2(y)``), ``fused_attn_half``
(the attention half alone) and ``fused_resblock`` (both halves). The CUDA
kernels in ``csrc/resblock.cu`` run for CUDA tensors, the plain versions for
CPU tensors. On CUDA the gradient is that of the plain version, recomputed
(``ops/_grad.py``), the JAX ``custom_vjp`` rules (resblock.py:574-682): a
mask that requires grad gets its cotangent from ``fused_attn_ln2`` and
``fused_attn_half``, none from ``fused_resblock``.

The JAX package admits a shape to its kernels by TPU memory and launch
overhead (``_usable``, ``_attn_sizes``, ``_mlp_sizes``); here a CUDA tensor
always launches the kernel, and a shape the kernel does not take raises.

The fp32 attention halves (``fused_attn_ln2``, ``fused_attn_half`` and
the TP partial) are planned launches (``ops.gemm.launch_plan``): their two
products run on ``gemm_tf32x3`` (3xTF32) as the plan rows of
``attn_gemm_shapes`` say, ln_1 staged first, and the launch writes back the
route each product took (``gemm_routes``: tf32x3 x 2 a launch) and the
kernel its attention took (``attn_routes``); a product the plan refuses
raises. In bf16 they plan no product: their products take ``gemm_sm90``
where ``gemm_route`` gives wgmma, tallied by that rule; past 128 tokens
their one attention row (a three-int host buffer, no tensor) reads back
the kernel the attention took (``attn_routes``: "mma_sm90", or "mma" where
the Hopper kernel's rule declines the length). Up to 128 tokens (the text
towers, the serving path) a bf16 launch passes no row and tallies no
attention, so its host work stays what it was. The MLP half's fp32
products stay on ``gemm_tile``'s FMA loop.

Under tensor parallelism (``parallel/tensor.py``) ``fused_attn_ln2`` splits
at its all-reduce into two stages: ``fused_attn_ln2_partial`` (ln_1, the
rank's heads, its out_proj columns into an fp32 [B, S, W] partial; it
counts as one ``fused_attn_ln2`` launch) and, after the caller's sum over
the model ranks, ``fused_attn_ln2_post`` (y = x + round(sum + b_out), h =
ln_2(y)). They take no gradient.
"""
from __future__ import annotations

import ctypes
import math

import torch

from torch.nn import functional as F

from qa_tiger_tpu_torch.nn.core import layer_norm, linear, quick_gelu
from qa_tiger_tpu_torch.ops import _build, _grad
from qa_tiger_tpu_torch.ops.epilogue import launch_epilogue, no_grad_stage, reduce_epilogue_plain
from qa_tiger_tpu_torch.ops.attention import KEEP_MAX_SK, KERNEL_NAMES, _wide_reference
from qa_tiger_tpu_torch.ops.gemm import (
    aligned16,
    attn_gemm_shapes,
    launch_plan,
    mlp_gemm_shapes,
    note_launch_plan,
    note_routes,
    tma_ready,
)


def _attn_params(block) -> list:
    return [block.ln_1.weight, block.ln_1.bias, block.attn.in_proj_weight,
            block.attn.in_proj_bias, block.attn.out_proj.weight, block.attn.out_proj.bias]


def _block_params(block) -> list:
    """The attention half's parameters and ln_2's."""
    return _attn_params(block) + [block.ln_2.weight, block.ln_2.bias]


def _resblock_params(block) -> list:
    return _block_params(block) + [block.mlp.c_fc.weight, block.mlp.c_fc.bias,
                                   block.mlp.c_proj.weight, block.mlp.c_proj.bias]


def _param_shapes(W: int, n: int) -> list:
    """The shapes of the first n of ``_resblock_params``."""
    return [(W,), (W,), (3 * W, W), (3 * W,), (W, W), (W,), (W,), (W,),
            (4 * W, W), (4 * W,), (W, 4 * W), (W,)][:n]


def _attn_half_flat(x, ln1w, ln1b, wqkv, bqkv, wout, bout, *, heads, mask):
    """Plain version of the attention half: ln_1, the packed qkv
    projection, ``_wide_reference``, out_proj, residual (the JAX package's
    ``_attn_half_jnp``)."""
    h = layer_norm(x, ln1w, ln1b)
    q, k, v = linear(h, wqkv, bqkv).chunk(3, dim=-1)
    ctx = _wide_reference(q, k, v, mask, 1.0 / math.sqrt(x.shape[-1] // heads), heads)
    return x + linear(ctx, wout, bout)


def _attn_ln2_flat(x, ln1w, ln1b, wqkv, bqkv, wout, bout, ln2w, ln2b, *, heads, mask):
    """Plain version of ``fused_attn_ln2`` (the JAX ``_attn_ln2_jnp``)."""
    y = _attn_half_flat(x, ln1w, ln1b, wqkv, bqkv, wout, bout, heads=heads, mask=mask)
    return y, layer_norm(y, ln2w, ln2b)


def _attn_ln2_plain(block, x, *, heads, mask):
    return _attn_ln2_flat(x, *_block_params(block), heads=heads, mask=mask)


def _mlp_half_flat(x, ln2w, ln2b, wfc, bfc, wpj, bpj):
    """Plain version of the MLP half as the Pallas ``_mlp_kernel`` computes
    it: ln_2 rounded to x's dtype; c_fc plus bias in fp32 and QuickGELU on
    that unrounded value, then rounded; c_proj plus bias in fp32, rounded;
    x plus that in x's dtype."""
    h = layer_norm(x, ln2w, ln2b)
    hid = quick_gelu(linear(h.float(), wfc.float(), bfc.float())).to(x.dtype)
    return x + linear(hid.float(), wpj.float(), bpj.float()).to(x.dtype)


def _resblock_flat(x, *params, heads, mask):
    """The forward's plain version of ``fused_resblock``: the attention
    half, then ``_mlp_half_flat`` (the Pallas bodies)."""
    y = _attn_half_flat(x, *params[:6], heads=heads, mask=mask)
    return _mlp_half_flat(y, *params[6:])


def _resblock_rule(x, *params, heads, mask):
    """The gradient's plain version, ``resblock_jnp``, which the JAX
    ``custom_vjp`` recomputes: its ``linear`` rounds the c_fc output to x's
    dtype before QuickGELU. The two agree in fp32; in bf16 they do not."""
    ln2w, ln2b, wfc, bfc, wpj, bpj = params[6:]
    y = _attn_half_flat(x, *params[:6], heads=heads, mask=mask)
    h = quick_gelu(linear(layer_norm(y, ln2w, ln2b), wfc, bfc))
    return y + linear(h, wpj, bpj)


def _checked_mask(x, params, heads: int, mask):
    """Raise on what the kernels do not take; the mask as a contiguous fp32
    [S, S] on x's device."""
    if x.device.type != "cuda":
        raise ValueError(f"the resblock kernels run on cpu or cuda, not {x.device}")
    B, S, W = x.shape
    if W % heads:
        raise ValueError(f"width {W} does not split into {heads} heads")
    for p, shape in zip([x] + params, [(B, S, W)] + _param_shapes(W, len(params))):
        if tuple(p.shape) != shape or not p.is_contiguous():
            raise ValueError(f"expected a contiguous {shape}, got {tuple(p.shape)}")
        if p.dtype != x.dtype or p.device != x.device:
            raise ValueError("parameters must match x's dtype and device")
    if mask is None:
        return None
    if tuple(mask.shape) != (S, S):
        raise ValueError(f"mask must be [{S}, {S}], got {tuple(mask.shape)}")
    return mask.to(device=x.device, dtype=torch.float32).contiguous()


def fused_attn_ln2(x: torch.Tensor, block, mask: torch.Tensor | None,
                   heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, ln_2(y)) for x [B, S, W]; ``block`` holds ``ln_1``, ``attn``
    (packed in_proj + out_proj) and ``ln_2``; ``mask`` is an additive [S, S]
    mask or None."""
    if x.device.type == "cpu":
        return _attn_ln2_plain(block, x, heads=heads, mask=mask)
    params = _block_params(block)
    mask = _checked_mask(x, params, heads, mask)
    return _grad.apply_masked(_launch_ln2, _attn_ln2_flat, dict(heads=heads), x, *params,
                              mask=mask)


def fused_attn_half(x: torch.Tensor, block, mask: torch.Tensor | None,
                    heads: int) -> torch.Tensor:
    """y = x + out_proj(attn(ln_1(x))) for x [B, S, W]; ``block`` holds
    ``ln_1`` and ``attn``; ``mask`` is an additive [S, S] mask or None."""
    params = _attn_params(block)
    if x.device.type == "cpu":
        return _attn_half_flat(x, *params, heads=heads, mask=mask)
    mask = _checked_mask(x, params, heads, mask)
    return _grad.apply_masked(_launch_half, _attn_half_flat, dict(heads=heads), x, *params,
                              mask=mask)


def fused_resblock(x: torch.Tensor, block, mask: torch.Tensor | None,
                   heads: int) -> torch.Tensor:
    """One CLIP block, x [B, S, W] -> [B, S, W]: the attention half's
    kernel, then the MLP half's. The forward is ``_resblock_flat``'s
    arithmetic, the gradient ``_resblock_rule``'s on either device; the mask
    is a constant, as in the JAX rule."""
    params = _resblock_params(block)
    if x.device.type == "cpu":
        return _grad.KernelWithPlainGrad.apply(_resblock_flat, _resblock_rule,
                                               dict(heads=heads, mask=mask), x, *params)
    mask = _checked_mask(x, params, heads, mask)
    return _grad.KernelWithPlainGrad.apply(_launch_resblock, _resblock_rule,
                                           dict(heads=heads, mask=mask), x, *params)


def _attn_partial_flat(x, ln1w, ln1b, wqkv, bqkv, wout, *, heads, mask):
    """Plain version of ``fused_attn_ln2_partial``: ln_1, the rank's qkv
    rows [3 Wl, W], ``_wide_reference`` over its ``heads`` heads, and the
    out-projection over its Wl columns in fp32 with no bias."""
    h = layer_norm(x, ln1w, ln1b)
    q, k, v = linear(h, wqkv, bqkv).chunk(3, dim=-1)
    ctx = _wide_reference(q, k, v, mask, 1.0 / math.sqrt(wqkv.shape[0] // 3 // heads), heads)
    return F.linear(ctx.float(), wout.float())


def fused_attn_ln2_partial(x: torch.Tensor, block, mask: torch.Tensor | None,
                           heads: int) -> torch.Tensor:
    """One model rank's share of ``fused_attn_ln2``'s attention half: x [B,
    S, W] -> the fp32 [B, S, W] partial of out_proj(attn(ln_1 x)) over this
    rank's ``heads`` heads, without out_proj's bias. ``block`` holds ln_1
    and the rank's shards: in_proj [3 Wl, W] (its q, k and v head rows) and
    out_proj.weight [W, Wl]. The partials summed over the ranks go to
    ``fused_attn_ln2_post``."""
    params = [block.ln_1.weight, block.ln_1.bias, block.attn.in_proj_weight,
              block.attn.in_proj_bias, block.attn.out_proj.weight]
    no_grad_stage("fused_attn_ln2_partial", x, *params)
    if x.device.type == "cpu":
        return _attn_partial_flat(x, *params, heads=heads, mask=mask)
    B, S, W = x.shape
    Wl = params[2].shape[0] // 3
    if Wl % heads:
        raise ValueError(f"{Wl} lanes do not split into {heads} heads")
    mask = _checked_mask(x, params[:2], heads, mask)
    for p, shape in zip(params[2:], [(3 * Wl, W), (3 * Wl,), (W, Wl)]):
        if tuple(p.shape) != shape or not p.is_contiguous():
            raise ValueError(f"expected a contiguous {shape}, got {tuple(p.shape)}")
        if p.dtype != x.dtype or p.device != x.device:
            raise ValueError("parameters must match x's dtype and device")
    params = [aligned16(p) for p in params]  # the products' B operands (TMA, cp.async)
    part = torch.empty(B, S, W, dtype=torch.float32, device=x.device)
    qkv = torch.empty(B * S, 3 * Wl, dtype=x.dtype, device=x.device)
    ctx = torch.empty(B * S, W, dtype=x.dtype, device=x.device)
    stats = torch.empty(2, B * S, dtype=torch.float32, device=x.device)
    shapes = [(B * S, 3 * Wl, W), (B * S, W, Wl)]
    plan, rows, args, _ws = _attn_plan(x, shapes)
    _build.launch("qt_attn_ln2_partial", _build.dtype_code(x), x.data_ptr(),
                  *[p.data_ptr() for p in params], _build.ptr(mask), part.data_ptr(),
                  qkv.data_ptr(), ctx.data_ptr(), stats.data_ptr(), B, S, W, Wl, heads, *args)
    fused_attn_ln2.launches += 1
    fused_attn_ln2_partial.launches += 1
    _note_attn_plan(fused_attn_ln2_partial, x.dtype, shapes, plan, rows)
    return part


def fused_attn_ln2_post(x: torch.Tensor, total: torch.Tensor, block) -> tuple:
    """(y, ln_2(y)) from x [B, S, W] and ``total``, the fp32 partials of
    ``fused_attn_ln2_partial`` summed over the model ranks: y = x +
    round(total + out_proj.bias), the one rounding the single-rank kernel
    makes there."""
    bias, ln2 = block.attn.out_proj.bias, block.ln_2
    no_grad_stage("fused_attn_ln2_post", x, total, bias, ln2.weight, ln2.bias)
    if x.device.type == "cpu":
        y = reduce_epilogue_plain(total, bias, res=x, dtype=x.dtype)
        return y, layer_norm(y, ln2.weight, ln2.bias)
    y, h = torch.empty_like(x), torch.empty_like(x)
    launch_epilogue(total, bias, x, y, (ln2.weight, ln2.bias, h))
    fused_attn_ln2_post.launches += 1
    return y, h


def _attn_scratch(x):
    B, S, W = x.shape
    return (torch.empty(B * S, 3 * W, dtype=x.dtype, device=x.device),
            torch.empty(B * S, W, dtype=x.dtype, device=x.device),
            torch.empty(2, B * S, dtype=torch.float32, device=x.device))


def _attn_plan(x, shapes) -> tuple:
    """``launch_plan`` of one fp32 attention half over x [B, S, W]: its
    products ``shapes`` and its one S x S attention. A bf16 launch plans no
    product (null plan arguments), so the serving path's host work per
    launch stays small; past KEEP_MAX_SK tokens its one attention row (S, S,
    kernel) is a ctypes buffer that the launch writes the kernel into."""
    if x.dtype != torch.float32:
        if x.shape[1] <= KEEP_MAX_SK:
            return None, None, [None, 0, None, 0, None, 0], None
        row = _ATTN_ROW(x.shape[1], x.shape[1], -1)
        return None, row, [None, 0, ctypes.addressof(row), 1, None, 0], None
    return launch_plan(x.dtype, shapes, [(x.shape[1],) * 2], x.device)


_ATTN_ROW = ctypes.c_int * 3  # one attention row (Sq, Sk, kernel)


def _note_attn_plan(kernel, dtype, shapes, plan, rows) -> None:
    """The routes of one attention-half launch: in fp32 its products' and
    its attention's from the plan rows it wrote, in bf16 its products' by
    the route rule and, past 128 tokens, its attention's from its row."""
    if plan is None:
        note_routes(kernel, dtype, shapes)
        if rows is not None:
            name = KERNEL_NAMES[rows[2]] if rows[2] >= 0 else "none"
            kernel.attn_routes[name] = kernel.attn_routes.get(name, 0) + 1
    else:
        note_launch_plan(kernel, plan, rows)


def _launch_ln2(x, *params, heads, mask):
    B, S, W = x.shape
    params = [aligned16(p) for p in params]  # the products' B operands (TMA, cp.async)
    y, h = torch.empty_like(x), torch.empty_like(x)
    qkv, ctx, stats = _attn_scratch(x)
    shapes = attn_gemm_shapes(B * S, W)
    plan, rows, args, _ws = _attn_plan(x, shapes)
    _build.launch("qt_attn_ln2", _build.dtype_code(x), x.data_ptr(),
                  *[p.data_ptr() for p in params], _build.ptr(mask),
                  y.data_ptr(), h.data_ptr(), qkv.data_ptr(), ctx.data_ptr(),
                  stats.data_ptr(), B, S, W, heads, *args)
    fused_attn_ln2.launches += 1
    _note_attn_plan(fused_attn_ln2, x.dtype, shapes, plan, rows)
    return y, h


def _launch_half(x, *params, heads, mask):
    B, S, W = x.shape
    params = [aligned16(p) for p in params]  # the products' B operands (TMA, cp.async)
    y = torch.empty_like(x)
    qkv, ctx, stats = _attn_scratch(x)
    shapes = attn_gemm_shapes(B * S, W)
    plan, rows, args, _ws = _attn_plan(x, shapes)
    _build.launch("qt_attn_half", _build.dtype_code(x), x.data_ptr(),
                  *[p.data_ptr() for p in params], _build.ptr(mask),
                  y.data_ptr(), qkv.data_ptr(), ctx.data_ptr(), stats.data_ptr(),
                  B, S, W, heads, *args)
    fused_attn_half.launches += 1
    _note_attn_plan(fused_attn_half, x.dtype, shapes, plan, rows)
    return y


def _launch_mlp(x, *params):
    B, S, W = x.shape
    params = [tma_ready(p) for p in params]  # the GEMMs' B operands
    y = torch.empty_like(x)  # also the bf16 route's ln_2 scratch
    hidden = torch.empty(B * S, 4 * W, dtype=x.dtype, device=x.device)
    stats = torch.empty(2, B * S, dtype=torch.float32, device=x.device)
    _build.launch("qt_mlp_half", _build.dtype_code(x), x.data_ptr(),
                  *[p.data_ptr() for p in params], y.data_ptr(), hidden.data_ptr(),
                  stats.data_ptr(), B * S, W, 4 * W)
    fused_resblock.launches += 1
    note_routes(fused_resblock, x.dtype, mlp_gemm_shapes(B * S, W))
    return y


def _launch_resblock(x, *params, heads, mask):
    return _launch_mlp(_launch_half(x, *params[:6], heads=heads, mask=mask), *params[6:])


fused_attn_ln2.launches = 0
fused_attn_ln2_partial.launches = 0
fused_attn_ln2_post.launches = 0
fused_attn_half.launches = 0
fused_resblock.launches = 0
# the GEMM routine of each product the attention halves and the MLP half
# launched, and the kernel each fp32 attention half's attention took
fused_attn_ln2.gemm_routes = {}
fused_attn_ln2_partial.gemm_routes = {}
fused_attn_half.gemm_routes = {}
fused_resblock.gemm_routes = {}
fused_attn_ln2.attn_routes = {}
fused_attn_ln2_partial.attn_routes = {}
fused_attn_half.attn_routes = {}
