"""Gradients of the forward-only kernels: recompute through the plain version.

The JAX package gives ``attention_wide``, ``fused_attention``,
``fused_attn_ln2``, ``fused_attn_half``, ``fused_resblock``,
``fused_patch_select`` and ``fused_gaussian_moe`` a ``custom_vjp`` whose
backward is ``jax.vjp`` of the plain jnp version on the saved inputs. This
is that rule as a ``torch.autograd.Function``: the forward launches the
kernel, the backward runs the plain version under autograd on the saved
inputs and returns ``torch.autograd.grad`` of it. Constants (scales, head
counts) ride in ``consts`` and get no gradient. ``apply_masked`` routes an
additive mask: a constant when it needs no gradient, a tensor input (so the
plain version's cotangent reaches it, as the JAX rules give one) when it
does.
"""
from __future__ import annotations

import torch


class KernelWithPlainGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, consts: dict, *tensors):
        ctx.plain, ctx.consts = plain, consts
        ctx.save_for_backward(*tensors)
        return kernel(*tensors, **consts)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[3:]
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            outs = ctx.plain(*inputs, **ctx.consts)
        outs = (outs,) if torch.is_tensor(outs) else tuple(outs)
        wrt = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True)) if wrt else iter(())
        return (None, None, None, *[next(got) if need else None for need in needs])


def apply_masked(kernel, plain, consts: dict, *tensors, mask: torch.Tensor | None):
    """``KernelWithPlainGrad`` for functions that take the additive mask as
    the keyword ``mask``: in ``consts`` unless it requires grad, else the
    last tensor input."""
    if mask is None or not mask.requires_grad:
        return KernelWithPlainGrad.apply(kernel, plain, dict(consts, mask=mask), *tensors)
    return KernelWithPlainGrad.apply(_mask_last(kernel), _mask_last(plain), consts, *tensors,
                                     mask)


def _mask_last(fn):
    def call(*tensors, **consts):
        return fn(*tensors[:-1], mask=tensors[-1], **consts)
    return call

