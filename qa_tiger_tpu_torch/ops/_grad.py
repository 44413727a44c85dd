"""Gradients of the forward-only kernels: recompute through the plain version.

The JAX package gives ``attention_wide``, ``fused_attn_ln2``,
``fused_patch_select`` and ``fused_gaussian_moe`` a ``custom_vjp`` whose
backward is ``jax.vjp`` of the plain jnp version on the saved inputs. This
is that rule as a ``torch.autograd.Function``: the forward launches the
kernel, the backward runs the plain version under autograd on the saved
inputs and returns ``torch.autograd.grad`` of it. Constants (masks, scales,
head counts) ride in ``consts`` and get no gradient.
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

