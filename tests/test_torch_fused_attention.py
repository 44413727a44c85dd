"""``fused_attention`` (the classic [BH, S, dh] attention) against the JAX
function, and the mask routing of the attention wrappers' autograd Function.

The JAX side runs ``fused_attention`` in interpret mode, as
``tests/test_pallas_attention.py`` does: the per-row Pallas ``_kernel``, and
the packed ``_packed_kernel`` where BH >= 256, S <= 16 and no mask. Inputs
come from numpy seeds. Tolerances: fp32 rtol 1e-5 / atol 1e-6 (summation
order, and the packed kernel scales the dot where the port scales q);
bf16 max|got - want| <= 1e-2 * max|want| (bf16 rounding of p and the
output); gradients rtol / atol 2e-4, as the JAX gradient tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qa_tiger_tpu.ops.pallas.attention import fused_attention as j_fused_attention
from qa_tiger_tpu_torch.ops import _grad, fused_attention, launch_counts
from qa_tiger_tpu_torch.ops import attention as A

FP32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=2e-4)


def _qkv(seed, bh, sq, sk, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((bh, sq, dh), (bh, sk, dh), (bh, sk, dh))]


def _causal(sq, sk):
    return np.triu(np.full((sq, sk), -np.inf, np.float32), 1)


def _jax(q, k, v, mask, scale, dtype=jnp.float32):
    return j_fused_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                             None if mask is None else jnp.asarray(mask), scale,
                             bh_tile=4, interpret=True)


@pytest.mark.parametrize("bh,sq,sk,dh,causal", [
    (6, 77, 77, 64, False), (10, 1, 60, 64, False), (8, 14, 14, 64, False),
    (5, 60, 60, 32, False), (6, 12, 12, 32, True),
    (256, 14, 14, 64, False),  # the packed route: BH >= 256, S <= 16, no mask
])
def test_fused_attention_fp32(bh, sq, sk, dh, causal):
    q, k, v = _qkv(0, bh, sq, sk, dh)
    mask = _causal(sq, sk) if causal else None
    want = _jax(q, k, v, mask, dh ** -0.5)
    got = fused_attention(*map(torch.from_numpy, (q, k, v)),
                          None if mask is None else torch.from_numpy(mask), dh ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_fused_attention_bf16_causal():
    q, k, v = _qkv(1, 6, 77, 77, 32)
    mask = _causal(77, 77)
    want = np.asarray(_jax(q, k, v, mask, 32 ** -0.5, jnp.bfloat16), np.float32)
    got = fused_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                          torch.from_numpy(mask), 32 ** -0.5)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("masked", [False, True])
def test_fused_attention_grads(masked):
    """d/dq, d/dk, d/dv and, for an additive mask that requires grad, the
    mask's cotangent (the JAX ``_fa_masked_bwd`` rule) against jax.grad."""
    bh, s, dh = 4, 10, 32
    q, k, v = _qkv(2, bh, s, s, dh)
    mask = (0.5 * np.random.default_rng(3).standard_normal((s, s))).astype(np.float32)
    scale = dh ** -0.5
    args = [q, k, v] + ([mask] if masked else [])

    def j_loss(*a):
        return jnp.sum(j_fused_attention(*a[:3], a[3] if masked else None, scale, bh_tile=2,
                                         interpret=True) ** 2)

    want = jax.grad(j_loss, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fused_attention(*leaves[:3], leaves[3] if masked else None, scale)
    out.square().sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **GRAD)


def test_cpu_tensors_launch_nothing():
    before = launch_counts()
    q = torch.randn(3, 5, 16)
    fused_attention(q, q, q, None, 0.25)
    assert launch_counts() == before


@pytest.mark.parametrize("key_bias", [False, True])
def test_attention_wide_mask_routing(key_bias):
    """``_grad.apply_masked``, which ``attention_wide`` calls on the card,
    with the plain version standing in for the launch: a mask that requires
    grad reaches the Function as a tensor input and gets the plain
    version's cotangent; one that does not stays a constant. Either way the
    other gradients are the plain version's."""
    rng = np.random.default_rng(4)
    B, sq, sk, W, heads = 2, 6, 9, 32, 4
    q, k, v = (torch.from_numpy(rng.standard_normal((B, s, W), dtype=np.float32))
               for s in (sq, sk, sk))
    kb = torch.from_numpy(rng.standard_normal((B, sk), dtype=np.float32)) if key_bias else None
    mask = torch.from_numpy(rng.standard_normal((sq, sk), dtype=np.float32))
    cot = torch.from_numpy(rng.standard_normal((B, sq, W), dtype=np.float32))
    consts = dict(scale=0.3, heads=heads)
    for mask_grad in (True, False):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v, mask)]
        tensors = ins[:3] + ([kb] if key_bias else [])
        plain = A._wide_reference_kb if key_bias else A._wide_reference
        m = ins[3].requires_grad_(mask_grad)
        got = _grad.apply_masked(plain, plain, consts, *tensors, mask=m)
        got_g = torch.autograd.grad(got, ins[:3 + mask_grad], cot)
        ref_ins = [t.clone().requires_grad_(True) for t in (q, k, v, mask)]
        want = A._wide_reference(*ref_ins, 0.3, heads, kb)
        want_g = torch.autograd.grad(want, ref_ins[:3 + mask_grad], cot)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        for g, w in zip(got_g, want_g):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
