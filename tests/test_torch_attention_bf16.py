"""The bf16 contract of ``attention_wide``: its plain version against the JAX
``fused_attention_wide`` in interpret mode, in bf16 on the same inputs.

This is the function the card's tensor-core kernel is held to: fp32 scores
(plus mask and key bias), an fp32 softmax over the whole row, p rounded to
bf16 after the global max and sum, p·v summed in fp32 and rounded to bf16.
The key lengths pass one and two 64-key tiles and are not multiples of 16,
and 129 and 577 pass one and four of the card's 128-key tiles (the Hopper
kernel's); 2 heads of 64 lanes. Inputs come from numpy seeds and are rounded to bf16
before either side sees them.

Tolerance: max|got - want| <= 2e-2 * max(1, max|want|): the two sides round
p and the output to bf16 from fp32 values that differ by summation order, so
a probability or an output element may land one bf16 step apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qa_tiger_tpu.ops.pallas.attention import fused_attention_wide as j_fused_attention_wide
from qa_tiger_tpu_torch.ops import attention_wide

TOL = 2e-2
B, HEADS, HD = 2, 2, 64


def _bf16(rng, *shape):
    """numpy fp32 values that are exact in bf16."""
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)
    return x.float().numpy()


@pytest.mark.parametrize("sq,sk", [(20, 145), (16, 77), (33, 200), (40, 129), (20, 577)])
@pytest.mark.parametrize("key_bias,causal", [(False, False), (True, False), (False, True),
                                             (True, True)])
def test_attention_wide_bf16_matches_jax(sq, sk, key_bias, causal):
    rng = np.random.default_rng(sq * 1000 + sk)
    W = HEADS * HD
    q, k, v = _bf16(rng, B, sq, W), _bf16(rng, B, sk, W), _bf16(rng, B, sk, W)
    mask = np.triu(np.full((sq, sk), -np.inf, np.float32), 1) if causal else None
    kb = np.log(rng.integers(1, 41, (B, sk))).astype(np.float32) if key_bias else None
    scale = HD ** -0.5
    want = j_fused_attention_wide(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        None if mask is None else jnp.asarray(mask), scale, HEADS, interpret=True,
        key_bias=None if kb is None else jnp.asarray(kb))
    got = attention_wide(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), scale, HEADS,
        key_bias=None if kb is None else torch.from_numpy(kb))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, sq, W)
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), err
