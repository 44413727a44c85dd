"""The decomposition ``fused_gaussian_moe``'s CUDA kernel computes, on the CPU.

On the card the op is two products: one [B*T, E*H] product of x and W1^T
whose 64-row tiles are one sample's T chunk each (rows past T weigh 0, the
weighted column sums carried over the chunks into s [B, E*H]), then
s W2 + (sum_t w) b2 (``csrc/gaussian_moe.cu``). ``_decomposed`` writes that
arithmetic out in plain PyTorch; here it is held against the JAX op (Pallas
in interpret mode) at
odd batches, T on both sides of the chunk edges, one and seven experts, a
hidden width that is not a multiple of 64, and the combined weights of both
TempMoE gather modes.

Tolerance: fp32 on both sides; the two sum in other orders, which moves
outputs of size ~1 by ~1e-6: max|got - want| <= 2e-5 + 1e-5 |want|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from qa_tiger_tpu.ops import tempmoe as jt
from qa_tiger_tpu.ops.pallas.gaussian_moe import fused_gaussian_moe as j_moe
from qa_tiger_tpu_torch.ops import gaussian_moe as G

TOL = dict(rtol=1e-5, atol=2e-5)
ROWS = 64  # csrc/gaussian_moe.cu MOE_ROWS: the rows of one sample's T chunk


def _decomposed(x, w1t, b1, w2t, b2, w, rows=ROWS):
    """The kernel's arithmetic in plain PyTorch, fp32: each sample's T
    padded with zero rows to whole chunks of ``rows``; h = relu(x W1 + b1)
    as one [B*Tp, E*H] product; the padded rows weighted 0 (relu(b1) is not
    0); each chunk's weighted column sums added to the carry s [B, E*H]
    chunk by chunk; out = s W2 + (sum_t w) b2, cast once."""
    B, T, D = x.shape
    E, _, H = w1t.shape
    chunks = -(-T // rows)
    pad = chunks * rows - T
    xp = F.pad(x.float(), (0, 0, 0, pad))                       # [B, Tp, D]
    wp = F.pad(w.float(), (0, pad))                             # [B, E, Tp]
    w1 = w1t.float().transpose(1, 2).reshape(E * H, D)          # W1^T, [E*H, D]
    h = torch.relu(xp.reshape(-1, D) @ w1.t() + b1.float().reshape(-1))
    h = h.reshape(B, chunks, rows, E, H)
    wr = wp.reshape(B, E, chunks, rows).permute(0, 2, 3, 1)     # [B, chunk, row, E]
    s = torch.zeros(B, E, H)
    for c in range(chunks):
        s = s + torch.einsum("bre,breh->beh", wr[:, c], h[:, c])
    out = s.reshape(B, E * H) @ w2t.float().reshape(E * H, -1)
    out = out + wp.sum(-1) @ b2.float()
    return out.to(x.dtype)


def _case(B, T, E, H, D, gather_mode, seed=0):
    """x, the four expert tensors and the combined weights w [B, E, T] of
    one TempMoE call (top-K routing, K = min(3, E)), as numpy arrays."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    w1t, b1, w2t, b2 = f(E, D, H), f(E, H), f(E, H, D), f(E, D)
    K = min(3, E)
    gauss_w = jax.nn.softmax(jnp.asarray(rng.standard_normal((B, K, T)), jnp.float32), -1)
    inds = jnp.asarray(np.stack([rng.permutation(E)[:K] for _ in range(B)]), jnp.int32)
    probs = jax.nn.softmax(jnp.asarray(rng.standard_normal((B, K)), jnp.float32), -1)
    w = np.array(jt.combined_expert_weights(gauss_w, inds, probs, E, gather_mode))
    return x, w1t, b1, w2t, b2, w


def _jax(x, w1t, b1, w2t, b2, w, batch_tile=2):
    return np.asarray(j_moe(*map(jnp.asarray, (x, w1t, b1, w2t, b2, w)), batch_tile, True))


@pytest.mark.parametrize("gather_mode", ["reference", "paper"])
@pytest.mark.parametrize("E", [1, 7])
@pytest.mark.parametrize("T", [1, 7, 60, 64, 65, 130])
def test_decomposition_matches_jax(T, E, gather_mode):
    """B = 3 (the last pair holds one sample), H = 40, D = 24: the
    [B*T, E*H] product, the zero-weighted padded rows, the carry over
    ceil(T / 64) chunks and the wsum b2 term give the JAX op's output."""
    args = _case(3, T, E, 40, 24, gather_mode)
    got = _decomposed(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), _jax(*args), **TOL)


@pytest.mark.parametrize("rows", [1, 5, 16])
def test_decomposition_any_chunk_height(rows):
    """The carry does not depend on where the chunks cut T: chunks of 1, 5
    and 16 rows over T = 37 give the JAX op's output."""
    args = _case(5, 37, 7, 24, 16, "reference", seed=1)
    got = _decomposed(*map(torch.from_numpy, args), rows=rows)
    np.testing.assert_allclose(got.numpy(), _jax(*args), **TOL)


def test_padded_rows_must_weigh_zero():
    """The reason the padded rows get weight 0: relu(0 W1 + b1) = relu(b1)
    is not 0, so a chunk that weighted them as a real row would move the
    output by sum_e (relu(b1_e) W2_e) per padded row."""
    x, w1t, b1, w2t, b2, w = map(torch.from_numpy, _case(3, 7, 7, 40, 24, "reference"))
    b1 = b1.abs() + 0.1  # every relu(b1) > 0
    want = G._reference_impl(x, w1t, b1, w2t, b2, w)
    np.testing.assert_allclose(_decomposed(x, w1t, b1, w2t, b2, w).numpy(),
                               want.numpy(), **TOL)
    # the same chunk with the padded rows given the next real row's weight
    wrong = torch.cat([w, w[..., -1:].expand(-1, -1, 64 - 7)], dim=-1)
    xpad = torch.cat([x, torch.zeros(3, 64 - 7, 24)], dim=1)
    off = G._reference_impl(xpad, w1t, b1, w2t, b2, wrong) - want
    assert off.abs().max() > 100 * TOL["atol"]


@pytest.mark.parametrize("dtype,d,route", [(torch.bfloat16, 512, "wgmma"),
                                           (torch.bfloat16, 24, "wgmma"),
                                           (torch.bfloat16, 768, "tf32x3"),
                                           (torch.float32, 512, "tf32x3"),
                                           (torch.float32, 24, "tf32x3")])
def test_route(dtype, d, route):
    """The first product's routine is a function of dtype and width: wgmma
    for bf16 up to D = 512 (both samples' x chunks in shared memory),
    3xTF32 otherwise."""
    assert G.moe_route(dtype, d) == route


def test_cpu_tensor_takes_the_plain_version():
    """A CPU tensor takes ``_reference_impl``: no launch, no route tallied."""
    args = [torch.from_numpy(a) for a in _case(2, 9, 7, 40, 24, "paper")]
    G.fused_gaussian_moe.launches, G.fused_gaussian_moe.gemm_routes = 0, {}
    got = G.fused_gaussian_moe(*args)
    assert G.fused_gaussian_moe.launches == 0 and G.fused_gaussian_moe.gemm_routes == {}
    assert torch.equal(got, G._reference_impl(*args))
