"""``fused_attn_half`` and ``fused_resblock`` against the JAX functions, the
mask routing of ``fused_attn_ln2``'s autograd Function, and the
``bench_resblock`` entry point on the CPU.

The JAX side runs both functions in interpret mode, as
``tests/test_pallas_resblock.py`` does: the attention half at a packed
(S=13) and an unpacked (S=40) shape, causal and not, and the MLP half.
Parameters come from the JAX initialiser with noise, carried into a
``ResidualAttentionBlock`` by ``params_from_jax`` and a strict load.
Tolerances: fp32 rtol / atol 2e-5 (summation order), as the JAX tests;
bf16 max|got - want| <= 1e-2 * max|want| (bf16 rounding of the projections
and the hidden layer); gradients rtol / atol 2e-4, as the JAX tests.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qa_tiger_tpu.models.clip_text import causal_mask as j_causal_mask
from qa_tiger_tpu.models.clip_text import resblock_init
from qa_tiger_tpu.ops.pallas.resblock import fused_attn_half as j_attn_half
from qa_tiger_tpu.ops.pallas.resblock import fused_resblock as j_resblock
from qa_tiger_tpu_torch import bench_resblock
from qa_tiger_tpu_torch.convert import params_from_jax
from qa_tiger_tpu_torch.models.clip_text import ResidualAttentionBlock, causal_mask
from qa_tiger_tpu_torch.ops import _grad, fused_attn_half, fused_resblock, launch_counts
from qa_tiger_tpu_torch.ops import resblock as R

FP32 = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
W, HEADS = 128, 4
FNS = {"attn_half": (fused_attn_half, j_attn_half), "resblock": (fused_resblock, j_resblock)}


def _params(width, seed=0):
    p = resblock_init(jax.random.PRNGKey(seed), width)
    ks = jax.random.split(jax.random.PRNGKey(seed + 1), 4)
    p["attn"]["in_proj_weight"] = 0.05 * jax.random.normal(ks[0], (3 * width, width))
    p["attn"]["in_proj_bias"] = 0.01 * jnp.arange(3 * width, dtype=jnp.float32) / width
    p["attn"]["out_proj"]["weight"] = 0.05 * jax.random.normal(ks[1], (width, width))
    p["mlp"]["c_fc"]["weight"] = 0.05 * jax.random.normal(ks[2], (4 * width, width))
    p["mlp"]["c_proj"]["weight"] = 0.05 * jax.random.normal(ks[3], (width, 4 * width))
    p["ln_1"]["weight"] = 1.0 + 0.1 * jnp.sin(jnp.arange(width))
    p["ln_2"]["bias"] = 0.1 * jnp.cos(jnp.arange(width))
    return jax.tree_util.tree_map(np.asarray, p)


def _block(p):
    block = ResidualAttentionBlock(W, 2, torch.Generator().manual_seed(0))
    block.load_state_dict(params_from_jax(p), strict=True)
    return block


def _x(seed, B, S):
    return np.random.default_rng(seed).standard_normal((B, S, W)).astype(np.float32)


@pytest.mark.parametrize("fn", sorted(FNS))
@pytest.mark.parametrize("B,S,causal", [(8, 13, True), (8, 13, False), (3, 40, True),
                                        (3, 40, False)])
def test_fp32(fn, B, S, causal):
    port, jfn = FNS[fn]
    p = _params(W)
    x = _x(7, B, S)
    want = jfn(jnp.asarray(x), p, j_causal_mask(S) if causal else None, HEADS, True)
    got = port(torch.from_numpy(x), _block(p), causal_mask(S) if causal else None, HEADS)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize("fn", sorted(FNS))
def test_bf16(fn):
    port, jfn = FNS[fn]
    p = _params(W)
    B, S = 4, 26
    x = _x(3, B, S)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    want = np.asarray(jfn(jnp.asarray(x, jnp.bfloat16), jp, j_causal_mask(S), HEADS, True),
                      np.float32)
    block = _block(p).to(torch.bfloat16)
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16(), block, causal_mask(S), HEADS)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("fn", sorted(FNS))
def test_grads(fn):
    """Every parameter's gradient, x's and the mask's against jax.grad
    through the JAX function: ``fused_attn_half`` gives the additive mask a
    cotangent (``_ah_bwd``); ``fused_resblock`` none (``_bwd`` returns None,
    a zero in JAX), so the port's mask gets no gradient."""
    port, jfn = FNS[fn]
    p = _params(W)
    B, S = 4, 13
    x = _x(9, B, S)
    mask = (0.5 * np.random.default_rng(10).standard_normal((S, S))).astype(np.float32)

    def j_loss(p_, x_, m_):
        return jnp.sum(jnp.square(jfn(x_, p_, m_, HEADS, True)))

    jp, jx, jm = jax.grad(j_loss, argnums=(0, 1, 2))(p, jnp.asarray(x), jnp.asarray(mask))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    block = _block(p)
    tx, tm = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(mask).requires_grad_(True)
    port(tx, block, tm, HEADS).square().sum().backward()
    got = {n: q.grad for n, q in block.named_parameters() if q.grad is not None}
    used = [n for n in want if fn == "resblock" or n.startswith(("ln_1.", "attn."))]
    assert sorted(got) == sorted(used)
    for name in used:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), **GRAD, err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx), **GRAD)
    if fn == "resblock":
        assert tm.grad is None and not np.asarray(jm).any()
    else:
        assert np.abs(np.asarray(jm)).max() > 0
        np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jm), **GRAD)


def test_fused_resblock_forward_and_rule_differ_in_bf16_only():
    """The forward follows the Pallas bodies (QuickGELU on the fp32 c_fc
    output), the gradient rule ``resblock_jnp`` (c_fc rounded first): equal
    in fp32, apart in bf16."""
    p = _params(W)
    x = torch.from_numpy(_x(11, 2, 13))
    for dtype, equal in ((torch.float32, True), (torch.bfloat16, False)):
        params = [t.to(dtype) for t in R._resblock_params(_block(p))]
        mask = causal_mask(13)
        a = R._resblock_flat(x.to(dtype), *params, heads=HEADS, mask=mask)
        b = R._resblock_rule(x.to(dtype), *params, heads=HEADS, mask=mask)
        assert torch.allclose(a.float(), b.float(), rtol=1e-5, atol=1e-5) == equal


def test_attn_ln2_mask_routing():
    """``_grad.apply_masked``, which ``fused_attn_ln2`` calls on the card,
    with the plain version standing in for the launch: a mask that requires
    grad gets the plain version's cotangent, and every other gradient is
    the plain version's either way."""
    block = _block(_params(W))
    params = R._block_params(block)
    rng = np.random.default_rng(12)
    x = torch.from_numpy(_x(12, 2, 9))
    mask = torch.from_numpy(rng.standard_normal((9, 9), dtype=np.float32))
    cots = [torch.from_numpy(rng.standard_normal((2, 9, W), dtype=np.float32)) for _ in range(2)]
    for mask_grad in (True, False):
        xs, ms = x.clone().requires_grad_(True), mask.clone().requires_grad_(mask_grad)
        wrt = [xs] + params + ([ms] if mask_grad else [])
        got = _grad.apply_masked(R._attn_ln2_flat, R._attn_ln2_flat, dict(heads=HEADS), xs,
                                 *params, mask=ms)
        got_g = torch.autograd.grad(got, wrt, cots)
        xr, mr = x.clone().requires_grad_(True), mask.clone().requires_grad_(mask_grad)
        want = R._attn_ln2_flat(xr, *params, heads=HEADS, mask=mr)
        want_g = torch.autograd.grad(want, [xr] + params + ([mr] if mask_grad else []), cots)
        for g, w in zip(list(got) + list(got_g), list(want) + list(want_g)):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_cpu_tensors_launch_nothing():
    before = launch_counts()
    block = _block(_params(W))
    x = torch.randn(2, 5, W)
    fused_attn_half(x, block, None, HEADS)
    fused_resblock(x, block, causal_mask(5), HEADS)
    assert launch_counts() == before


@pytest.mark.parametrize("fn", ["attn_ln2", "attn_half"])
def test_bench_resblock_on_cpu(fn, capsys):
    line = bench_resblock.main(["--device", "cpu", "--batch", "2", "--seq", "9", "--width", "64",
                                "--heads", "4", "--iters", "2", "--repeats", "2", "--fn", fn])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert line["metric"] == f"fused_{fn}_ms_per_layer" and line["unit"] == "ms"
    assert (line["B"], line["S"], line["W"], line["device"]) == (2, 9, 64, "cpu")
    assert line["value"] > 0
