"""The port's nn layer (qa_tiger_tpu_torch.nn) against qa_tiger_tpu.nn.

Both sides get the same parameters (drawn by the JAX initialisers, carried
across with ``params_from_jax``) and the same numpy inputs, on the CPU in
fp32. Tolerance: rtol 1e-5, atol 1e-5 — the two run the same fp32
arithmetic and differ only in reduction order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qa_tiger_tpu import nn as jnn
from qa_tiger_tpu_torch.convert import params_from_jax
from qa_tiger_tpu_torch.nn import MultiheadAttention, layer_norm, linear, mha, mlp2, quick_gelu
from qa_tiger_tpu_torch.nn.core import MLP2

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_linear_and_layer_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    p = _np(jnn.linear_init(jax.random.PRNGKey(0), 24, 16))
    _close(linear(torch.tensor(x), torch.tensor(p["weight"]), torch.tensor(p["bias"])),
           jnn.linear(p, jnp.asarray(x)))
    ln = {"weight": 1 + 0.1 * rng.standard_normal(24).astype(np.float32),
          "bias": 0.1 * rng.standard_normal(24).astype(np.float32)}
    _close(layer_norm(torch.tensor(x), torch.tensor(ln["weight"]), torch.tensor(ln["bias"])),
           jnn.layer_norm(ln, jnp.asarray(x)))
    _close(quick_gelu(torch.tensor(x)), jnn.quick_gelu(jnp.asarray(x)))


def test_mlp2():
    x = np.random.default_rng(1).standard_normal((4, 32)).astype(np.float32)
    p = _np(jnn.mlp2_init(jax.random.PRNGKey(1), 32, 16, 32))
    m = MLP2(32, 16, 32, torch.Generator().manual_seed(0))
    m.load_state_dict(params_from_jax(p), strict=True)
    _close(mlp2(torch.tensor(x), m), jnn.mlp2(p, jnp.asarray(x)))


@pytest.mark.parametrize("branch", ["self", "kv_shared", "separate"])
@pytest.mark.parametrize("need_weights", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_mha_matches_jax(branch, need_weights, masked):
    D, heads, B, S = 32, 4, 2, 7
    rng = np.random.default_rng(2)
    p = _np(jnn.mha_init(jax.random.PRNGKey(3), D))
    # non-zero biases so that every slice of the packed projection counts
    p["in_proj_bias"] = 0.1 * rng.standard_normal(3 * D).astype(np.float32)
    p["out_proj"]["bias"] = 0.1 * rng.standard_normal(D).astype(np.float32)
    m = MultiheadAttention(D, torch.Generator().manual_seed(0))
    m.load_state_dict(params_from_jax(p), strict=True)

    q = rng.standard_normal((B, S, D)).astype(np.float32)
    k = rng.standard_normal((B, S, D)).astype(np.float32)
    v = rng.standard_normal((B, S, D)).astype(np.float32)
    mask = np.triu(np.full((S, S), -np.inf, np.float32), 1) if masked else None
    jq, tq = jnp.asarray(q), torch.tensor(q)
    if branch == "self":
        jargs, targs = (jq, jq, jq), (tq, tq, tq)
    elif branch == "kv_shared":
        jk, tk = jnp.asarray(k), torch.tensor(k)
        jargs, targs = (jq, jk, jk), (tq, tk, tk)
    else:
        jargs = (jq, jnp.asarray(k), jnp.asarray(v))
        targs = (tq, torch.tensor(k), torch.tensor(v))
    j_out, j_w = jnn.mha(p, *jargs, num_heads=heads, need_weights=need_weights,
                         attn_mask=None if mask is None else jnp.asarray(mask))
    t_out, t_w = mha(m, *targs, num_heads=heads, need_weights=need_weights,
                     attn_mask=None if mask is None else torch.tensor(mask))
    _close(t_out, j_out)
    if need_weights:
        assert t_w.shape == (B, S, S)
        _close(t_w, j_w)
    else:
        assert t_w is None and j_w is None


def test_mha_cross_lengths_sq1():
    """The Sq=1 query form of TempMoE and QstGrounding."""
    D, heads = 64, 8
    rng = np.random.default_rng(4)
    p = _np(jnn.mha_init(jax.random.PRNGKey(5), D))
    m = MultiheadAttention(D, torch.Generator().manual_seed(0))
    m.load_state_dict(params_from_jax(p), strict=True)
    q = rng.standard_normal((3, 1, D)).astype(np.float32)
    kv = rng.standard_normal((3, 9, D)).astype(np.float32)
    jkv = jnp.asarray(kv)
    j_out, _ = jnn.mha(p, jnp.asarray(q), jkv, jkv, num_heads=heads, need_weights=False)
    tkv = torch.tensor(kv)
    t_out, _ = mha(m, torch.tensor(q), tkv, tkv, num_heads=heads, need_weights=False)
    _close(t_out, j_out)
