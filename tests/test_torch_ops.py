"""Each kernel module's plain version (what a CPU tensor takes) against its
JAX function, plus the TempMoE routing math.

The JAX side runs every Pallas function in interpret mode, as the
``tests/test_pallas_*.py`` files do. Inputs come from numpy seeds and the
parameters from the JAX initialisers, carried across with
``params_from_jax``. All in fp32 on the CPU; each tolerance is stated where
it is used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qa_tiger_tpu.models import modules as JM
from qa_tiger_tpu.models.clip_text import causal_mask as j_causal_mask
from qa_tiger_tpu.models.clip_text import resblock_init
from qa_tiger_tpu.ops import tempmoe as jt
from qa_tiger_tpu.ops.pallas.attention import attention_wide as j_attention_wide
from qa_tiger_tpu.ops.pallas.gaussian_moe import fused_gaussian_moe as j_moe
from qa_tiger_tpu.ops.pallas.patch_select import fused_patch_select as j_patch_select
from qa_tiger_tpu.ops.pallas.resblock import fused_attn_ln2 as j_attn_ln2
from qa_tiger_tpu_torch.convert import params_from_jax
from qa_tiger_tpu_torch.models.clip_text import ResidualAttentionBlock, causal_mask
from qa_tiger_tpu_torch.models.modules import PatchSelecter
from qa_tiger_tpu_torch.ops import attention_wide, fused_attn_ln2, fused_gaussian_moe
from qa_tiger_tpu_torch.ops import fused_patch_select, launch_counts
from qa_tiger_tpu_torch.ops import tempmoe as tt

# fp32 on both sides; the kernels' interpret mode and torch sum in other
# orders, which moves O(1) outputs by ~1e-6
TOL = dict(rtol=1e-5, atol=2e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _routing(rng, B, K, E, T):
    gauss_w = jax.nn.softmax(jnp.asarray(rng.standard_normal((B, K, T)), jnp.float32), -1)
    topk_inds = jnp.asarray(np.stack([rng.permutation(E)[:K] for _ in range(B)]), jnp.int32)
    topk_probs = jax.nn.softmax(jnp.asarray(rng.standard_normal((B, K)), jnp.float32), -1)
    return gauss_w, topk_inds, topk_probs


@pytest.mark.parametrize("gather_mode", ["reference", "paper"])
def test_fused_gaussian_moe(gather_mode):
    rng = np.random.default_rng(0)
    B, T, D, H, E, K = 3, 10, 64, 32, 5, 3
    f = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    w1t, b1, w2t, b2 = f(E, D, H), f(E, H), f(E, H, D), f(E, D)
    gauss_w, inds, probs = _routing(rng, B, K, E, T)
    j_w = jt.combined_expert_weights(gauss_w, inds, probs, E, gather_mode)
    t_w = tt.combined_expert_weights(_t(gauss_w), _t(inds).long(), _t(probs), E, gather_mode)
    _close(t_w, j_w)
    want = j_moe(*map(jnp.asarray, (x, w1t, b1, w2t, b2)), j_w, 2, True)
    got = fused_gaussian_moe(*map(torch.tensor, (x, w1t, b1, w2t, b2)), t_w)
    _close(got, want)


@pytest.mark.parametrize("sq,sk,masked,key_bias", [(12, 17, False, False), (9, 9, True, False),
                                                   (1, 11, False, False), (12, 17, False, True),
                                                   (9, 9, True, True)])
def test_attention_wide(sq, sk, masked, key_bias):
    """With ``key_bias`` (ToMe's proportional attention: the log of integer
    token sizes) against the JAX wrapper's key-bias kernels in interpret
    mode."""
    rng = np.random.default_rng(1)
    B, W, heads = 4, 64, 4
    q = rng.standard_normal((B, sq, W)).astype(np.float32)
    k = rng.standard_normal((B, sk, W)).astype(np.float32)
    v = rng.standard_normal((B, sk, W)).astype(np.float32)
    mask = np.triu(np.full((sq, sk), -np.inf, np.float32), 1) if masked else None
    kb = np.log(rng.integers(1, 40, (B, sk))).astype(np.float32) if key_bias else None
    want = j_attention_wide(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            None if mask is None else jnp.asarray(mask), 0.25, heads,
                            interpret=True, key_bias=None if kb is None else jnp.asarray(kb))
    got = attention_wide(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                         None if mask is None else torch.tensor(mask), 0.25, heads,
                         key_bias=None if kb is None else torch.tensor(kb))
    _close(got, want)


def _resblock_params(width, seed=0):
    p = resblock_init(jax.random.PRNGKey(seed), width)
    ks = jax.random.split(jax.random.PRNGKey(seed + 1), 4)
    p["attn"]["in_proj_weight"] = 0.05 * jax.random.normal(ks[0], (3 * width, width))
    p["attn"]["in_proj_bias"] = 0.01 * jnp.arange(3 * width, dtype=jnp.float32) / width
    p["attn"]["out_proj"]["weight"] = 0.05 * jax.random.normal(ks[1], (width, width))
    p["mlp"]["c_fc"]["weight"] = 0.05 * jax.random.normal(ks[2], (4 * width, width))
    p["mlp"]["c_proj"]["weight"] = 0.05 * jax.random.normal(ks[3], (width, 4 * width))
    p["ln_1"]["weight"] = 1.0 + 0.1 * jnp.sin(jnp.arange(width))
    p["ln_2"]["bias"] = 0.1 * jnp.cos(jnp.arange(width))
    return _np(p)


@pytest.mark.parametrize("causal", [True, False])
def test_fused_attn_ln2(causal):
    """The tiny test tower's block: W=128 (the Pallas kernel's lane rule),
    4 heads, S=13."""
    B, S, W, heads = 3, 13, 128, 4
    p = _resblock_params(W)
    block = ResidualAttentionBlock(W, 2, torch.Generator().manual_seed(0))
    block.load_state_dict(params_from_jax(p), strict=True)
    x = np.random.default_rng(2).standard_normal((B, S, W)).astype(np.float32)
    want_y, want_h = j_attn_ln2(jnp.asarray(x), p, j_causal_mask(S) if causal else None,
                                heads, True)
    got_y, got_h = fused_attn_ln2(torch.tensor(x), block, causal_mask(S) if causal else None,
                                  heads)
    _close(got_y, want_y)
    _close(got_h, want_h)


def test_fused_patch_select():
    B, T, P, D, heads = 2, 4, 14, 64, 8
    p = _np(JM.patch_selecter_init(jax.random.PRNGKey(3), D))
    mod = PatchSelecter(D, torch.Generator().manual_seed(0))
    mod.load_state_dict(params_from_jax(p), strict=True)
    rng = np.random.default_rng(3)
    patch = rng.standard_normal((B, T, P, D)).astype(np.float32)
    audio = rng.standard_normal((B, T, D)).astype(np.float32)
    video = rng.standard_normal((B, T, D)).astype(np.float32)
    want = j_patch_select(jnp.asarray(patch), jnp.asarray(audio), jnp.asarray(video), p,
                          heads, 4, True)
    got = fused_patch_select(torch.tensor(patch), torch.tensor(audio), torch.tensor(video),
                             mod, heads)
    for g, w in zip(got, want):
        _close(g, w)


def test_cpu_tensors_launch_nothing():
    before = launch_counts()
    x = torch.randn(2, 3, 8)
    attention_wide(x, x, x, None, 1.0, 2)
    assert launch_counts() == before


def test_gaussian_weights_and_topk():
    rng = np.random.default_rng(4)
    centers = rng.uniform(-0.2, 1.2, (3, 4)).astype(np.float32)
    widths = rng.uniform(0.0, 1.0, (3, 4)).astype(np.float32)
    _close(tt.gaussian_weights(torch.tensor(centers), torch.tensor(widths), 60, 9.0),
           jt.gaussian_weights(jnp.asarray(centers), jnp.asarray(widths), 60, 9.0))
    probs = jax.nn.softmax(jnp.asarray(rng.standard_normal((5, 7)), jnp.float32), -1)
    j_p, j_i = jt.topk_renormalized(probs, 3)
    t_p, t_i = tt.topk_renormalized(_t(probs), 3)
    _close(t_p, j_p)
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(j_i))


@pytest.mark.parametrize("gather_mode", ["reference", "paper"])
def test_experts_forward_and_aggregate(gather_mode):
    rng = np.random.default_rng(5)
    B, T, D, H, E, K = 3, 8, 16, 8, 5, 3
    f = lambda *s: (0.2 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    w1, b1, w2, b2 = f(E, H, D), f(E, H), f(E, D, H), f(E, D)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    j_out = jt.experts_forward(*map(jnp.asarray, (w1, b1, w2, b2, x)))
    t_out = tt.experts_forward(*map(torch.tensor, (w1, b1, w2, b2, x)))
    _close(t_out, j_out)
    gauss_w, inds, probs = _routing(rng, B, K, E, T)
    want = jt.gaussian_expert_aggregate(j_out, gauss_w, inds, probs, gather_mode)
    got = tt.gaussian_expert_aggregate(t_out, _t(gauss_w), _t(inds).long(), _t(probs),
                                       gather_mode)
    _close(got, want)
    # the folded weights reproduce the gather-and-sum exactly
    w_bet = tt.combined_expert_weights(_t(gauss_w), _t(inds).long(), _t(probs), E,
                                       gather_mode)
    folded = fused_gaussian_moe(torch.tensor(x), torch.tensor(w1).transpose(1, 2).contiguous(),
                                torch.tensor(b1), torch.tensor(w2).transpose(1, 2).contiguous(),
                                torch.tensor(b2), w_bet)
    _close(folded, want)
