"""Top-K routing on tied router probabilities: the port against JAX.

``jax.lax.top_k`` orders equal values by index, lower first. The port's
``topk_renormalized`` must pick the same experts in the same slots: slot j's
expert is weighted by Gaussian j, so a different order is a different
output, and at the k-th edge a different choice is a different set. Router
probabilities held in bf16 tie easily.

The module cases give the router a zero weight and a bias of log
probabilities, so every row's router probabilities are the same tied
values on both sides (equal inputs to one softmax give equal outputs).
CPU, fp32; tolerance rtol 1e-5 / atol 1e-5 (reduction order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qa_tiger_tpu.models import modules as JM
from qa_tiger_tpu.ops import tempmoe as jt
from qa_tiger_tpu_torch.convert import params_from_jax
from qa_tiger_tpu_torch.models.modules import TempMoE
from qa_tiger_tpu_torch.ops import tempmoe as tt

TIED_ROWS = {
    "halves_and_eighths": [0.25, 0.25, 0.125, 0.125, 0.125, 0.0625, 0.0625],
    "three_way_twice": [0.1, 0.2, 0.2, 0.1, 0.2, 0.1, 0.1],
    "all_equal": [1.0 / 7] * 7,
    "tie_at_kth_edge": [0.3, 0.2, 0.1, 0.1, 0.1, 0.1, 0.1],
}


@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("row", sorted(TIED_ROWS))
def test_topk_ties_match_lax_top_k(row, k):
    probs = np.asarray(TIED_ROWS[row], np.float32)[None].repeat(2, axis=0)
    j_p, j_i = jt.topk_renormalized(jnp.asarray(probs), k)
    t_p, t_i = tt.topk_renormalized(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(j_i))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(j_p), rtol=1e-6, atol=0)


@pytest.mark.parametrize("topk", [3, 7])
@pytest.mark.parametrize("row", ["halves_and_eighths", "three_way_twice"])
@pytest.mark.parametrize("gather_mode", ["reference", "paper"])
def test_tempmoe_with_tied_router_matches_jax(gather_mode, row, topk):
    """The whole aggregator (question attention, router, Gaussians, the
    expert gather and sum, the per-stream LayerNorms) with tied router
    probabilities, visual branch (two streams) against the JAX module."""
    D, E, B, T = 32, 7, 3, 6
    rng = np.random.default_rng(12)
    params = jax.tree_util.tree_map(
        np.asarray, JM.temp_moe_init(jax.random.PRNGKey(2), D, E, vis_branch=True))
    params["router"]["0"]["weight"] = np.zeros((E, D), np.float32)
    params["router"]["0"]["bias"] = np.log(np.asarray(TIED_ROWS[row], np.float32))
    qst, data = rng.standard_normal((B, D)), rng.standard_normal((B, T, D))
    sub = [rng.standard_normal((B, T, D)) for _ in range(2)]
    qst, data, *sub = (a.astype(np.float32) for a in (qst, data, *sub))

    want = JM.temp_moe(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(qst),
                       jnp.asarray(data), [jnp.asarray(s) for s in sub], nhead=8, topK=topk,
                       n_experts=E, gather_mode=gather_mode)
    mod = TempMoE(D, E, torch.Generator().manual_seed(0), vis_branch=True)
    mod.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(qst), torch.from_numpy(data),
                  [torch.from_numpy(s) for s in sub], nhead=8, topK=topk,
                  gather_mode=gather_mode)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
