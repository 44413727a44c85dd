"""The port's ToMe (``ops/tome.py``) against qa_tiger_tpu's, on the same
numpy inputs: merge in every mode, ``merge_wavg``, unmerge,
``merge_source`` (whose 0/1 provenance matrix equals JAX's only when the
matched indices are equal) and the kth variant. fp32 on the CPU; values to
1e-6 (both sides gather and add the same fp32 numbers, in orders that can
differ)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qa_tiger_tpu.ops import tome as jt
from qa_tiger_tpu_torch.ops import tome as tt

TOL = dict(rtol=1e-6, atol=1e-6)
CASES = [(20, 5, False), (21, 6, True), (577, 25, True), (27, 25, True)]


def _inputs(t, seed, channels=8):
    rng = np.random.default_rng(seed)
    metric = rng.standard_normal((2, t, 16), dtype=np.float32)
    x = rng.standard_normal((2, t, channels), dtype=np.float32)
    return metric, x


def _pair(metric, r, cls):
    return (tt.bipartite_soft_matching(torch.tensor(metric), r, class_token=cls),
            jt.bipartite_soft_matching(jnp.asarray(metric), r, class_token=cls))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("t,r,cls", CASES)
def test_merge_modes_and_source(t, r, cls):
    metric, x = _inputs(t, 0)
    (t_merge, _), (j_merge, _) = _pair(metric, r, cls)
    for mode in ("sum", "amax", "mean"):
        _close(t_merge(torch.tensor(x), mode=mode), j_merge(jnp.asarray(x), mode=mode))
    np.testing.assert_array_equal(tt.merge_source(t_merge, torch.tensor(x)).numpy(),
                                  np.asarray(jt.merge_source(j_merge, jnp.asarray(x))))
    idx = t_merge.indices
    assert idx["unm"].shape[1] + idx["src"].shape[1] == (t + 1) // 2
    if cls:  # the class token is never merged and stays first
        assert (idx["unm"][:, 0] == 0).all()


@pytest.mark.parametrize("t,r,cls", CASES)
def test_merge_wavg_and_unmerge(t, r, cls):
    metric, x = _inputs(t, 1)
    size = np.abs(np.random.default_rng(2).standard_normal((2, t, 1))).astype(np.float32) + 1
    (t_merge, t_unmerge), (j_merge, j_unmerge) = _pair(metric, r, cls)
    t_x, t_s = tt.merge_wavg(t_merge, torch.tensor(x), torch.tensor(size))
    j_x, j_s = jt.merge_wavg(j_merge, jnp.asarray(x), jnp.asarray(size))
    _close(t_x, j_x)
    _close(t_s, j_s)
    merged = j_merge(jnp.asarray(x), mode="sum")
    _close(t_unmerge(torch.tensor(np.asarray(merged))), j_unmerge(merged))


@pytest.mark.parametrize("t,k", [(20, 2), (21, 3), (16, 4)])
def test_kth_matching(t, k):
    metric, x = _inputs(t, 3)
    t_m, t_u = tt.kth_bipartite_soft_matching(torch.tensor(metric), k)
    j_m, j_u = jt.kth_bipartite_soft_matching(jnp.asarray(metric), k)
    for mode in ("sum", "amax", "mean"):
        _close(t_m(torch.tensor(x), mode=mode), j_m(jnp.asarray(x), mode=mode))
    merged = j_m(jnp.asarray(x), mode="sum")
    _close(t_u(torch.tensor(np.asarray(merged))), j_u(merged))


def test_random_matching_structure():
    """The permutation comes from a torch generator, so it is not JAX's:
    check the shapes, that unmerge fills every position, and that one
    generator seed gives one result."""
    metric, x = _inputs(12, 4)
    outs = []
    for _ in range(2):
        merge, unmerge = tt.random_bipartite_soft_matching(
            torch.tensor(metric), 4, generator=torch.Generator().manual_seed(3))
        merged = merge(torch.tensor(x), mode="sum")
        assert merged.shape == (2, 8, 8)
        back = unmerge(merged)
        assert back.shape == (2, 12, 8)
        assert (back != 0).any(dim=-1).all()
        outs.append(merged)
    assert torch.equal(outs[0], outs[1])


def test_schedule_parse_r_and_identity():
    plan = tt.tome_schedule(577, [25] * 23)
    assert plan == jt.tome_schedule(577, [25] * 23)
    assert plan[0] == (25, 552) and plan[-1][1] == 14
    for r in ([25] * 23, 25, (25, -1.0), (16, 0.5), 0):
        assert tt.parse_r(24, r) == jt.parse_r(24, r)
    x = torch.randn(2, 10, 4)
    for merge, unmerge in (tt.bipartite_soft_matching(x, 0),
                           tt.kth_bipartite_soft_matching(x, 1),
                           tt.random_bipartite_soft_matching(x, 0)):
        assert merge(x) is x and unmerge(x) is x


def test_ties_sort_stably():
    """Equal scores: the edge order keeps token order (JAX's stable
    argsort of -score) and the match is the first maximum."""
    metric = np.ones((1, 10, 4), np.float32)
    x = np.arange(10, dtype=np.float32).reshape(1, 10, 1)
    (t_merge, _), (j_merge, _) = _pair(metric, 3, True)
    _close(t_merge(torch.tensor(x), mode="sum"), j_merge(jnp.asarray(x), mode="sum"))
    assert t_merge.indices["src"].tolist() == [[1, 2, 3]]
    assert t_merge.indices["dst"].tolist() == [[0, 0, 0]]
