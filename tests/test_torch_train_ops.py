"""The port's train-mode operations against the JAX package, on the CPU.

``fused_avq_train`` and ``fused_patch_select_train`` (their plain versions
here: a CPU tensor takes them) are held to JAX's ``fused_*_train`` in
interpret mode through ``jax.vjp``, and to JAX's masked oracles
(``avq_sub_forward_masked``, ``patch_selecter_jnp(masks=)``) at ragged
shapes: the forward, every input gradient and every parameter gradient. The
dropout masks come from JAX's samplers and enter both sides unchanged. The
four slice-1 wrappers' gradients are held to ``jax.vjp`` of their JAX
counterparts, and the autograd Function that gives them a gradient on the
card is run here with the plain version standing in for the kernel.

All fp32. Tolerance rtol 1e-4 / atol 1e-5: the two frameworks sum in other
orders, which moves gradients summed over every row by ~1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qa_tiger_tpu.models import modules as JM
from qa_tiger_tpu.models.clip_text import causal_mask as j_causal_mask
from qa_tiger_tpu.ops.pallas.attention import attention_wide as j_attention_wide
from qa_tiger_tpu.ops.pallas.avq import fused_avq_train as j_avq_train
from qa_tiger_tpu.ops.pallas.gaussian_moe import fused_gaussian_moe as j_moe
from qa_tiger_tpu.ops.pallas.patch_select import fused_patch_select as j_patch_select
from qa_tiger_tpu.ops.pallas.patch_select import fused_patch_select_train as j_ps_train
from qa_tiger_tpu.ops.pallas.resblock import fused_attn_ln2 as j_attn_ln2
from qa_tiger_tpu_torch.convert import nested_to_flat, params_from_jax
from qa_tiger_tpu_torch.models.clip_text import ResidualAttentionBlock, causal_mask
from qa_tiger_tpu_torch.models.modules import (
    AVQCrossAttn,
    PatchSelecter,
    make_avq_dropout_masks,
    make_patch_dropout_masks,
)
from qa_tiger_tpu_torch.ops import _grad, launch_counts
from qa_tiger_tpu_torch.ops import attention as A
from qa_tiger_tpu_torch.ops import gaussian_moe as G
from qa_tiger_tpu_torch.ops import patch_select as PS
from qa_tiger_tpu_torch.ops import resblock as R
from qa_tiger_tpu_torch.ops.avq import fused_avq_train
from qa_tiger_tpu_torch.ops.patch_select import fused_patch_select_train

TOL = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=msg, **TOL)


def _param_grads_close(names, torch_grads, jax_tree):
    """Each named gradient against the JAX tree's; names the op does not
    read (the tower block's MLP half) have zero gradients there."""
    want = nested_to_flat(_np(jax_tree))
    assert set(names) <= set(want)
    for name, got in zip(names, torch_grads):
        _close(got, want[name], name)
    for name in set(want) - set(names):
        assert not np.asarray(want[name]).any(), name


def _avq_setup(N, T, S, D, heads, seed):
    rng = np.random.default_rng(seed)
    params = _np(JM.avq_cross_attn_init(jax.random.PRNGKey(seed), D))
    src, val = (rng.standard_normal((N, T, D)).astype(np.float32) for _ in range(2))
    wrd = rng.standard_normal((N, S, D)).astype(np.float32)
    g = rng.standard_normal((N, T, D)).astype(np.float32)
    masks = _np(JM.make_avq_dropout_masks(jax.random.PRNGKey(seed + 1), N, T, S, D,
                                          nhead=heads, dropout_p=0.1))
    module = AVQCrossAttn(D, torch.Generator().manual_seed(0))
    module.load_state_dict(params_from_jax(params), strict=True)
    return params, src, val, wrd, g, masks, module


@pytest.mark.parametrize("oracle,N,T,S", [("interpret", 5, 6, 9), ("masked_jnp", 5, 6, 9),
                                          ("masked_jnp", 3, 7, 5)])
def test_fused_avq_train_forward_and_grads(oracle, N, T, S):
    D, heads = 32, 4
    params, src, val, wrd, g, masks, module = _avq_setup(N, T, S, D, heads, seed=N + T)
    if oracle == "interpret":
        def fn(s, v, q, p):
            return j_avq_train(s, v, q, p, masks, heads, 2, True)
    else:
        def fn(s, v, q, p):
            return JM.avq_sub_forward_masked(p, s, v, q, masks, nhead=heads)
    want, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (src, val, wrd)),
                        jax.tree_util.tree_map(jnp.asarray, params))
    j_gsrc, j_gval, j_gwrd, j_gp = vjp(jnp.asarray(g))

    ins = [_t(src, True), _t(val, True), _t(wrd, True)]
    t_masks = {k: _t(v) for k, v in masks.items()}
    got = fused_avq_train(*ins, module, t_masks, heads)
    _close(got, want, "out")
    grads = torch.autograd.grad(got, ins + list(module.parameters()), _t(g))
    for gt, wt, name in zip(grads[:3], (j_gsrc, j_gval, j_gwrd), ("src", "val", "wrd")):
        _close(gt, wt, name)
    _param_grads_close([n for n, _ in module.named_parameters()], grads[3:], j_gp)


def _ps_setup(B, T, D, heads, seed, P=14):
    rng = np.random.default_rng(seed)
    params = _np(JM.patch_selecter_init(jax.random.PRNGKey(seed), D))
    patch = rng.standard_normal((B, T, P, D)).astype(np.float32)
    audio, video, ga, gv = (rng.standard_normal((B, T, D)).astype(np.float32) for _ in range(4))
    masks = _np(JM.make_patch_dropout_masks(jax.random.PRNGKey(seed + 1), B * T, P, D,
                                            nhead=heads, dropout_p=0.1))
    module = PatchSelecter(D, torch.Generator().manual_seed(0))
    module.load_state_dict(params_from_jax(params), strict=True)
    return params, patch, audio, video, ga, gv, masks, module


@pytest.mark.parametrize("oracle,B,T", [("interpret", 2, 3), ("masked_jnp", 2, 3),
                                        ("masked_jnp", 1, 5)])
def test_fused_patch_select_train_forward_and_grads(oracle, B, T):
    D, heads = 32, 4
    params, patch, audio, video, ga, gv, masks, module = _ps_setup(B, T, D, heads, seed=B + T)
    if oracle == "interpret":
        def fn(pt, au, vi, p):
            return tuple(j_ps_train(pt, au, vi, p, masks, heads, 4, True))
    else:
        def fn(pt, au, vi, p):
            return tuple(JM.patch_selecter_jnp(p, pt, au, vi, nhead=heads, masks=masks))
    want, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (patch, audio, video)),
                        jax.tree_util.tree_map(jnp.asarray, params))
    j_gpatch, j_gaudio, j_gvideo, j_gp = vjp((jnp.asarray(ga), jnp.asarray(gv)))

    ins = [_t(patch, True), _t(audio, True), _t(video, True)]
    t_masks = {k: _t(v) for k, v in masks.items()}
    got_a, got_v = fused_patch_select_train(*ins, module, t_masks, heads)
    _close(got_a, want[0], "a")
    _close(got_v, want[1], "v")
    grads = torch.autograd.grad((got_a, got_v), ins + list(module.parameters()),
                                (_t(ga), _t(gv)))
    for gt, wt, name in zip(grads[:3], (j_gpatch, j_gaudio, j_gvideo),
                            ("patch", "audio", "video")):
        _close(gt, wt, name)
    _param_grads_close([n for n, _ in module.named_parameters()], grads[3:], j_gp)


# ---------------------------------------------------------------------------
# the slice-1 wrappers' gradients
# ---------------------------------------------------------------------------

def _attention_case(rng):
    B, sq, sk, W, heads = 3, 5, 7, 32, 4
    q, k, v = (rng.standard_normal((B, s, W)).astype(np.float32) for s in (sq, sk, sk))
    mask = np.triu(np.full((sq, sk), -np.inf, np.float32), 3)
    g = rng.standard_normal((B, sq, W)).astype(np.float32)

    def j_fn(q, k, v):
        return j_attention_wide(q, k, v, jnp.asarray(mask), 0.3, heads, interpret=True)

    def t_fn(q, k, v):
        return A.attention_wide(q, k, v, torch.tensor(mask), 0.3, heads)

    return [q, k, v], {}, j_fn, t_fn, [g], []


def _attn_ln2_case(rng):
    from qa_tiger_tpu.models.clip_text import resblock_init

    B, S, W, heads = 2, 9, 128, 4
    p = _np(resblock_init(jax.random.PRNGKey(1), W))
    block = ResidualAttentionBlock(W, 2, torch.Generator().manual_seed(0))
    block.load_state_dict(params_from_jax(p), strict=True)
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    gy, gh = (rng.standard_normal((B, S, W)).astype(np.float32) for _ in range(2))

    def j_fn(x, prm):
        return j_attn_ln2(x, prm, j_causal_mask(S), heads, True)

    def t_fn(x):
        return R.fused_attn_ln2(x, block, causal_mask(S), heads)

    used = [(n, t) for n, t in block.named_parameters() if not n.startswith("mlp")]
    return [x], p, j_fn, t_fn, [gy, gh], used


def _patch_select_case(rng):
    B, T, P, D, heads = 2, 3, 14, 32, 4
    p = _np(JM.patch_selecter_init(jax.random.PRNGKey(2), D))
    mod = PatchSelecter(D, torch.Generator().manual_seed(0))
    mod.load_state_dict(params_from_jax(p), strict=True)
    patch = rng.standard_normal((B, T, P, D)).astype(np.float32)
    audio, video, ga, gv = (rng.standard_normal((B, T, D)).astype(np.float32) for _ in range(4))

    def j_fn(patch, audio, video, prm):
        return tuple(j_patch_select(patch, audio, video, prm, heads, 4, True))

    def t_fn(patch, audio, video):
        return PS.fused_patch_select(patch, audio, video, mod, heads)

    return [patch, audio, video], p, j_fn, t_fn, [ga, gv], list(mod.named_parameters())


def _moe_case(rng):
    B, T, D, H, E = 3, 6, 16, 8, 4
    f = lambda *s: (0.3 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    arrs = [rng.standard_normal((B, T, D)).astype(np.float32), f(E, D, H), f(E, H), f(E, H, D),
            f(E, D), np.abs(f(B, E, T))]
    g = rng.standard_normal((B, D)).astype(np.float32)

    def j_fn(*a):
        return j_moe(*a, 2, True)

    return arrs, {}, j_fn, G.fused_gaussian_moe, [g], []


@pytest.mark.parametrize("case", [_attention_case, _attn_ln2_case, _patch_select_case,
                                  _moe_case], ids=["attention_wide", "fused_attn_ln2",
                                                   "fused_patch_select", "fused_gaussian_moe"])
def test_slice1_wrapper_gradients_match_jax(case):
    arrays, params, j_fn, t_fn, cots, named = case(np.random.default_rng(3))
    j_args = [jnp.asarray(a) for a in arrays]
    if params:
        j_args.append(jax.tree_util.tree_map(jnp.asarray, params))
    want, vjp = jax.vjp(j_fn, *j_args)
    j_grads = vjp(tuple(jnp.asarray(c) for c in cots) if len(cots) > 1 else jnp.asarray(cots[0]))

    ins = [_t(a, True) for a in arrays]
    got = t_fn(*ins)
    got = [got] if torch.is_tensor(got) else list(got)
    want = [want] if not isinstance(want, tuple) else list(want)
    for gt, wt in zip(got, want):
        _close(gt, wt, "out")
    grads = torch.autograd.grad(got, ins + [t for _, t in named], [_t(c) for c in cots])
    for i, gt in enumerate(grads[:len(ins)]):
        _close(gt, j_grads[i], f"input {i}")
    if named:
        _param_grads_close([n for n, _ in named], grads[len(ins):], j_grads[-1])


def test_plain_grad_function_returns_the_plain_gradient():
    """The Function that gives a kernel the plain version's gradient on the
    card, run with the plain version in the kernel's place: its gradients
    equal autograd's through the plain version, constants get none, and an
    input that needs no gradient gets None."""
    rng = np.random.default_rng(4)
    q, k, v = (_t(rng.standard_normal((2, 5, 16)).astype(np.float32), True) for _ in range(3))
    v_const = v.detach()
    mask = torch.tensor(np.triu(np.full((5, 5), -np.inf, np.float32), 1))
    consts = dict(mask=mask, scale=0.25, heads=4)
    out = _grad.KernelWithPlainGrad.apply(A._wide_reference, A._wide_reference, consts,
                                          q, k, v_const)
    ref = A._wide_reference(q, k, v_const, **consts)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(out, (q, k), cot)
    want = torch.autograd.grad(ref, (q, k), cot)
    for gt, wt in zip(got, want):
        torch.testing.assert_close(gt, wt, rtol=0, atol=0)
    assert out.grad_fn is not None


# ---------------------------------------------------------------------------
# the mask samplers and the train routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_avq_mask_sampler(dtype):
    N, T, S, D, heads, p = 4, 6, 9, 32, 4, 0.25
    masks = make_avq_dropout_masks(torch.Generator().manual_seed(5), N, T, S, D, nhead=heads,
                                   dropout_p=p, dtype=dtype)
    j_masks = JM.make_avq_dropout_masks(jax.random.PRNGKey(0), N, T, S, D, nhead=heads,
                                        dropout_p=p)
    assert list(masks) == list(j_masks)
    scale = torch.tensor(1.0 / (1.0 - p), dtype=dtype).item()
    for key, m in masks.items():
        assert tuple(m.shape) == tuple(j_masks[key].shape) and m.dtype == dtype, key
        assert set(torch.unique(m.float()).tolist()) <= {0.0, scale}, key
    for key, sk in (("qst", S), ("slf", T), ("crs", T)):
        assert masks[key].shape[1] == 128 and not masks[key][:, heads * sk:].any()
        kept = (masks[key][:, :heads * sk] > 0).float().mean().item()
        assert abs(kept - (1 - p)) < 0.1, (key, kept)
    again = make_avq_dropout_masks(torch.Generator().manual_seed(5), N, T, S, D, nhead=heads,
                                   dropout_p=p, dtype=dtype)
    other = make_avq_dropout_masks(torch.Generator().manual_seed(6), N, T, S, D, nhead=heads,
                                   dropout_p=p, dtype=dtype)
    assert all(torch.equal(masks[k], again[k]) for k in masks)
    assert not all(torch.equal(masks[k], other[k]) for k in masks)


def test_patch_mask_sampler():
    BT, P, D, heads, p = 6, 14, 32, 8, 0.1
    masks = make_patch_dropout_masks(torch.Generator().manual_seed(7), BT, P, D, nhead=heads,
                                     dropout_p=p)
    j_masks = JM.make_patch_dropout_masks(jax.random.PRNGKey(0), BT, P, D, nhead=heads,
                                          dropout_p=p)
    assert list(masks) == list(j_masks)
    for key, m in masks.items():
        assert tuple(m.shape) == tuple(j_masks[key].shape), key
        assert set(torch.unique(m).tolist()) <= {0.0, torch.tensor(1.0 / (1.0 - p)).item()}, key
    for key in ("slf", "crs_v", "crs_a"):
        assert masks[key].shape[1] == 128 and not masks[key][:, heads * P:].any()
    again = make_patch_dropout_masks(torch.Generator().manual_seed(7), BT, P, D, nhead=heads,
                                     dropout_p=p)
    assert all(torch.equal(masks[k], again[k]) for k in masks)


def test_modules_route_dropout_through_the_train_ops():
    """With a generator and p > 0 AVQCrossAttn and PatchSelecter sample
    their masks from it and run the train ops; the result equals the train
    op fed masks from an identically seeded generator. Without a generator
    they compute the eval function, and a CPU tensor launches nothing."""
    D, heads, B, T, S, P = 32, 4, 2, 5, 7, 14
    g0 = torch.Generator().manual_seed(0)
    avq, ps = AVQCrossAttn(D, g0), PatchSelecter(D, g0)
    rng = np.random.default_rng(8)
    a, v = (torch.tensor(rng.standard_normal((B, T, D)).astype(np.float32)) for _ in range(2))
    words = torch.tensor(rng.standard_normal((B, S, D)).astype(np.float32))
    patch = torch.tensor(rng.standard_normal((B, T, P, D)).astype(np.float32))
    before = launch_counts()

    out = avq(a, v, words, nhead=heads, dropout_p=0.1, generator=torch.Generator().manual_seed(1))
    masks = make_avq_dropout_masks(torch.Generator().manual_seed(1), 2 * B, T, S, D, nhead=heads,
                                   dropout_p=0.1)
    want = fused_avq_train(torch.cat([a, v]), torch.cat([v, a]), torch.cat([words, words]), avq,
                           masks, heads)
    torch.testing.assert_close(torch.cat(out), want, rtol=0, atol=0)
    eval_out = avq(a, v, words, nhead=heads)
    assert not torch.allclose(torch.cat(eval_out), want)
    assert torch.equal(torch.cat(avq(a, v, words, nhead=heads, dropout_p=0.1)),
                       torch.cat(eval_out))

    out = ps(patch, a, v, nhead=heads, dropout_p=0.1, generator=torch.Generator().manual_seed(2))
    pmasks = make_patch_dropout_masks(torch.Generator().manual_seed(2), B * T, P, D, nhead=heads,
                                      dropout_p=0.1)
    want = fused_patch_select_train(patch, a, v, ps, pmasks, heads)
    for gt, wt in zip(out, want):
        torch.testing.assert_close(gt, wt, rtol=0, atol=0)
    assert launch_counts() == before
