"""TSPM under a data x model grid and the model-axis step window, on the CPU.

(a) the spec table: ``tp_spec`` over TSPM's whole tree (configs/tspm/vitl14.py)
    against JAX ``_spec_for`` at tp 2 and 4: equal but for the head-aligned
    ``in_proj_*`` (QKV: for one head, each rank's lanes of q, k and v);
    ``qst_query_linear1/2`` stay whole on both sides;
(b) the two stages of one-head attention split by lanes
    (``attention_wide_tp_scores`` / ``attention_wide_tp_pv``), their plain
    versions on the ranks' lanes in turn, the partial scores summed in rank
    order, against ``attention_wide``'s plain version on the whole head, at
    tp 2 and 4, fp32 and bf16, with and without a mask; fp32 also the q, k
    and v gradients; the stages' route names and lane padding; a bf16 head
    on the plain branch (a ``prob_mask``, ``need_weights``) rounding q·scale
    in bf16 as one rank and JAX's ``mha`` do;
(c) each TSPM block's tensor-parallel form (the ranks simulated as threads,
    ``tests/torch_tp.py``) at tp 2 and 4: without dropout against the JAX
    block on the same numpy inputs, with dropout (the whole realization
    from one seed) against the unsharded port block, forward and backward:
    outputs within rtol 1e-5 / atol 2e-6 (TP_TOL), every input and
    parameter gradient gathered within 1e-5 of its own largest element,
    replicated parameters' gradients bitwise equal on the ranks; the
    ``need_weights`` weights and the top-K frames bitwise equal on every
    rank and equal to one process's;
(d) spawned gloo ranks (``tests/torch_dp.py``): dp1 x tp2 against one
    process with dropout on (three ``train_step`` calls, the resumes across
    grids), and dp2 x tp2 ``_run_eval`` and ``train_epoch`` against JAX's
    ``AVQARunner`` on ``make_mesh(4, model_parallel=2)`` with dropout off,
    at the tolerances of ``test_torch_tensor_parallel_mesh.py``;
(e) ``steps_per_dispatch`` 2 under dp1 x tp2 gloo ranks: ``train_epoch``
    bitwise the K = 1 epoch (losses, parameters, Adam's moments, the dropout
    stream), and a ``StepGraph`` that would capture under gloo raises,
    naming it (QA-TIGER's case: ``test_torch_tensor_parallel_train.py``).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp
import torch_tp
from qa_tiger_tpu.data import AVQADataset as JDataset
from qa_tiger_tpu.data import BatchLoader as JBatchLoader
from qa_tiger_tpu.models import tspm as J
from qa_tiger_tpu.nn.attention import mha as j_mha
from qa_tiger_tpu.parallel import make_mesh
from qa_tiger_tpu.parallel.mesh import _spec_for
from qa_tiger_tpu.training.loop import AVQARunner as JAXRunner
from qa_tiger_tpu.utils import Box as JBox
from qa_tiger_tpu_torch.convert import nested_to_flat, params_from_jax
from qa_tiger_tpu_torch.models import TSPM
from qa_tiger_tpu_torch.models import tspm as P
from qa_tiger_tpu_torch.nn import attention as nn_attention
from qa_tiger_tpu_torch.nn.attention import MultiheadAttention, _project, mha
from qa_tiger_tpu_torch.nn.core import attend
from qa_tiger_tpu_torch.ops import attention as A
from qa_tiger_tpu_torch.parallel import tp_spec
from qa_tiger_tpu_torch.parallel.tensor import QKV, QKV_VEC, merge_shards
from qa_tiger_tpu_torch.training import AVQARunner
from qa_tiger_tpu_torch.utils import Box
from torch_corpus import val_questions, write_corpus

SMALL = dict(topK=3, audio_dim=16, vis_dim=24, patch_dim=20, qst_dim=12, hidden_size=32,
             num_labels=42)
# fp32: the split only reorders sums; the blocks end in a LayerNorm whose
# 1/std scales that reordering (test_torch_tensor_parallel.py)
TP_TOL = dict(rtol=1e-5, atol=2e-6)
GRAD_TOL = 1e-5  # of each gradient's largest element
LR = 1e-3
DP = 0.1
T, N = 8, 5
DIMS = {"vggish": (12, 16), "clip": (12, 24), "tome": (12, 4, 20)}
SPLITS = {"train": (0, 19), "val": (19, 35), "test": (35, 52)}


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _walk(value, path + (key,))
    else:
        yield path, tree


def _close_grad(got, want, what):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= GRAD_TOL * scale, f"{what}: {err:.3e} of {scale:.3e}"


def jax_params(seed=0):
    """TSPM's JAX parameters with every leaf moved off its init value, so
    each name (the LayerNorms' ones, the zero biases) is exercised."""
    params = J.tspm_init(jax.random.PRNGKey(seed), J.tspm_config(**SMALL))
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a))).astype(np.float32),
        params)


def port_model(params):
    model = TSPM(P.tspm_config(**SMALL), seed=2)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


# ---------------------------------------------------------------------------
# (a) the spec table


@pytest.mark.parametrize("tp", [2, 4])
def test_spec_table_against_jax(tp):
    shapes = jax.eval_shape(lambda key: J.tspm_init(key, J.tspm_config()), jax.random.PRNGKey(0))
    differs, count, split = {}, 0, 0
    for path, leaf in _walk(shapes):
        name = ".".join(path)
        want = tuple(_spec_for(path, leaf, tp))
        got = tp_spec(name, leaf.shape, tp)
        count += 1
        split += bool(got)
        if got != want:
            differs[name] = (got, want)
    # six attentions, each a packed projection split by lanes of q, k, v
    assert len(differs) == 2 * 6
    for name, (got, want) in differs.items():
        assert name.endswith(("in_proj_weight", "in_proj_bias")), name
        assert got == (QKV if name.endswith("weight") else QKV_VEC), name
        assert want == (("model", None) if name.endswith("weight") else ("model",)), name
    for name in ("AV_Attn.layers.0.linear1.weight", "SpatioPerception.TokensAttn.linear1.bias"):
        assert tp_spec(name, dict(_walk(shapes))[tuple(name.split("."))].shape, tp)
    for name in ("QstTempGrd_Module.qst_query_linear1.weight", "input_a.weight",
                 "av_fusion_fc.weight", "SpatioPerception.TokensAttn.norm1.weight"):
        assert not tp_spec(name, dict(_walk(shapes))[tuple(name.split("."))].shape, tp)
    # in_proj x 12, out_proj.weight x 6, two FFNs' linear1 (weight, bias)
    # and linear2.weight
    assert split == 12 + 6 + 2 * 3 and count == 76


def test_check_model_parallel():
    model = TSPM(P.tspm_config())
    for tp in (1, 2, 4):
        model.check_model_parallel(tp)
    for tp in (3, 8):
        with pytest.raises(ValueError, match=f"model_parallel={tp}"):
            model.check_model_parallel(tp)


# ---------------------------------------------------------------------------
# (b) the stages of one-head attention split by lanes


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", [2, 4])
def test_stage_plains_sum_to_attention_wide(tp, dtype, masked):
    rng = np.random.default_rng(tp)
    B, Sq, Sk, W = 3, 7, 9, 64
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, s, W), dtype=np.float32)).to(dt)
               .requires_grad_(dtype == "float32") for s in (Sq, Sk, Sk))
    mask = (torch.from_numpy(np.triu(np.full((Sq, Sk), -1e9, np.float32), 3))
            if masked else None)
    scale = W ** -0.5
    want = A._wide_reference(q, k, v, mask, scale, 1)
    lanes = [slice(r * W // tp, (r + 1) * W // tp) for r in range(tp)]
    parts = [A.attention_wide_tp_scores(q[..., c], k[..., c]) for c in lanes]
    assert all(p.dtype == torch.float32 and p.shape == (B, Sq, Sk) for p in parts)
    scores = torch_tp.sum_in_rank_order(parts)
    ctx = torch.cat([A.attention_wide_tp_pv(scores, v[..., c], mask, scale) for c in lanes], -1)
    assert ctx.dtype == dt
    if dtype == "bfloat16":  # p and the context round to bf16
        np.testing.assert_allclose(ctx.float().numpy(), want.float().numpy(), rtol=2e-2,
                                   atol=2e-2)
        return
    np.testing.assert_allclose(ctx.detach().numpy(), want.detach().numpy(), **TP_TOL)
    cot = torch.from_numpy(rng.standard_normal((B, Sq, W), dtype=np.float32))
    for got, w, name in zip(torch.autograd.grad(ctx, (q, k, v), cot),
                            torch.autograd.grad(want, (q, k, v), cot), "qkv"):
        _close_grad(got, w, name)


@pytest.mark.parametrize("dtype,sq,sk,route", [
    (torch.bfloat16, 60, 60, "mma"), (torch.bfloat16, 14, 14, "mma_short"),
    (torch.bfloat16, 16, 17, "mma"), (torch.bfloat16, 1, 16, "mma_short"),
    (torch.float32, 60, 60, "tf32x3"), (torch.float32, 14, 14, "tf32x3_short"),
    (torch.float32, 17, 16, "tf32x3"), (torch.float32, 16, 1, "tf32x3_short"),
    (torch.float32, 1, 129, "tf32x3")])
def test_lane_split_routes(dtype, sq, sk, route):
    """The lane split's stages name their kernel family by dtype and shape
    class: a warp per problem at most TP_SHORT_MAX queries and keys, else 64
    query rows a block; bf16 on mma.sync, fp32 on 3xTF32."""
    assert A.tp_scores_route(dtype, sq, sk) == route


def test_lane_split_short_limit_is_the_kernels():
    """TP_SHORT_MAX is csrc/attention_tp.cuh's TP_SHORT (ATT_SHORT_MAX)."""
    csrc = Path(A.__file__).resolve().parents[1] / "csrc"
    tp = (csrc / "attention_tp.cuh").read_text()
    common = (csrc / "common.cuh").read_text()
    assert re.search(r"TP_SHORT = ATT_SHORT_MAX\b", tp)
    limit = re.search(r"ATT_SHORT_MAX = (\d+)", common)
    assert limit and int(limit.group(1)) == A.TP_SHORT_MAX


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lane_slabs_pad_and_copy(dtype):
    """What the lane-split kernels read: lanes zero-padded to whole 128-byte
    slabs (32 fp32, 64 bf16), a copy of a view off 16 bytes, a view on whole
    16 bytes as it is."""
    dt = getattr(torch, dtype)
    slab = 128 // torch.tensor([], dtype=dt).element_size()
    buf = torch.randn(2, 5, 3 * slab + 1, generator=torch.Generator().manual_seed(0)).to(dt)
    padded = A._lane_slabs(buf[..., :40])
    assert padded.shape[-1] == -(-40 // slab) * slab
    assert torch.equal(padded[..., :40], buf[..., :40]) and not padded[..., 40:].any()
    odd = A._lane_slabs(buf[..., 1:1 + slab])
    assert odd.is_contiguous() and torch.equal(odd, buf[..., 1:1 + slab])
    whole = torch.randn(2, 5, 2 * slab).to(dt)
    assert A._lane_slabs(whole[..., slab:]).data_ptr() == whole[..., slab:].data_ptr()


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at each element of ``x`` (8 bits of
    mantissa), the smallest normal's spacing near 0."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


# JAX's bf16 projections round twice (the product, then + bias) where the
# port's round once, so q, k and v may differ by a bf16 ulp here and there;
# through the softmax that moves the weights and the output by an ulp or
# two of their largest element
JAX_BF16_ULPS = 2


@pytest.mark.parametrize("case", ["prob_mask", "need_weights"])
@pytest.mark.parametrize("tp", [2, 4])
def test_bf16_one_head_plain_split_rounds_q_scale_as_one_rank(tp, case):
    """One bf16 head split by lanes on the plain branch (a ``prob_mask`` or
    ``need_weights``): each rank rounds q·scale in bf16 before its partial,
    as one rank's ``attend`` and JAX's ``mha`` do. The fp32 probabilities
    equal one rank's within fp32 summation order (atol 1e-6), the context
    (``out_proj`` the identity, so the output is the context) within 1 bf16
    ulp of each element; against JAX's ``mha`` the weights and the output
    within JAX_BF16_ULPS bf16 ulps of their largest element."""
    rng = np.random.default_rng(40 + tp)
    B, Sq, Sk, D = 3, 9, 11, 48  # a scale of 1/sqrt(48): q·scale rounds in bf16
    holder = torch.nn.Module()
    holder.attn = MultiheadAttention(D, torch.Generator().manual_seed(tp))
    with torch.no_grad():
        holder.attn.in_proj_bias.copy_(torch.from_numpy(0.1 * _rn(rng, 3 * D)))
        holder.attn.out_proj.weight.copy_(torch.eye(D))
    holder = holder.to(torch.bfloat16).requires_grad_(False)
    q = torch.from_numpy(_rn(rng, B, Sq, D)).bfloat16()
    kv = torch.from_numpy(_rn(rng, B, Sk, D)).bfloat16()
    mask = torch.from_numpy(np.triu(np.full((Sq, Sk), -1e9, np.float32), 4))
    keep = (rng.random((B, 1, Sq, Sk)) >= DP) / (1.0 - DP)
    prob_mask = torch.from_numpy(keep.astype(np.float32)) if case == "prob_mask" else None
    kw = dict(num_heads=1, attn_mask=mask, need_weights=case == "need_weights",
              prob_mask=prob_mask)
    seen = []

    def recorded(*args):
        seen.append(A.tp_probs(*args))
        return seen[-1]

    want, want_w = mha(holder.attn, q, kv, kv, **kw)
    _, want_p = attend(*_project(holder.attn, q, kv, kv, D), 1, attn_mask=mask)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn_attention, "tp_probs", recorded)
        ranks = torch_tp.run_ranks(tp, lambda grid: mha(
            torch_tp.sharded(holder, grid).attn, q, kv, kv, grid=grid, **kw))
    assert len(seen) == tp and all(torch.equal(p, seen[0]) for p in seen)
    np.testing.assert_allclose(seen[0].numpy(), want_p[:, 0].numpy(), rtol=0, atol=1e-6)
    out, weights = ranks[0]
    assert out.dtype == torch.bfloat16 and all(torch.equal(r[0], out) for r in ranks)
    assert bool(((out.float() - want.float()).abs() <= _bf16_ulp(want)).all())
    if case == "need_weights":
        assert weights.dtype == torch.bfloat16
        assert bool(((weights.float() - want_w.float()).abs() <= _bf16_ulp(want_w)).all())

    jp = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
          for k, v in (("in_proj_weight", holder.attn.in_proj_weight),
                       ("in_proj_bias", holder.attn.in_proj_bias))}
    jp["out_proj"] = {k: jnp.asarray(getattr(holder.attn.out_proj, k).float().numpy(),
                                     jnp.bfloat16) for k in ("weight", "bias")}
    jkv = jnp.asarray(kv.float().numpy(), jnp.bfloat16)
    j_out, j_w = j_mha(jp, jnp.asarray(q.float().numpy(), jnp.bfloat16), jkv, jkv, num_heads=1,
                       attn_mask=jnp.asarray(mask.numpy()), need_weights=True,
                       prob_mask=None if prob_mask is None else jnp.asarray(keep, jnp.float32))
    pairs = [(out, j_out)] + ([(weights, j_w)] if case == "need_weights" else [])
    for got, ref in pairs:
        ref = torch.from_numpy(np.asarray(ref, np.float32))
        err = float((got.float() - ref).abs().max())
        assert err <= JAX_BF16_ULPS * float(_bf16_ulp(ref.abs().max())), err


# ---------------------------------------------------------------------------
# (c) the blocks


def _rn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def block_case(name: str, rng):
    """(numpy inputs, port(model, inputs, grid, generator) -> tensors,
    jax(params, inputs) -> arrays) of one block at the small widths."""
    t = torch.from_numpy
    if name == "av_han_layer":
        ins = [_rn(rng, 6, T, 32), _rn(rng, 6, T, 32)]

        def port(m, x, grid, gen):
            return [P.av_han_layer(m.AV_Attn.layers["0"], x[0], x[1], nhead=1, dp=DP,
                                   generator=gen, grid=grid)]

        def jax_(p, x):
            return [J.av_han_layer(p["AV_Attn"]["layers"]["0"], *x, nhead=1, dp=DP,
                                   train=False, rng=None)]
    elif name == "tokens_self_attn":
        ins = [_rn(rng, 12, N, 32)]

        def port(m, x, grid, gen):
            return [P.tokens_self_attn(m.SpatioPerception.TokensAttn, x[0], nhead=1, dp=DP,
                                       generator=gen, grid=grid)]

        def jax_(p, x):
            return [J.tokens_self_attn(p["SpatioPerception"]["TokensAttn"], x[0], nhead=1,
                                       dp=DP, train=False, rng=None)]
    elif name == "attn_ffn_weights":
        ins = [_rn(rng, 3, 2, 32), _rn(rng, 3, T, 32)]

        def port(m, x, grid, gen):
            return list(P.attn_ffn(m.QstTempGrd_Module, x[0], x[1], x[1], nhead=4, dp=DP,
                                   generator=gen, need_weights=True, grid=grid))

        def jax_(p, x):
            return list(J._attn_ffn(p["QstTempGrd_Module"], x[0], x[1], x[1], nhead=4, dp=DP,
                                    train=False, rng=None, need_weights=True))
    elif name == "temporal_perception":
        ins = [_rn(rng, 3, T, 32), _rn(rng, 3, T, 32), _rn(rng, 3, 32)]

        def port(m, x, grid, gen):
            a, v, idx, w = P.temporal_perception(m.TemporalPerception, *x, topK=3, dp=DP,
                                                 generator=gen, grid=grid)
            return [a, v, w, idx]

        def jax_(p, x):
            pj = p["TemporalPerception"]
            a, v, idx = J.temporal_perception(pj, *x, topK=3, dp=DP, train=False, rng=None)
            _, w = J._attn_ffn(pj, x[2][:, None], x[1], x[1], nhead=4, dp=DP, train=False,
                               rng=None, need_weights=True)
            return [a, v, w, idx]
    elif name == "spatio_perception":
        ins = [_rn(rng, 2, 3, 32), _rn(rng, 2, T, N, 32)]
        idx = np.array([[0, 4, 7], [1, 2, 6]], np.int32)

        def port(m, x, grid, gen):
            return [P.spatio_perception(m.SpatioPerception, x[0], x[1], t(idx).long(), dp=DP,
                                        generator=gen, grid=grid)]

        def jax_(p, x):
            return [J.spatio_perception(p["SpatioPerception"], x[0], x[1], jnp.asarray(idx),
                                        topK=3, dp=DP, train=False, rng=None)]
    elif name == "qst_temporal_grounding":
        ins = [_rn(rng, 3, 32), _rn(rng, 3, 4, 32), _rn(rng, 3, 4, 32)]

        def port(m, x, grid, gen):
            return list(P.qst_temporal_grounding(m.QstTempGrd_Module, *x, dp=DP,
                                                 generator=gen, grid=grid))

        def jax_(p, x):
            return list(J.qst_temporal_grounding(p["QstTempGrd_Module"], *x, dp=DP,
                                                 train=False, rng=None))
    else:  # the whole forward
        keys = ("audio", "video", "patch", "quest", "prompt")
        ins = [_rn(rng, 3, T, 16), _rn(rng, 3, T, 24), _rn(rng, 3, T, N, 20), _rn(rng, 3, 12),
               _rn(rng, 3, 12)]

        def port(m, x, grid, gen):
            out = m(dict(zip(keys, x)), train=gen is not None, generator=gen, aux=True,
                    grid=grid)
            return [out["out"], out["temporal_weights"], out["topk_idx"]]

        def jax_(p, x):
            return [J.tspm_forward(p, dict(zip(keys, x)), J.tspm_config(**SMALL))["out"]]
    return ins, port, jax_


BLOCKS = ["av_han_layer", "tokens_self_attn", "attn_ffn_weights", "temporal_perception",
          "spatio_perception", "qst_temporal_grounding", "forward"]


def _run(model, ins, port, grid, dropout: bool):
    """The block on ``model`` (whole, or this rank's shards under ``grid``):
    its float outputs, the integer ones, and the gradients of every input
    and parameter under a fixed cotangent."""
    xs = [torch.from_numpy(x).requires_grad_(True) for x in ins]
    gen = torch.Generator().manual_seed(9) if dropout else None
    outs = port(model, xs, grid, gen)
    floats = [o for o in outs if o.is_floating_point()]
    ints = [o for o in outs if not o.is_floating_point()]
    cots = [torch.randn(o.shape, generator=torch.Generator().manual_seed(5 + i))
            for i, o in enumerate(floats)]
    params = [p for _, p in model.named_parameters()]
    grads = torch.autograd.grad(floats, xs + params, cots, allow_unused=True)
    return [o.detach() for o in floats], ints, grads


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", BLOCKS)
def test_tp_block_matches_port_and_jax(name, tp, dropout):
    params = jax_params()
    model = port_model(params).train(dropout)
    ins, port, jax_ = block_case(name, np.random.default_rng(BLOCKS.index(name)))
    want, want_ints, want_grads = _run(model, ins, port, None, dropout)

    ranks = torch_tp.run_ranks(
        tp, lambda grid: _run(torch_tp.sharded(model, grid), ins, port, grid, dropout))
    got, got_ints, _ = ranks[0]
    for outs, ints, grads in ranks:  # whole and bitwise equal on every rank
        assert all(torch.equal(a, b) for a, b in zip(outs, got))
        assert all(torch.equal(a, b) for a, b in zip(ints, got_ints))
        assert all(torch.equal(grads[i], ranks[0][2][i]) for i in range(len(ins)))
    for a, b in zip(got_ints, want_ints):  # the top-K frames: one process's
        assert torch.equal(a, b)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TP_TOL)
    if not dropout:
        ref = jax_(jax.tree_util.tree_map(jnp.asarray, params), [jnp.asarray(x) for x in ins])
        for a, b in zip(got + got_ints, ref):
            if a.is_floating_point():
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TP_TOL)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for i in range(len(ins)):
        _close_grad(ranks[0][2][i], want_grads[i], f"input {i}")
    names = [n for n, _ in model.named_parameters()]
    compared = 0
    for j, pname in enumerate(names):
        shards = [grads[len(ins) + j] for _, _, grads in ranks]
        w = want_grads[len(ins) + j]
        if w is None:
            assert all(s is None for s in shards), pname
            continue
        spec = tp_spec(pname, dict(model.named_parameters())[pname].shape, tp)
        if not spec:
            for s in shards[1:]:
                assert torch.equal(s, shards[0]), f"{pname}: replicated gradient differs"
        _close_grad(merge_shards(shards, spec) if spec else shards[0], w, pname)
        compared += 1
    assert compared >= 2  # TemporalPerception: only in_proj reaches the weights


def test_topk_on_the_reduced_weights_is_the_same_on_every_rank():
    """The temporal weights are summed over the model group before the
    top-K: at tp 2 and 4 every rank's weights and frames are bitwise one
    another's, on inputs whose weights are near ties (a shared visual
    sequence with small per-frame noise)."""
    params = jax_params(3)
    model = port_model(params).eval()
    rng = np.random.default_rng(4)
    visual = np.repeat(_rn(rng, 4, 1, 32), T, axis=1) + 1e-3 * _rn(rng, 4, T, 32)
    x = [torch.from_numpy(a) for a in (_rn(rng, 4, T, 32), visual, _rn(rng, 4, 32))]
    with torch.no_grad():
        _, _, want, w = P.temporal_perception(model.TemporalPerception, *x, topK=3, dp=DP)
    for tp in (2, 4):
        def rank(grid):
            with torch.no_grad():
                return P.temporal_perception(torch_tp.sharded(model, grid).TemporalPerception,
                                             *x, topK=3, dp=DP, grid=grid)
        ranks = torch_tp.run_ranks(tp, rank)
        for r in ranks:
            assert torch.equal(r[2], ranks[0][2]) and torch.equal(r[3], ranks[0][3])
        assert torch.equal(ranks[0][2], want)
        np.testing.assert_allclose(ranks[0][3].numpy(), w.numpy(), **TP_TOL)


# ---------------------------------------------------------------------------
# (d), (e): spawned gloo ranks


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_tspm")
    write_corpus(root, SPLITS, DIMS)
    rng = np.random.default_rng(1)
    for sub in ("qst", "prompt"):
        (root / sub).mkdir()
        for q in val_questions()[:52]:
            np.save(root / sub / f"{q['question_id']}.npy", _rn(rng, 12))
    return root


def cfg_dict(corpus) -> dict:
    return dict(
        type="tspm", mode="train", debug=False, log_interval=100, epochs=1, seed=7,
        num_labels=42,
        data=dict(root=str(corpus), frame_sample_rate=1, batch_size=8, eval_batch_size=8,
                  train_annot="train.json", valid_annot="val.json", test_annot="test.json",
                  ans_quelen="answer2idx.json", audio_feat="vggish", video_feat="clip",
                  patch_feat="tome", quest_feat="qst", prompt_feat="prompt"),
        hyper_params=dict(
            model=dict(SMALL),
            optim=dict(lr=LR, betas=(0.95, 0.999), weight_decay=0, encoder_lr=None),
            sched=dict(name="StepLR", step_size=8, gamma=0.1, mode="min", factor=0.5,
                       patience=5)))


def model_cfg(dropout=0.1):
    return {**P.tspm_config(**SMALL), "dropout": dropout}


def _losses_close(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


def test_dp1_tp2_matches_the_single_process(corpus, tmp_path):
    """Three steps with dropout on against one process, and the resumes
    across grids (``torch_tp.train_steps``)."""
    from qa_tiger_tpu_torch.data import AVQADataset, BatchLoader
    from qa_tiger_tpu_torch.training.checkpoint import load_train_state, save_train_state

    cfg, params = cfg_dict(corpus), jax_params()
    batches = list(BatchLoader(AVQADataset(Box(cfg), mode="train"), 8, prefetch=0))
    single = AVQARunner(Box(cfg), model_cfg(), device="cpu", seed=0, init_params=params)
    losses, first_grads = [], None
    for i, batch in enumerate(batches):
        if i == 2:
            save_train_state(single.train_state(epoch=1), tmp_path / "single_state")
        losses.append({k: float(v) for k, v in single.train_step(
            batch, LR, single._step_generator).items()})
        if i == 0:
            first_grads = {n: p.grad.clone() for n, p in single.trainable()
                           if p.grad is not None}
    ranks = torch_dp.spawn(torch_tp.train_steps, 2, tmp_path / "ranks", cfg, model_cfg(),
                           params, batches, LR, str(tmp_path / "tp_state"),
                           str(tmp_path / "single_state"))
    for r in ranks:
        for got, want in zip(r["losses"], losses):
            _losses_close(got, want)
        assert set(r["first_grads"]) == set(first_grads)
        for name, want in first_grads.items():
            _close_grad(torch.from_numpy(r["first_grads"][name]), want, name)
        assert r["resume_bitwise"] and r["resume_rng_equal"]
        assert r["resume_loss"] == r["losses"][2]
        _losses_close(r["from_single_loss"], losses[2])
        assert not any(r["launches"].values()) and not any(r["stages"].values())
    assert len(ranks[0]["replicated"]) > 20
    for name, value in ranks[0]["replicated"].items():
        assert np.array_equal(value, ranks[1]["replicated"][name]), name
    resumed = AVQARunner(Box(cfg), model_cfg(), device="cpu", seed=4, init_params=params)
    resumed.restore_train_state(load_train_state(tmp_path / "tp_state"))
    _losses_close({k: float(v) for k, v in resumed.train_step(
        batches[2], LR, resumed._step_generator).items()}, losses[2])


def jax_run(cfg, params):
    """The JAX runner on its dp2 x tp2 mesh with TSPM, dropout off: its
    eval over the test split, then one train epoch's logged losses and
    trainable parameters, flat."""
    def forward(p, batch, mcfg, train=False, rng=None):  # dropout off
        return J.tspm_forward(p, batch, mcfg, train=train, rng=None)

    runner = JAXRunner(JBox(cfg), J.tspm_config(**SMALL), J.tspm_init, forward,
                       J.TSPM_FROZEN_PREFIXES,
                       mesh=make_mesh(4, model_parallel=2, devices=jax.devices("cpu")),
                       seed=0, init_params=params)
    assert dict(runner.mesh.shape) == {"data": 2, "model": 2}
    evals = runner._run_eval(JBatchLoader(JDataset(JBox(cfg), mode="test"), 8), debug=False)
    writer = torch_dp.Writer()
    loader = JBatchLoader(JDataset(JBox(cfg), mode="train"), 8, shuffle=True, seed=cfg["seed"])
    runner.train_epoch(1, loader, lr=LR, writer=writer)
    return evals, writer.scalars, nested_to_flat(
        jax.tree_util.tree_map(np.asarray, runner.trainable))


def test_dp2_tp2_matches_the_jax_mesh(corpus, tmp_path):
    """``_run_eval`` and ``train_epoch`` at dp2 x tp2, dropout off: the
    counters exactly and the loss within rtol 1e-5; the logged losses within
    rtol 1e-5, the parameters within rtol 2e-4 / atol 2e-5 where the last
    gradient is above 1e-6; ``params`` gathered back bitwise."""
    cfg, params = cfg_dict(corpus), jax_params()
    ranks = torch_dp.spawn(torch_tp.eval_and_train, 4, tmp_path, cfg, model_cfg(0.0), params, 2)
    (j_loss, j_cor, j_tot, j_cor9, j_tot9), j_scalars, want = jax_run(cfg, params)
    assert [r["eval"]["grid"] for r in ranks] == [(g // 2, 2, g % 2, 2) for g in range(4)]
    for r in ranks:
        loss, cor, tot, cor9, tot9 = r["eval"]["eval"]
        assert (cor, tot) == (int(j_cor), int(j_tot)) and tot == 17
        np.testing.assert_array_equal(np.asarray(cor9), np.asarray(j_cor9))
        np.testing.assert_array_equal(np.asarray(tot9), np.asarray(j_tot9))
        np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
        assert r["eval"]["params_bitwise"] and r["eval"]["train_error"] is None
    r0 = ranks[0]["train"]
    assert r0["steps"] == 3
    assert [(t, s) for t, s, _ in r0["scalars"]] == [(t, s) for t, s, _ in j_scalars]
    np.testing.assert_allclose([v for *_, v in r0["scalars"]], [v for *_, v in j_scalars],
                               rtol=1e-5)
    for r in ranks[1:]:
        assert r["train"]["scalars"] == r0["scalars"]
        for name, value in r0["params"].items():
            assert np.array_equal(r["train"]["params"][name], value), name
    for a, b in ((ranks[0], ranks[1]), (ranks[2], ranks[3])):
        assert len(a["train"]["replicated"]) > 20
        for name, value in a["train"]["replicated"].items():
            assert np.array_equal(b["train"]["replicated"][name], value), name
    assert set(r0["params"]) == set(want)
    compared = 0
    for name, value in r0["params"].items():
        keep = np.abs(r0["grads"].get(name, np.zeros_like(value))) > 1e-6
        if keep.any():
            np.testing.assert_allclose(value[keep], want[name][keep], rtol=2e-4, atol=2e-5,
                                       err_msg=name)
            compared += 1
    assert compared > 40


def window_batches(n=5, b=4):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        out.append({"audio": _rn(rng, b, T, 16), "video": _rn(rng, b, T, 24),
                    "patch": _rn(rng, b, T, N, 20), "quest": _rn(rng, b, 1, 12),
                    "prompt": _rn(rng, b, 12), "label": rng.integers(0, 42, b),
                    "qtype_label": rng.integers(0, 9, b), "valid": np.ones(b, bool)})
    return out


def test_steps_per_dispatch_under_a_model_axis(corpus, tmp_path):
    """(e) dp1 x tp2, dropout on, 5 batches: K = 2 (the step graph's eager
    static-input step) bitwise the K = 1 epoch; a capture under gloo
    raises."""
    cfg = cfg_dict(corpus)
    cfg["log_interval"] = 1000
    ranks = torch_dp.spawn(torch_tp.window_epochs, 2, tmp_path, cfg, model_cfg(), jax_params(),
                           window_batches(), 2)
    for r in ranks:
        one, k = r["k1"], r["k"]
        assert k["graph"] and not one["graph"]
        assert k["scalars"] == one["scalars"] and len(one["scalars"]) == 5 * 2
        assert torch.equal(k["rng"], one["rng"])
        for name, value in one["params"].items():
            assert torch.equal(k["params"][name], value), name
        assert set(k["moments"]) == set(one["moments"]) and len(one["moments"]) > 40
        for name, (m1, v1) in one["moments"].items():
            m2, v2 = k["moments"][name]
            assert torch.equal(m1, m2) and torch.equal(v1, v2), name
        assert "gloo" in r["capture_error"]
    for name, value in ranks[0]["k"]["replicated"].items():
        assert np.array_equal(value, ranks[1]["k"]["replicated"][name]), name
