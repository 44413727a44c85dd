"""Tensor parallelism of the port's eval forward (``parallel/tensor.py``), on
the CPU.

(a) the spec table: ``tp_spec`` against JAX ``_spec_for`` over every
    parameter of configs/qa-tiger/vitl14.py at tp 2 and 4, equal but for the
    two deliberate differences, named one by one: the head-aligned
    ``in_proj_*`` split and the replicated ``gauss_pred.0``;
(b) shard and gather: ``gather_state_dict(shard_state_dict(sd))`` is ``sd``
    bitwise, the identity at tp 1;
(c) the tensor-parallel forms in one process: the tp model ranks simulated
    as threads (``tests/torch_tp.py``: each rank's stages on its shards, the
    partials summed in rank order, then the epilogue), each module against
    the unsharded port module and the JAX module at tp 2 and 4, fp32,
    rtol 1e-5 / atol 2e-6 (the sums only change order; TP_TOL), the ranks bitwise
    equal; the attention plan of every ``attention_wide`` call at full
    width the same at tp 1, 2 and 4;
(d) spawned gloo ranks (``tests/torch_dp.py``) at dp1 x tp2 and dp2 x tp2:
    ``AVQARunner(grid=...)._run_eval`` over 17 rows against JAX's
    ``AVQARunner`` on its dp2 x tp2 CPU mesh (the mesh of
    ``tests/test_training.py:436``) and the port's single process with the
    same weights, ``gather_mode="paper"``: the counters exactly, the loss
    within rtol 1e-5; ``params`` gathered back bitwise; a train step runs,
    its loss equal on every rank; and a grid of model size 1 at world 2
    bitwise the plain data-parallel eval.
"""
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_dp
import torch_tp
from qa_tiger_tpu.data import AVQADataset as JDataset
from qa_tiger_tpu.data import BatchLoader as JBatchLoader
from qa_tiger_tpu.models import clip_text as j_clip_text
from qa_tiger_tpu.models import modules as JM
from qa_tiger_tpu.models.clip_text import causal_mask as j_causal_mask
from qa_tiger_tpu.models.clip_text import resblock as j_resblock
from qa_tiger_tpu.models.qa_tiger import FROZEN_PREFIXES as J_FROZEN
from qa_tiger_tpu.models.qa_tiger import qa_tiger_config as j_config
from qa_tiger_tpu.models.qa_tiger import qa_tiger_forward, qa_tiger_init
from qa_tiger_tpu.nn.attention import mha as j_mha
from qa_tiger_tpu.parallel import make_mesh
from qa_tiger_tpu.parallel.mesh import _spec_for
from qa_tiger_tpu.training.loop import AVQARunner as JAXRunner
from qa_tiger_tpu.utils import Box as JBox
from qa_tiger_tpu_torch.convert import params_from_jax
from qa_tiger_tpu_torch.data import AVQADataset, BatchLoader
from qa_tiger_tpu_torch.models import QATiger, qa_tiger_config
from qa_tiger_tpu_torch.models import clip_text as t_clip_text
from qa_tiger_tpu_torch.nn.attention import mha
from qa_tiger_tpu_torch.ops.attention import attention_plan
from qa_tiger_tpu_torch.parallel import Grid, gather_state_dict, shard_state_dict, tp_spec
from qa_tiger_tpu_torch.parallel.tensor import QKV, QKV_VEC, REPLICATED
from qa_tiger_tpu_torch.training import AVQARunner
from qa_tiger_tpu_torch.utils import Box
from qa_tiger_tpu_torch.utils.config import load_config_module
from torch_corpus import val_questions, write_corpus, write_merges

REPO = Path(__file__).resolve().parents[1]
VITL14 = REPO / "configs" / "qa-tiger" / "vitl14.py"
TINY = dict(d_model=32, video_dim=32, patch_dim=24, audio_dim=16, topK=2, num_experts=4,
            encoder_type="tiny-test")
# fp32, one module: the tensor-parallel form only changes the order of the
# sums (partials over the ranks' shards, added in rank order). rtol 1e-5;
# atol 2e-6, not 1e-6: the modules end in a LayerNorm whose 1/std scales
# that reordering, which reached 1.6e-6 on single elements of TempMoE's and
# PatchSelecter's normalised outputs at d_model 32
TP_TOL = dict(rtol=1e-5, atol=2e-6)
DIMS = {"vggish": (12, 16), "clip": (12, 32), "tome": (12, 4, 24)}
SPLITS = {"train": (0, 19), "val": (19, 35), "test": (35, 52)}
NHEAD = 8


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    monkeypatch.setitem(t_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", torch_dp.TINY_TOWER)
    monkeypatch.setitem(j_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", torch_dp.TINY_TOWER)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _walk(value, path + (key,))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# (a) the spec table


@pytest.mark.parametrize("tp", [2, 4])
def test_spec_table_against_jax(tp):
    hp = load_config_module(str(VITL14))["hyper_params"]
    cfg = j_config(num_labels=42, **hp["model"])
    shapes = jax.eval_shape(lambda key: qa_tiger_init(key, cfg), jax.random.PRNGKey(0))
    differs, count = {}, 0
    for path, leaf in _walk(shapes):
        name = ".".join(path)
        want = tuple(_spec_for(path, leaf, tp))
        got = tp_spec(name, leaf.shape, tp)
        count += 1
        if got != want:
            differs[name] = (got, want)
    in_proj = {n: v for n, v in differs.items() if n.endswith(("in_proj_weight", "in_proj_bias"))}
    # every attention's packed projection: split by head, where JAX stacks
    assert len(in_proj) == 2 * (3 + 2 + 1 + 1 + 1 + 12)
    for name, (got, want) in in_proj.items():
        assert got == (QKV if name.endswith("weight") else QKV_VEC), name
        assert want == (("model", None) if name.endswith("weight") else ("model",)), name
    solo = {n: v for n, v in differs.items() if n not in in_proj}
    if tp == 2:  # gauss_pred.0 [14, 512] splits in JAX; its 14 outputs feed the router
        assert set(solo) == {f"{agg}.gauss_pred.0.{leaf}" for agg in
                             ("at_aggregator", "vt_aggregator") for leaf in ("weight", "bias")}
        assert all(got == REPLICATED for got, _ in solo.values())
    else:  # 14 does not divide by 4: replicated on both sides
        assert solo == {}
    assert count > 250


# ---------------------------------------------------------------------------
# (b) shard and gather


def tiny_model(gather_mode="paper"):
    params = jax.tree_util.tree_map(
        np.asarray, qa_tiger_init(jax.random.PRNGKey(0),
                                  j_config(num_labels=42, gather_mode=gather_mode, **TINY)))
    model = QATiger(qa_tiger_config(num_labels=42, gather_mode=gather_mode, **TINY),
                    seed=1).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    return params, model


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_shard_gather_roundtrip(tp):
    _, model = tiny_model()
    sd = model.state_dict()
    shapes = {n: tuple(t.shape) for n, t in sd.items()}
    if tp == 1:
        grid = Grid()
        assert shard_state_dict(sd, grid) == sd
        assert gather_state_dict(sd, grid, shapes) == sd
        return

    def rank(grid):
        local = shard_state_dict(sd, grid)
        return local, gather_state_dict(local, grid, shapes)

    out = torch_tp.run_ranks(tp, rank)
    D = TINY["d_model"]
    for r, (local, whole) in enumerate(out):
        assert set(whole) == set(sd)
        for name, value in sd.items():
            assert torch.equal(whole[name], value), name
        # rank r holds rows [r D/tp, (r+1) D/tp) of each of q, k and v
        w = sd["crs_attn.qst_attn.in_proj_weight"].reshape(3, D, D)
        want = w[:, r * D // tp:(r + 1) * D // tp].reshape(3 * D // tp, D)
        assert torch.equal(local["crs_attn.qst_attn.in_proj_weight"], want)
        assert local["crs_attn.qst_attn.out_proj.weight"].shape == (D, D // tp)
        assert torch.equal(local["crs_attn.qst_attn.out_proj.bias"],
                           sd["crs_attn.qst_attn.out_proj.bias"])
        assert local["at_aggregator.experts.0.0.weight"].shape == (D // 2 // tp, D)
        assert local["at_aggregator.gauss_pred.0.weight"].shape == (2 * TINY["num_experts"], D)


# ---------------------------------------------------------------------------
# (c) the tensor-parallel forms in one process


def _sub(tree, dotted: str):
    for key in dotted.split("."):
        tree = tree[key]
    return tree


def _np_in(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def module_case(name: str, params, rng):
    """(port submodule path, port call(module, inputs, grid), JAX call,
    inputs as numpy) of one module at the tiny widths."""
    B, T, P, D = 2, 5, 14, TINY["d_model"]
    j = lambda path: _sub(params, path)  # noqa: E731
    if name.startswith("mha"):
        q, kv = _np_in(rng, B, T, D), _np_in(rng, B, 7, D)
        key, value = {"mha_self": (q, q), "mha_kv": (kv, kv),
                      "mha_cross": (kv, _np_in(rng, B, 7, D))}[name]
        ins = [q, key, value]

        def port(m, x, grid):
            a, b, c = x
            b = a if name == "mha_self" else b
            c = b if name != "mha_cross" else c
            return mha(m, a, b, c, num_heads=NHEAD, need_weights=False, grid=grid)[0]

        def jx(x):
            return j_mha(j("crs_attn.qst_attn"), *x, num_heads=NHEAD, need_weights=False)[0]

        return "crs_attn.qst_attn", port, jx, ins
    if name == "text_block":
        W, L = torch_dp.TINY_TOWER["width"], 9
        heads = torch_dp.TINY_TOWER["heads"]

        def port(m, x, grid):
            mask = t_clip_text.causal_mask(L)
            return m(x[0], heads=heads, mask=mask, grid=grid)

        def jx(x):
            return j_resblock(j("quest_encoder.transformer.resblocks.0"), x[0], heads=heads,
                              mask=j_causal_mask(L))

        return "quest_encoder.transformer.resblocks.0", port, jx, [_np_in(rng, B, L, W)]
    if name == "avq":
        ins = [_np_in(rng, B, T, D), _np_in(rng, B, T, D), _np_in(rng, B, 9, D)]

        def port(m, x, grid):
            return torch.stack(m(*x, nhead=NHEAD, grid=grid))

        def jx(x):
            return np.stack([np.asarray(o) for o in
                             JM.avq_cross_attn(j("crs_attn"), *x, nhead=NHEAD, train=False)])

        return "crs_attn", port, jx, ins
    if name == "grounding":
        ins = [_np_in(rng, B, D), _np_in(rng, B, 3, D), _np_in(rng, B, 4, D)]

        def port(m, x, grid):
            return m(x[0], [x[1], x[2]], nhead=NHEAD, grid=grid)

        def jx(x):
            return JM.qst_grounding(j("quest_grounding"), x[0], [x[1], x[2]], nhead=NHEAD)

        return "quest_grounding", port, jx, ins
    if name.startswith("temp_moe"):
        vis = name == "temp_moe_vis"
        ins = [_np_in(rng, B, D), _np_in(rng, B, T, D)]
        if vis:
            ins += [_np_in(rng, B, T, D), _np_in(rng, B, T, D)]
        moe = dict(nhead=NHEAD, topK=TINY["topK"], sigma=9.0, gather_mode="paper")
        path = "vt_aggregator" if vis else "at_aggregator"

        def port(m, x, grid):
            out = m(x[0], x[1], [x[2], x[3]] if vis else None, grid=grid, **moe)
            return torch.stack(out) if vis else out

        def jx(x):
            out = JM.temp_moe(j(path), x[0], x[1], [x[2], x[3]] if vis else None,
                              n_experts=TINY["num_experts"], **moe)
            return np.stack([np.asarray(o) for o in out]) if vis else out

        return path, port, jx, ins
    assert name == "patch_selecter"
    ins = [_np_in(rng, B, T, P, D), _np_in(rng, B, T, D), _np_in(rng, B, T, D)]

    def port(m, x, grid):
        return torch.stack(m(*x, nhead=NHEAD, grid=grid))

    def jx(x):
        return np.stack([np.asarray(o) for o in
                         JM.patch_selecter(j("patch_selecter"), *x, nhead=NHEAD)])

    return "patch_selecter", port, jx, ins


MODULES = ["mha_self", "mha_kv", "mha_cross", "text_block", "avq", "grounding", "temp_moe",
           "temp_moe_vis", "patch_selecter"]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", MODULES)
def test_tp_module_matches_port_and_jax(name, tp):
    params, model = tiny_model()
    path, port, jx, ins = module_case(name, params, np.random.default_rng(MODULES.index(name)))
    x = [torch.tensor(a) for a in ins]
    with torch.no_grad():
        whole = port(model.get_submodule(path), x, None).numpy()

    def rank(grid):
        sharded = torch_tp.sharded(model, grid)
        with torch.no_grad():
            return port(sharded.get_submodule(path), x, grid)

    outs = torch_tp.run_ranks(tp, rank)
    want = np.asarray(jx([jax.numpy.asarray(a) for a in ins]))
    for out in outs:
        assert torch.equal(out, outs[0])  # every rank ends with the same value
    got = outs[0].numpy()
    np.testing.assert_allclose(got, whole, **TP_TOL)
    np.testing.assert_allclose(got, want, **TP_TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_forward_matches_port_and_jax(tp):
    params, model = tiny_model()
    rng = np.random.default_rng(11)
    B, T, P = 3, 5, 14
    toks = np.zeros((B, 77), np.int64)
    for i in range(B):
        toks[i, 0], toks[i, 1:7], toks[i, 7] = 49406, rng.integers(1, 49000, 6), 49407
    batch = {"quest": toks, "audio": _np_in(rng, B, T, 16), "video": _np_in(rng, B, T, 32),
             "patch": _np_in(rng, B, T, P, 24)}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        whole = model(tb)["out"].numpy()

    def rank(grid):
        sharded = torch_tp.sharded(model, grid)
        with torch.no_grad():
            return sharded(tb, grid=grid)["out"]

    outs = torch_tp.run_ranks(tp, rank)
    want = np.asarray(qa_tiger_forward(params, {k: jax.numpy.asarray(v) for k, v in batch.items()},
                                       j_config(num_labels=42, gather_mode="paper", **TINY),
                                       train=False)["out"])
    assert all(torch.equal(o, outs[0]) for o in outs)
    np.testing.assert_allclose(outs[0].numpy(), whole, **TP_TOL)
    np.testing.assert_allclose(outs[0].numpy(), want, rtol=1e-4, atol=1e-5)

    # the train forward under the grid (dropout on, the ranks drawing from
    # one stream) is the single process's train forward
    def train(grid):
        with torch.no_grad():
            return torch_tp.sharded(model, grid)(tb, train=True, grid=grid,
                                                 generator=torch.Generator().manual_seed(4))["out"]

    with torch.no_grad():
        whole_train = model(tb, train=True, generator=torch.Generator().manual_seed(4))["out"]
    train_outs = torch_tp.run_ranks(tp, train)
    assert all(torch.equal(o, train_outs[0]) for o in train_outs)
    np.testing.assert_allclose(train_outs[0].numpy(), whole_train.numpy(), **TP_TOL)
    assert not np.allclose(whole_train.numpy(), whole, **TP_TOL)  # dropout was on


def test_attention_plan_unchanged_by_the_split():
    """Every ``attention_wide`` call of the vitl14 forward takes, at tp 2
    and 4, the kernel it takes at tp 1: the split keeps head size 64 and
    only the head count changes. In bf16 the AVQ calls (60 queries over 77
    or 60 keys) take ``mma``, QstGrounding's one query over 2 keys
    ``mma_short``, TempMoE's one query over 60 keys ``mma_nokeep`` (the
    keep-masked kernel without a keep mask); in fp32 every call
    ``mma_nokeep``; the text tower's 77 x 77 ``mma``."""
    D, heads, T, S = 512, 8, 60, 77
    calls = {"avq_qst": (T, S, "mma"), "avq_self": (T, T, "mma"), "avq_cross": (T, T, "mma"),
             "grounding": (1, 2, "mma_short"), "moe": (1, T, "mma_nokeep")}
    for dtype in (torch.bfloat16, torch.float32):
        for name, (sq, sk, route) in calls.items():
            plans = {tp: attention_plan(dtype, sq, sk, (D // tp) // (heads // tp))
                     for tp in (1, 2, 4)}
            assert plans[2] == plans[1] == plans[4], name
            assert plans[1].route == (route if dtype == torch.bfloat16 else "mma_nokeep"), name
    text = {tp: attention_plan(torch.bfloat16, S, S, (768 // tp) // (12 // tp)) for tp in (1, 2, 4)}
    assert text[1] == text[2] == text[4] and text[1].route == "mma"


# ---------------------------------------------------------------------------
# (d) spawned gloo ranks


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    write_corpus(root / "data", SPLITS, DIMS)
    write_merges(root / "vocab.txt.gz", [q["question_content"] for q in val_questions()], 300)
    return root


def cfg_dict(corpus) -> dict:
    return dict(
        type="qa-tiger", mode="test", debug=False, log_interval=100, epochs=1, seed=7,
        num_labels=42,
        data=dict(root=str(corpus / "data"), frame_sample_rate=1, batch_size=8,
                  eval_batch_size=8, train_annot="train.json", valid_annot="val.json",
                  test_annot="test.json", ans_quelen="answer2idx.json", audio_feat="vggish",
                  video_feat="clip", patch_feat="tome", quest_feat=None, prompt_feat=None),
        hyper_params=dict(
            model=dict(TINY),
            optim=dict(lr=1e-3, betas=(0.95, 0.999), weight_decay=0, encoder_lr=None),
            sched=dict(name="StepLR", step_size=8, gamma=0.1, mode="min", factor=0.5,
                       patience=5)))


@pytest.fixture(scope="module")
def reference(corpus):
    """The JAX runner's ``_run_eval`` on its dp2 x tp2 CPU mesh and the
    port's single process, over the 17 test rows, with the same weights."""
    mp = pytest.MonkeyPatch()
    mp.setitem(j_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", torch_dp.TINY_TOWER)
    mp.setitem(t_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", torch_dp.TINY_TOWER)
    mp.setenv("QA_TIGER_BPE_VOCAB", str(corpus / "vocab.txt.gz"))
    try:
        cfg = cfg_dict(corpus)
        params, _ = tiny_model()
        j_run = JAXRunner(JBox(cfg), j_config(num_labels=42, gather_mode="paper", **TINY),
                          qa_tiger_init, qa_tiger_forward, J_FROZEN,
                          mesh=make_mesh(4, model_parallel=2, devices=jax.devices("cpu")),
                          seed=0, init_params=params)
        assert dict(j_run.mesh.shape) == {"data": 2, "model": 2}
        jax_eval = j_run._run_eval(JBatchLoader(JDataset(JBox(cfg), mode="test"), 8),
                                   debug=False)
        runner = AVQARunner(Box(cfg), qa_tiger_config(num_labels=42, gather_mode="paper", **TINY),
                            device="cpu", seed=0, init_params=params)
        port_eval = runner._run_eval(BatchLoader(AVQADataset(Box(cfg), mode="test"), 8),
                                     debug=False)
        yield cfg, params, jax_eval, port_eval
    finally:
        mp.undo()


def _same_counters(got, want):
    loss, cor, tot, cor9, tot9 = got
    assert (cor, tot) == (int(want[1]), int(want[2])) and tot == 17
    np.testing.assert_array_equal(np.asarray(cor9), np.asarray(want[3]))
    np.testing.assert_array_equal(np.asarray(tot9), np.asarray(want[4]))
    np.testing.assert_allclose(loss, float(want[0]), rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_grid_eval_matches_jax_mesh(reference, tmp_path, monkeypatch, corpus, world):
    """dp1 x tp2 (world 2) and dp2 x tp2 (world 4)."""
    monkeypatch.setenv("QA_TIGER_BPE_VOCAB", str(corpus / "vocab.txt.gz"))
    cfg, params, jax_eval, port_eval = reference
    mcfg = qa_tiger_config(num_labels=42, gather_mode="paper", **TINY)
    ranks = torch_dp.spawn(torch_tp.tp_eval, world, tmp_path, cfg, mcfg, params, 2)
    dp = world // 2
    assert [r["grid"] for r in ranks] == [(g // 2, dp, g % 2, 2) for g in range(world)]
    for r in ranks:
        assert r["batches"] == math.ceil(math.ceil(17 / dp) / (8 // dp))
        _same_counters(r["eval"], jax_eval)
        _same_counters(r["eval"], port_eval)
        assert r["params_bitwise"]
        # a train step under the grid runs (A7b.2), the ranks' losses equal
        assert r["train_error"] is None and np.isfinite(r["train_loss"])
        assert r["train_loss"] == ranks[0]["train_loss"]
    if world == 4:  # data rank 1 holds 8 rows: its last batch of 4 is all padding
        assert ranks[2]["batches"] == 3


def test_model_size_one_is_data_parallel_eval(reference, tmp_path, monkeypatch, corpus):
    """A grid of model size 1 at world 2: the counters and the loss bitwise
    those of the data-parallel eval without a grid on the same ranks."""
    monkeypatch.setenv("QA_TIGER_BPE_VOCAB", str(corpus / "vocab.txt.gz"))
    cfg, params, _, port_eval = reference
    mcfg = qa_tiger_config(num_labels=42, gather_mode="paper", **TINY)
    ranks = torch_dp.spawn(torch_tp.tp_eval, 2, tmp_path / "grid", cfg, mcfg, params, 1)
    plain = torch_dp.spawn(torch_dp.run_eval, 2, tmp_path / "plain", cfg, mcfg, params)
    for r, p in zip(ranks, plain):
        assert r["grid"][1:] == (2, 0, 1)
        loss, cor, tot, cor9, tot9 = r["eval"]
        assert loss == p[0] and (cor, tot) == p[1:3]
        np.testing.assert_array_equal(cor9, p[3])
        np.testing.assert_array_equal(tot9, p[4])
        _same_counters(r["eval"], port_eval)
        assert r["params_bitwise"] and r["train_error"] is None
