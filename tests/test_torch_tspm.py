"""The port's TSPM baseline against qa_tiger_tpu's, on the CPU.

Each block (``av_han_layer``, ``_attn_ffn`` with and without weights,
``tokens_self_attn``, ``temporal_perception``, ``spatio_perception``,
``qst_temporal_grounding``) and the whole ``tspm_forward`` take the same
numpy inputs and the JAX parameters (``tspm_init``, carried across with
``params_from_jax`` and loaded strictly) on both sides, fp32, JAX at
``jax_default_matmul_precision="highest"`` (conftest). The top-K on
constructed ties in fp32 and bf16; one ``AVQARunner`` train step with
dropout off against the JAX runner's; the question cache skipped; token
ids, ``Predictor`` and ``serve`` refusing TSPM; ``steps_per_dispatch``;
the wide-head attention plan (head sizes 256 and 512) and its plain version
against the Pallas op in interpret mode; ``bench --device cpu``. Each
tolerance is stated where it is used.
"""
import json
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qa_tiger_tpu.models import tspm as J
from qa_tiger_tpu.ops.pallas import attention as j_attention
from qa_tiger_tpu.parallel import make_mesh
from qa_tiger_tpu.training.loop import AVQARunner as JAXRunner
from qa_tiger_tpu.utils import Box
from qa_tiger_tpu_torch import bench
from qa_tiger_tpu_torch.convert import nested_to_flat, params_from_jax
from qa_tiger_tpu_torch.models import TSPM, build_model, model_config
from qa_tiger_tpu_torch.models import tspm as P
from qa_tiger_tpu_torch.ops import attention as A
from qa_tiger_tpu_torch.training import AVQARunner

SMALL = dict(topK=3, audio_dim=16, vis_dim=24, patch_dim=20, qst_dim=12, hidden_size=32,
             num_labels=7)
FULL = dict(topK=10, num_labels=42)  # configs/tspm/vitl14.py's widths are the defaults
# small widths, fp32: the frameworks differ in summation order only
TOL = dict(rtol=1e-5, atol=1e-5)
# full width (512-wide contractions, 60 frames of 14 patches), fp32
FULL_TOL = dict(rtol=1e-4, atol=2e-5)
LR = 1e-3


def _perturbed(params, seed, scale=0.05):
    """JAX parameters with the LayerNorms' ones and the zero biases moved
    off their init values, so that each parameter's name is exercised."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        params)


def pair(kw=SMALL, seed=0):
    j_cfg = J.tspm_config(**kw)
    params = _perturbed(J.tspm_init(jax.random.PRNGKey(seed), j_cfg), seed + 1)
    model = TSPM(P.tspm_config(**kw), seed=seed + 2).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    return j_cfg, params, model


def jx(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def rn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def make_batch(rng, b, kw=SMALL, T=8, N=5, quest_3d=True):
    h = dict(P.tspm_config(**kw))
    return {"audio": rn(rng, b, T, h["audio_dim"]), "video": rn(rng, b, T, h["vis_dim"]),
            "patch": rn(rng, b, T, N, h["patch_dim"]),
            "quest": rn(rng, b, 1, h["qst_dim"]) if quest_3d else rn(rng, b, h["qst_dim"]),
            "prompt": rn(rng, b, h["qst_dim"])}


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), **tol)


def t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# parameters and configs
# ---------------------------------------------------------------------------

def test_state_dict_names_equal_the_jax_tree():
    flat = nested_to_flat(jax.tree_util.tree_map(
        np.asarray, J.tspm_init(jax.random.PRNGKey(0), J.tspm_config(**FULL))))
    state = TSPM(P.tspm_config(**FULL)).state_dict()
    assert set(state) == set(flat)
    assert all(tuple(state[k].shape) == v.shape for k, v in flat.items())
    model = TSPM(P.tspm_config(**FULL), seed=3)
    model.load_state_dict(params_from_jax(flat), strict=True)
    assert torch.equal(model.AV_Attn.layers["0"].cm_attn.in_proj_weight,
                       torch.tensor(flat["AV_Attn.layers.0.cm_attn.in_proj_weight"]))
    assert P.TSPM_FROZEN_PREFIXES == J.TSPM_FROZEN_PREFIXES == ()


def test_config_and_registry():
    """``model_config`` dispatches TSPM* as the JAX registry does, to the
    JAX ``tspm_config`` plus the ``arch`` that names the class."""
    from qa_tiger_tpu.models.registry import build_model as j_build

    kw = dict(topK=10, avq_cross_attn=False, audio_dim=128, vis_dim=768, patch_dim=1024,
              qst_dim=768, hidden_size=512)
    got = model_config("TSPM_CLIP_ViT-L/14@336px", kw, num_labels=42)
    want = j_build("TSPM_CLIP_ViT-L/14@336px", kw, num_labels=42)[0]
    assert {k: v for k, v in got.items() if k != "arch"} == want and got["arch"] == "TSPM"
    model = build_model("TSPM_base", {}, device="cpu")
    assert isinstance(model, TSPM) and not model.training


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def test_av_han_layer():
    _, params, model = pair()
    rng = np.random.default_rng(1)
    q, v = rn(rng, 6, 8, 32), rn(rng, 6, 8, 32)
    want = J.av_han_layer(jx(params)["AV_Attn"]["layers"]["0"], jnp.asarray(q), jnp.asarray(v),
                          nhead=1, dp=0.1, train=False, rng=None)
    with torch.no_grad():
        got = P.av_han_layer(model.AV_Attn.layers["0"], t(q), t(v), nhead=1, dp=0.1)
    close(got, want)


@pytest.mark.parametrize("need_weights", [False, True])
def test_attn_ffn(need_weights):
    _, params, model = pair()
    rng = np.random.default_rng(2)
    q, kv = rn(rng, 3, 2, 32), rn(rng, 3, 8, 32)
    out, w = J._attn_ffn(jx(params)["QstTempGrd_Module"], jnp.asarray(q), jnp.asarray(kv),
                         jnp.asarray(kv), nhead=4, dp=0.1, train=False, rng=None,
                         need_weights=need_weights)
    kvt = t(kv)
    with torch.no_grad():
        got, gw = P.attn_ffn(model.QstTempGrd_Module, t(q), kvt, kvt, nhead=4, dp=0.1,
                             need_weights=need_weights)
    close(got, out)
    if need_weights:
        assert tuple(gw.shape) == (3, 2, 8)
        close(gw, w)
    else:
        assert gw is None and w is None


def test_tokens_self_attn():
    _, params, model = pair()
    x = rn(np.random.default_rng(3), 12, 5, 32)
    want = J.tokens_self_attn(jx(params)["SpatioPerception"]["TokensAttn"], jnp.asarray(x),
                              nhead=1, dp=0.1, train=False, rng=None)
    with torch.no_grad():
        got = P.tokens_self_attn(model.SpatioPerception.TokensAttn, t(x), nhead=1, dp=0.1)
    close(got, want)


def test_temporal_perception():
    """The gathered frames and their indices; the weights the port also
    returns are JAX's ``_attn_ffn`` weights."""
    _, params, model = pair()
    rng = np.random.default_rng(4)
    a, v, qp = rn(rng, 3, 8, 32), rn(rng, 3, 8, 32), rn(rng, 3, 32)
    pj = jx(params)["TemporalPerception"]
    wa, wv, widx = J.temporal_perception(pj, jnp.asarray(a), jnp.asarray(v), jnp.asarray(qp),
                                         topK=3, dp=0.1, train=False, rng=None)
    _, ww = J._attn_ffn(pj, jnp.asarray(qp)[:, None], jnp.asarray(v), jnp.asarray(v),
                        nhead=4, dp=0.1, train=False, rng=None, need_weights=True)
    with torch.no_grad():
        ga, gv, gidx, gw = P.temporal_perception(model.TemporalPerception, t(a), t(v), t(qp),
                                                 topK=3, dp=0.1)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(widx))
    close(ga, wa)
    close(gv, wv)
    close(gw, ww)


def test_spatio_perception():
    _, params, model = pair()
    rng = np.random.default_rng(5)
    audio, patch = rn(rng, 2, 3, 32), rn(rng, 2, 8, 5, 32)
    idx = np.array([[0, 4, 7], [1, 2, 6]], np.int32)
    want = J.spatio_perception(jx(params)["SpatioPerception"], jnp.asarray(audio),
                               jnp.asarray(patch), jnp.asarray(idx), topK=3, dp=0.1,
                               train=False, rng=None)
    with torch.no_grad():
        got = P.spatio_perception(model.SpatioPerception, t(audio), t(patch),
                                  torch.tensor(idx, dtype=torch.int64), dp=0.1)
    assert tuple(got.shape) == (2, 3, 32)
    close(got, want)


def test_qst_temporal_grounding():
    _, params, model = pair()
    rng = np.random.default_rng(6)
    q, a, v = rn(rng, 3, 32), rn(rng, 3, 4, 32), rn(rng, 3, 4, 32)
    wa, wv = J.qst_temporal_grounding(jx(params)["QstTempGrd_Module"], jnp.asarray(q),
                                      jnp.asarray(a), jnp.asarray(v), dp=0.1, train=False,
                                      rng=None)
    with torch.no_grad():
        ga, gv = P.qst_temporal_grounding(model.QstTempGrd_Module, t(q), t(a), t(v), dp=0.1)
    close(ga, wa)
    close(gv, wv)


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quest_3d", [True, False])
def test_forward_small(quest_3d):
    j_cfg, params, model = pair()
    batch = make_batch(np.random.default_rng(7), 3, quest_3d=quest_3d)
    want = J.tspm_forward(jx(params), {k: jnp.asarray(v) for k, v in batch.items()},
                          j_cfg)["out"]
    with torch.no_grad():
        got = model({k: t(v) for k, v in batch.items()}, aux=True)
    assert tuple(got["out"].shape) == (3, 7)
    assert tuple(got["topk_idx"].shape) == (3, 3)
    assert tuple(got["temporal_weights"].shape) == (3, 1, 8)
    close(got["out"], want)


def test_forward_full_width():
    """configs/tspm/vitl14.py's widths, T=60 frames of P=14 patches, B=2."""
    j_cfg, params, model = pair(FULL, seed=4)
    batch = make_batch(np.random.default_rng(8), 2, FULL, T=60, N=14)
    want = J.tspm_forward(jx(params), {k: jnp.asarray(v) for k, v in batch.items()},
                          j_cfg)["out"]
    with torch.no_grad():
        got = model({k: t(v) for k, v in batch.items()})["out"]
    assert tuple(got.shape) == (2, 42)
    close(got, want, FULL_TOL)


def test_token_ids_are_refused():
    j_cfg, params, model = pair()
    batch = make_batch(np.random.default_rng(9), 2)
    batch["quest"] = np.ones((2, 77), np.int64)
    with pytest.raises(NotImplementedError) as j_err:
        J.tspm_forward(jx(params), {k: jnp.asarray(v) for k, v in batch.items()}, j_cfg)
    with pytest.raises(NotImplementedError) as t_err:
        model({k: t(v) for k, v in batch.items()})
    assert str(t_err.value) == str(j_err.value) == P.TOKEN_IDS_REFUSED


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_time_indices_on_ties(dtype):
    """Rows with ties across the K-th place, all equal, and ties inside the
    top-K: the same indices as JAX's stable argsort, last K, sort; on a tie
    the higher frame wins the last slot."""
    rows = np.array([
        [0.1, 0.5, 0.5, 0.2, 0.5, 0.3],
        [0.25] * 6,
        [0.9, 0.1, 0.9, 0.1, 0.9, 0.1],
        [0.3, 0.30000001, 0.3, 0.2, 0.1, 0.3],
    ], np.float32)[:, None, :]
    for k in (1, 2, 3):
        want = np.asarray(J.topk_time_indices(jnp.asarray(rows, dtype), k))
        got = P.topk_time_indices(torch.tensor(rows).to(getattr(torch, dtype)), k).numpy()
        np.testing.assert_array_equal(got, want)
    assert P.topk_time_indices(torch.tensor(rows[1:2]), 2).tolist() == [[4, 5]]


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def runner_cfg(**hp):
    optim = dict(lr=LR, betas=(0.95, 0.999), weight_decay=0.0, encoder_lr=None)
    return {"log_interval": 1, "debug": False, "hyper_params": {"optim": optim, **hp}}


def train_batch(rng, b):
    batch = make_batch(rng, b)
    batch.update(label=rng.integers(0, 7, b).astype(np.int32),
                 qtype_label=rng.integers(0, 9, b).astype(np.int32), valid=np.ones(b, bool))
    return batch


class Loader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def set_epoch(self, epoch):
        pass


def test_train_step_matches_the_jax_runner():
    """One step from the same weights and batch, dropout off on both sides
    (the JAX runner's forward given no key): the loss at rtol 1e-5, and every
    parameter after Adam where its gradient is above 1e-6 (Adam's first step
    is lr * sign(g) there) at rtol 1e-5 / atol 1e-6."""
    j_cfg, params, _ = pair()
    batch = train_batch(np.random.default_rng(10), 4)

    def j_forward(p, b, cfg, train=False, rng=None):
        return J.tspm_forward(p, b, cfg, train=train, rng=None)

    cfg = Box(dict(type="tspm", debug=False, log_interval=1, epochs=1,
                   hyper_params=dict(model=dict(SMALL), optim=dict(
                       lr=LR, betas=(0.95, 0.999), weight_decay=0, encoder_lr=None))))
    j_runner = JAXRunner(cfg, j_cfg, J.tspm_init, j_forward, J.TSPM_FROZEN_PREFIXES,
                         mesh=make_mesh(1, devices=jax.devices("cpu")), seed=0,
                         init_params=params)
    losses = []

    class Writer:
        def add_scalar(self, tag, value, step):
            if tag == "train/loss/ce_loss":
                losses.append(float(value))

    j_runner.train_epoch(1, Loader([batch]), lr=LR, writer=Writer())
    want = nested_to_flat(jax.tree_util.tree_map(np.asarray, j_runner.trainable))

    port = AVQARunner(runner_cfg(), P.tspm_config(**SMALL), device="cpu", init_params=params)
    got_losses = port.train_step(batch, LR)
    np.testing.assert_allclose(got_losses["ce_loss"].item(), losses[0], rtol=1e-5)
    trained = dict(port.trainable())
    assert set(trained) == set(want) and len(trained) == len(port.params)
    compared = 0
    for name, p in trained.items():
        if p.grad is None:  # AV_Attn's two norms, which no forward reads
            np.testing.assert_array_equal(p.detach().numpy(), want[name], err_msg=name)
            continue
        keep = np.abs(p.grad.numpy()) > 1e-6
        if keep.any():
            np.testing.assert_allclose(p.detach().numpy()[keep], want[name][keep], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
            compared += 1
    assert compared > 40


def test_runner_has_no_tower(caplog, tmp_path):
    """TSPM has no frozen tower: every parameter trains, the question cache
    is skipped with the JAX runner's log lines, and CLIP text weights are
    read and left unused."""
    from qa_tiger_tpu_torch.models.clip_text import CLIPTextTower
    from qa_tiger_tpu_torch.training import save_checkpoint

    runner = AVQARunner(runner_cfg(), P.tspm_config(**SMALL), device="cpu", seed=0)
    assert len(runner.trainable()) == len(runner.params)

    class Dataset:
        tokenizer = None
        samples = []

    class Tokenizing(Dataset):
        tokenizer = staticmethod(lambda texts, truncate=True: np.zeros((len(texts), 77)))

    with caplog.at_level(logging.INFO, logger="AVQA"):
        assert runner.build_question_cache(Dataset()) is False
        assert runner.build_question_cache(Tokenizing()) is False
        tower = CLIPTextTower("ViT-B/32", torch.Generator().manual_seed(0))
        save_checkpoint(tower.state_dict(), tmp_path / "clip.npz")
        before = {k: v.clone() for k, v in runner.params.items()}
        runner.load_clip_text_weights(tmp_path / "clip.npz")
    text = caplog.text
    assert "question cache skipped: dataset serves precomputed question features" in text
    assert "question cache skipped: no frozen text tower" in text
    assert "(unused" in text and not runner._qst_caches
    assert all(torch.equal(before[k], v) for k, v in runner.params.items())


def test_steps_per_dispatch_matches_per_step():
    """K=2 (on the CPU the graph's static-input step runs eagerly, its
    dropout sites reseeded from the step stream) against K=1 over 5 batches
    with dropout on: the step stream, every parameter and Adam moment
    bitwise equal."""
    rng = np.random.default_rng(11)
    batches = [train_batch(rng, 4) for _ in range(5)]
    r1 = AVQARunner(runner_cfg(), P.tspm_config(**SMALL), device="cpu", seed=0)
    r2 = AVQARunner(runner_cfg(steps_per_dispatch=2), P.tspm_config(**SMALL), device="cpu",
                    seed=0)
    r1.train_epoch(1, Loader(batches), LR)
    r2.train_epoch(1, Loader(batches), LR)
    assert r2._step_graph is not None and len(r2._step_graph.sites[0]) == P.SITES
    assert torch.equal(r1._step_generator.get_state(), r2._step_generator.get_state())
    for (name, a), (_, b) in zip(r1.trainable(), r2.trainable()):
        assert torch.equal(a, b), name
        for key in ("exp_avg", "exp_avg_sq"):  # AV_Attn's unused norms have no state
            if key in r1.optimizer.state[a]:
                assert torch.equal(r1.optimizer.state[a][key], r2.optimizer.state[b][key])


def test_dropout_draws_from_the_generator():
    """Train mode with a generator: the same seed gives the same logits, a
    different one others, and no generator gives the eval function."""
    _, _, model = pair()
    batch = {k: t(v) for k, v in make_batch(np.random.default_rng(12), 3).items()}
    with torch.no_grad():
        a = model(batch, train=True, generator=torch.Generator().manual_seed(1))["out"]
        b = model(batch, train=True, generator=torch.Generator().manual_seed(1))["out"]
        c = model(batch, train=True, generator=torch.Generator().manual_seed(2))["out"]
        d = model(batch, train=True)["out"]
        e = model(batch)["out"]
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(d, e)


# ---------------------------------------------------------------------------
# the entry points that refuse TSPM, and bench
# ---------------------------------------------------------------------------

def tspm_serving_config(tmp_path):
    (tmp_path / "answer2idx.json").write_text(json.dumps({"ans2ix": {"yes": 0, "no": 1}}))
    return {"seed": 0, "data": {"root": str(tmp_path), "ans_quelen": "answer2idx.json"},
            "hyper_params": {"model_type": "TSPM_CLIP_ViT-L/14@336px", "platform": "cpu",
                             "model": {k: v for k, v in SMALL.items() if k != "num_labels"}}}


def test_predictor_and_serve_refuse_tspm(tmp_path):
    """The JAX entry point's error (``tspm_forward`` on token ids), raised
    as the model is built."""
    from qa_tiger_tpu_torch import serve
    from qa_tiger_tpu_torch.predict import Predictor

    cfg = tspm_serving_config(tmp_path)
    with pytest.raises(NotImplementedError) as err:
        Predictor(cfg, device="cpu")
    assert str(err.value) == P.TOKEN_IDS_REFUSED
    path = tmp_path / "tspm.py"
    path.write_text(f"config = {cfg!r}\n")
    with pytest.raises(NotImplementedError, match="precomputed question/prompt features"):
        serve.Service(serve.parse_args(["--config", str(path), "--batch-size", "2"]))


def test_bench_on_the_cpu(monkeypatch, capsys):
    """``bench --model tspm --device cpu`` at a tiny batch and frame count:
    one JSON line with the JAX script's keys, and the protocol's call
    count (one compiling call, the warm-up, the repeats)."""
    monkeypatch.setattr(bench, "BATCH", 2)
    monkeypatch.setattr(bench, "T", 4)
    monkeypatch.setattr(bench, "BENCH_ITERS", 2)
    calls = []
    forward = TSPM.forward
    monkeypatch.setattr(TSPM, "forward", lambda self, b, **kw: calls.append(1) or
                        forward(self, b, **kw))
    line = bench.main(["--model", "tspm", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line and line["metric"] == "tspm_qa_pairs_per_sec_per_chip"
    assert line["unit"] == "qa/s" and line["value"] > 0 and line["device"] == "cpu"
    assert len(calls) == 1 + bench.WARMUP_ITERS + bench.REPEATS * 2


# ---------------------------------------------------------------------------
# attention at head sizes 256 and 512
# ---------------------------------------------------------------------------

# TSPM's attention_wide calls at B=256: AV_Attn (both directions, 2B), the
# TokensAttn self-attention (B K), SpatioPerception's and the grounding's
# attn_ffn; and a 256-lane head over 577 keys
TSPM_CALLS = [((512, 60, 60), 1, 512), ((2560, 14, 14), 1, 512), ((2560, 1, 14), 4, 128),
              ((256, 1, 10), 4, 128), ((120, 577, 577), 4, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,heads,hd", TSPM_CALLS)
def test_wide_head_plan(dtype, shape, heads, hd):
    """The plan the card's dispatch follows (``qt::attention_plan``): the
    kernel, the head size it runs at and its shared memory, each under an
    H100's 232,448-byte opt-in limit. bf16 takes the tensor-core kernels at
    head sizes 256 and 512: the wide short one (a warp per problem, a
    two-stage ring of 64-lane Q and K slabs per warp: 36,864 bytes) at 14
    keys, the wide mma one (a two-stage ring of 64-lane slabs, 36,864 bytes;
    past 128 keys, in two passes, also p, 64 rows of Sk rounded up to 16
    plus 8) otherwise: 36,864 bytes at 60 keys, 113,664 at 577. fp32 takes
    the lane split's two 3xTF32 stages at 256 and 512 lanes (route tf32x3,
    two stages of 128 rows of 144 bytes: 36,864 bytes) at any length. The
    four-head calls (128 lanes, one query over 14 or 10 keys) take the
    short tensor-core kernel in bf16 and the keep-masked kernel without its
    keep mask in fp32 (a warp per problem, four a block: 101,376 bytes),
    with a mask or key bias too."""
    _, sq, sk = shape
    plan = A.attention_plan(dtype, sq, sk, hd)
    if hd == 128 and dtype == torch.float32:
        assert tuple(A.attention_plan(dtype, sq, sk, hd, has_bias=True)) == (
            "mma_nokeep", "mma_nokeep", 128, 4 * 4 * 3 * 16 * 132)
    want = {(torch.float32, 60, 512): ("tf32x3", "lane_split", 36_864),
            (torch.float32, 14, 512): ("tf32x3", "lane_split", 36_864),
            (torch.float32, 577, 256): ("tf32x3", "lane_split", 36_864),
            (torch.bfloat16, 60, 512): ("mma", "mma_wide", 36_864),
            (torch.bfloat16, 14, 512): ("mma_short", "mma_wide_short", 36_864),
            (torch.bfloat16, 577, 256): ("mma", "mma_wide", 113_664)}
    if hd == 128:
        want_plan = (("mma_short", "mma_short", 2 * 4 * 2 * 3 * 16 * 136)
                     if dtype == torch.bfloat16 else
                     ("mma_nokeep", "mma_nokeep", 4 * 4 * 3 * 16 * 132))
    else:
        want_plan = want[(dtype, sk, hd)]
    assert (plan.route, plan.kernel, plan.smem_bytes) == want_plan and plan.head == hd
    assert plan.smem_bytes <= 232_448 == A.H100_SMEM_OPTIN
    assert A._smem_bytes("staged", 60, 512) == 255_152 > A.H100_SMEM_OPTIN


def test_wide_head_plan_limits():
    """fp32 with a mask or key bias at 512 lanes keeps the FMA kernels: the
    staged kernel fits up to 54 keys, a smaller limit moves a call to the
    tiled kernels; past 512 lanes over many keys nothing fits and the error
    names the shape. In bf16 the wide mma
    kernel's p fits up to 1,520 keys (232,448 bytes); past that, or with a
    keep mask, the call takes the FMA wide-head kernel; a bf16 head between
    128 and 512 lanes runs zero-padded on the tensor-core kernels."""
    f32 = torch.float32
    assert A.attention_plan(f32, 60, 54, 512, has_bias=True).kernel == "staged"
    assert A.attention_plan(f32, 60, 55, 512, has_bias=True).kernel == "wide"
    assert A.attention_plan(f32, 60, 54, 512, limit=200_000, has_bias=True).kernel == "wide"
    assert A.attention_plan(f32, 60, 300, 200, has_bias=True) == ("fma", "wide", 256, 84_800)
    assert A.attention_plan(f32, 60, 300, 200) == ("tf32x3", "lane_split", 256, 36_864)
    assert A.attention_plan(torch.bfloat16, 60, 300, 100).head == 128
    with pytest.raises(ValueError, match=r"Sq=60, Sk=60, head size 1024"):
        A.attention_plan(torch.float32, 60, 60, 1024)
    bf = torch.bfloat16
    assert A.attention_plan(bf, 60, 1520, 512) == ("mma", "mma_wide", 512, 232_448)
    assert A.attention_plan(bf, 60, 1521, 512) == ("fma", "wide", 512, 99_904)
    assert A.attention_plan(bf, 577, 577, 256, limit=100_000) == ("fma", "wide", 256, 84_800)
    assert A.attention_plan(bf, 60, 60, 512, has_keep=True) == ("fma", "wide", 512, 99_904)
    assert A.attention_plan(bf, 14, 14, 512, has_keep=True) == ("fma", "staged", 512, 65_816)
    assert A.attention_plan(bf, 60, 300, 200) == ("mma", "mma_wide", 256, 76_800)
    assert A.attention_plan(bf, 14, 14, 200) == ("mma_short", "mma_wide_short", 256, 36_864)
    assert A.attention_plan(bf, 1, 60, 300) == ("mma", "mma_wide", 512, 36_864)
    assert A.attention_plan(bf, 60, 128, 512) == ("mma", "mma_wide", 512, 36_864)
    assert A.attention_plan(bf, 60, 129, 512) == ("mma", "mma_wide", 512, 56_320)
    assert A.attention_plan(bf, 1, 1, 512) == ("mma_short", "mma_wide_short", 512, 36_864)
    with pytest.raises(ValueError, match=r"Sq=60, Sk=60, head size 1024"):
        A.attention_plan(bf, 60, 60, 1024)


# the plans of head sizes 32, 64 and 128 (and 48, which runs at its own size
# or padded to 64), pinned: the QA-TIGER, raw-media and op-level paths' bf16
# calls keep the kernels they had before the wide-head tensor-core kernels,
# but past 128 keys at head size 64, which take the Hopper kernel
# ("mma_sm90": 128 query rows, Q twice, 5 K and 3 V stages of 16 KB);
# fp32 calls with a mask or a key bias take the keep-masked kernel without
# its keep multiply up to 128 keys and its key-tiled form past them
# (128 query rows, two stages of 64 K and 64 V rows, rows of hd + 4 floats)
PINNED_PLANS = [
    ("bfloat16", 1, 2, 32, ("mma_short", "mma_short", 32, 30720)),
    ("bfloat16", 16, 17, 32, ("mma", "mma", 32, 25600)),
    ("bfloat16", 1, 60, 32, ("fma", "staged", 32, 17072)),
    ("bfloat16", 577, 577, 32, ("mma", "mma", 32, 25600)),
    ("bfloat16", 14, 14, 64, ("mma_short", "mma_short", 64, 55296)),
    ("bfloat16", 60, 77, 64, ("mma", "mma", 64, 46080)),
    ("bfloat16", 1, 60, 64, ("fma", "staged", 64, 32944)),
    ("bfloat16", 60, 15, 64, ("fma", "staged", 64, 9004)),
    ("bfloat16", 577, 577, 64, ("wgmma", "mma_sm90", 64, 167584)),
    ("bfloat16", 1, 2, 128, ("mma_short", "mma_short", 128, 104448)),
    ("bfloat16", 16, 17, 128, ("mma", "mma", 128, 87040)),
    ("bfloat16", 1, 60, 128, ("fma", "staged", 128, 64688)),
    ("bfloat16", 60, 15, 128, ("fma", "staged", 128, 17708)),
    ("bfloat16", 577, 577, 128, ("mma", "mma", 128, 87040)),
    ("bfloat16", 60, 77, 48, ("fma", "staged", 48, 31876)),
    ("bfloat16", 577, 577, 48, ("wgmma", "mma_sm90", 64, 167584)),
    ("float32", 14, 14, 32, ("mma_nokeep", "mma_nokeep", 32, 27648)),
    ("float32", 577, 577, 32, ("mma_nokeep", "mma_nokeep_tiled", 32, 55296)),
    ("float32", 60, 77, 64, ("mma_nokeep", "mma_nokeep", 64, 60928)),
    ("float32", 577, 577, 64, ("mma_nokeep", "mma_nokeep_tiled", 64, 104448)),
    ("float32", 1, 60, 128, ("mma_nokeep", "mma_nokeep", 128, 76032)),
    ("float32", 60, 77, 128, ("mma_nokeep", "mma_nokeep", 128, 118272)),
    ("float32", 577, 577, 128, ("mma_nokeep", "mma_nokeep_tiled", 128, 202752)),
    ("float32", 577, 577, 48, ("mma_nokeep", "mma_nokeep_tiled", 64, 104448)),
]
# the same calls without a mask or a key bias where that changes the plan:
# the keep-masked kernel without its keep multiply, every fp32 call at 32,
# 64 and 128 lanes over at most 128 keys and bf16's one query over more
# than 16 keys (shared memory: 16 query rows, or 64, and the keys' k and v
# rows of hd lanes plus 16 bytes; four 16-row problems at 14 x 14)
NOKEEP_PLANS = {
    ("bfloat16", 1, 60, 32): ("mma_nokeep", "mma_nokeep", 32, 11520),
    ("bfloat16", 1, 60, 64): ("mma_nokeep", "mma_nokeep", 64, 20736),
    ("bfloat16", 1, 60, 128): ("mma_nokeep", "mma_nokeep", 128, 39168),
    ("float32", 14, 14, 32): ("mma_nokeep", "mma_nokeep", 32, 27648),
    ("float32", 60, 77, 64): ("mma_nokeep", "mma_nokeep", 64, 60928),
    ("float32", 1, 60, 128): ("mma_nokeep", "mma_nokeep", 128, 76032),
    ("float32", 60, 77, 128): ("mma_nokeep", "mma_nokeep", 128, 118272),
}


@pytest.mark.parametrize("dtype,sq,sk,hd,want", PINNED_PLANS)
def test_plan_head_sizes_up_to_128_pinned(dtype, sq, sk, hd, want):
    """Head sizes up to 128 plan as PINNED_PLANS says when the call adds a
    mask or a key bias; without either, as NOKEEP_PLANS says where that
    differs; with a keep mask those of 32, 64 and 128 lanes over at most
    128 keys take the keep-masked tensor-core kernel, every other an FMA
    kernel."""
    dt = getattr(torch, dtype)
    assert tuple(A.attention_plan(dt, sq, sk, hd, has_bias=True)) == want
    assert tuple(A.attention_plan(dt, sq, sk, hd)) == NOKEEP_PLANS.get((dtype, sq, sk, hd), want)
    keep_route = "mma_keep" if hd in (32, 64, 128) and sk <= 128 else "fma"
    assert A.attention_plan(dt, sq, sk, hd, has_keep=True).route == keep_route


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape,heads", [((2, 60, 60, 512), 1), ((3, 14, 14, 512), 1),
                                         ((2, 20, 140, 512), 2)])
def test_wide_head_plain_against_pallas(dtype, masked, shape, heads):
    """The plain version the card's wide-head kernel is held to against the
    Pallas op (``fused_attention_wide`` in interpret mode) at TSPM's head
    sizes, with a mask and a key bias or neither. fp32 at rtol 1e-5 /
    atol 1e-6 (summation order); bf16 within one bf16 step of the context
    (2e-2 relative), the probabilities rounded at the same point on both
    sides."""
    B, sq, sk, W = shape
    rng = np.random.default_rng(sq + sk)
    q, k, v = rn(rng, B, sq, W), rn(rng, B, sk, W), rn(rng, B, sk, W)
    mask = kb = None
    if masked:
        mask = np.where(rng.random((sq, sk)) < 0.2, -1e9, 0.0).astype(np.float32)
        kb = np.log(rng.integers(1, 9, (B, sk))).astype(np.float32)
    scale = (W // heads) ** -0.5
    jd = jnp.dtype(dtype)
    want = j_attention.attention_wide(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)),
        None if mask is None else jnp.asarray(mask), scale, heads, interpret=True,
        key_bias=None if kb is None else jnp.asarray(kb))
    td = getattr(torch, dtype)
    got = A.attention_wide(*(t(a).to(td) for a in (q, k, v)), None if mask is None else t(mask),
                           scale, heads, key_bias=None if kb is None else t(kb))
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


# the edges of the wide tensor-core kernels, bf16 (B, Sq, Sk, W, heads): one
# and two 64-key tiles and past them (the mma kernel's one pass ends at 128
# keys), the short kernel's 16 and one past it, one query, and a head of 200
# lanes that the card pads to 256
WIDE_TC_EDGES = ([(2, 17, sk, 512, h) for h in (1, 2) for sk in (16, 17, 64, 65, 128, 129)]
                 + [(3, 1, sk, 512, h) for h in (1, 2) for sk in (14, 60, 129)]
                 + [(2, 16, 16, 512, 1), (2, 20, 65, 400, 2), (3, 14, 14, 400, 2)])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", WIDE_TC_EDGES)
def test_wide_head_tc_edges_plain_against_pallas(masked, shape):
    """The plain version the card's wide tensor-core kernels are held to
    against the Pallas op (``fused_attention_wide`` in interpret mode) at
    their edges, bf16, with a mask and a key bias or neither, at the
    tolerance of ``test_wide_head_plain_against_pallas`` (one bf16 step of
    the context, 2e-2 relative); and the plan each shape takes on the card
    (the wide short kernel at most 16 queries and keys, the wide mma kernel
    otherwise)."""
    B, sq, sk, W, heads = shape
    hd = W // heads
    plan = A.attention_plan(torch.bfloat16, sq, sk, hd)
    assert plan.kernel == ("mma_wide_short" if sq <= 16 and sk <= 16 else "mma_wide")
    assert plan.head == (256 if hd <= 256 else 512)
    rng = np.random.default_rng(1000 * sq + sk + W + heads)
    q, k, v = rn(rng, B, sq, W), rn(rng, B, sk, W), rn(rng, B, sk, W)
    mask = kb = None
    if masked:
        mask = np.where(rng.random((sq, sk)) < 0.2, -1e9, 0.0).astype(np.float32)
        kb = np.log(rng.integers(1, 9, (B, sk))).astype(np.float32)
    scale = hd ** -0.5
    want = j_attention.attention_wide(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        None if mask is None else jnp.asarray(mask), scale, heads, interpret=True,
        key_bias=None if kb is None else jnp.asarray(kb))
    got = A.attention_wide(*(t(a).to(torch.bfloat16) for a in (q, k, v)),
                           None if mask is None else t(mask), scale, heads,
                           key_bias=None if kb is None else t(kb))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# annotations -> text features -> train -> test
# ---------------------------------------------------------------------------

def test_cli_over_extracted_features(tmp_path, monkeypatch):
    """The ``questions`` and ``prompts`` stages (a 2-block text tower,
    random weights) write each split's features; ``train`` runs one epoch
    of TSPM on them with the question cache asked for (and skipped: no
    tower), and ``test`` on its best.npz gives the train run's final test
    accuracy."""
    from torch_corpus import val_questions, write_corpus, write_merges

    from qa_tiger_tpu_torch import test as t_test
    from qa_tiger_tpu_torch import train as t_train
    from qa_tiger_tpu_torch.models import clip_text
    from qa_tiger_tpu_torch.pipeline import extract as E

    monkeypatch.setitem(clip_text.CLIP_TEXT_CONFIGS, "tiny-tspm",
                        dict(width=32, heads=4, layers=2, embed_dim=32))
    splits = {"train": (0, 24), "val": (24, 32), "test": (32, 40)}
    data = write_corpus(tmp_path / "data", splits,
                        {"vggish": (12, 16), "clip": (12, 24), "tome": (12, 4, 20)})
    write_merges(tmp_path / "vocab.txt.gz", [q["question_content"] for q in val_questions()[:40]])
    monkeypatch.setenv("QA_TIGER_BPE_VOCAB", str(tmp_path / "vocab.txt.gz"))
    for split in splits:
        for stage, sub in (("questions", "qst"), ("prompts", "prompt")):
            E.main([stage, "--annot", str(data / f"{split}.json"), "--dst", str(data / sub),
                    "--encoder", "tiny-tspm", "--random-weights", "--device", "cpu"])
    assert len(list((data / "qst").iterdir())) == len(list((data / "prompt").iterdir())) == 40
    config = dict(
        type="tspm", seed=1, epochs=1, num_labels=42, log_interval=100,
        output_dir=str(tmp_path / "out"), weight="",
        data=dict(root=str(data), batch_size=8, eval_batch_size=8, num_workers=0,
                  frame_sample_rate=1, train_annot="train.json", valid_annot="val.json",
                  test_annot="test.json", test_annots=None, ans_quelen="answer2idx.json",
                  audio_feat="vggish", video_feat="clip", patch_feat="tome", quest_feat="qst",
                  prompt_feat="prompt"),
        hyper_params=dict(
            gpus="0", platform="cpu", cache_qst_features=True, model_type="TSPM_test",
            model=dict(topK=3, audio_dim=16, vis_dim=24, patch_dim=20, qst_dim=32,
                       hidden_size=32),
            optim=dict(lr=1e-3, encoder_lr=None, min_lr=1e-7, weight_decay=0,
                       betas=(0.95, 0.999)),
            sched=dict(name="StepLR", mode="min", gamma=0.1, step_size=8, factor=0.5,
                       patience=5, verbose=True, warmup_epochs=1)))
    path = tmp_path / "tspm.py"
    path.write_text(f"config = {config!r}\n")
    summary = t_train.main(["--config", str(path)])
    assert summary["epochs"][0]["steps"] == 3 and summary["question_caches"] == 0
    run = Path(summary["run_dir"])
    with np.load(run / "best.npz") as ckpt:
        assert set(ckpt.files) == set(TSPM(P.tspm_config(**config["hyper_params"]["model"])
                                           ).state_dict())
    accs = t_test.main(["--config", str(path), "--weight", str(run / "best.npz"),
                        "--output_path", str(tmp_path / "eval")])
    assert accs == summary["tests"] and (tmp_path / "eval" / "best_result.txt").exists()
