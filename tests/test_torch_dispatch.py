"""``hyper_params.steps_per_dispatch`` of the port's runner, on the CPU.

The port's counterpart of the JAX runner's K-step dispatch is a CUDA graph
of the whole train step (``training/step_graph.py``); the CPU has no graphs
and runs the same static-input step eagerly, which is what these tests
drive. Against the port's own K=1 run: the same ``_step_generator`` state,
bitwise equal parameters and Adam moments, the same logged (tag, step,
value) lists, as JAX's ``TestMultiStepDispatch::test_matches_per_step_path``
asks of the JAX runner (which allows rtol 2e-4 there; the port's CPU path is
bitwise). Against the JAX runner's own K=2 window with dropout off: the
logged losses and the parameters (where the last gradient is above 1e-6,
as ``test_train_step_matches_jax`` compares them) at rtol 2e-4 / atol 2e-5,
JAX's K-window tolerance. Also: persistent reseeded site generators against
``split_generator``, the graph dropped by ``load_params`` and
``restore_train_state``, ``debug`` and ``profile_dir`` forcing K=1 (and the
trace written), the per-replay launch counting of ``StepGraph`` on a fake
step with a fake graph, and ``bench_train --device cpu``.
"""
import contextlib
import json

import jax
import numpy as np
import pytest
import torch

from qa_tiger_tpu.models import clip_text as j_clip_text
from qa_tiger_tpu.models.qa_tiger import FROZEN_PREFIXES as J_FROZEN
from qa_tiger_tpu.models.qa_tiger import qa_tiger_config as j_config
from qa_tiger_tpu.models.qa_tiger import qa_tiger_forward, qa_tiger_init
from qa_tiger_tpu.parallel import make_mesh
from qa_tiger_tpu.training.loop import AVQARunner as JAXRunner
from qa_tiger_tpu.utils import Box
from qa_tiger_tpu_torch import bench_train, ops
from qa_tiger_tpu_torch.convert import nested_to_flat
from qa_tiger_tpu_torch.models import clip_text as t_clip_text
from qa_tiger_tpu_torch.models import qa_tiger_config
from qa_tiger_tpu_torch.models.qa_tiger import QATiger, split_generator
from qa_tiger_tpu_torch.ops.gemm import tally_routes
from qa_tiger_tpu_torch.training import AVQARunner
from qa_tiger_tpu_torch.training import loop as t_loop
from qa_tiger_tpu_torch.training.step_graph import StepGraph, site_seeds

TOWER = "tiny-dispatch"
TINY_TOWER = dict(width=64, heads=4, layers=2, embed_dim=64)
TOY = dict(d_model=32, video_dim=64, patch_dim=48, audio_dim=16, topK=2, num_experts=4,
           num_labels=42, encoder_type=TOWER)
VOCAB, CTX, T, P = 49408, 77, 6, 4
LR = 1e-3
# JAX's own K-window tolerance (tests/test_training.py TestMultiStepDispatch)
WINDOW_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def tower(monkeypatch):
    monkeypatch.setitem(j_clip_text.CLIP_TEXT_CONFIGS, TOWER, TINY_TOWER)
    monkeypatch.setitem(t_clip_text.CLIP_TEXT_CONFIGS, TOWER, TINY_TOWER)


def make_batch(rng, b):
    quest = np.zeros((b, CTX), dtype=np.int64)
    for i in range(b):
        n = int(rng.integers(5, 20))
        quest[i, 0] = VOCAB - 2
        quest[i, 1:n] = rng.integers(1, VOCAB - 2, n - 1)
        quest[i, n] = VOCAB - 1
    return {"quest": quest,
            "audio": rng.standard_normal((b, T, TOY["audio_dim"])).astype(np.float32),
            "video": rng.standard_normal((b, T, TOY["video_dim"])).astype(np.float32),
            "patch": rng.standard_normal((b, T, P, TOY["patch_dim"])).astype(np.float32),
            "label": rng.integers(0, 42, b).astype(np.int32),
            "qtype_label": rng.integers(0, 9, b).astype(np.int32),
            "valid": np.ones(b, bool),
            "ds_idx": np.arange(b, dtype=np.int32)}


def runner_cfg(k=1, log_interval=3, **top):
    optim = dict(lr=LR, betas=(0.95, 0.999), weight_decay=0.0, encoder_lr=None,
                 grad_accum=top.pop("grad_accum", 1))
    return {"log_interval": log_interval, "debug": False, **top,
            "hyper_params": {"optim": optim, "steps_per_dispatch": k}}


def runner(k=1, init_params=None, **top):
    return AVQARunner(runner_cfg(k, **top), qa_tiger_config(**TOY), device="cpu", seed=0,
                      init_params=init_params)


class Loader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def set_epoch(self, epoch):
        pass


class Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, int(step), float(value)))


def run_epoch(r, batches):
    writer = Writer()
    r.train_epoch(1, Loader(batches), LR, writer)
    return writer.scalars


def assert_same_state(a, b):
    assert torch.equal(a._step_generator.get_state(), b._step_generator.get_state())
    for (name, pa), (_, pb) in zip(a.trainable(), b.trainable()):
        assert torch.equal(pa, pb), name
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[key], sb[key]), (name, key)


@pytest.mark.parametrize("k", [2, 3])
def test_window_matches_per_step_path(tower, monkeypatch, k):
    """7 batches at log_interval 3, the last one short: a log-boundary
    flush at batch 0, full and partial windows, the tail, and one batch of
    other shapes through the eager step. The step generator, every
    parameter and Adam moment bitwise as the K=1 run's, and the writer's
    (tag, step, value) lists identical."""
    rng = np.random.default_rng(21)
    batches = [make_batch(rng, 4) for _ in range(6)] + [make_batch(rng, 3)]
    calls = []
    step_graph_call = StepGraph.__call__
    monkeypatch.setattr(StepGraph, "__call__",
                        lambda self, b, g: calls.append(1) or step_graph_call(self, b, g))
    r1, rk = runner(1), runner(k)
    w1 = run_epoch(r1, batches)
    assert not calls and r1._step_graph is None
    wk = run_epoch(rk, batches)
    assert len(calls) == 6  # the short batch took the eager step
    assert_same_state(r1, rk)
    assert wk == w1 and len(w1) == 7 * 2


def test_window_matches_the_jax_runner(tower, monkeypatch):
    """The port's K=2 against the JAX runner's K=2 (one scanned call per
    window) over 5 batches from the same weights, dropout off on both
    sides: every logged loss, and every trainable parameter where its last
    gradient is above 1e-6, at rtol 2e-4 / atol 2e-5."""
    params = jax.tree_util.tree_map(
        np.asarray, qa_tiger_init(jax.random.PRNGKey(0), j_config(**TOY)))
    rng = np.random.default_rng(5)
    batches = [make_batch(rng, 4) for _ in range(5)]

    def jax_forward(p, batch, cfg, train=False, rng=None):
        return qa_tiger_forward(p, batch, cfg, train=train, rng=None)

    cfg = Box(dict(type="qa-tiger", debug=False, log_interval=3, epochs=1,
                   hyper_params=dict(model=dict(TOY), steps_per_dispatch=2,
                                     optim=dict(lr=LR, betas=(0.95, 0.999), weight_decay=0,
                                                encoder_lr=None))))
    j_runner = JAXRunner(cfg, j_config(**TOY), qa_tiger_init, jax_forward, J_FROZEN,
                         mesh=make_mesh(1, devices=jax.devices("cpu")), seed=0,
                         init_params=params)
    j_writer = Writer()
    j_runner.train_epoch(1, Loader(batches), lr=LR, writer=j_writer)

    forward = QATiger.forward
    monkeypatch.setattr(QATiger, "forward",
                        lambda self, batch, train=False, generator=None, sites=None:
                        forward(self, batch, train=train))
    port = runner(2, init_params=params)
    t_scalars = run_epoch(port, batches)

    assert [(tag, step) for tag, step, _ in t_scalars] == \
        [(tag, step) for tag, step, _ in j_writer.scalars]
    np.testing.assert_allclose([v for *_, v in t_scalars], [v for *_, v in j_writer.scalars],
                               **WINDOW_TOL)
    want = nested_to_flat(jax.tree_util.tree_map(np.asarray, j_runner.trainable))
    trained = dict(port.trainable())
    assert set(trained) == set(want)
    compared = 0
    for name, p in trained.items():
        # where the last step's gradient is above 1e-6, as
        # test_train_step_matches_jax compares: Adam turns a structurally
        # zero gradient's fp noise (the key biases') into steps of either sign
        keep = np.abs(p.grad.numpy()) > 1e-6
        if keep.any():
            np.testing.assert_allclose(p.detach().numpy()[keep], want[name][keep],
                                       err_msg=name, **WINDOW_TOL)
            compared += 1
    assert compared > 50


@pytest.mark.parametrize("accum", [1, 2])
def test_reseeded_site_generators_equal_split_generator(tower, accum):
    """A step whose dropout sites draw from persistent generators, used
    once before and reseeded with ``site_seeds``, equals ``train_step``
    through ``split_generator``, bitwise; both leave the stream in the same
    state."""
    batch = make_batch(np.random.default_rng(3), 4)
    a, b = runner(grad_accum=accum), runner(grad_accum=accum)
    gen_a, gen_b = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    la = a.train_step(batch, LR, gen_a)
    sites = [[torch.Generator() for _ in range(6)] for _ in range(accum)]
    for gens in sites:
        for g in gens:
            torch.rand(5, generator=g)  # persistent: already drawn from
    for gens, row in zip(sites, site_seeds(gen_b, accum, torch.device("cpu"))):
        for g, seed in zip(gens, row):
            g.manual_seed(seed)
    t_loop.set_lr(b.optimizer, LR)
    lb = b._step(b._device_batch(batch), sites=sites)
    assert torch.equal(gen_a.get_state(), gen_b.get_state())
    for key in la:
        assert torch.equal(la[key], lb[key]), key
    for (name, pa), (_, pb) in zip(a.trainable(), b.trainable()):
        assert torch.equal(pa, pb), name


def test_site_seeds_follow_the_eager_draw_order():
    """With accum > 1 the stream is split per microbatch first, then each
    microbatch generator gives the six site seeds."""
    gen, ref = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    got = site_seeds(gen, 2, torch.device("cpu"))
    want = [torch.randint(0, 2 ** 62, (6,), generator=g).tolist()
            for g in split_generator(ref, 2, torch.device("cpu"))]
    assert got == want and torch.equal(gen.get_state(), ref.get_state())


def test_load_params_and_restore_drop_the_step_graph(tower):
    """A step graph is made at the first window and dropped by
    ``load_params`` and ``restore_train_state`` (each replaces Adam's
    state); the next window makes a new one. The train state holds Adam in
    its eager form, and the CPU runner keeps that form."""
    r = runner(2)
    staged = r.stage_batch(make_batch(np.random.default_rng(4), 4))
    r.train_window([staged], LR)
    first = r._step_graph
    assert first is not None
    r.load_params(r.params)
    assert r._step_graph is None
    r.train_window([staged, staged], LR)
    assert r._step_graph is not None and r._step_graph is not first
    state = r.train_state()
    assert all(isinstance(g["lr"], float) and not g["capturable"]
               for g in state["opt_state"]["param_groups"])
    r.restore_train_state(state)
    assert r._step_graph is None
    assert all(isinstance(g["lr"], float) and not g["capturable"]
               for g in r.optimizer.param_groups)


@pytest.mark.parametrize("mode", ["debug", "profile_dir", "env"])
def test_debug_and_profile_dir_force_one_step_per_batch(tower, monkeypatch, tmp_path, mode):
    """``debug`` and a profile directory (config key or
    ``QA_TIGER_PROFILE_DIR``) keep K=1: no step graph is made and the
    parameters are the K=1 run's; the profile run writes a Chrome trace of
    steps 1-3 of epoch 1."""
    top = {"debug": True} if mode == "debug" else {}
    if mode == "profile_dir":
        top["profile_dir"] = str(tmp_path)
    if mode == "env":
        monkeypatch.setenv("QA_TIGER_PROFILE_DIR", str(tmp_path))
    rng = np.random.default_rng(6)
    batches = [make_batch(rng, 4) for _ in range(5)]
    rk, r1 = runner(2, **top), runner(1)
    run_epoch(rk, batches)
    monkeypatch.delenv("QA_TIGER_PROFILE_DIR", raising=False)
    run_epoch(r1, batches)
    assert rk._step_graph is None
    assert_same_state(r1, rk)
    trace = tmp_path / t_loop.TRACE_FILE
    if mode == "debug":
        assert not trace.exists()
    else:
        events = json.loads(trace.read_text())["traceEvents"]
        assert any("aten::" in str(e.get("name", "")) for e in events)


class FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: a replay runs no
    Python, as a real replay runs none."""

    def __init__(self):
        self.generators, self.replays = [], 0

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def replay(self):
        self.replays += 1


class FakeStream:
    def wait_stream(self, other):
        pass


def test_step_graph_counts_each_replay_once(monkeypatch):
    """On a fake step that counts launches as the kernel wrappers do, with
    a fake graph: the warm-up counts its launches, the capture's are taken
    off again, and each replay adds one step's launches and GEMM routes, so
    that five calls count as five eager steps."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: FakeStream())

    def fake_step(batch, sites):
        ops.fused_avq_train.launches += 1
        tally_routes(ops.fused_avq_train, ["tf32x3"] * 10)
        ops.fused_gaussian_moe.launches += 2
        tally_routes(ops.fused_gaussian_moe, ["wgmma", "tf32x3"] * 2)
        return {"total_loss": batch["x"].sum() + torch.rand((), generator=sites[0][0])}

    ops.reset_launches()
    batch = {"x": torch.ones(3)}
    graph = StepGraph(fake_step, batch, accum=1, device=torch.device("cpu"), capture=True)
    gen = torch.Generator().manual_seed(0)
    losses = [graph(batch, gen) for _ in range(5)]
    assert graph.graph.replays == 4 and len(graph.graph.generators) == 6
    assert graph.delta == {"fused_avq_train": (1, {"tf32x3": 10}),
                           "fused_gaussian_moe": (2, {"wgmma": 2, "tf32x3": 2})}
    counts = ops.launch_counts()
    assert counts["fused_avq_train"] == 5 and counts["fused_gaussian_moe"] == 10
    assert sum(counts.values()) == 15
    assert ops.fused_avq_train.gemm_routes == {"tf32x3": 50}
    assert ops.fused_gaussian_moe.gemm_routes == {"wgmma": 10, "tf32x3": 10}
    assert all(torch.is_tensor(x["total_loss"]) for x in losses)
    ops.reset_launches()


@pytest.mark.parametrize("flags,metric", [
    ([], "train_steps_per_sec_b2"),
    (["--steps-per-dispatch", "2", "--cache-qst", "--accum", "2"],
     "train_steps_per_sec_b2_accum2_cacheqst_spd2"),
])
def test_bench_train_on_the_cpu(tower, monkeypatch, capsys, tmp_path, flags, metric):
    """``python -m qa_tiger_tpu_torch.bench_train --device cpu`` at a tiny
    config prints one JSON line with the JAX script's keys (and the
    device's name), and ``--trace`` writes its trace."""
    monkeypatch.setattr(bench_train, "MODEL", dict(TOY))
    monkeypatch.setattr(bench_train, "T", T)
    monkeypatch.setattr(bench_train, "P", P)
    line = bench_train.main(["--device", "cpu", "--batch", "2", "--iters", "2", "--repeats",
                             "1", "--trace", str(tmp_path), *flags])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert set(line) == {"metric", "value", "unit", "qa_pairs_per_sec", "step_ms", "device"}
    assert line["metric"] == metric and line["unit"] == "steps/s" and line["device"] == "cpu"
    assert line["value"] > 0 and line["qa_pairs_per_sec"] == pytest.approx(2 * line["value"])
    assert (tmp_path / "bench_train.json").exists()
