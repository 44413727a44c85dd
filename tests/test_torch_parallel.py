"""Data parallelism of the port (``qa_tiger_tpu_torch.parallel``), on the
CPU over gloo.

Ranks are fresh processes (``tests/torch_dp.py``: ``torch.multiprocessing``
spawn, a ``file://`` store) at a tiny config over real MUSIC-AVQA questions
with synthetic features. They are held against the JAX runner on a
2-device CPU mesh (``tests/conftest.py`` gives JAX 8 CPU devices), which
shards each global batch over its ``data`` axis:

(a) ``train.make_loaders`` per rank against ``src/train.py``'s under a
    simulated 2-process world: the per-rank batch size, disjoint and
    complete shards; at N=17 and 4 rows per rank every rank takes 3 steps
    (the JAX loader gives 3 and 2), the short shard's last batch all
    padding;
(b) one epoch (3 steps, the last a tail batch whose ranks hold 2 and 1
    valid rows), fp32, dropout off, ``gather_mode="paper"``, with
    ``grad_accum`` 1 and 2: the logged losses and the parameters against
    the JAX runner's at rtol 2e-4 / atol 2e-5 (the single-process
    train-parity tolerance of ``tests/test_torch_dispatch.py``), the ranks
    bitwise equal to each other;
(c) the all-reduced eval counters and loss against the JAX runner's
    ``_run_eval`` over the whole split (17 questions: a rank's last batch
    is all padding): counters exactly, the loss at rtol 1e-5;
(d) ``gather_mode="reference"``: each rank's logits are a single-process
    forward of its own shard (the batch-rotated gather rotates within the
    shard), which differ from the global batch's;
(e) ``torch.distributed.run --nproc-per-node 2`` of the train and test
    entry points (``platform='cpu'``): one run directory, one
    ``best.npz``, one report, accuracies equal to a single-process test of
    that ``best.npz``; a ``resume`` under ``--distributed`` restores the
    same state on both ranks;
(f) ``steps_per_dispatch`` 2 under gloo: a capturing step graph raises,
    naming the backend; the eager static-input step runs;
and at world 1 (a one-rank gloo group in this process) the train step,
dropout on, is bitwise the single process's.
"""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dp
from qa_tiger_tpu.data import AVQADataset as JDataset
from qa_tiger_tpu.data import BatchLoader as JBatchLoader
from qa_tiger_tpu.models import clip_text as j_clip_text
from qa_tiger_tpu.models.qa_tiger import FROZEN_PREFIXES as J_FROZEN
from qa_tiger_tpu.models.qa_tiger import qa_tiger_config as j_config
from qa_tiger_tpu.models.qa_tiger import qa_tiger_forward, qa_tiger_init
from qa_tiger_tpu.parallel import make_mesh
from qa_tiger_tpu.training.loop import AVQARunner as JAXRunner
from qa_tiger_tpu.utils import Box as JBox
from qa_tiger_tpu_torch import test as t_test
from qa_tiger_tpu_torch import train as t_train
from qa_tiger_tpu_torch.convert import nested_to_flat
from qa_tiger_tpu_torch.data import AVQADataset, BatchLoader
from qa_tiger_tpu_torch.models import clip_text as t_clip_text
from qa_tiger_tpu_torch.models import qa_tiger_config
from qa_tiger_tpu_torch.training import AVQARunner
from qa_tiger_tpu_torch.utils import Box
from torch_corpus import val_questions, write_config, write_corpus, write_merges

REPO = Path(__file__).resolve().parents[1]
TINY = dict(d_model=32, video_dim=32, patch_dim=24, audio_dim=16, topK=2, num_experts=4,
            encoder_type="tiny-test")
DIMS = {"vggish": (12, 16), "clip": (12, 32), "tome": (12, 4, 24)}
SPLITS = {"train": (0, 19), "train17": (0, 17), "val": (19, 35), "test": (35, 52)}
LR = 1e-3
# the single-process train-parity tolerance of several steps against the
# JAX runner (tests/test_torch_dispatch.py WINDOW_TOL)
TRAIN_TOL = dict(rtol=2e-4, atol=2e-5)
REPORT = re.compile(r"\]:(Test .* accuracy: .*)$")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    write_corpus(root / "data", SPLITS, DIMS)
    write_merges(root / "vocab.txt.gz", [q["question_content"] for q in val_questions()], 300)
    return root


@pytest.fixture(autouse=True)
def _tiny(corpus, monkeypatch):
    monkeypatch.setitem(t_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", torch_dp.TINY_TOWER)
    monkeypatch.setitem(j_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", torch_dp.TINY_TOWER)
    monkeypatch.setenv("QA_TIGER_BPE_VOCAB", str(corpus / "vocab.txt.gz"))


def cfg_dict(corpus, train_annot="train.json", grad_accum=1) -> dict:
    return dict(
        type="qa-tiger", mode="train", debug=False, log_interval=100, epochs=1, seed=7,
        num_labels=42,
        data=dict(root=str(corpus / "data"), frame_sample_rate=1, batch_size=8,
                  eval_batch_size=8, train_annot=train_annot, valid_annot="val.json",
                  test_annot="test.json", ans_quelen="answer2idx.json", audio_feat="vggish",
                  video_feat="clip", patch_feat="tome", quest_feat=None, prompt_feat=None),
        hyper_params=dict(
            model=dict(TINY),
            optim=dict(lr=LR, betas=(0.95, 0.999), weight_decay=0, encoder_lr=None,
                       grad_accum=grad_accum),
            sched=dict(name="StepLR", step_size=8, gamma=0.1, mode="min", factor=0.5,
                       patience=5)))


def jax_params(gather_mode):
    params = qa_tiger_init(jax.random.PRNGKey(0), j_config(num_labels=42, gather_mode=gather_mode,
                                                          **TINY))
    return jax.tree_util.tree_map(np.asarray, params)


# dropout "off" with the train kernels' masked path on: keep rounds to 1.0,
# so every mask is all ones (the ranks also set modules.ATTN_DROPOUT to 0)
DROPOUT_OFF = 1e-300


def port_model_cfg(gather_mode="paper", dropout=DROPOUT_OFF):
    return {**qa_tiger_config(num_labels=42, gather_mode=gather_mode, **TINY),
            "dropout": dropout}


def jax_runner(cfg, params, gather_mode="paper"):
    def forward(p, batch, mcfg, train=False, rng=None):  # dropout off
        return qa_tiger_forward(p, batch, mcfg, train=train, rng=None)

    return JAXRunner(JBox(cfg), j_config(num_labels=42, gather_mode=gather_mode, **TINY),
                     qa_tiger_init, forward, J_FROZEN,
                     mesh=make_mesh(2, devices=jax.devices("cpu")), seed=0, init_params=params)


def load_src(name):
    spec = importlib.util.spec_from_file_location(f"qa_dp_{name}", REPO / "src" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# (a) loaders


@pytest.mark.parametrize("n", [19, 17])
def test_make_loaders_per_rank(corpus, monkeypatch, n):
    """Port ranks against src/train.py's processes (process_count 2): the
    same per-rank batch size and shards, disjoint and complete; every port
    rank counts ceil(ceil(n/2)/4) = 3 batches, padded with invalid rows."""
    j_train = load_src("train")
    cfg = cfg_dict(corpus, train_annot="train.json" if n == 19 else "train17.json")
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(t_train.parallel, "world", lambda: 2)
    seen, j_seen, lens, j_lens = [], [], [], []
    for rank in (0, 1):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(t_train.parallel, "rank", lambda r=rank: r)
        port = t_train.make_loaders(Box(cfg))
        ref = j_train.make_loaders(JBox(cfg), mesh=None)
        for name in ("train", "val"):
            assert port[name].batch_size == ref[name].batch_size == 4
            assert (port[name].shard_id, port[name].num_shards) == (rank, 2)
        port["train"].set_epoch(1)
        ref["train"].set_epoch(1)
        batches = list(port["train"])
        assert len(batches) == len(port["train"]) == 3
        lens.append(len(batches))
        j_lens.append(len(ref["train"]))
        rows = [np.asarray(b["ds_idx"])[b["valid"]].tolist() for b in batches]
        j_rows = [np.asarray(b["ds_idx"])[b["valid"]].tolist() for b in ref["train"]]
        assert [r for r in rows if r] == j_rows  # the same shard, batch for batch
        seen += sum(rows, [])
        j_seen += sum(j_rows, [])
        if n == 17 and rank == 1:
            assert not batches[-1]["valid"].any()
            assert batches[-1]["quest"].shape == batches[0]["quest"].shape
    assert sorted(seen) == sorted(j_seen) == list(range(n))
    assert lens == [3, 3]
    assert j_lens == ([3, 3] if n == 19 else [3, 2])  # the hang the port's rule removes


def test_batch_loader_length_rule(corpus):
    """One shard keeps today's count; N shards count the largest shard's."""
    ds = AVQADataset(Box(cfg_dict(corpus, "train17.json")), mode="train")
    assert len(BatchLoader(ds, 4)) == 5
    assert [len(BatchLoader(ds, 4, shard_id=r, num_shards=3)) for r in range(3)] == [2, 2, 2]
    tail = list(BatchLoader(ds, 4, shard_id=2, num_shards=3, prefetch=0))
    assert [int(b["valid"].sum()) for b in tail] == [4, 1]


# ---------------------------------------------------------------------------
# (b) training


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_train_matches_the_jax_mesh(corpus, tmp_path, accum):
    cfg = cfg_dict(corpus, grad_accum=accum)
    params = jax_params("paper")
    ranks = torch_dp.spawn(torch_dp.train_epoch, 2, tmp_path, cfg, port_model_cfg(), params)

    j_run = jax_runner(cfg, params)
    j_writer = torch_dp.Writer()
    loader = JBatchLoader(JDataset(JBox(cfg), mode="train"), 8, shuffle=True, seed=cfg["seed"])
    j_run.train_epoch(1, loader, lr=LR, writer=j_writer)
    want = nested_to_flat(jax.tree_util.tree_map(np.asarray, j_run.trainable))

    r0, r1 = ranks
    assert r0["steps"] == r1["steps"] == len(loader) == 3
    assert r0["scalars"] == r1["scalars"]
    assert torch.equal(r0["step_rng"], r1["step_rng"])
    assert set(r0["params"]) == set(want)
    for name, value in r0["params"].items():
        assert np.array_equal(value, r1["params"][name]), name
    assert [(t, s) for t, s, _ in r0["scalars"]] == [(t, s) for t, s, _ in j_writer.scalars]
    np.testing.assert_allclose([v for *_, v in r0["scalars"]],
                               [v for *_, v in j_writer.scalars], **TRAIN_TOL)
    compared = 0
    for name, value in r0["params"].items():
        # where the last gradient is above 1e-6, as the single-process
        # parity tests compare (Adam turns a structurally zero gradient's fp
        # noise into steps of either sign)
        keep = np.abs(r0["grads"].get(name, np.zeros_like(value))) > 1e-6
        if keep.any():
            np.testing.assert_allclose(value[keep], want[name][keep], err_msg=name, **TRAIN_TOL)
            compared += 1
    assert compared > 50


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of this process alone, left when the test ends."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _epoch(runner, batches):
    class Loader(list):
        def set_epoch(self, epoch):
            pass

    writer = torch_dp.Writer()
    runner.train_epoch(1, Loader(batches), LR, writer)
    return writer.scalars


@pytest.mark.parametrize("accum", [1, 2])
def test_world_one_is_the_single_process(corpus, tmp_path, accum):
    """A one-rank process group takes the data-parallel step (the count and
    gradient all-reduces, the rank-split dropout stream), dropout on: every
    loss, parameter and the stream bitwise the runner's without a group."""
    cfg = Box(cfg_dict(corpus, grad_accum=accum))
    batches = list(BatchLoader(AVQADataset(cfg, mode="train"), 8, prefetch=0))
    params = jax_params("reference")

    def run():
        runner = AVQARunner(cfg, port_model_cfg("reference", dropout=0.1), device="cpu",
                            seed=3, init_params=params)
        return runner, _epoch(runner, batches)

    single, s_scalars = run()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        grouped, g_scalars = run()
    finally:
        dist.destroy_process_group()
    assert g_scalars == s_scalars and len(s_scalars) == 2 * len(batches)
    assert torch.equal(grouped._step_generator.get_state(), single._step_generator.get_state())
    for (name, pa), (_, pb) in zip(grouped.trainable(), single.trainable()):
        assert torch.equal(pa, pb), name


def test_rank_generator_splits_the_stream(monkeypatch):
    """At world 2 each rank seeds its step from its own of two seeds drawn
    from the shared stream, which both advance alike; at world 1 the stream
    is used as it is."""
    from qa_tiger_tpu_torch.models.qa_tiger import split_seeds
    from qa_tiger_tpu_torch.training import loop

    runner = AVQARunner.__new__(AVQARunner)
    gen = torch.Generator().manual_seed(5)
    assert runner._rank_generator(gen) is gen
    monkeypatch.setattr(loop.parallel, "world", lambda: 2)
    seeds, states = [], []
    for rank in (0, 1):
        monkeypatch.setattr(loop.parallel, "rank", lambda r=rank: r)
        g = torch.Generator().manual_seed(5)
        seeds.append(runner._rank_generator(g).initial_seed())
        states.append(g.get_state())
    want = split_seeds(torch.Generator().manual_seed(5), 2)
    assert seeds == want and seeds[0] != seeds[1]
    assert torch.equal(states[0], states[1])


def test_steps_per_dispatch_under_gloo_raises(corpus, one_rank_group):
    """A step graph that would capture under gloo raises, naming the
    backend; the eager static-input step (``graph_capture`` False, as on
    the CPU) runs under it."""
    cfg = cfg_dict(corpus)
    cfg["hyper_params"]["steps_per_dispatch"] = 2
    runner = AVQARunner(Box(cfg), port_model_cfg(), device="cpu", seed=0)
    batch = runner.stage_batch(next(iter(BatchLoader(AVQADataset(Box(cfg), mode="train"), 8))))
    runner.graph_capture = True
    with pytest.raises(RuntimeError, match="gloo backend"):
        runner.train_window([batch, batch], LR)
    runner.graph_capture = False
    losses = runner.train_window([batch, batch], LR)
    assert len(losses) == 2 and runner._step_graph is not None
    assert all(np.isfinite(float(ld["total_loss"])) for ld in losses)


# ---------------------------------------------------------------------------
# (c), (d) evaluation


def test_dp_eval_matches_the_jax_mesh(corpus, tmp_path):
    cfg = cfg_dict(corpus)
    params = jax_params("paper")
    ranks = torch_dp.spawn(torch_dp.run_eval, 2, tmp_path, cfg, port_model_cfg(), params)
    loader = JBatchLoader(JDataset(JBox(cfg), mode="test"), 8)
    j_loss, j_cor, j_tot, j_cor9, j_tot9 = jax_runner(cfg, params)._run_eval(loader, debug=False)
    for loss, cor, tot, cor9, tot9, n_batches in ranks:
        assert n_batches == len(loader) == 3  # rank 1's third batch is all padding
        assert (cor, tot) == (j_cor, j_tot) and tot == 17
        np.testing.assert_array_equal(cor9, np.asarray(j_cor9))
        np.testing.assert_array_equal(tot9, np.asarray(j_tot9))
        np.testing.assert_allclose(loss, j_loss, rtol=1e-5)


def test_reference_gather_rotates_within_each_rank(corpus, tmp_path):
    cfg = cfg_dict(corpus)
    params = jax_params("reference")
    mcfg = port_model_cfg("reference")
    ranks = torch_dp.spawn(torch_dp.shard_logits, 2, tmp_path, cfg, mcfg, params)
    runner = AVQARunner(Box(cfg), mcfg, device="cpu", seed=0, init_params=params)
    ds = AVQADataset(Box(cfg), mode="test")
    with torch.no_grad():
        for rank, logits in enumerate(ranks):
            shard = BatchLoader(ds, 4, shard_id=rank, num_shards=2)
            for got, batch in zip(logits, shard):
                want = runner.model(runner._device_batch(batch))["out"].numpy()
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        # the global batch's forward rotates over both ranks' rows
        first = next(iter(BatchLoader(ds, 8)))
        whole = runner.model(runner._device_batch(first))["out"].numpy()
    assert not np.allclose(whole[0::2], ranks[0][0], rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# (e) the entry points under torchrun


def torchrun(n: int, module: str, *args: str) -> subprocess.CompletedProcess:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
           "--master-addr", "localhost", "--master-port", str(torch_dp.free_port()),
           "-m", module, *args, "--distributed"]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    return out


def report_lines(path: Path) -> list[str]:
    return [m.group(1) for line in path.read_text().splitlines()
            if (m := REPORT.search(line.rstrip()))]


def test_torchrun_train_test_and_resume(corpus, tmp_path):
    # the config registers the tiny tower itself: torchrun's ranks are new
    # processes
    model = {**TINY, "gather_mode": "paper"}
    cfg = write_config(tmp_path / "dp.py", corpus / "data", tmp_path / "out", model,
                       platform="cpu")
    cfg.write_text("from qa_tiger_tpu_torch.models import clip_text\n"
                   f"clip_text.CLIP_TEXT_CONFIGS.setdefault('tiny-test', {torch_dp.TINY_TOWER!r})\n"
                   + cfg.read_text().replace("'train.json'", "'train17.json'"))
    torchrun(2, "qa_tiger_tpu_torch.train", "--config", str(cfg))
    runs = list((tmp_path / "out").iterdir())
    assert len(runs) == 1
    run = runs[0]
    assert [p.name for p in (tmp_path / "out").rglob("best.npz")] == ["best.npz"]
    assert (run / "last_state" / "state.pt").exists()
    train_report = report_lines(run / "log.txt")
    assert len(train_report) == 13

    torchrun(2, "qa_tiger_tpu_torch.test", "--config", str(cfg), "--weight",
             str(run / "best.npz"), "--output_path", str(tmp_path / "eval"))
    assert [p.name for p in (tmp_path / "eval").iterdir()] == ["best_result.txt"]
    dp_report = report_lines(tmp_path / "eval" / "best_result.txt")
    single = t_test.main(["--config", str(cfg), "--weight", str(run / "best.npz"),
                          "--output_path", str(tmp_path / "eval1")])
    assert dp_report == train_report == report_lines(tmp_path / "eval1" / "best_result.txt")
    assert re.search(rf"Total avg\s+accuracy: {single[0]:.2f}\(", dp_report[-1])

    # resume for epoch 2 under --distributed: both ranks restore the same
    # state and end equal; rank 0 carries best.npz over
    resume = tmp_path / "resume.py"
    resume.write_text(cfg.read_text().replace("'epochs': 1", "'epochs': 2").replace(
        str(tmp_path / "out"), str(tmp_path / "out_resume")) +
        f"config['resume'] = {str(run / 'last_state')!r}\n")
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": "0"}
    ranks = torch_dp.spawn(torch_dp.train_main, 2, tmp_path / "ranks",
                           ["--config", str(resume), "--distributed"], env)
    for out in ranks:
        assert out["summary"]["start_epoch"] == 2
        assert [e["epoch"] for e in out["summary"]["epochs"]] == [2]
    (a, b) = ranks
    assert len(a["restored"]) == len(b["restored"]) == 1
    for key in ("restored", "final"):
        for name, value in a[key][0].items():
            assert np.array_equal(value, b[key][0][name]), (key, name)
    assert a["summary"]["run_dir"] == b["summary"]["run_dir"]
    assert [p.parent.name for p in (tmp_path / "out_resume").rglob("best.npz")] == \
        [Path(a["summary"]["run_dir"]).name]
    assert a["summary"]["tests"] == b["summary"]["tests"]


def test_distributed_without_torchrun_raises(corpus, tmp_path, monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    cfg = write_config(tmp_path / "c.py", corpus / "data", tmp_path / "out", TINY,
                       platform="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        t_train.main(["--config", str(cfg), "--distributed"])
    assert not (tmp_path / "out").exists()


def test_batch_sizes_must_divide_by_the_world(corpus, tmp_path):
    cfg = Box(cfg_dict(corpus))
    cfg.data.eval_batch_size = 6
    with pytest.raises(ValueError, match="batch_size=8 and data.eval_batch_size=6"):
        t_train.check_batch_sizes(cfg, 4)
    t_train.check_batch_sizes(cfg, 2)
