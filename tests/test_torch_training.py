"""The port's training slice against the JAX package, on the CPU.

Metrics, schedules and LR multipliers against ``qa_tiger_tpu.training``;
one whole ``AVQARunner.train_step`` at toy dims with dropout off against
``jax.grad`` of ``qa_tiger_forward(train=True, rng=None)`` and the JAX
``make_optimizer``; gradient accumulation, the bf16 compute mode,
``train_epoch``, ``evaluate`` and the question cache of the port's runner.
Each tolerance is stated where it is used; all fp32 unless a test says
otherwise.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qa_tiger_tpu.models import clip_text as j_clip_text
from qa_tiger_tpu.models.qa_tiger import FROZEN_PREFIXES as J_FROZEN
from qa_tiger_tpu.models.qa_tiger import qa_tiger_config as j_config
from qa_tiger_tpu.models.qa_tiger import qa_tiger_forward, qa_tiger_init
from qa_tiger_tpu.training import metrics as jmet
from qa_tiger_tpu.training import optim as jopt
from qa_tiger_tpu_torch.convert import nested_to_flat
from qa_tiger_tpu_torch.models import clip_text as t_clip_text
from qa_tiger_tpu_torch.models import qa_tiger_config
from qa_tiger_tpu_torch.training import (
    AVQARunner,
    PlateauScheduler,
    accuracy_report,
    lr_multipliers,
    make_lr_schedule,
    masked_cross_entropy,
    qtype_counters,
)

TINY_TOWER = dict(width=128, heads=4, layers=2, embed_dim=128)
TOY = dict(d_model=64, video_dim=128, patch_dim=96, audio_dim=32, topK=2,
           num_experts=4, num_labels=42, encoder_type="tiny-test")
VOCAB, CTX, T, P = 49408, 77, 8, 14
# toy dims, fp32: the frameworks differ only in summation order
TOY_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def tiny_tower(monkeypatch):
    monkeypatch.setitem(j_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", TINY_TOWER)
    monkeypatch.setitem(t_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", TINY_TOWER)


def make_batch(rng, b, valid=None):
    quest = np.zeros((b, CTX), dtype=np.int64)
    for i in range(b):
        n = int(rng.integers(5, 30))
        quest[i, 0] = VOCAB - 2
        quest[i, 1:n] = rng.integers(1, VOCAB - 2, n - 1)
        quest[i, n] = VOCAB - 1
    return {"quest": quest,
            "audio": rng.standard_normal((b, T, TOY["audio_dim"])).astype(np.float32),
            "video": rng.standard_normal((b, T, TOY["video_dim"])).astype(np.float32),
            "patch": rng.standard_normal((b, T, P, TOY["patch_dim"])).astype(np.float32),
            "label": rng.integers(0, 42, b).astype(np.int32),
            "qtype_label": rng.integers(0, 9, b).astype(np.int32),
            "valid": np.ones(b, bool) if valid is None else np.asarray(valid)}


def runner_cfg(**hp):
    optim = dict(lr=1e-3, betas=(0.95, 0.999), weight_decay=0.0, encoder_lr=None)
    optim.update(hp.pop("optim", {}))
    return {"log_interval": 1, "debug": False, "hyper_params": {"optim": optim, **hp}}


def jax_params(**extra):
    params = qa_tiger_init(jax.random.PRNGKey(0), j_config(**TOY, **extra))
    return jax.tree_util.tree_map(np.asarray, params)


class Lines(list):
    def __call__(self, line):
        self.append(line)


# ---------------------------------------------------------------------------
# metrics, schedules, multipliers
# ---------------------------------------------------------------------------

def test_masked_cross_entropy_and_counters():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((11, 42)).astype(np.float32)
    labels = rng.integers(0, 42, 11)
    labels[:4] = logits[:4].argmax(1)  # some right answers
    qtype = rng.integers(0, 9, 11)
    valid = rng.random(11) > 0.2
    want = jmet.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     jnp.asarray(valid))
    got = masked_cross_entropy(torch.tensor(logits), torch.tensor(labels), torch.tensor(valid))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    j = jmet.qtype_counters(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(qtype),
                            jnp.asarray(valid))
    t = qtype_counters(torch.tensor(logits), torch.tensor(labels), torch.tensor(qtype),
                       torch.tensor(valid))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("epoch", [None, 3])
def test_accuracy_report_text_is_identical(epoch):
    cor9, tot9 = [3, 0, 5, 1, 7, 2, 0, 4, 9], [4, 0, 9, 2, 7, 5, 1, 4, 12]
    mine, theirs = Lines(), Lines()
    out = accuracy_report(31, 44, cor9, tot9, mine, epoch=epoch)
    want = jmet.accuracy_report(31, 44, cor9, tot9, theirs, epoch=epoch)
    assert mine == theirs and len(mine) == 13
    assert out == want


@pytest.mark.parametrize("name", ["StepLR", "cosine"])
def test_lr_schedules_over_15_epochs(name):
    kw = dict(epochs=15, step_size=8, gamma=0.1, min_lr=1e-7, warmup_epochs=2)
    got = [make_lr_schedule(name, 1e-4, **kw)(e) for e in range(1, 17)]
    want = [jopt.make_lr_schedule(name, 1e-4, **kw)(e) for e in range(1, 17)]
    assert got == want
    with pytest.raises(ValueError):
        make_lr_schedule("plateau", 1e-4)


@pytest.mark.parametrize("mode,metrics", [
    ("min", [1.0, 0.9, 0.95, 0.95, 0.95, 0.9, 0.91, 0.92, 0.93, 0.94, 0.95, 0.96, 0.97, 0.98]),
    ("max", [50.0, 51.0, 51.0, 50.9, 50.0, 49.0, 48.0, 47.0, 46.0, 52.0, 52.0, 52.0, 51.0, 50.0]),
])
def test_plateau_sequences(mode, metrics):
    mine = PlateauScheduler(1e-4, mode=mode, factor=0.5, patience=2, cooldown=1)
    theirs = jopt.PlateauScheduler(1e-4, mode=mode, factor=0.5, patience=2, cooldown=1)
    got = [mine.step(m) for m in metrics]
    assert got == [theirs.step(m) for m in metrics]
    assert got[-1] < 1e-4


@pytest.mark.parametrize("encoder_lr", [None, 1e-5])
def test_lr_multipliers(encoder_lr):
    tree = {"quest_encoder": {"ln_final": {"weight": 0}}, "video_encoder": {"x": {"w": 0}},
            "head": {"weight": 0, "bias": 0}, "crs_attn": {"qst_attn": {"in_proj_weight": 0}}}
    want = nested_to_flat(jopt.lr_multipliers(tree, encoder_lr, 1e-4))
    got = lr_multipliers(list(want), encoder_lr, 1e-4)
    assert got == {k: float(v) for k, v in want.items()}


# ---------------------------------------------------------------------------
# one whole train step against JAX
# ---------------------------------------------------------------------------

def test_train_step_matches_jax(tiny_tower):
    """Loss, every trainable gradient and every Adam-updated parameter
    after one step with dropout off, from the same weights and batch. The
    frozen tower gets no gradient and no Adam state. Updated parameters are
    compared where |grad| > 1e-6 (Adam's first step is lr * sign(g) there;
    structurally zero gradients turn fp noise into sign flips on both sides,
    as tests/test_train_step_parity.py notes), at rtol 1e-5 / atol 1e-6."""
    j_cfg = dict(j_config(**TOY), use_fused=False)
    params = jax_params()
    batch = make_batch(np.random.default_rng(1), 3)
    lr = 1e-3

    trainable = {k: v for k, v in params.items() if k not in J_FROZEN}
    frozen = {k: v for k, v in params.items() if k in J_FROZEN}

    def loss_fn(tp):
        out = qa_tiger_forward({**tp, **frozen}, {k: jnp.asarray(v) for k, v in batch.items()},
                               j_cfg, train=True, rng=None)
        return jmet.masked_cross_entropy(out["out"], jnp.asarray(batch["label"]),
                                         jnp.asarray(batch["valid"]))

    tp = jax.tree_util.tree_map(jnp.asarray, trainable)
    j_loss, j_grads = jax.value_and_grad(loss_fn)(tp)
    tx = jopt.make_optimizer(betas=(0.95, 0.999), weight_decay=0.0)
    updates, _ = tx.update(j_grads, tx.init(tp), tp)
    j_new = jax.tree_util.tree_map(lambda p, u: p + lr * u, tp, updates)
    j_grads = nested_to_flat(jax.tree_util.tree_map(np.asarray, j_grads))
    j_new = nested_to_flat(jax.tree_util.tree_map(np.asarray, j_new))

    runner = AVQARunner(runner_cfg(), qa_tiger_config(**TOY), device="cpu", init_params=params)
    assert all(not p.requires_grad for p in runner.model.quest_encoder.parameters())
    losses = runner.train_step(batch, lr)
    np.testing.assert_allclose(losses["ce_loss"].item(), float(j_loss), **TOY_TOL)
    assert losses["total_loss"].item() == losses["ce_loss"].item()
    trained = dict(runner.trainable())
    assert set(trained) == set(j_grads)
    n_state = sum(len(runner.optimizer.state[p]) > 0 for p in runner.model.parameters())
    assert n_state == len(trained)
    compared = 0
    for name, p in trained.items():
        g = p.grad.numpy()
        np.testing.assert_allclose(g, j_grads[name], err_msg=name, **TOY_TOL)
        keep = np.abs(j_grads[name]) > 1e-6
        if keep.any():
            np.testing.assert_allclose(p.detach().numpy()[keep], j_new[name][keep],
                                       rtol=1e-5, atol=1e-6, err_msg=name)
            compared += 1
    assert compared > 50


def test_grad_accum_equals_the_full_batch(tiny_tower):
    """grad_accum=2 over microbatches of 3 rows (one invalid) against one
    step over all 6 rows, in gather_mode="paper", where no row's forward
    depends on another's; rtol 1e-5 / atol 1e-6 (summation order)."""
    params = jax_params(gather_mode="paper")
    batch = make_batch(np.random.default_rng(2), 6, valid=[1, 1, 0, 1, 1, 1])
    model_cfg = qa_tiger_config(**TOY, gather_mode="paper")
    full = AVQARunner(runner_cfg(), model_cfg, device="cpu", init_params=params)
    accum = AVQARunner(runner_cfg(optim=dict(grad_accum=2)), model_cfg, device="cpu",
                       init_params=params)
    l_full, l_acc = full.train_step(batch, 1e-3), accum.train_step(batch, 1e-3)
    np.testing.assert_allclose(l_acc["ce_loss"].item(), l_full["ce_loss"].item(), rtol=1e-5)
    acc_params = dict(accum.trainable())
    for name, p in full.trainable():
        np.testing.assert_allclose(acc_params[name].grad.numpy(), p.grad.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_bf16_compute_keeps_fp32_masters(tiny_tower):
    """train_dtype="bfloat16": the forward and backward run in bf16 from
    cast copies; parameters, their gradients and Adam's moments stay fp32.
    The loss agrees with the fp32 step to 3e-2 (bf16 rounding)."""
    params = jax_params()
    batch = make_batch(np.random.default_rng(3), 3)
    bf = AVQARunner(runner_cfg(train_dtype="bfloat16"), qa_tiger_config(**TOY), device="cpu",
                    init_params=params)
    fp = AVQARunner(runner_cfg(), qa_tiger_config(**TOY), device="cpu", init_params=params)
    before = {n: p.detach().clone() for n, p in bf.trainable()}
    l_bf, l_fp = bf.train_step(batch, 1e-3), fp.train_step(batch, 1e-3)
    np.testing.assert_allclose(l_bf["ce_loss"].item(), l_fp["ce_loss"].item(), rtol=3e-2)
    for name, p in bf.trainable():
        assert p.dtype == p.grad.dtype == torch.float32, name
        assert all(v.dtype == torch.float32 for v in bf.optimizer.state[p].values()
                   if torch.is_tensor(v) and v.dim()), name
        if p.grad.abs().max() > 1e-6:  # experts outside every top-K get none
            assert not torch.equal(p.detach(), before[name]), name


class Loader:
    def __init__(self, batches):
        self.batches, self.epochs = batches, []

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def set_epoch(self, epoch):
        self.epochs.append(epoch)


def test_train_epoch_is_a_sequence_of_steps(tiny_tower, caplog):
    """train_epoch over two batches equals two train_steps drawing dropout
    from the runner's step generator, bit for bit, and logs one line per
    batch at log_interval 1."""
    params = jax_params()
    rng = np.random.default_rng(4)
    loader = Loader([make_batch(rng, 2), make_batch(rng, 2)])
    a = AVQARunner(runner_cfg(), qa_tiger_config(**TOY), device="cpu", seed=5,
                   init_params=params)
    b = AVQARunner(runner_cfg(), qa_tiger_config(**TOY), device="cpu", seed=5,
                   init_params=params)
    with caplog.at_level(logging.INFO, logger="AVQA"):
        a.train_epoch(1, loader, 1e-3)
    for batch in loader.batches:
        b.train_step(batch, 1e-3, b._step_generator)
    assert loader.epochs == [1]
    for (name, pa), (_, pb) in zip(a.trainable(), b.trainable()):
        assert torch.equal(pa, pb), name
    lines = [r.getMessage() for r in caplog.records if "Epoch: 1" in r.getMessage()]
    assert len(lines) == 2 and "ce_loss-" in lines[1] and "[1/1 (100%)]" in lines[1]


def test_evaluate_matches_jax(tiny_tower, monkeypatch):
    """evaluate over a two-batch loader: the loss, the 9-way counters and
    the report text equal JAX's eval of the same weights (loss at rtol
    1e-5)."""
    params = jax_params()
    rng = np.random.default_rng(6)
    loader = Loader([make_batch(rng, 4), make_batch(rng, 4, valid=[1, 1, 1, 0])])
    j_cfg = dict(j_config(**TOY), use_fused=False)
    ce_sum, cor, tot = 0.0, 0, 0
    cor9, tot9 = np.zeros(9, np.int64), np.zeros(9, np.int64)
    for batch in loader.batches:
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        logits = qa_tiger_forward(jax.tree_util.tree_map(jnp.asarray, params), jb, j_cfg)["out"]
        ce_sum += float(jmet.masked_cross_entropy(logits, jb["label"], jb["valid"]))
        c, t, c9, t9 = jmet.qtype_counters(logits, jb["label"], jb["qtype_label"], jb["valid"])
        cor, tot = cor + int(c), tot + int(t)
        cor9, tot9 = cor9 + np.asarray(c9), tot9 + np.asarray(t9)
    want_lines = Lines()
    want = jmet.accuracy_report(cor, tot, cor9, tot9, want_lines, epoch=2)

    runner = AVQARunner(runner_cfg(), qa_tiger_config(**TOY), device="cpu", init_params=params)
    lines = Lines()
    # through monkeypatch: the "AVQA" logger outlives the test, and later
    # tests in the process read the run logs it writes
    monkeypatch.setattr(runner.logger, "info", lines)
    acc, loss = runner.evaluate(2, loader)
    np.testing.assert_allclose(loss, ce_sum / 2, rtol=1e-5)
    assert acc == want["Total"]
    assert [x for x in lines if "accuracy" in x] == list(want_lines)


def test_question_cache_and_params_round_trip(tiny_tower):
    """A batch that carries ds_idx into a cache built from the same tokens
    gives the same loss as the tokens themselves; ``params`` holds every
    parameter and ``load_params`` takes it back (the tower may be left out)."""
    params = jax_params()
    rng = np.random.default_rng(7)
    batch = make_batch(rng, 3)
    runner = AVQARunner(runner_cfg(), qa_tiger_config(**TOY), device="cpu", init_params=params)
    runner.build_question_cache_from_tokens(batch["quest"], "demo")
    cached = dict(batch, ds_idx=np.arange(3))
    runner._active_qst_cache = runner._qst_caches["demo"]
    ce_cached = runner.eval_step(cached)[0]
    runner._active_qst_cache = None
    ce_tokens = runner.eval_step(batch)[0]
    np.testing.assert_allclose(ce_cached.item(), ce_tokens.item(), rtol=1e-6)

    state = runner.params
    assert set(state) == set(nested_to_flat(params))
    other = AVQARunner(runner_cfg(), qa_tiger_config(**TOY), device="cpu", seed=9)
    other.load_params({k: v for k, v in state.items() if not k.startswith("quest_encoder")})
    for name, p in other.trainable():
        assert torch.equal(p, state[name]), name
    with pytest.raises(KeyError, match="missing"):
        other.load_params({"head.weight": state["head.weight"]})
