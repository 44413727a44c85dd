"""The port's checkpoints against the JAX package's, on the CPU.

``best.npz`` written by either package is read by the other with equal
arrays (``video_encoder*`` stripped, a bf16 tower stored as fp32, the same
missing / unexpected key lists); a train state saved after 2 steps and
restored into a fresh runner continues with dropout on exactly as an
uninterrupted run does (spec: tests/test_resume.py:57, :124); the async
save copies the state when it is called. Every comparison is exact.
"""
import jax
import numpy as np
import pytest
import torch

from qa_tiger_tpu.models import clip_text as j_clip_text
from qa_tiger_tpu.models.qa_tiger import qa_tiger_config as j_config
from qa_tiger_tpu.models.qa_tiger import qa_tiger_init
from qa_tiger_tpu.training import checkpoint as jck
from qa_tiger_tpu_torch.convert import nested_to_flat
from qa_tiger_tpu_torch.models import clip_text as t_clip_text
from qa_tiger_tpu_torch.models import qa_tiger_config
from qa_tiger_tpu_torch.training import (
    AVQARunner,
    load_checkpoint,
    load_train_state,
    save_checkpoint,
    save_train_state,
    save_train_state_async,
    wait_for_async_saves,
)

TINY_TOWER = dict(width=64, heads=4, layers=2, embed_dim=64)
TOY = dict(d_model=32, video_dim=64, patch_dim=24, audio_dim=16, topK=2,
           num_experts=4, num_labels=42, encoder_type="ckpt-test")
VOCAB, CTX, T, P = 49408, 77, 6, 14
LR = 1e-3


@pytest.fixture
def tiny_tower(monkeypatch):
    monkeypatch.setitem(j_clip_text.CLIP_TEXT_CONFIGS, "ckpt-test", TINY_TOWER)
    monkeypatch.setitem(t_clip_text.CLIP_TEXT_CONFIGS, "ckpt-test", TINY_TOWER)


def make_batch(rng, b):
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
            "valid": np.ones(b, bool)}


def runner(seed=0, **model):
    cfg = {"log_interval": 1, "debug": False, "hyper_params": {
        "optim": dict(lr=LR, betas=(0.95, 0.999), weight_decay=0.0)}}
    return AVQARunner(cfg, qa_tiger_config(**TOY, **model), device="cpu", seed=seed)


def jax_flat(params):
    return nested_to_flat(jax.tree_util.tree_map(np.asarray, params))


def with_video_encoder(flat):
    """A state that also holds a video tower, which checkpoints leave out
    (the reference's src/train.py:75-79)."""
    return {**flat, "video_encoder.proj.weight": np.ones((3, 2), np.float32),
            "video_encoder.proj.bias": np.zeros(3, np.float32)}


def test_best_npz_from_jax_loads_in_the_port(tiny_tower, tmp_path):
    params = jax.tree_util.tree_map(np.asarray,
                                    qa_tiger_init(jax.random.PRNGKey(0), j_config(**TOY)))
    params["video_encoder"] = {"proj": {"weight": np.ones((3, 2), np.float32)}}
    jck.save_checkpoint(params, tmp_path / "best.npz")
    got, missing, unexpected = load_checkpoint(tmp_path / "best.npz")
    want = {k: v for k, v in jax_flat(params).items() if not k.startswith("video_encoder")}
    assert (missing, unexpected) == ([], [])
    assert set(got) == set(want)
    for key, value in want.items():
        assert np.array_equal(got[key].numpy(), value), key
    # and into a runner, strictly
    r = runner(seed=3)
    r.load_params(got)
    for name, p in r.trainable():
        assert np.array_equal(p.detach().numpy(), want[name]), name


def test_best_npz_from_the_port_loads_in_jax(tiny_tower, tmp_path):
    """The port's runner keeps its frozen tower in bf16 here (as on the
    card): the checkpoint stores it as fp32, the exact widening."""
    r = runner(encoder_dtype="bfloat16")
    assert r.model.quest_encoder.token_embedding.weight.dtype == torch.bfloat16
    state = {k: v.detach() for k, v in r.params.items()}
    save_checkpoint(with_video_encoder(state), tmp_path / "best.npz")
    with np.load(tmp_path / "best.npz") as data:
        assert all(data[k].dtype == np.float32 for k in data.files if k.startswith("quest"))
        assert not any(k.startswith("video_encoder") for k in data.files)
    got = jax_flat(jck.load_checkpoint(tmp_path / "best.npz")[0])
    assert set(got) == set(state)
    for key, value in state.items():
        assert np.array_equal(got[key], value.float().numpy()), key


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_key_diff_against_a_base_matches_jax(tiny_tower, tmp_path, suffix):
    """Over a base state: a missing name, an unknown one and one of another
    shape give the same (missing, unexpected) lists and the same merged
    values in both packages; ``.pt`` through ``torch.load``."""
    r = runner()
    base = {k: v.detach().clone() for k, v in r.params.items()}
    file = {k: v + 1.0 for k, v in base.items()}  # the merged values come from the file
    del file["head.weight"]
    file["head.extra"] = torch.ones(2)
    file["head.bias"] = torch.ones(5)
    path = tmp_path / f"ckpt{suffix}"
    if suffix == ".npz":
        save_checkpoint(file, path)
    else:
        torch.save(file, path)
    merged, missing, unexpected = load_checkpoint(path, base)
    j_merged, j_missing, j_unexpected = jck.load_checkpoint(
        path, _nested({k: v.numpy() for k, v in base.items()}))
    assert sorted(missing) == sorted(j_missing) == ["head.weight"]
    assert sorted(unexpected) == sorted(j_unexpected) == ["head.bias", "head.extra"]
    j_merged = jax_flat(j_merged)
    assert set(merged) == set(j_merged)
    for key, value in merged.items():
        assert np.array_equal(value.numpy(), j_merged[key]), key


def _nested(flat):
    out = {}
    for key, value in flat.items():
        node = out
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def test_resume_is_bitwise(tiny_tower, tmp_path):
    """3 steps with dropout on (the runner's step generator) against 2
    steps, a saved and restored train state in a fresh runner whose
    parameters and generator were scrambled, then 1 step: every parameter
    and Adam moment bitwise equal. Without the generator state the third
    step draws other dropout and the parameters differ."""
    batch = make_batch(np.random.default_rng(1), 3)
    straight = runner()
    for _ in range(3):
        straight.train_step(batch, LR, straight._step_generator)

    first = runner()
    for _ in range(2):
        first.train_step(batch, LR, first._step_generator)
    save_train_state(first.train_state(epoch=1, best_acc=12.5, best_epoch=1), tmp_path / "state")

    def resumed(keep_rng: bool):
        r = runner(seed=0)  # the same frozen tower, as in a real resume
        with torch.no_grad():
            for _, p in r.trainable():
                p.add_(1.0)
        r._step_generator.manual_seed(12345)
        state = load_train_state(tmp_path / "state")
        if not keep_rng:
            del state["step_rng"]
        assert r.restore_train_state(state) == {"epoch": 1, "best_acc": 12.5, "best_epoch": 1}
        r.train_step(batch, LR, r._step_generator)
        return r

    r = resumed(True)
    for (name, a), (_, b) in zip(straight.trainable(), r.trainable()):
        assert torch.equal(a, b), name
        sa, sb = straight.optimizer.state[a], r.optimizer.state[b]
        assert all(torch.equal(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq", "step")), name
    other = resumed(False)
    assert any(not torch.equal(a, b) for (_, a), (_, b) in zip(straight.trainable(),
                                                                other.trainable()))


def test_restore_consumes_the_generator_state(tiny_tower, tmp_path):
    """The dropout stream rides in the state, is restored and is not handed
    back with the scalars (spec: tests/test_resume.py:124)."""
    a = runner()
    torch.rand(5, generator=a._step_generator)  # advance, as train_epoch does
    save_train_state(a.train_state(epoch=2, best_acc=1.0, best_epoch=2), tmp_path / "state")
    b = runner(seed=7)
    scalars = b.restore_train_state(load_train_state(tmp_path / "state"))
    assert scalars == {"epoch": 2, "best_acc": 1.0, "best_epoch": 2}
    assert torch.equal(a._step_generator.get_state(), b._step_generator.get_state())
    assert torch.equal(torch.rand(4, generator=a._step_generator),
                       torch.rand(4, generator=b._step_generator))


def test_async_save_round_trips(tiny_tower, tmp_path):
    """The async save holds the state of the moment it was called: a step
    taken before the write finishes does not reach the file; restored into
    a fresh runner, every parameter and the scalars come back exactly
    (spec: tests/test_resume.py:95)."""
    r = runner()
    batch = make_batch(np.random.default_rng(2), 2)
    r.train_step(batch, LR, r._step_generator)
    snapshot = {n: p.detach().clone() for n, p in r.trainable()}
    save_train_state_async(r.train_state(epoch=3, best_acc=55.5, best_epoch=2),
                           tmp_path / "astate")
    r.train_step(batch, LR, r._step_generator)
    wait_for_async_saves()
    s = runner(seed=0)
    scalars = s.restore_train_state(load_train_state(tmp_path / "astate"))
    assert scalars == {"epoch": 3, "best_acc": 55.5, "best_epoch": 2}
    for name, p in s.trainable():
        assert torch.equal(p, snapshot[name]), name


def test_async_save_raises_what_failed(tiny_tower, tmp_path):
    (tmp_path / "taken").write_text("a file where the directory should go")
    save_train_state_async({"params": {}, "epoch": 1}, tmp_path / "taken")
    with pytest.raises(FileExistsError):
        wait_for_async_saves()
    wait_for_async_saves()  # nothing left in flight
