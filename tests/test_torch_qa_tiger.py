"""The port's QA-TIGER eval forward against qa_tiger_tpu's, end to end.

The JAX parameters (``qa_tiger_init``) are carried across with
``params_from_jax`` and loaded strictly, and both sides take the same numpy
batch on the CPU in fp32 (JAX at ``jax_default_matmul_precision=highest``,
set by conftest).
"""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from qa_tiger_tpu.models import clip_text as j_clip_text
from qa_tiger_tpu.models.qa_tiger import qa_tiger_config as j_config
from qa_tiger_tpu.models.qa_tiger import qa_tiger_forward, qa_tiger_init
from qa_tiger_tpu_torch.convert import nested_to_flat, params_from_jax
from qa_tiger_tpu_torch.models import QATiger, build_model, qa_tiger_config
from qa_tiger_tpu_torch.models import clip_text as t_clip_text
from qa_tiger_tpu_torch.predict import Predictor

REPO = Path(__file__).resolve().parents[1]
VOCAB, CTX = 49408, 77
TINY_TOWER = dict(width=128, heads=4, layers=2, embed_dim=128)
TOY = dict(d_model=64, video_dim=128, patch_dim=96, audio_dim=32, topK=2,
           num_experts=4, num_labels=42, encoder_type="tiny-test")
# toy dims, fp32: the two frameworks differ only in reduction order
TOY_TOL = dict(rtol=1e-4, atol=1e-5)
# shipped dims, fp32: 512/768-wide contractions through 12 tower layers
# (the tolerance tests/test_fullsize_parity.py holds JAX to against torch)
SHIPPED_TOL = dict(rtol=2e-3, atol=5e-4)


@pytest.fixture
def tiny_tower(monkeypatch):
    monkeypatch.setitem(j_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", TINY_TOWER)
    monkeypatch.setitem(t_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", TINY_TOWER)


def make_tokens(b, rng, max_len=30):
    """CLIP-style rows: SOT, random ids, EOT (the largest id), zero pad."""
    toks = np.zeros((b, CTX), dtype=np.int64)
    for i in range(b):
        n = int(rng.integers(5, max_len))
        toks[i, 0] = VOCAB - 2
        toks[i, 1:n] = rng.integers(1, VOCAB - 2, n - 1)
        toks[i, n] = VOCAB - 1
    return toks


def make_batch(rng, b, cfg, T=8, P=14):
    return {
        "quest": make_tokens(b, rng),
        "audio": rng.standard_normal((b, T, cfg["audio_dim"])).astype(np.float32),
        "video": rng.standard_normal((b, T, cfg["video_dim"])).astype(np.float32),
        "patch": rng.standard_normal((b, T, P, cfg["patch_dim"])).astype(np.float32),
    }


def jax_logits(params, batch, cfg):
    out = qa_tiger_forward(params, {k: jax.numpy.asarray(v) for k, v in batch.items()},
                           cfg, train=False)["out"]
    return np.asarray(out)


def toy_pair(**extra):
    j_cfg = j_config(**TOY, **extra)
    params = jax.tree_util.tree_map(np.asarray, qa_tiger_init(jax.random.PRNGKey(0), j_cfg))
    model = QATiger(qa_tiger_config(**TOY, **extra), seed=1).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    return j_cfg, params, model


@torch.no_grad()
def port_logits(model, batch):
    return model({k: torch.tensor(v) for k, v in batch.items()})["out"].numpy()


def test_state_dict_names_equal_the_jax_tree(tiny_tower):
    params = qa_tiger_init(jax.random.PRNGKey(0), j_config(**TOY))
    flat = nested_to_flat(jax.tree_util.tree_map(np.asarray, params))
    model = QATiger(qa_tiger_config(**TOY), seed=0)
    state = model.state_dict()
    assert set(state) == set(flat)
    for key, value in flat.items():
        assert tuple(state[key].shape) == value.shape, key
    model.load_state_dict(params_from_jax(params), strict=True)
    # an already flat dict (what best.npz holds) loads the same way
    model.load_state_dict(params_from_jax(flat), strict=True)


@pytest.mark.parametrize("form", ["tokens", "tokens_text_ctx", "float_2d", "float_3d"])
def test_toy_logits_for_each_question_form(tiny_tower, form):
    extra = {"text_ctx": 32} if form == "tokens_text_ctx" else {}
    j_cfg, params, model = toy_pair(**extra)
    rng = np.random.default_rng(7)
    batch = make_batch(rng, 3, TOY)
    if form.startswith("float"):
        width = TINY_TOWER["width"]
        quest = rng.standard_normal((3, width)).astype(np.float32)
        batch["quest"] = quest[:, None] if form == "float_3d" else quest
        batch["quest_words"] = rng.standard_normal((3, CTX, width)).astype(np.float32)
    want = jax_logits(params, batch, j_cfg)
    got = port_logits(model, batch)
    assert got.shape == (3, 42)
    np.testing.assert_allclose(got, want, **TOY_TOL)


def test_bf16_tower_output_is_cast_to_the_head_dtype(tiny_tower):
    """A bf16 tower under fp32 heads, on both sides: the tower's outputs
    reach the projections as fp32. Tolerance 3e-2: the two frameworks round
    the bf16 tower's intermediates at different places."""
    j_cfg, params, model = toy_pair()
    params["quest_encoder"] = jax.tree_util.tree_map(
        lambda a: a.astype(jax.numpy.bfloat16), params["quest_encoder"])
    model.quest_encoder.to(torch.bfloat16)
    batch = make_batch(np.random.default_rng(10), 2, TOY)
    quest, words = model.encode_question(torch.tensor(batch["quest"]))
    assert quest.dtype == words.dtype == torch.float32
    np.testing.assert_allclose(port_logits(model, batch), jax_logits(params, batch, j_cfg),
                               rtol=3e-2, atol=3e-2)


def test_float_question_without_words_raises(tiny_tower):
    _, _, model = toy_pair()
    batch = make_batch(np.random.default_rng(8), 2, TOY)
    batch["quest"] = np.zeros((2, TINY_TOWER["width"]), np.float32)
    with pytest.raises(ValueError, match="quest_words"):
        port_logits(model, batch)


def test_shipped_dims_logits_b2():
    """configs/qa-tiger/vitl14.py through the Predictor (config loading,
    strict load of the JAX pytree) against qa_tiger_forward at B=2."""
    cfg_path = REPO / "configs" / "qa-tiger" / "vitl14.py"
    j_cfg = j_config(d_model=512, video_dim=768, patch_dim=1024, audio_dim=128,
                     topK=7, num_experts=7, num_labels=42,
                     encoder_type="ViT-L/14@336px")
    params = jax.tree_util.tree_map(np.asarray, qa_tiger_init(jax.random.PRNGKey(0), j_cfg))
    pred = Predictor(cfg_path, device="cpu", dtype=torch.float32, weights=params)
    batch = make_batch(np.random.default_rng(0), 2, j_cfg, T=60)
    want = jax_logits(params, batch, j_cfg)
    got = pred.logits(batch).numpy()
    np.testing.assert_allclose(got, want, **SHIPPED_TOL)
    assert (got.argmax(1) == want.argmax(1)).all()


def test_predictor_answers_a_batch(tiny_tower, tmp_path):
    cfg_file = tmp_path / "tiny.py"
    cfg_file.write_text(
        "config = dict(data=dict(root=%r, ans_quelen='annots/music_avqa/answer2idx.json'),\n"
        "              hyper_params=dict(model_type='QA-TIGER_tiny', model=dict(%s)))\n"
        % (str(REPO / "data"), ", ".join(f"{k}={v!r}" for k, v in TOY.items()
                                          if k != "num_labels")))
    pred = Predictor(cfg_file, device="cpu", dtype=torch.float32, seed=3)
    batch = make_batch(np.random.default_rng(9), 4, TOY)
    answers = pred.answer(batch, topk=5)
    logits = pred.logits(batch)
    assert len(answers) == 4
    names = set(pred.ix2ans.values())
    for row, ans in zip(logits, answers):
        probs = [t["prob"] for t in ans["topk"]]
        assert len(ans["topk"]) == 5 and probs == sorted(probs, reverse=True)
        assert all(t["answer"] in names for t in ans["topk"])
        assert ans["answer"] == pred.ix2ans[int(row.argmax())]


def test_build_model_prefixes(tiny_tower):
    model = build_model("QA-TIGER_tiny", {k: v for k, v in TOY.items() if k != "num_labels"},
                        device="cpu")
    assert not model.training and next(model.parameters()).device.type == "cpu"
    assert type(build_model("TSPM_base", {}, device="cpu")).__name__ == "TSPM"
    with pytest.raises(NotImplementedError, match="known prefixes"):
        build_model("OTHER_base", {}, device="cpu")
