"""The port's CLIP text-weight import against the JAX package's, on the CPU.

No CLIP checkpoint is in the repository, so the test writes one: the JAX
text tower initialised from a seed, flattened to OpenAI's names, stored in
fp16 as the released archives are, with a few ``visual.*`` keys and the
integer entries those archives carry, through ``torch.save`` (and once as a
TorchScript archive). The port's ``infer_clip_config`` and
``split_clip_state_dict`` must equal JAX's on it; after each runner's
``load_clip_text_weights`` (``.pt``, or an ``.npz`` of the tower with bare
or ``quest_encoder.`` names) both towers hold the same weights and their
outputs on the same tokens agree to fp32 rtol 1e-5 / atol 1e-5 (the two
frameworks' summation order; the outputs are LayerNorm'd, of order 1, and
differ by up to ~1.3e-6 where they cross zero).
"""
import jax
import numpy as np
import pytest
import torch

from qa_tiger_tpu.convert import clip_import as j_clip_import
from qa_tiger_tpu.models import clip_text as j_clip_text
from qa_tiger_tpu.models.qa_tiger import FROZEN_PREFIXES as J_FROZEN
from qa_tiger_tpu.models.qa_tiger import qa_tiger_config as j_config
from qa_tiger_tpu.models.qa_tiger import qa_tiger_forward, qa_tiger_init
from qa_tiger_tpu.parallel import make_mesh
from qa_tiger_tpu.training.loop import AVQARunner as JRunner
from qa_tiger_tpu.utils import Box
from qa_tiger_tpu_torch.convert import clip_import, nested_to_flat
from qa_tiger_tpu_torch.models import clip_text as t_clip_text
from qa_tiger_tpu_torch.models import qa_tiger_config
from qa_tiger_tpu_torch.training import AVQARunner

TOWER = dict(width=64, heads=4, layers=2, embed_dim=48)
TOY = dict(d_model=32, video_dim=48, patch_dim=24, audio_dim=16, topK=2,
           num_experts=4, num_labels=42, encoder_type="clip-test")
OPTIM = dict(lr=1e-3, betas=(0.95, 0.999), weight_decay=0.0)
VOCAB = 49408


@pytest.fixture
def tower(monkeypatch):
    monkeypatch.setitem(j_clip_text.CLIP_TEXT_CONFIGS, "clip-test", TOWER)
    monkeypatch.setitem(t_clip_text.CLIP_TEXT_CONFIGS, "clip-test", TOWER)


def openai_state_dict() -> dict:
    """A CLIP state_dict in OpenAI's names: the text tower from a seed, a
    two-block ViT vision tower's telling keys (width 64, 8-pixel patches,
    a 4 x 4 grid), the archives' integer entries; floats in fp16."""
    text = jax.tree_util.tree_map(np.asarray,
                                  j_clip_text.clip_text_init(jax.random.PRNGKey(3), "clip-test"))
    sd = {k: torch.from_numpy(v.copy()).half() for k, v in nested_to_flat(text).items()}
    rng = np.random.default_rng(4)
    visual = {"conv1.weight": (64, 3, 8, 8), "class_embedding": (64,),
              "positional_embedding": (17, 64), "proj": (64, 48),
              "transformer.resblocks.0.ln_1.weight": (64,),
              "transformer.resblocks.1.ln_1.weight": (64,)}
    for key, shape in visual.items():
        sd["visual." + key] = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).half()
    sd.update(input_resolution=torch.tensor(32), context_length=torch.tensor(77),
              vocab_size=torch.tensor(VOCAB))
    return sd


class _Holder(torch.nn.Module):
    """Parameters under dotted names, for a TorchScript archive."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def save_torchscript(sd: dict, path) -> None:
    root = _Holder()
    for key, value in sd.items():
        *parents, leaf = key.split(".")
        node = root
        for part in parents:
            if not hasattr(node, part):
                node.add_module(part, _Holder())
            node = getattr(node, part)
        node.register_buffer(leaf, value.clone())
    torch.jit.save(torch.jit.script(root), str(path))


def test_config_and_split_equal_jax(tower):
    sd = openai_state_dict()
    cfg = clip_import.infer_clip_config(sd)
    assert cfg == j_clip_import.infer_clip_config(sd)
    assert (cfg["text_width"], cfg["text_layers"], cfg["embed_dim"]) == (64, 2, 48)
    assert (cfg["vision_kind"], cfg["input_resolution"], cfg["vision_layers"]) == ("vit", 32, 2)
    text, vision = clip_import.split_clip_state_dict(sd)
    j_text, j_vision = j_clip_import.split_clip_state_dict(sd)
    for got, want in ((text, nested_to_flat(j_text)), (vision, nested_to_flat(j_vision))):
        assert set(got) == set(want)
        for key, value in want.items():
            assert got[key].dtype == torch.float32 and np.array_equal(got[key].numpy(), value), key


@pytest.mark.parametrize("kind", ["script", "state_dict"])
def test_load_clip_state_dict_reads_both_archives(tower, tmp_path, kind):
    sd = openai_state_dict()
    path = tmp_path / "clip.pt"
    if kind == "script":
        save_torchscript(sd, path)
    else:
        torch.save(sd, path)
    got = clip_import.load_clip_state_dict(path)
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def _write(sd: dict, tmp_path, fmt: str):
    if fmt == "pt":
        path = tmp_path / "clip.pt"
        torch.save(sd, path)
        return path
    text = {k: v.float().numpy() for k, v in sd.items() if k.startswith(clip_import.TEXT_KEYS)}
    prefix = "quest_encoder." if fmt == "npz_prefixed" else ""
    path = tmp_path / "tower.npz"
    np.savez(path, **{prefix + k: v for k, v in text.items()})
    return path


@pytest.mark.parametrize("fmt", ["pt", "npz", "npz_prefixed"])
def test_load_clip_text_weights_matches_jax(tower, tmp_path, fmt):
    sd = openai_state_dict()
    path = _write(sd, tmp_path, fmt)
    j_runner = JRunner(Box(dict(type="qa-tiger", debug=False, log_interval=100,
                                hyper_params=dict(model=dict(TOY), optim=OPTIM))),
                       j_config(**TOY), qa_tiger_init, qa_tiger_forward, J_FROZEN,
                       mesh=make_mesh(1, devices=jax.devices("cpu")), seed=5)
    runner = AVQARunner({"hyper_params": {"optim": OPTIM}}, qa_tiger_config(**TOY),
                        device="cpu", seed=5)
    j_runner.load_clip_text_weights(str(path))
    runner.load_clip_text_weights(path)

    want = nested_to_flat(jax.tree_util.tree_map(np.asarray, j_runner.frozen["quest_encoder"]))
    got = runner.model.quest_encoder.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert np.array_equal(got[key].numpy(), value), key
        assert np.array_equal(value, sd[key].float().numpy()), key

    toks = np.zeros((3, 77), np.int64)
    toks[:, 0] = VOCAB - 2
    toks[0, 1:6] = [5, 9, 2, 7, VOCAB - 1]
    toks[1, 1:3] = [7, VOCAB - 1]
    toks[2, 1:20] = np.r_[np.arange(100, 118), VOCAB - 1]
    j_pooled, j_words = j_clip_text.clip_text_encode(
        j_runner.frozen["quest_encoder"], jax.numpy.asarray(toks), encoder_type="clip-test")
    with torch.no_grad():
        pooled, words = runner.model.quest_encoder(torch.from_numpy(toks))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(j_pooled), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(words.numpy(), np.asarray(j_words), rtol=1e-5, atol=1e-5)


def test_load_is_strict_and_casts_to_the_encoder_dtype(tower, tmp_path):
    """A tower file missing a parameter is refused; a whole one lands in
    the tower's ``encoder_dtype`` (bf16 here) and nowhere else."""
    sd = openai_state_dict()
    path = _write(sd, tmp_path, "npz")
    runner = AVQARunner({"hyper_params": {"optim": OPTIM}},
                        qa_tiger_config(**TOY, encoder_dtype="bfloat16"), device="cpu", seed=5)
    before = {n: p.detach().clone() for n, p in runner.trainable()}
    runner.load_clip_text_weights(path)
    tower_params = runner.model.quest_encoder.state_dict()
    assert all(v.dtype == torch.bfloat16 for v in tower_params.values())
    assert torch.equal(tower_params["ln_final.weight"], sd["ln_final.weight"].bfloat16())
    assert all(torch.equal(p, before[n]) for n, p in runner.trainable())
    with np.load(path) as data:
        partial = {k: data[k] for k in data.files if k != "ln_final.weight"}
    np.savez(tmp_path / "partial.npz", **partial)
    with pytest.raises(RuntimeError, match="ln_final.weight"):
        runner.load_clip_text_weights(tmp_path / "partial.npz")
