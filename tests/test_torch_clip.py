"""The port's CLIP model surface (``models/clip_resnet.py``,
``models/clip.py``) and the ToMe merge visualisation (``pipeline/vis.py``)
against qa_tiger_tpu's, on the CPU.

No CLIP checkpoint is in the repository, so the towers are tiny configs
registered in both packages at test time (as
tests/test_clip_resnet_parity.py registers "tiny-rn"): a ModifiedResNet of
layers (1, 1, 1, 1), width 8, output 32 at 64 pixels, a two-block ViT
(32 pixels, 8-pixel patches, width 64) and two-block text towers whose
embedding width matches each. The JAX parameters (perturbed, so that
biases and norms are not trivial; BatchNorm's running statistics drawn at
random) go to the port through ``params_from_jax`` or through a ``.pt`` in
OpenAI's names that both packages' ``load`` read. fp32 on the CPU, the JAX
side at matmul precision "highest" (tests/conftest.py). Features: rtol 1e-4
/ atol 2e-4, the tolerance tests/test_clip_resnet_parity.py holds the JAX
tower to upstream with; logits carry exp(2.6592) = 14.3 times the cosine,
so atol 3e-3 there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qa_tiger_tpu.models import clip as j_clip
from qa_tiger_tpu.models import clip_image as j_clip_image
from qa_tiger_tpu.models import clip_resnet as j_clip_resnet
from qa_tiger_tpu.models import clip_text as j_clip_text
from qa_tiger_tpu.models import vit as j_vit
from qa_tiger_tpu.pipeline import vis as j_vis
from qa_tiger_tpu_torch.convert import nested_to_flat, params_from_jax
from qa_tiger_tpu_torch.models import clip, clip_image, clip_resnet, clip_text, vit
from qa_tiger_tpu_torch.pipeline import vis

FEAT_TOL = dict(rtol=1e-4, atol=2e-4)
LOGIT_TOL = dict(rtol=1e-4, atol=3e-3)
TINY_RN = dict(layers=(1, 1, 1, 1), width=8, output_dim=32, input_resolution=64)
TINY_VIS = dict(input_resolution=32, patch_size=8, width=64, layers=2, heads=4, output_dim=48)
TEXT = {"RN-tiny": dict(width=64, heads=4, layers=2, embed_dim=32),
        "ViT-tiny": dict(width=64, heads=4, layers=2, embed_dim=48)}
PIXELS = {"RN-tiny": 64, "ViT-tiny": 32}
TINY_VIT = dict(img_size=32, patch_size=8, width=64, depth=3, heads=4, ln_eps=1e-6)
VOCAB = 49408


@pytest.fixture
def tiny(monkeypatch):
    for mod in (j_clip_resnet, clip_resnet):
        monkeypatch.setitem(mod.CLIP_RESNET_CONFIGS, "tiny-rn", TINY_RN)
        monkeypatch.setitem(mod.CLIP_RESNET_CONFIGS, "RN-tiny", TINY_RN)
    for mod in (j_clip_image, clip_image):
        monkeypatch.setitem(mod.CLIP_VISION_CONFIGS, "ViT-tiny", TINY_VIS)
    for mod in (j_clip_text, clip_text):
        for name, cfg in TEXT.items():
            monkeypatch.setitem(mod.CLIP_TEXT_CONFIGS, name, cfg)
    for mod in (j_vit, vit):
        monkeypatch.setitem(mod.VIT_CONFIGS, "tiny-vit", TINY_VIT)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        params)


def _bn_stats(params, seed):
    """Random running statistics for every BatchNorm of a JAX RN tree, so
    that eval-mode BatchNorm is not the identity."""
    rng = np.random.default_rng(seed)

    def visit(node):
        if isinstance(node, dict):
            if "running_mean" in node:
                n = np.shape(node["running_mean"])
                node["running_mean"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
                node["running_var"] = (rng.random(n) + 0.5).astype(np.float32)
            for v in node.values():
                visit(v)
    visit(params)
    return params


def rn_params(name="tiny-rn", seed=0):
    return _bn_stats(_perturbed(j_clip_resnet.clip_resnet_init(jax.random.PRNGKey(seed), name),
                                seed + 1), seed + 2)


def _images(seed, b, size):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3), dtype=np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("batch,seed", [(1, 0), (2, 3), (3, 5)])
def test_resnet_encode_matches_jax(tiny, batch, seed):
    params = rn_params(seed=seed)
    model = clip_resnet.CLIPResNetTower("tiny-rn", seed=9)
    model.load_state_dict(params_from_jax(params), strict=True)
    imgs = _images(seed + 7, batch, 64)
    want, want_tokens = j_clip_resnet.clip_resnet_encode(params, jnp.asarray(imgs), name="tiny-rn")
    with torch.no_grad():
        got, tokens = clip_resnet.clip_resnet_encode(model, torch.from_numpy(imgs))
    assert got.shape == (batch, 32) and tokens.shape == (batch, 4, 256)
    _close(got, want, FEAT_TOL)
    _close(tokens, want_tokens, FEAT_TOL)


def test_resnet_state_dict_and_init_match_jax(tiny):
    """The port's names and shapes are the JAX tree's flattened; the init
    has clip_resnet_init's statistics (BatchNorm at 1, 0, 0, 1; conv
    weights within 1/sqrt(fan_in); the positional embedding at std
    embed^-0.5)."""
    want = {k: np.shape(v) for k, v in nested_to_flat(
        j_clip_resnet.clip_resnet_init(jax.random.PRNGKey(0), "RN50")).items()}
    model = clip_resnet.CLIPResNetTower("RN50", seed=1)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    sd = model.state_dict()
    assert set(dict(model.named_buffers())) == {k for k in sd if k.endswith(("running_mean",
                                                                              "running_var"))}
    for key, value in sd.items():
        if key.endswith(("bn1.weight", "bn3.weight", "running_var", "downsample.1.weight")):
            assert torch.equal(value, torch.ones_like(value)), key
        if key.endswith(("bn2.bias", "running_mean")):
            assert torch.equal(value, torch.zeros_like(value)), key
        if key.endswith("conv2.weight"):
            fan_in = value.shape[1] * 9
            assert value.abs().max() <= fan_in ** -0.5 and value.std() > 0.4 * fan_in ** -0.5
    pos = sd["attnpool.positional_embedding"]
    assert abs(pos.std().item() * 2048 ** 0.5 - 1) < 0.05
    assert clip_resnet.resnet_config("RN50")["heads"] == 32


def openai_state_dict(encoder_type, seed=0, batches_tracked=True):
    """A CLIP state_dict in OpenAI's names (fp32): the JAX text tower and
    image tower from a seed, perturbed, the archives' integer entries, and
    for an RN tower the ``num_batches_tracked`` of each BatchNorm."""
    text = _perturbed(j_clip_text.clip_text_init(jax.random.PRNGKey(seed), encoder_type),
                      seed + 1)
    if encoder_type.startswith("RN"):
        visual = rn_params(encoder_type, seed + 2)
    else:
        visual = _perturbed(j_clip_image.clip_vision_init(jax.random.PRNGKey(seed + 2),
                                                          encoder_type), seed + 3)
    sd = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in nested_to_flat(text).items()}
    for key, value in nested_to_flat(visual).items():
        sd["visual." + key] = torch.from_numpy(np.array(value, np.float32))
        if batches_tracked and key.endswith("running_var"):
            sd["visual." + key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    sd.update(input_resolution=torch.tensor(PIXELS[encoder_type]),
              context_length=torch.tensor(77), vocab_size=torch.tensor(VOCAB))
    return sd


class _Holder(torch.nn.Module):
    """Buffers under dotted names, for a TorchScript archive."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _save(sd: dict, path, kind: str) -> None:
    if kind == "state_dict":
        torch.save(sd, path)
        return
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


@pytest.mark.parametrize("kind", ["state_dict", "script"])
@pytest.mark.parametrize("encoder_type", ["RN-tiny", "ViT-tiny"])
def test_load_equals_jax_in_both_archive_forms(tiny, tmp_path, kind, encoder_type):
    path = tmp_path / "clip.pt"
    _save(openai_state_dict(encoder_type), path, kind)
    text, vision, cfg = clip.load(str(path))
    j_text, j_vision, j_cfg = j_clip.load(str(path))
    assert cfg == j_cfg
    assert cfg["vision_kind"] == ("resnet" if encoder_type.startswith("RN") else "vit")
    for got, want in ((text, nested_to_flat(j_text)), (vision, nested_to_flat(j_vision))):
        assert set(got) == set(want)
        for key, value in want.items():
            assert np.array_equal(got[key].numpy(), value), key


def test_build_towers_is_strict_and_drops_num_batches_tracked(tiny, tmp_path):
    path = tmp_path / "rn.pt"
    torch.save(openai_state_dict("RN-tiny"), path)
    text, vision, _ = clip.load(str(path))
    assert any(k.endswith("num_batches_tracked") for k in vision)
    text_tower, rn = clip.build_towers(text, vision, "RN-tiny", device="cpu")
    assert isinstance(rn, clip_resnet.CLIPResNetTower) and not rn.training
    assert torch.equal(rn.state_dict()["bn1.running_var"], vision["bn1.running_var"])
    assert not any(p.requires_grad for p in text_tower.parameters())
    partial = {k: v for k, v in vision.items() if k != "layer2.0.bn3.running_mean"}
    with pytest.raises(RuntimeError, match="layer2.0.bn3.running_mean"):
        clip.build_towers(text, partial, "RN-tiny", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        # no card here: the default device refuses, it does not fall back
        clip.build_towers(text, vision, "RN-tiny")


def _tokens(n):
    toks = np.zeros((n, 77), np.int64)
    rng = np.random.default_rng(11)
    for i in range(n):
        k = int(rng.integers(3, 30))
        toks[i, 0] = VOCAB - 2
        toks[i, 1:k] = rng.integers(1, VOCAB - 2, k - 1)
        toks[i, k] = VOCAB - 1
    return toks


@pytest.mark.parametrize("encoder_type", ["RN-tiny", "ViT-tiny"])
def test_clip_forward_matches_jax(tiny, tmp_path, encoder_type):
    """load -> build_towers -> clip_forward against JAX's load ->
    clip_forward on the same .pt, images and tokens: the features and both
    logit matrices."""
    path = tmp_path / "clip.pt"
    torch.save(openai_state_dict(encoder_type, seed=4), path)
    text, vision, _ = clip.load(str(path))
    text_tower, vision_tower = clip.build_towers(text, vision, encoder_type, device="cpu")
    j_text, j_vision, _ = j_clip.load(str(path))
    imgs = _images(12, 3, PIXELS[encoder_type])
    toks = _tokens(4)
    want_i, want_t = j_clip.clip_forward(j_text, j_vision, jnp.asarray(imgs), jnp.asarray(toks),
                                         encoder_type=encoder_type)
    with torch.no_grad():
        got_i, got_t = clip.clip_forward(text_tower, vision_tower, torch.from_numpy(imgs),
                                         torch.from_numpy(toks), encoder_type=encoder_type)
        text_feat, _ = text_tower(torch.from_numpy(toks))
        encode = (clip_resnet.clip_resnet_encode if encoder_type.startswith("RN")
                  else clip_image.clip_vision_encode)
        image_feat, _ = encode(vision_tower, torch.from_numpy(imgs))
    j_text_feat, _ = j_clip_text.clip_text_encode(j_text, jnp.asarray(toks),
                                                  encoder_type=encoder_type)
    j_encode = (j_clip_resnet.clip_resnet_encode if encoder_type.startswith("RN")
                else j_clip_image.clip_vision_encode)
    j_image_feat, _ = j_encode(j_vision, jnp.asarray(imgs), name=encoder_type)
    assert got_i.shape == (3, 4) and got_t.shape == (4, 3)
    _close(text_feat, j_text_feat, FEAT_TOL)
    _close(image_feat, j_image_feat, FEAT_TOL)
    _close(got_i, want_i, LOGIT_TOL)
    _close(got_t, want_t, LOGIT_TOL)


@pytest.mark.parametrize("encoder_type", ["RN101", "RN50x4", "RN-notext"])
def test_encoder_types_without_a_text_config_raise_as_jax(tiny, monkeypatch, encoder_type):
    """RN101 and RN50x4 have image towers but no text config: JAX's
    clip_forward raises KeyError from ``text_config``, and so does the
    port's, with the same reason (before it runs any tower). The messages'
    lists of known types are not compared: other tests register their own
    tiny types in either package."""
    def reason(exc) -> str:
        return str(exc.value).split("; known")[0]

    for mod in (j_clip_resnet, clip_resnet):
        monkeypatch.setitem(mod.CLIP_RESNET_CONFIGS, "RN-notext", TINY_RN)
    with pytest.raises(KeyError) as want:
        j_clip_text.text_config(encoder_type)
    with pytest.raises(KeyError) as got:
        clip.clip_forward(None, None, None, None, encoder_type=encoder_type)
    assert reason(got) == reason(want)
    assert f"unknown CLIP encoder type {encoder_type!r}" in reason(got)
    if encoder_type == "RN-notext":
        params = rn_params("RN-notext")
        with pytest.raises(KeyError) as jax_side:
            j_clip.clip_forward({}, params, jnp.asarray(_images(0, 1, 64)),
                                jnp.asarray(_tokens(1)), encoder_type=encoder_type)
        assert reason(jax_side) == reason(got)


def test_unknown_model_name_raises_keyerror(tmp_path):
    with pytest.raises(KeyError) as want:
        j_clip.load("RN51", download_root=str(tmp_path))
    with pytest.raises(KeyError) as got:
        clip.load("RN51", download_root=str(tmp_path))
    assert str(got.value) == str(want.value)
    assert clip.available_models() == j_clip.available_models()
    assert clip._MODELS == j_clip._MODELS
    assert not any(tmp_path.iterdir())


# ---------------------------------------------------------------- vis

GRID, PATCH, GROUPS = 8, 16, 12


def _source(seed=0, class_token=True):
    """Every patch token traces to one merged group ({0, 1} rows), plus a
    class-token column."""
    rng = np.random.default_rng(seed)
    tokens = GRID * GRID + int(class_token)
    src = np.zeros((GROUPS, tokens), np.float32)
    owner = rng.integers(0, GROUPS, tokens)
    owner[:GROUPS] = np.arange(GROUPS)
    src[owner, np.arange(tokens)] = 1.0
    return src


@pytest.mark.parametrize("class_token", [True, False])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_vis_equals_jax(class_token, as_tensor):
    src = _source(1, class_token)
    image = np.random.default_rng(2).random((GRID * PATCH, GRID * PATCH, 3)).astype(np.float32)
    arg = torch.from_numpy(src) if as_tensor else src
    np.testing.assert_array_equal(vis.group_assignment(arg, class_token),
                                  j_vis.group_assignment(src, class_token))
    got = vis.make_visualization(image, arg, patch_size=PATCH, class_token=class_token, seed=3)
    want = j_vis.make_visualization(image, src, patch_size=PATCH, class_token=class_token,
                                    seed=3)
    assert got.shape == image.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_vis_colormap_is_deterministic():
    a, b = vis.generate_colormap(20, seed=5), vis.generate_colormap(20, seed=5)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, j_vis.generate_colormap(20, seed=5))
    assert a.dtype == np.float32 and a.min() >= 0.25 and a.max() <= 1.0
    assert not np.array_equal(a, vis.generate_colormap(20, seed=6))
    with pytest.raises(ValueError, match="square"):
        vis.group_assignment(np.ones((3, 1 + 12), np.float32))


@pytest.mark.parametrize("rs", [[3, 3, 3], [5, 2, 0]])
def test_vis_of_the_ports_tome_provenance_equals_jax(tiny, rs):
    """The port's ``vit_forward(trace_source=True)`` and JAX's at a tiny
    ToMe config give equal group maps and overlays for every image."""
    params = _perturbed(j_vit.vit_init(jax.random.PRNGKey(0), "tiny-vit"), 1)
    model = vit.VisionTransformer("tiny-vit", seed=5)
    model.load_state_dict(params_from_jax(params), strict=True)
    imgs = _images(2, 2, 32)
    want = j_vit.vit_forward(params, jnp.asarray(imgs), name="tiny-vit", tome_r=rs,
                             trace_source=True)["source"]
    with torch.no_grad():
        got = vit.vit_forward(model, torch.from_numpy(imgs), tome_r=rs,
                              trace_source=True)["source"]
    pixels = (imgs * 0.1 + 0.5).clip(0, 1)
    for i in range(2):
        np.testing.assert_array_equal(vis.group_assignment(got[i]),
                                      j_vis.group_assignment(np.asarray(want[i])))
        np.testing.assert_array_equal(
            vis.make_visualization(pixels[i], got[i], patch_size=8),
            j_vis.make_visualization(pixels[i], np.asarray(want[i]), patch_size=8))
