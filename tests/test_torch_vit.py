"""The port's ToMe ViT (``models/vit.py``), CLIP image tower
(``models/clip_image.py``) and the key-bias attention behind them, against
qa_tiger_tpu's on the same numpy inputs.

The JAX parameters (``vit_init``, ``clip_vision_init``, perturbed so that
biases and LayerNorm parameters are not trivial) are carried across with
``params_from_jax`` and loaded strictly. fp32 on the CPU: rtol 2e-4 /
atol 5e-5, the tolerance tests/test_vit.py holds the JAX ViT to against its
torch oracle (reduction orders differ through 3 layers and the merges).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qa_tiger_tpu.models import clip_image as j_clip_image
from qa_tiger_tpu.models import vit as j_vit
from qa_tiger_tpu.ops.pallas.attention import attention_wide as j_attention_wide
from qa_tiger_tpu_torch.convert import params_from_jax
from qa_tiger_tpu_torch.models import clip_image, vit
from qa_tiger_tpu_torch.ops import _grad
from qa_tiger_tpu_torch.ops import attention as A
from qa_tiger_tpu_torch.ops.tome import tome_schedule

TOL = dict(rtol=2e-4, atol=5e-5)
TINY_VIT = dict(img_size=32, patch_size=8, width=64, depth=3, heads=4, ln_eps=1e-6)
TINY_CLIP = dict(input_resolution=32, patch_size=8, width=64, layers=2, heads=4, output_dim=48)


@pytest.fixture
def tiny(monkeypatch):
    for mod in (j_vit, vit):
        monkeypatch.setitem(mod.VIT_CONFIGS, "tiny-vit", TINY_VIT)
    for mod in (j_clip_image, clip_image):
        monkeypatch.setitem(mod.CLIP_VISION_CONFIGS, "tiny-vis", TINY_CLIP)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _vit_pair(fc_norm=False):
    params = j_vit.vit_init(jax.random.PRNGKey(0), "tiny-vit")
    if fc_norm:
        params["fc_norm"] = {"weight": jnp.ones(64), "bias": jnp.zeros(64)}
    params = _perturbed(params, 1)
    model = vit.VisionTransformer("tiny-vit", seed=5, fc_norm=fc_norm)
    model.load_state_dict(params_from_jax(params), strict=True)
    return params, model


def _images(seed, b=2, size=32):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3), dtype=np.float32)


@pytest.mark.parametrize("rs", [[0, 0, 0], [3, 3, 3], [5, 5, 5]])
def test_vit_forward_tome(tiny, rs):
    params, model = _vit_pair()
    imgs = _images(2)
    want = j_vit.vit_forward(params, jnp.asarray(imgs), name="tiny-vit", tome_r=rs,
                             trace_source=True)
    with torch.no_grad():
        got = vit.vit_forward(model, torch.tensor(imgs), tome_r=rs, trace_source=True)
    tokens = tome_schedule(17, rs)[-1][1]  # r is capped at half the tokens
    assert got["tokens"].shape == want["tokens"].shape == (2, tokens, 64)
    for key in ("tokens", "cls", "tokens_pre_norm"):
        _close(got[key], want[key])
    if sum(rs):
        _close(got["size"], want["size"], rtol=0, atol=0)
        np.testing.assert_array_equal(got["source"].numpy(), np.asarray(want["source"]))
        assert len(got["merges"]) == 3
    else:
        assert got["size"] is want["size"] is None and got["merges"] == []


@pytest.mark.parametrize("rs", [None, [2, 2, 0]])
def test_vit_global_pool(tiny, rs):
    """MAE's pooling: size-weighted over the original patch count, through
    fc_norm; proportional attention off, as MAE runs."""
    params, model = _vit_pair(fc_norm=True)
    imgs = _images(3)
    want = j_vit.vit_forward(params, jnp.asarray(imgs), name="tiny-vit", tome_r=rs,
                             prop_attn=False, global_pool=True)
    with torch.no_grad():
        got = vit.vit_forward(model, torch.tensor(imgs), tome_r=rs, prop_attn=False,
                              global_pool=True)
    _close(got["gap"], want["gap"])
    _close(got["tokens"], want["tokens"])


def test_swag_state_dict_loads_strictly(tiny):
    """A SWAG (torchvision-named) state_dict renamed by the port loads into
    the timm-named module and gives JAX's converted forward."""
    w, p = 64, 8
    rng = np.random.default_rng(3)
    sd = {"class_token": rng.standard_normal((1, 1, w)),
          "conv_proj.weight": 0.05 * rng.standard_normal((w, 3, p, p)),
          "conv_proj.bias": rng.standard_normal(w),
          "encoder.pos_embedding": rng.standard_normal((1, 17, w)),
          "encoder.ln.weight": rng.standard_normal(w), "encoder.ln.bias": rng.standard_normal(w)}
    for i in range(3):
        pre = f"encoder.layers.encoder_layer_{i}."
        for name, shape in (("ln_1.weight", w), ("ln_1.bias", w), ("ln_2.weight", w),
                            ("ln_2.bias", w), ("self_attention.in_proj_weight", (3 * w, w)),
                            ("self_attention.in_proj_bias", 3 * w),
                            ("self_attention.out_proj.weight", (w, w)),
                            ("self_attention.out_proj.bias", w), ("mlp.0.weight", (4 * w, w)),
                            ("mlp.0.bias", 4 * w), ("mlp.3.weight", (w, 4 * w)),
                            ("mlp.3.bias", w)):
            sd[pre + name] = 0.1 * rng.standard_normal(shape)
    model = vit.VisionTransformer("tiny-vit")
    model.load_state_dict(vit.swag_state_dict_to_vit(sd), strict=True)
    imgs = _images(4, b=1)
    want = j_vit.vit_forward(j_vit.swag_state_dict_to_vit(sd), jnp.asarray(imgs),
                             name="tiny-vit", tome_r=[2, 2])
    with torch.no_grad():
        got = vit.vit_forward(model, torch.tensor(imgs), tome_r=[2, 2])
    _close(got["tokens"], want["tokens"])


def test_clip_vision_encode(tiny):
    params = _perturbed(j_clip_image.clip_vision_init(jax.random.PRNGKey(1), "tiny-vis"), 6)
    model = clip_image.CLIPVisionTower("tiny-vis", seed=2)
    model.load_state_dict(params_from_jax(params), strict=True)
    imgs = _images(5)
    j_cls, j_tokens = j_clip_image.clip_vision_encode(params, jnp.asarray(imgs), name="tiny-vis")
    with torch.no_grad():
        t_cls, t_tokens = clip_image.clip_vision_encode(model, torch.tensor(imgs))
    assert t_cls.shape == (2, 48) and t_tokens.shape == (2, 16, 64)
    _close(t_cls, j_cls)
    _close(t_tokens, j_tokens)
    frames = np.random.default_rng(6).integers(0, 256, (2, 4, 4, 3), dtype=np.uint8)
    _close(clip_image.preprocess_frames(torch.tensor(frames)),
           j_clip_image.preprocess_frames(jnp.asarray(frames)), rtol=1e-6, atol=1e-6)


def test_key_bias_attention_gradients():
    """The key-bias plain version and every gradient, dkey_bias included,
    against jax.vjp of the JAX wrapper with its Pallas kernel in interpret
    mode (custom_vjp: real cotangents for q, k, v and key_bias). The port's
    side runs through the autograd Function that wraps the CUDA kernel, with
    the plain version standing in for the kernel."""
    rng = np.random.default_rng(7)
    B, Sq, Sk, W, heads, scale = 3, 9, 13, 32, 4, 0.3
    q, k, v, g = (rng.standard_normal((B, s, W), dtype=np.float32) for s in (Sq, Sk, Sk, Sq))
    kb = np.log(rng.integers(1, 30, (B, Sk))).astype(np.float32)

    def j_fn(q_, k_, v_, kb_):
        return j_attention_wide(q_, k_, v_, None, scale, heads, interpret=True, key_bias=kb_)

    want, vjp = jax.vjp(j_fn, *map(jnp.asarray, (q, k, v, kb)))
    want_grads = vjp(jnp.asarray(g))
    ins = [torch.tensor(a, requires_grad=True) for a in (q, k, v, kb)]
    consts = dict(mask=None, scale=scale, heads=heads)
    got = _grad.KernelWithPlainGrad.apply(
        lambda *t, **c: A._wide_reference_kb(*t, **c), A._wide_reference_kb, consts, *ins)
    got_grads = torch.autograd.grad(got, ins, torch.tensor(g))
    _close(got, want)
    for gg, wg in zip(got_grads, want_grads):
        _close(gg, wg)
    # the CPU wrapper's own path (the plain version under autograd) agrees
    plain = A.attention_wide(*ins[:3], None, scale, heads, key_bias=ins[3])
    for gg, pg in zip(got_grads, torch.autograd.grad(plain, ins, torch.tensor(g))):
        _close(gg, pg.detach().numpy())
