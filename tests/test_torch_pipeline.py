"""The port's raw-media pipeline against qa_tiger_tpu's on the same numpy
inputs: the log-mel frontend, VGGish at full size, the raw-media forward on
a tiny configuration, and the extraction stages over a synthetic jpg/wav
corpus (built as tests/test_extract.py builds it).

Weights come from the JAX initialisers (perturbed where they are zeros or
ones), carried across with ``params_from_jax`` and loaded strictly. fp32 on
the CPU; each tolerance is stated where it is used.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qa_tiger_tpu.models import clip_image as j_clip_image
from qa_tiger_tpu.models import clip_text as j_clip_text
from qa_tiger_tpu.models import vit as j_vit
from qa_tiger_tpu.models.qa_tiger import qa_tiger_config as j_qa_config
from qa_tiger_tpu.ops import mel as j_mel
from qa_tiger_tpu.pipeline import e2e as j_e2e
from qa_tiger_tpu.pipeline import extract as j_extract
from qa_tiger_tpu.pipeline import vggish as j_vggish
from qa_tiger_tpu_torch.convert import params_from_jax
from qa_tiger_tpu_torch.models import clip_image, clip_text, vit
from qa_tiger_tpu_torch.models.qa_tiger import qa_tiger_config
from qa_tiger_tpu_torch.ops import mel
from qa_tiger_tpu_torch.pipeline import e2e
from qa_tiger_tpu_torch.pipeline import extract as E
from qa_tiger_tpu_torch.pipeline import vggish

# fp32 through rFFT and log on both sides: the FFT libraries differ in the
# last bits
MEL_TOL = dict(rtol=1e-4, atol=1e-4)
# fp32 through 8 conv/dense layers of 64-4096 channels (the ViT tolerance)
NET_TOL = dict(rtol=2e-4, atol=5e-5)


def _perturbed(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (scale * rng.standard_normal(np.shape(a))).astype(np.float32)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a), params)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), **tol)


def test_log_mel_and_examples():
    rng = np.random.default_rng(0)
    secs = (0.1 * rng.standard_normal((3, 16000))).astype(np.float32)
    _close(mel.log_mel_spectrogram(torch.tensor(secs)),
           j_mel.log_mel_spectrogram(jnp.asarray(secs)), MEL_TOL)
    got = mel.waveform_to_examples(torch.tensor(secs))
    assert got.shape == (3, 1, 96, 64)
    _close(got, j_mel.waveform_to_examples(jnp.asarray(secs)), MEL_TOL)
    np.testing.assert_array_equal(mel.mel_matrix(), j_mel.mel_matrix())
    assert mel.stft_params() == j_mel.stft_params() == (400, 160, 512)


def test_vggish_forward_full_size():
    """B=2 at the released network's widths; a flatten in NCHW order (not
    TF's NHWC) would permute fc1's inputs and fail here."""
    params = _perturbed(j_vggish.vggish_init(jax.random.PRNGKey(0)), 1, scale=0.01)
    model = vggish.VGGish(seed=3)
    model.load_state_dict(params_from_jax(params), strict=True)
    patches = np.random.default_rng(2).standard_normal((2, 96, 64), dtype=np.float32)
    want = j_vggish.vggish_forward(jax.tree_util.tree_map(jnp.asarray, params),
                                   jnp.asarray(patches))
    with torch.no_grad():
        got = vggish.vggish_forward(model, torch.tensor(patches))
    assert got.shape == (2, 128) and float(got.abs().max()) > 0
    _close(got, want, dict(rtol=2e-4, atol=2e-6))


def test_vggish_checkpoint_names(tmp_path):
    """TF variable names in an .npz load strictly into the module."""
    flat = {"vggish/" + k.replace(".", "/"): v.numpy()
            for k, v in vggish.VGGish(seed=1).state_dict().items()}
    np.savez(tmp_path / "vggish.npz", **flat)
    model = vggish.VGGish(seed=2)
    model.load_state_dict(vggish.load_npz_checkpoint(tmp_path / "vggish.npz"), strict=True)
    assert torch.equal(model.fc1.fc1_1.weights, vggish.VGGish(seed=1).fc1.fc1_1.weights)


def test_audio_host_helpers(tmp_path):
    snd = np.arange(300, dtype=np.float32)
    np.testing.assert_array_equal(vggish.pad_audio_last_second(snd, 100, 5),
                                  j_vggish.pad_audio_last_second(snd, 100, 5))
    from scipy.io import wavfile

    wav = (np.random.default_rng(0).standard_normal(16000 * 3) * 3000).astype(np.int16)
    wavfile.write(tmp_path / "a.wav", 16000, wav)
    got = vggish.wavfile_to_examples(tmp_path / "a.wav", num_secs=5)
    want = j_vggish.wavfile_to_examples(tmp_path / "a.wav", num_secs=5)
    np.testing.assert_allclose(got, want, **MEL_TOL)
    assert np.all(got[3:] == 0)


# ---------------------------------------------------------------------------
# raw media -> logits, the tiny fixture of tests/test_e2e.py
# ---------------------------------------------------------------------------

TINY_CLIP = dict(input_resolution=32, patch_size=8, width=32, layers=2, heads=4, output_dim=48)
TINY_TEXT = dict(width=48, heads=4, layers=2, embed_dim=48)
TINY_VIT = dict(img_size=32, patch_size=8, width=24, depth=3, heads=4, ln_eps=1e-6)
TOY = dict(d_model=32, video_dim=48, patch_dim=24, audio_dim=128, topK=2, num_experts=4,
           num_labels=42, encoder_type="tiny-vis")


@pytest.fixture
def tiny(monkeypatch):
    for mod in (j_clip_image, clip_image):
        monkeypatch.setitem(mod.CLIP_VISION_CONFIGS, "tiny-vis", TINY_CLIP)
    for mod in (j_clip_text, clip_text):
        monkeypatch.setitem(mod.CLIP_TEXT_CONFIGS, "tiny-vis", TINY_TEXT)
    for mod in (j_vit, vit):
        monkeypatch.setitem(mod.VIT_CONFIGS, "tiny-tome", TINY_VIT)
        monkeypatch.setitem(mod.VIT_CONFIGS, "tiny-vit", dict(TINY_VIT, width=16))
    kw = dict(clip_encoder="tiny-vis", tome_model="tiny-tome", tome_r=3, tome_layers=3)
    return (j_e2e.e2e_config(j_qa_config(**TOY), **kw),
            e2e.e2e_config(qa_tiger_config(**TOY), **kw))


def _e2e_pair(cfgs, seed=0):
    j_cfg, t_cfg = cfgs
    params = _perturbed(j_e2e.e2e_init(jax.random.PRNGKey(seed), j_cfg), seed + 1, scale=0.02)
    model = e2e.e2e_init(t_cfg, seed=seed + 2, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return params, model


def _media(seed, B=2, T=3):
    rng = np.random.default_rng(seed)
    toks = np.zeros((B, 77), np.int64)
    toks[:, 0], toks[:, 1], toks[:, 2] = 49406, 320, 49407
    return (rng.standard_normal((B, T, 32, 32, 3), dtype=np.float32),
            rng.standard_normal((B, T, 32, 32, 3), dtype=np.float32),
            (0.1 * rng.standard_normal((B, T, 16000))).astype(np.float32), toks)


def test_encode_media_and_logits(tiny):
    """Every stream and the logits; the tolerance of the ViT parity tests."""
    params, model = _e2e_pair(tiny)
    clip_f, tome_f, pcm, toks = _media(1)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    want = j_e2e.encode_media(j_params, *map(jnp.asarray, (clip_f, tome_f, pcm)), tiny[0])
    want_logits = j_e2e.e2e_forward(j_params, *map(jnp.asarray, (clip_f, tome_f, pcm, toks)),
                                    tiny[0])
    with torch.no_grad():
        got = e2e.encode_media(model, *map(torch.tensor, (clip_f, tome_f, pcm)), tiny[1])
        logits = e2e.e2e_forward(model, *map(torch.tensor, (clip_f, tome_f, pcm, toks)),
                                 tiny[1])
    shapes = {"video": (2, 3, 48), "patch": (2, 3, 8, 24), "audio": (2, 3, 128)}
    for key, shape in shapes.items():
        assert tuple(got[key].shape) == shape
        _close(got[key], want[key], NET_TOL)
    assert logits.shape == (2, 42)
    _close(logits, want_logits, NET_TOL)


def test_e2e_state_dict_names_equal_the_jax_tree(tiny):
    from qa_tiger_tpu_torch.convert import nested_to_flat

    flat = nested_to_flat(jax.tree_util.tree_map(
        np.asarray, j_e2e.e2e_init(jax.random.PRNGKey(0), tiny[0])))
    state = e2e.E2EModel(tiny[1]).state_dict()
    assert set(state) == set(flat)
    assert all(tuple(state[k].shape) == v.shape for k, v in flat.items())


# ---------------------------------------------------------------------------
# the extraction stages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """Synthetic corpus: jpg frame dirs and wavs for 2 videos."""
    from PIL import Image
    from scipy.io import wavfile

    root = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(0)
    for v in ("vid1", "vid2"):
        d = root / "frames" / v
        d.mkdir(parents=True)
        for i in range(5):
            Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
                d / f"{i:06d}.jpg")
    (root / "audio").mkdir()
    for v in ("vid1", "vid2"):
        wavfile.write(root / "audio" / f"{v}.wav", 16000,
                      (rng.standard_normal(16000 * 3) * 2000).astype(np.int16))
    (root / "annot.json").write_text(json.dumps([]))
    return root


@pytest.mark.parametrize("n", [100, 60, 40])
def test_select_frame_paths(n):
    from pathlib import Path

    paths = [Path(f"{i:06d}.jpg") for i in range(n)]
    assert E.select_frame_paths(paths, 60) == j_extract.select_frame_paths(paths, 60)
    with pytest.raises(ValueError):
        E.select_frame_paths([], 60)


def test_load_image_batch(media):
    paths = sorted((media / "frames" / "vid1").glob("*.jpg"))
    got = E.load_image_batch(paths, 32, clip_image.CLIP_MEAN, clip_image.CLIP_STD)
    want = j_extract.load_image_batch(paths, 32, j_clip_image.CLIP_MEAN, j_clip_image.CLIP_STD)
    assert got.shape == (5, 32, 32, 3)
    np.testing.assert_array_equal(got, want)


def test_extraction_stages(tiny, media, tmp_path):
    """Each model stage over the corpus on the CPU: shapes, the padding
    rules (frames 5.. repeat the last frame, seconds 3.. the last second),
    and resumability (a second run rewrites nothing)."""
    run = [("vggish", media / "audio", ["--num-secs", "6"], (6, 128)),
           ("clip", media / "frames", ["--encoder", "tiny-vis"], (60, 48)),
           ("clip-tokens", media / "frames", ["--encoder", "tiny-vis"], (60, 16, 32)),
           ("tome", media / "frames", ["--model", "tiny-vit", "--r", "3", "--layers", "3"],
            (60, 8, 16))]
    for cmd, src, extra, shape in run:
        dst = tmp_path / cmd
        argv = [cmd, "--src", str(src), "--dst", str(dst), "--random-weights",
                "--device", "cpu", *extra]
        E.main(argv)
        out = np.load(dst / "vid1.npy")
        assert out.shape == shape and np.all(np.isfinite(out)), cmd
        last = 3 if cmd == "vggish" else 5
        np.testing.assert_allclose(out[last], out[-1], rtol=1e-5, atol=1e-6)
        before = (dst / "vid1.npy").stat().st_mtime_ns
        E.main(argv)
        assert (dst / "vid1.npy").stat().st_mtime_ns == before
    with pytest.raises(SystemExit, match="random-weights"):
        E.main(["tome", "--src", str(media / "frames"), "--dst", str(tmp_path / "x"),
                "--device", "cpu"])


def test_tome_stage_with_weights(tiny, media, tmp_path):
    """``--weights`` loads a state_dict .npz strictly: JAX's weights give
    JAX's features."""
    params = _perturbed(j_vit.vit_init(jax.random.PRNGKey(0), "tiny-vit"), 1)
    flat = {k: v.numpy() for k, v in params_from_jax(params).items()}
    np.savez(tmp_path / "w.npz", **flat)
    E.main(["tome", "--src", str(media / "frames"), "--dst", str(tmp_path / "o"),
            "--weights", str(tmp_path / "w.npz"), "--model", "tiny-vit", "--r", "3",
            "--layers", "3", "--device", "cpu"])
    paths = j_extract.select_frame_paths(sorted((media / "frames" / "vid2").glob("*.jpg")))
    imgs = j_extract.load_image_batch(paths, 32, (0.5,) * 3, (0.5,) * 3)
    want = j_vit.vit_forward(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(imgs),
                             name="tiny-vit", tome_r=[3] * 3)["tokens"]
    np.testing.assert_allclose(np.load(tmp_path / "o" / "vid2.npy"), np.asarray(want),
                               **NET_TOL)


# ---------------------------------------------------------------------------
# the question and prompt stages (TSPM's features)
# ---------------------------------------------------------------------------

@pytest.fixture
def text_corpus(tiny, tmp_path, monkeypatch):
    """The first 12 val questions (their templates, slot values and ids), a
    merges file learned from their filled questions and prompts through
    QA_TIGER_BPE_VOCAB, and one --weights .npz of JAX's clip_text_init for
    the tiny tower (perturbed), which both packages read."""
    from torch_corpus import val_questions, write_merges

    from qa_tiger_tpu.data.annotations import substitute_template
    from qa_tiger_tpu.data.prompts import match_prompt

    samples = val_questions()[:12]
    annot = tmp_path / "annot.json"
    annot.write_text(json.dumps(samples))
    texts = [f(s["question_content"], s["templ_values"]) for s in samples
             for f in (substitute_template, match_prompt)]
    write_merges(tmp_path / "vocab.txt.gz", texts)
    monkeypatch.setenv("QA_TIGER_BPE_VOCAB", str(tmp_path / "vocab.txt.gz"))
    params = _perturbed(j_clip_text.clip_text_init(jax.random.PRNGKey(0), "tiny-vis"), 1)
    flat = {k: v.numpy() for k, v in params_from_jax(params).items()}
    np.savez(tmp_path / "text.npz", **flat)
    return samples, annot, tmp_path / "text.npz"


@pytest.mark.parametrize("stage", ["questions", "prompts"])
def test_text_stages_match_jax(text_corpus, tmp_path, stage):
    """Both packages' stage over the same annotations, merges file and
    weights: one [1, 48] .npy per question_id, equal at the text tower's
    tolerance (fp32 through 2 blocks); the port's texts are JAX's. A second
    run writes nothing (ids already written are skipped), and a new id in
    the annotations is the only one encoded."""
    samples, annot, weights = text_corpus
    common = ["--annot", str(annot), "--encoder", "tiny-vis", "--weights", str(weights)]
    j_extract.main([stage, "--dst", str(tmp_path / "jax"), *common])
    E.main([stage, "--dst", str(tmp_path / "port"), "--device", "cpu", *common])
    ids = [int(s["question_id"]) for s in samples]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(f"{i}.npy" for i in ids)
    for i in ids:
        got, want = np.load(tmp_path / "port" / f"{i}.npy"), np.load(tmp_path / "jax" / f"{i}.npy")
        assert got.shape == want.shape == (1, 48)
        np.testing.assert_allclose(got, want, **NET_TOL)

    from qa_tiger_tpu.data.annotations import substitute_template
    from qa_tiger_tpu.data.prompts import match_prompt

    fill = match_prompt if stage == "prompts" else substitute_template
    assert E.stage_texts(samples, stage == "prompts") == \
        [fill(s["question_content"], s["templ_values"]) for s in samples]

    first = tmp_path / "port" / f"{ids[0]}.npy"
    before = first.stat().st_mtime_ns
    (tmp_path / "port" / f"{ids[1]}.npy").unlink()
    encoded = []
    real = E.encode_texts
    import qa_tiger_tpu_torch.pipeline.extract as extract_mod

    def counting(model, texts, chunk=E.TEXT_CHUNK):
        encoded.extend(texts)
        return real(model, texts, chunk)

    extract_mod.encode_texts = counting
    try:
        E.main([stage, "--dst", str(tmp_path / "port"), "--device", "cpu", *common])
    finally:
        extract_mod.encode_texts = real
    assert first.stat().st_mtime_ns == before and len(encoded) == 1
    np.testing.assert_allclose(np.load(tmp_path / "port" / f"{ids[1]}.npy"),
                               np.load(tmp_path / "jax" / f"{ids[1]}.npy"), **NET_TOL)


def test_text_stage_chunks(text_corpus, tmp_path):
    """Chunked encoding (3 texts per forward) gives the one-chunk features;
    a stage with texts to encode and no weights exits as the others do."""
    samples, annot, weights = text_corpus
    model = clip_text.CLIPTextTower("tiny-vis", torch.Generator().manual_seed(0))
    model.load_state_dict(E.load_npz(weights), strict=True)
    texts = E.stage_texts(samples, False)
    np.testing.assert_allclose(E.encode_texts(model.eval(), texts, chunk=3),
                               E.encode_texts(model, texts), rtol=1e-6, atol=1e-6)
    with pytest.raises(SystemExit, match="random-weights"):
        E.main(["questions", "--annot", str(annot), "--dst", str(tmp_path / "y"),
                "--device", "cpu"])
