"""VGGish audio embedder: log-mel frontend + conv net, PyTorch edition.

Port of ``qa_tiger_tpu/pipeline/vggish.py`` (the reference's TF-Slim
VGGish, scripts/extract_audio_feat/vggish_slim.py:77-90): 3x3 SAME convs
with ReLU, conv1(64) pool, conv2(128) pool, conv3_{1,2}(256) pool,
conv4_{1,2}(512) pool, flatten, fc1_{1,2}(4096), fc2(128). [B, 96, 64]
log-mel patches -> [B, 128] embeddings; a video's 60 seconds embed in one
batch.

The ``state_dict`` carries the TF checkpoint's names (``conv1.weights``,
``conv3.conv3_1.biases``, ``fc1.fc1_1.weights``, ...) in their layouts:
HWIO convolutions and [in, out] dense weights, permuted where they are
used, so the released ``vggish_model.ckpt`` converts by name. The flatten
before fc1 is in NHWC order, as TF's.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from qa_tiger_tpu_torch.convert import params_from_jax
from qa_tiger_tpu_torch.nn.core import trunc_normal
from qa_tiger_tpu_torch.ops.mel import SAMPLE_RATE, waveform_to_examples

INIT_STDDEV = 0.01  # vggish_params.py:44

_CONV_LAYERS = [("conv1", 1, 64, False), ("conv2", 64, 128, False),
                ("conv3", 128, 256, True), ("conv4", 256, 512, True)]


class _Layer(nn.Module):
    def __init__(self, shape, gen: torch.Generator):
        super().__init__()
        self.weights = nn.Parameter(trunc_normal(shape, gen, INIT_STDDEV))
        self.biases = nn.Parameter(torch.zeros(shape[-1]))


class VGGish(nn.Module):
    """TF-Slim-named VGGish parameters (``vggish_forward`` runs them);
    truncated-normal(0.01) weights and zero biases from ``seed``, as TF-Slim
    initialises."""

    def __init__(self, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        for name, cin, cout, repeated in _CONV_LAYERS:
            if repeated:
                self.add_module(name, nn.ModuleDict({
                    f"{name}_1": _Layer((3, 3, cin, cout), g),
                    f"{name}_2": _Layer((3, 3, cout, cout), g)}))
            else:
                self.add_module(name, _Layer((3, 3, cin, cout), g))
        self.fc1 = nn.ModuleDict({"fc1_1": _Layer((6 * 4 * 512, 4096), g),
                                  "fc1_2": _Layer((4096, 4096), g)})
        self.fc2 = _Layer((4096, 128), g)


def _conv(p: _Layer, x: torch.Tensor) -> torch.Tensor:
    # the log-mel input is fp32; under bf16 parameters the conv runs in the
    # parameter dtype, as the JAX package's
    w = p.weights.permute(3, 2, 0, 1)  # HWIO -> OIHW
    return torch.relu(F.conv2d(x.to(w.dtype), w, p.biases, padding=1))


def _dense(p: _Layer, x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x @ p.weights + p.biases)


def vggish_forward(model: VGGish, patches: torch.Tensor) -> torch.Tensor:
    """[B, 96, 64] log-mel patches -> [B, 128] embeddings. The 2x2 SAME
    max pools meet even sizes only (96x64 -> 6x4), where SAME is VALID."""
    x = patches[:, None]                                # NCHW, one channel
    x = F.max_pool2d(_conv(model.conv1, x), 2)
    x = F.max_pool2d(_conv(model.conv2, x), 2)
    x = F.max_pool2d(_conv(model.conv3.conv3_2, _conv(model.conv3.conv3_1, x)), 2)
    x = F.max_pool2d(_conv(model.conv4.conv4_2, _conv(model.conv4.conv4_1, x)), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # TF flatten: H*W*C order
    x = _dense(model.fc1.fc1_2, _dense(model.fc1.fc1_1, x))
    return _dense(model.fc2, x)


def vggish_embed_seconds(model: VGGish, seconds: torch.Tensor) -> torch.Tensor:
    """[T, sample_rate] one-second waveforms -> [T, 128] embeddings."""
    patches = waveform_to_examples(seconds)            # [T, 1, 96, 64]
    return vggish_forward(model, patches[:, 0])


# ---------------------------------------------------------------------------
# host-side audio handling
# ---------------------------------------------------------------------------

def pad_audio_last_second(snd: np.ndarray, sr: int, target_length: int = 60) -> np.ndarray:
    """Tile the final second until the clip reaches ``target_length``
    seconds (scripts/extract_audio_feat/audio_feature_extractor.py:29-61)."""
    if snd.shape[0] >= sr * target_length:
        return snd
    padding_needed = target_length - snd.shape[0] / sr
    last = snd[-sr:] if snd.shape[0] > sr else snd
    repeats = int(np.ceil(padding_needed))
    reps = (repeats, 1) if snd.ndim > 1 else repeats
    padding = np.tile(last, reps)[: int(padding_needed * sr)]
    return np.concatenate([snd, padding], axis=0)


def wavfile_to_examples(wav_file: str | Path, num_secs: int, inds=None) -> np.ndarray:
    """WAV -> [num_secs, 96, 64] per-second log-mel patches
    (src/models/vggish.py:94-129; missing or short seconds stay zero)."""
    from scipy.io import wavfile

    sr, snd = wavfile.read(str(wav_file))
    wav_data = np.asarray(snd)[: sr * num_secs] / 32768.0
    if wav_data.ndim > 1:
        wav_data = np.mean(wav_data, axis=1)
    if sr != SAMPLE_RATE:
        wav_data = _resample(wav_data, sr, SAMPLE_RATE)
        sr = SAMPLE_RATE
    out = np.zeros((num_secs, 96, 64), np.float32)
    for i in range(num_secs) if inds is None else inds:
        seg = wav_data[i * sr:(i + 1) * sr]
        if seg.shape[0] < sr:
            break
        out[i] = waveform_to_examples(torch.from_numpy(seg.astype(np.float32))).numpy()[0]
    return out


def _resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (scipy)."""
    from scipy.signal import resample_poly

    g = math.gcd(sr_in, sr_out)
    return resample_poly(x, sr_out // g, sr_in // g)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def load_tf_checkpoint(ckpt_path: str) -> dict[str, torch.Tensor]:
    """The released ``vggish_model.ckpt`` (TF-Slim variable names) as this
    module's state_dict. Reading the TF format needs tensorflow."""
    try:
        from tensorflow.python.training import py_checkpoint_reader  # type: ignore
    except ImportError as exc:
        raise ImportError(
            "reading vggish_model.ckpt requires tensorflow; alternatively "
            "convert it elsewhere to an .npz of {var_name: array} and load "
            "with load_npz_checkpoint") from exc
    reader = py_checkpoint_reader.NewCheckpointReader(ckpt_path)
    return _from_flat_tf({name: reader.get_tensor(name)
                          for name in reader.get_variable_to_shape_map()})


def load_npz_checkpoint(npz_path: str | Path) -> dict[str, torch.Tensor]:
    """An .npz of TF variable names (``vggish/conv1/weights``, ...) as this
    module's state_dict."""
    with np.load(npz_path) as data:
        return _from_flat_tf({k: data[k] for k in data.files})


def _from_flat_tf(flat: dict) -> dict[str, torch.Tensor]:
    return params_from_jax({name.replace("vggish/", "").replace("/", "."): np.asarray(value)
                            for name, value in flat.items()})
