"""Log-mel spectrogram frontend (VGGish flavour), batched, PyTorch edition.

Port of ``qa_tiger_tpu/ops/mel.py`` (the reference's numpy frontend,
src/models/vggish.py:148-353): framing by index, periodic Hann window, the
magnitude of a 512-point real FFT, the HTK mel filterbank with the DC bin
zeroed, log(mel + 0.01). Every second of audio in a batch is framed and
transformed at once, all in fp32.

VGGish constants: 16 kHz mono, 25 ms window (400 samples), 10 ms hop
(160), 512-point FFT, 64 mel bins over 125-7500 Hz, log offset 0.01,
0.96 s examples (96 frames) with no overlap.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

SAMPLE_RATE = 16000
STFT_WINDOW_SECONDS = 0.025
STFT_HOP_SECONDS = 0.010
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7500.0
LOG_OFFSET = 0.01
EXAMPLE_WINDOW_SECONDS = 0.96
EXAMPLE_HOP_SECONDS = 0.96

_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0


def hertz_to_mel(frequencies_hertz):
    """HTK mel scale (src/models/vggish.py:236-241)."""
    return _MEL_HIGH_FREQUENCY_Q * np.log(
        1.0 + (np.asarray(frequencies_hertz, dtype=np.float64) / _MEL_BREAK_FREQUENCY_HERTZ))


@functools.lru_cache()
def mel_matrix(num_mel_bins: int = NUM_MEL_BINS, num_spectrogram_bins: int = 257,
               audio_sample_rate: int = SAMPLE_RATE, lower_edge_hertz: float = MEL_MIN_HZ,
               upper_edge_hertz: float = MEL_MAX_HZ) -> np.ndarray:
    """[num_spectrogram_bins, num_mel_bins] triangular filterbank, DC zeroed
    (src/models/vggish.py:244-321)."""
    nyquist = audio_sample_rate / 2.0
    if not (0.0 <= lower_edge_hertz < upper_edge_hertz <= nyquist):
        raise ValueError("bad mel band edges")
    spec_mel = hertz_to_mel(np.linspace(0.0, nyquist, num_spectrogram_bins))
    band_edges = np.linspace(hertz_to_mel(lower_edge_hertz), hertz_to_mel(upper_edge_hertz),
                             num_mel_bins + 2)
    lower = band_edges[:-2][None, :]
    center = band_edges[1:-1][None, :]
    upper = band_edges[2:][None, :]
    lower_slope = (spec_mel[:, None] - lower) / (center - lower)
    upper_slope = (upper - spec_mel[:, None]) / (upper - center)
    weights = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    weights[0, :] = 0.0  # HTK excludes the DC bin
    return weights.astype(np.float32)


def periodic_hann(window_length: int) -> np.ndarray:
    """Period-N raised cosine (src/models/vggish.py:178-198)."""
    return (0.5 - 0.5 * np.cos(2 * np.pi / window_length
                               * np.arange(window_length))).astype(np.float32)


def stft_params(sample_rate: int = SAMPLE_RATE) -> tuple[int, int, int]:
    """(window, hop, fft_length) in samples."""
    window = int(round(sample_rate * STFT_WINDOW_SECONDS))
    hop = int(round(sample_rate * STFT_HOP_SECONDS))
    fft_length = 2 ** int(np.ceil(np.log(window) / np.log(2.0)))
    return window, hop, fft_length


def _windows(num: int, length: int, hop: int, device) -> torch.Tensor:
    return (torch.arange(num, device=device)[:, None] * hop
            + torch.arange(length, device=device)[None, :])


def log_mel_spectrogram(waveform: torch.Tensor, sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
    """[..., num_samples] -> [..., num_frames, 64] log-mel frames, fp32.
    Incomplete tail frames are dropped, as the reference frames."""
    window, hop, fft_length = stft_params(sample_rate)
    waveform = waveform.float()
    num_frames = 1 + (waveform.shape[-1] - window) // hop
    frames = waveform[..., _windows(num_frames, window, hop, waveform.device)]  # [..., F, W]
    frames = frames * torch.from_numpy(periodic_hann(window)).to(waveform.device)
    spec = torch.fft.rfft(frames, n=fft_length, dim=-1).abs()
    mel = spec @ torch.from_numpy(mel_matrix(
        num_spectrogram_bins=fft_length // 2 + 1,
        audio_sample_rate=sample_rate)).to(waveform.device)
    return torch.log(mel + LOG_OFFSET)


def waveform_to_examples(waveform: torch.Tensor, sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
    """[..., num_samples] -> [..., num_examples, 96, 64] log-mel patches
    (src/models/vggish.py:44-92; resampling to 16 kHz happens before)."""
    log_mel = log_mel_spectrogram(waveform, sample_rate)
    feat_rate = 1.0 / STFT_HOP_SECONDS
    win = int(round(EXAMPLE_WINDOW_SECONDS * feat_rate))
    hop = int(round(EXAMPLE_HOP_SECONDS * feat_rate))
    num_examples = 1 + (log_mel.shape[-2] - win) // hop
    return log_mel[..., _windows(num_examples, win, hop, log_mel.device), :]
