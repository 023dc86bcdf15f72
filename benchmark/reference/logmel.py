"""Plain log-mel: ``torchaudio``'s ``MelSpectrogram(sample_rate=16000,
n_fft=400, hop_length=160, n_mels=80, normalized=True)`` (periodic Hann
window, reflect padding of 200 on both sides, power spectrum over the
window's L2 norm, HTK mel scale from 0 Hz to 8 kHz without filter
normalization), then ``log(mel + 1e-9)`` and a per-clip standardization
with the unbiased standard deviation over the whole (80, 126) map.

The frames are cut with ``unfold`` and the real DFT is two dense products
with a cos and a sin basis, in the input's precision: float32 here is full
float32 only while TF32 is off."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 80
NUM_SAMPLES = 20000
N_FREQS = N_FFT // 2 + 1  # 201
NUM_FRAMES = 1 + NUM_SAMPLES // HOP  # 126
LOG_EPS = 1e-9
NORM_EPS = 1e-9


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank() -> np.ndarray:
    """(201, 80) float64 triangular HTK filters over the DFT bins."""
    freqs = np.linspace(0.0, SAMPLE_RATE / 2.0, N_FREQS)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2.0), N_MELS + 2))
    fb = np.zeros((N_FREQS, N_MELS))
    for m in range(N_MELS):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        rise = (freqs - lo) / (mid - lo)
        fall = (hi - freqs) / (hi - mid)
        fb[:, m] = np.maximum(0.0, np.minimum(rise, fall))
    return fb


@functools.lru_cache(maxsize=None)
def dft_bases() -> tuple:
    """(400, 201) float64 cos and sin bases with the normalized periodic
    Hann window folded in."""
    n = np.arange(N_FFT)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / N_FFT))
    window = window / np.sqrt(np.sum(window ** 2))
    angle = 2.0 * np.pi * n[:, None] * np.arange(N_FREQS)[None, :] / N_FFT
    return window[:, None] * np.cos(angle), window[:, None] * np.sin(angle)


def _tables(device, dtype) -> tuple:
    cos, sin = dft_bases()
    return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in (cos, sin, mel_filterbank()))


def log_mel(wave: torch.Tensor) -> torch.Tensor:
    """(B, 20000) waveforms in int16 range → (B, 80, 126) standardized
    log-mel, in ``wave``'s floating dtype (float32 for integer input)."""
    x = wave if wave.is_floating_point() else wave.to(torch.float32)
    cos, sin, fb = _tables(x.device, x.dtype)
    padded = F.pad(x[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = padded.unfold(-1, N_FFT, HOP)  # (B, 126, 400)
    re, im = frames @ cos, frames @ sin
    mel = ((re * re + im * im) @ fb).transpose(1, 2)  # (B, 80, 126)
    logmel = torch.log(mel + LOG_EPS)
    mean = logmel.mean(dim=(1, 2), keepdim=True)
    std = logmel.std(dim=(1, 2), keepdim=True, correction=1)
    return (logmel - mean) / (std + NORM_EPS)
