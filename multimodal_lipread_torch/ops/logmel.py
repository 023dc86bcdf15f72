"""Log-mel spectrogram frontend: constants, basis builders and the plain
PyTorch version (counterpart of the JAX package's ``ops/logmel.py``).

Semantics (those of ``torchaudio.transforms.MelSpectrogram(sample_rate=16000,
n_fft=400, hop_length=160, n_mels=80, normalized=True)`` followed by
``log(mel + 1e-9)`` and per-clip standardization):

- periodic Hann window, win_length = n_fft = 400;
- center=True with reflect padding of n_fft//2 = 200;
- power spectrogram |STFT|^2 / sum(window^2) (normalized=True, power=2);
- HTK mel scale, f_min=0, f_max=sr/2, norm=None;
- log(mel + 1e-9);
- per-clip (x - mean) / (std + 1e-9) with the unbiased std (ddof=1), over
  the whole (80, 126) spectrogram before any time slicing.

:func:`log_mel_reference` is the plain version of the CUDA kernel in
``ops/logmel_cuda.py``: the framing-free split-GEMM in fp32, as the JAX
package's ``log_mel_xla`` computes it. The public entry that picks the
kernel or this version by device is ``ops.logmel_cuda.log_mel``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
LOG_EPS = 1e-9
NORM_EPS = 1e-9

# Fixed-length input contract: 20,000 samples (1.25 s @ 16 kHz)
NUM_SAMPLES = 20000
# center=True ⇒ reflect-pad n_fft//2 on both sides
PAD = N_FFT // 2
NUM_FRAMES = 1 + NUM_SAMPLES // HOP_LENGTH  # 126
N_FREQS = N_FFT // 2 + 1  # 201

# DFT basis (n_fft, 512): cos in columns [0, 256), sin in [256, 512); only
# the first N_FREQS columns of each half are nonzero.
FREQ_PAD = 256


def hann_window(n: int = N_FFT) -> np.ndarray:
    """Periodic Hann window (matches torch.hann_window default)."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


@functools.lru_cache(maxsize=None)
def dft_basis(n_fft: int = N_FFT, normalized: bool = True) -> np.ndarray:
    """Windowed real-DFT basis of shape (n_fft, 2*FREQ_PAD), float32.

    column j < N_FREQS:              window[n] * cos(2π j n / n_fft)
    column FREQ_PAD + j, j < N_FREQS: -window[n] * sin(2π j n / n_fft)
    Window L2 normalization (normalized=True) is folded in as 1/sqrt(Σ w²).
    """
    w = hann_window(n_fft)
    if normalized:
        w = w / np.sqrt(np.sum(w ** 2))
    n = np.arange(n_fft)[:, None]
    j = np.arange(N_FREQS)[None, :]
    ang = 2.0 * np.pi * n * j / n_fft
    basis = np.zeros((n_fft, 2 * FREQ_PAD), dtype=np.float64)
    basis[:, :N_FREQS] = w[:, None] * np.cos(ang)
    basis[:, FREQ_PAD : FREQ_PAD + N_FREQS] = -w[:, None] * np.sin(ang)
    return basis.astype(np.float32)


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    n_mels: int = N_MELS,
    n_freqs: int = N_FREQS,
    sample_rate: int = SAMPLE_RATE,
    f_min: float = 0.0,
    f_max: float | None = None,
) -> np.ndarray:
    """HTK-scale triangular mel filterbank, shape (n_freqs, n_mels)
    (torchaudio.functional.melscale_fbanks with norm=None, mel_scale='htk')."""
    if f_max is None:
        f_max = sample_rate / 2.0

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)

    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=None)
def mel_filterbank_padded() -> np.ndarray:
    """(FREQ_PAD, N_MELS) filterbank with zero rows above N_FREQS."""
    fb = np.zeros((FREQ_PAD, N_MELS), dtype=np.float32)
    fb[:N_FREQS] = mel_filterbank()
    return fb


# Framing-free formulation. hop (160) cuts a frame into block-aligned pieces
# (400 = 160 + 160 + 80), so the windowed DFT is three matmuls over hop-sized
# blocks of the padded wave:
#     spec = blocks[0:126] @ W[0:160]
#          + blocks[1:127] @ W[160:320]
#          + blocks[2:128, :80] @ W[320:400]
N_BLOCKS = -(-(NUM_SAMPLES + 2 * PAD) // HOP_LENGTH)  # ceil(20400/160) = 128
_BLOCK_PAD = N_BLOCKS * HOP_LENGTH - (NUM_SAMPLES + 2 * PAD)  # 80 zeros


def block_signal(wave: torch.Tensor) -> torch.Tensor:
    """Reflect-pad and view as hop blocks: (..., NUM_SAMPLES) → (..., N_BLOCKS, HOP)."""
    lead = wave.shape[:-1]
    flat = wave.reshape(-1, 1, wave.shape[-1])
    padded = F.pad(flat, (PAD, PAD), mode="reflect")
    padded = F.pad(padded, (0, _BLOCK_PAD))
    return padded.reshape(lead + (N_BLOCKS, HOP_LENGTH))


@functools.lru_cache(maxsize=None)
def dft_basis_split() -> tuple:
    """The windowed-DFT basis split at hop boundaries: rows [0:160),
    [160:320), [320:400) of :func:`dft_basis`."""
    basis = dft_basis()
    return (
        basis[:HOP_LENGTH],
        basis[HOP_LENGTH : 2 * HOP_LENGTH],
        basis[2 * HOP_LENGTH :],
    )


@functools.lru_cache(maxsize=None)
def _reference_tables(device: torch.device) -> tuple:
    """(W0, W1, W2, fb) as float32 tensors on ``device``, built once."""
    arrays = dft_basis_split() + (mel_filterbank_padded(),)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def standardize(logmel: torch.Tensor) -> torch.Tensor:
    """Per-clip (x-μ)/(σ+eps) with unbiased std, over the last two axes."""
    n = logmel.shape[-1] * logmel.shape[-2]
    mean = logmel.mean(dim=(-2, -1), keepdim=True)
    sq = ((logmel - mean) ** 2).sum(dim=(-2, -1), keepdim=True)
    std = torch.sqrt(sq / (n - 1))
    return (logmel - mean) / (std + NORM_EPS)


def log_mel_reference(wave: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Plain PyTorch log-mel: (B, NUM_SAMPLES) → (B, N_MELS, NUM_FRAMES) float32.

    The split-GEMM in fp32 on ``wave``'s device. On a CUDA card this is full
    fp32 only while ``torch.backends.cuda.matmul.allow_tf32`` is False (the
    default): TF32 breaks the power-spectrum cancellation at spectral nulls.
    """
    blocks = block_signal(wave.to(torch.float32))  # (B, N_BLOCKS, HOP)
    w0, w1, w2, fb = _reference_tables(blocks.device)
    t = NUM_FRAMES
    spec = (
        blocks[:, :t] @ w0
        + blocks[:, 1 : t + 1] @ w1
        + blocks[:, 2 : t + 2, : N_FFT - 2 * HOP_LENGTH] @ w2
    )
    re, im = spec[..., :FREQ_PAD], spec[..., FREQ_PAD:]
    power = re * re + im * im  # (B, T, FREQ_PAD); cols >= N_FREQS are 0
    mel = (power @ fb).transpose(-1, -2)  # (B, N_MELS, T)
    logmel = torch.log(mel + LOG_EPS)
    return standardize(logmel) if normalize else logmel
