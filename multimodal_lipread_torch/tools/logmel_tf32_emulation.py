"""How far tensor-core DFT summations would sit from the log-mel's plain version.

    python -m multimodal_lipread_torch.tools.logmel_tf32_emulation [--seed 0]

A CPU emulation, not a measurement of any card. On ``chip_smoke.py``'s B=128
waveforms (drawn from ``--seed`` after its B=32 ones), it evaluates the raw
log-mel (``normalize=False``) with the windowed DFT summed in several ways
and prints, for each, the largest absolute difference from the fp32 plain
version (``log_mel_reference``, on the CPU) and from a float64 evaluation
(``log_mel_float64``). The kernel is held to the plain version at 1e-4.

- one 400-tap fp32 pass per frequency, by fused multiply-add;
- 3xTF32 (hi*hi + hi*lo + lo*hi, each operand split to TF32 by rounding to
  nearest), the products of each 8-tap step summed exactly and added to an
  fp32 accumulator, per hop block of 160, 160 and 80 taps, the blocks added
  as (P0 + P1) + P2: with the accumulator rounded to nearest, and rounded
  toward zero as a tensor core may do.

The power, the mel product and the log follow in fp32, as in the kernel.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from multimodal_lipread_torch.ops.logmel import (
    HOP_LENGTH, LOG_EPS, N_FFT, N_FREQS, NUM_FRAMES, NUM_SAMPLES, PAD, log_mel_reference, mel_filterbank)
from multimodal_lipread_torch.ops.logmel_cuda import KERNEL_FREQ_COLS, kernel_basis, log_mel_float64

HOP_BLOCKS = ((0, HOP_LENGTH), (HOP_LENGTH, 2 * HOP_LENGTH), (2 * HOP_LENGTH, N_FFT))
MMA_K = 8  # taps a tensor-core step sums before its accumulator rounds


def chip_smoke_waves(seed: int) -> np.ndarray:
    """chip_smoke.py's B=128 waveforms: its rng draws the B=32 batch first."""
    rng = np.random.default_rng(seed)
    rng.standard_normal((32, NUM_SAMPLES))
    return (rng.standard_normal((128, NUM_SAMPLES)) * 1000).astype(np.float32)


def frames_of(waves: np.ndarray) -> np.ndarray:
    """(B, 20000) → (B * 126, 400) float32 frames of the reflect-padded waves."""
    padded = np.pad(waves, ((0, 0), (PAD, PAD)), mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(padded, N_FFT, axis=-1)[:, ::HOP_LENGTH][:, :NUM_FRAMES]
    return np.ascontiguousarray(frames.reshape(-1, N_FFT))


def to_f32(v: np.ndarray, toward_zero: bool = False) -> np.ndarray:
    """float64 → float32, rounded to nearest or toward zero."""
    r = v.astype(np.float32)
    if toward_zero:
        r = np.where(np.abs(r.astype(np.float64)) > np.abs(v), np.nextafter(r, np.float32(0)), r)
    return r


def to_tf32(x: np.ndarray) -> np.ndarray:
    """float32 → TF32 (10 mantissa bits), to nearest with ties away (cvt.rna.tf32.f32)."""
    return ((x.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def dft_one_pass(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """One fp32 FMA chain over all 400 taps per frequency."""
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    for k in range(N_FFT):
        acc = to_f32(acc + np.outer(x64[:, k], w64[k]))  # exact product, one rounding: an FMA
    return acc


def dft_3xtf32(x: np.ndarray, w: np.ndarray, toward_zero: bool) -> np.ndarray:
    xh = to_tf32(x)
    xl = to_tf32(x - xh)
    wh = to_tf32(w)
    wl = to_tf32(w - wh)
    parts = []
    for lo, hi in HOP_BLOCKS:
        acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
        for k in range(lo, hi, MMA_K):
            s = slice(k, k + MMA_K)
            step = (xh[:, s].astype(np.float64) @ wh[s].astype(np.float64)
                    + xh[:, s].astype(np.float64) @ wl[s].astype(np.float64)
                    + xl[:, s].astype(np.float64) @ wh[s].astype(np.float64))
            acc = to_f32(acc + step, toward_zero)
        parts.append(acc)
    return (parts[0] + parts[1]) + parts[2]


def log_mel_from_spec(spec: np.ndarray, batch: int) -> np.ndarray:
    re, im = spec[:, :N_FREQS], spec[:, N_FREQS:]
    power = re * re + im * im
    mel = power @ mel_filterbank()
    return np.log(mel + np.float32(LOG_EPS)).reshape(batch, NUM_FRAMES, -1).transpose(0, 2, 1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    waves = chip_smoke_waves(args.seed)
    basis = kernel_basis()
    w = np.concatenate([basis[:, :N_FREQS], basis[:, KERNEL_FREQ_COLS : KERNEL_FREQ_COLS + N_FREQS]], axis=1)
    x = frames_of(waves)
    plain = log_mel_reference(torch.from_numpy(waves), False).numpy().astype(np.float64)
    exact = log_mel_float64(torch.from_numpy(waves), False).numpy()
    print(f"CPU emulation, B={len(waves)}, seed {args.seed}, raw log-mel; max abs err vs plain | vs float64")
    print(f"log_mel_reference itself: - | {np.abs(plain - exact).max():.2e}")
    variants = {
        "fp32, one 400-tap pass per frequency": lambda: dft_one_pass(x, w),
        "3xTF32, fp32 accumulation rounded to nearest every 8 taps, (P0+P1)+P2": lambda: dft_3xtf32(x, w, False),
        "3xTF32, fp32 accumulation rounded toward zero every 8 taps, (P0+P1)+P2": lambda: dft_3xtf32(x, w, True),
    }
    for name, dft in variants.items():
        got = log_mel_from_spec(dft(), len(waves)).astype(np.float64)
        print(f"{name}: {np.abs(got - plain).max():.2e} | {np.abs(got - exact).max():.2e}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
