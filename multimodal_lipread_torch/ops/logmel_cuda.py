"""The log-mel CUDA kernel's wrapper (counterpart of the JAX package's
``ops/logmel_pallas.py``).

:func:`log_mel` is the port's log-mel entry. For a tensor on a CUDA card it
launches ``csrc/logmel.cu`` (built with plain ``nvcc``, see ``_build.py``)
or raises; for a tensor on the CPU it runs the plain version,
``ops.logmel.log_mel_reference``. There is no fallback from one to the
other. ``launch_count`` counts the kernel's launches, so a caller can show
that a run went through the kernel.

The kernel reads the raw (B, 20000) waveform and does the reflect padding
and framing by index arithmetic; its design and bound are in the source.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from multimodal_lipread_torch.ops import _build
from multimodal_lipread_torch.ops.logmel import (
    FREQ_PAD,
    N_FREQS,
    N_MELS,
    NUM_FRAMES,
    NUM_SAMPLES,
    dft_basis,
    log_mel_reference,
    mel_filterbank,
)

# frequencies per DFT half in the kernel's basis: 201 padded to 7 x 32
KERNEL_FREQ_COLS = 224
_MAX_GRID_Y = 65535

# launches of the kernel in this process; a caller may set it to 0
launch_count = 0


def kernel_basis() -> np.ndarray:
    """(400, 448) float32: columns [0, 224) the cos half and [224, 448) the
    -sin half of :func:`ops.logmel.dft_basis`, 201 nonzero columns each."""
    full = dft_basis()
    basis = np.zeros((full.shape[0], 2 * KERNEL_FREQ_COLS), np.float32)
    basis[:, :N_FREQS] = full[:, :N_FREQS]
    basis[:, KERNEL_FREQ_COLS : KERNEL_FREQ_COLS + N_FREQS] = full[:, FREQ_PAD : FREQ_PAD + N_FREQS]
    return basis


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple:
    """(basis, filterbank) on ``device``, built once per device."""
    return (
        torch.from_numpy(kernel_basis()).to(device),
        torch.from_numpy(np.ascontiguousarray(mel_filterbank())).to(device),
    )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("logmel")
    fn = lib.mlt_logmel_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def log_mel(wave: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """(B, 20000) waveforms → (B, 80, 126) float32 log-mel spectrograms."""
    global launch_count
    if wave.ndim != 2 or wave.shape[1] != NUM_SAMPLES:
        raise ValueError(f"log_mel expects (B, {NUM_SAMPLES}) waveforms, got {tuple(wave.shape)}")
    if wave.device.type == "cpu":
        return log_mel_reference(wave, normalize)
    if wave.device.type != "cuda":
        raise ValueError(f"log_mel runs on a CUDA card or the CPU, not {wave.device}")
    if wave.dtype != torch.float32:
        raise TypeError(f"the log-mel kernel takes float32 waveforms, got {wave.dtype}")
    if not wave.is_contiguous():
        raise ValueError("the log-mel kernel takes a contiguous waveform tensor")
    batch = wave.shape[0]
    if not 0 < batch <= _MAX_GRID_Y:
        raise ValueError(f"the log-mel kernel takes 1 to {_MAX_GRID_Y} clips, got {batch}")
    basis, fb = _tables(wave.device)
    out = torch.empty((batch, N_MELS, NUM_FRAMES), dtype=torch.float32, device=wave.device)
    lib = _library()
    with torch.cuda.device(wave.device):
        stream = torch.cuda.current_stream(wave.device).cuda_stream
        rc = lib.mlt_logmel_forward(
            wave.data_ptr(), basis.data_ptr(), fb.data_ptr(), out.data_ptr(),
            batch, int(bool(normalize)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"log-mel kernel launch failed with CUDA error {rc}")
    launch_count += 1
    return out
