"""The log-mel CUDA kernel's wrapper (counterpart of the JAX package's
``ops/logmel_pallas.py``).

:func:`log_mel` is the port's log-mel entry. For a tensor on a CUDA card it
launches ``csrc/logmel.cu`` (built with plain ``nvcc``, see ``_build.py``)
or raises; for a tensor on the CPU it runs the plain version,
``ops.logmel.log_mel_reference``. There is no fallback from one to the
other. ``launch_count`` counts the kernel's launches, so a caller can show
that a run went through the kernel.

The kernel reads the raw (B, 20000) waveform and does the reflect padding
and framing by index arithmetic, and standardizes within the same launch;
its design and bound are in the source. Its tables are built here:
:func:`kernel_basis` (the DFT basis at the kernel's width) and
:func:`kernel_mel_table` (each mel filter's band of 16 frequencies).
:func:`log_mel_float64` evaluates the same function through those tables in
float64, the yardstick of accuracy for the kernel and the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_lipread_torch.ops import _build
from multimodal_lipread_torch.ops.logmel import (
    FREQ_PAD,
    HOP_LENGTH,
    LOG_EPS,
    N_FFT,
    N_FREQS,
    N_MELS,
    NUM_FRAMES,
    NUM_SAMPLES,
    PAD,
    dft_basis,
    log_mel_reference,
    mel_filterbank,
    standardize,
)

# frequencies per DFT half in the kernel's basis: 201 padded to 7 warps x 32
KERNEL_FREQ_COLS = 224
# clips per launch: the grid is (4 frame tiles, B clips), and a grid's y
# extent is at most 65535
_MAX_GRID_Y = 65535
# mlt_logmel_launch_config's fields, in order
LAUNCH_CONFIG_FIELDS = (
    "grid_x", "grid_y", "threads", "dynamic_smem_bytes", "static_smem_bytes",
    "registers", "local_bytes", "blocks_per_sm", "clusters_of_4",
)
# the kernel's phase timestamps, in order (mlt_logmel_forward's `stamps`)
PHASES = ("start", "staged", "dft", "mel", "ticket", "standardized")
# frame tiles per clip in the kernel's grid
KERNEL_TILES = 4
# frequencies in a mel filter's band of weights (the widest filter has 14)
KERNEL_MEL_BAND = 16

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
def kernel_mel_table() -> tuple:
    """The mel filterbank as the kernel reads it: only each filter's band.
    ``(first, bands)``: ``first`` int32 (80,), ``bands`` float32 (80, 16);
    filter ``m`` weighs frequency ``first[m] + j`` by ``bands[m, j]``. A band
    holds the filter's whole run of nonzero weights (HTK filters are
    triangles, at most 14 frequencies wide here) and zeros around it, and
    stays inside the 201 frequencies."""
    fb = mel_filterbank()
    first = np.zeros(N_MELS, np.int32)
    bands = np.zeros((N_MELS, KERNEL_MEL_BAND), np.float32)
    for m in range(N_MELS):
        nz = np.flatnonzero(fb[:, m])
        lo, hi = int(nz[0]), int(nz[-1]) + 1
        if hi - lo > KERNEL_MEL_BAND:
            raise ValueError(f"mel filter {m} spans {hi - lo} frequencies, more than the kernel's {KERNEL_MEL_BAND}")
        first[m] = min(lo, N_FREQS - KERNEL_MEL_BAND)
        bands[m, lo - first[m] : hi - first[m]] = fb[lo:hi, m]
    return first, bands


def log_mel_float64(wave: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """The log-mel in float64 on ``wave``'s device, through the kernel's own
    tables (:func:`kernel_basis`, :func:`kernel_mel_table`) upcast: what an
    exact summation of the kernel's function gives. (B, 20000) → (B, 80, 126)."""
    padded = F.pad(wave.to(torch.float64)[:, None], (PAD, PAD), mode="reflect")[:, 0]
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)  # (B, 126, 400)
    spec = frames @ torch.from_numpy(kernel_basis()).to(frames)
    cols = KERNEL_FREQ_COLS
    power = spec[..., :N_FREQS] ** 2 + spec[..., cols : cols + N_FREQS] ** 2
    first, bands = kernel_mel_table()
    fb = torch.zeros((N_FREQS, N_MELS), dtype=torch.float64)
    for m in range(N_MELS):
        fb[first[m] : first[m] + KERNEL_MEL_BAND, m] = torch.from_numpy(bands[m].astype(np.float64))
    logmel = torch.log((power @ fb.to(power.device)).transpose(-1, -2) + LOG_EPS)
    return standardize(logmel) if normalize else logmel


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple:
    """(basis, mel band starts, mel bands) on ``device``, built once per device."""
    return tuple(torch.from_numpy(a).to(device) for a in (kernel_basis(), *kernel_mel_table()))


@functools.lru_cache(maxsize=None)
def _scratch(device: torch.device, stream: int) -> tuple:
    """The standardization's scratch for launches on one stream: fp64 sums of
    each (clip, tile) and one ticket per clip. The kernel leaves the tickets
    at 0, so they are zeroed once; launches on one stream run in order."""
    return (
        torch.empty((_MAX_GRID_Y, KERNEL_TILES), dtype=torch.float64, device=device),
        torch.zeros(_MAX_GRID_Y, dtype=torch.int32, device=device),
    )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("logmel")
    fn = lib.mlt_logmel_forward
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cfg = lib.mlt_logmel_launch_config
    cfg.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    cfg.restype = ctypes.c_int
    return lib


def launch_config(batch: int, device: torch.device | str = "cuda") -> dict:
    """How the kernel launches for ``batch`` clips on ``device``: grid,
    threads, shared memory, registers, spill bytes, blocks per SM, and how
    many 4-block clusters (one per clip) would fit on the card at once."""
    info = (ctypes.c_int * len(LAUNCH_CONFIG_FIELDS))()
    with torch.cuda.device(torch.device(device)):
        rc = _library().mlt_logmel_launch_config(batch, info)
    if rc != 0:
        raise RuntimeError(f"reading the log-mel kernel's launch configuration failed with CUDA error {rc}")
    return dict(zip(LAUNCH_CONFIG_FIELDS, info))


def log_mel(wave: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """(B, 20000) waveforms → (B, 80, 126) float32 log-mel spectrograms.

    Forward only, as in the JAX package: the kernel has no backward, so a
    ``wave`` that requires a gradient while autograd is on is refused (on
    the CPU too) rather than answered with a tensor that silently has
    none."""
    return _log_mel(wave, normalize)


def phase_times(wave: torch.Tensor, normalize: bool = True) -> dict:
    """Run the kernel once on a CUDA ``wave`` with its phase timestamps on
    and return microseconds: per phase (waveform staging, DFT, mel, tile
    written to ticket taken, and standardizing the clip in its last block)
    the mean and the largest over the blocks, and the whole launch, first
    start to last end. The timestamps cost one global store per block and
    phase."""
    if wave.device.type != "cuda":
        raise ValueError("phase_times measures the kernel on a CUDA card")
    stamps = torch.zeros((wave.shape[0], KERNEL_TILES, len(PHASES)), dtype=torch.int64, device=wave.device)
    _log_mel(wave, normalize, stamps)
    raw = stamps.reshape(-1, len(PHASES)).cpu()
    last = raw[:, -1] > 0  # the blocks that standardized their clip
    t = (raw - raw[:, 0].min()).double() / 1e3  # offsets first: ns stamps exceed a double's 53 bits
    steps = t.diff(dim=1)
    out = {name: (float(steps[:, i].mean()), float(steps[:, i].max()))
           for i, name in enumerate(("stage", "dft", "mel", "ticket"))}
    if bool(last.any()):
        out["standardize"] = (float(steps[last, -1].mean()), float(steps[last, -1].max()))
    out["launch"] = float(torch.maximum(t[:, -2], torch.where(last, t[:, -1], t[:, -2])).max())
    return out


def _log_mel(wave: torch.Tensor, normalize: bool, stamps: torch.Tensor | None = None) -> torch.Tensor:
    global launch_count
    if wave.ndim != 2 or wave.shape[1] != NUM_SAMPLES:
        raise ValueError(f"log_mel expects (B, {NUM_SAMPLES}) waveforms, got {tuple(wave.shape)}")
    if wave.requires_grad and torch.is_grad_enabled():
        raise ValueError("the log-mel kernel has no backward: pass a waveform that does not require a gradient "
                         "(wave.detach()), or run under torch.no_grad()")
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
    basis, mel_first, mel_bands = _tables(wave.device)
    out = torch.empty((batch, N_MELS, NUM_FRAMES), dtype=torch.float32, device=wave.device)
    lib = _library()
    with torch.cuda.device(wave.device):
        stream = torch.cuda.current_stream(wave.device).cuda_stream
        partials, tickets = _scratch(wave.device, stream)
        rc = lib.mlt_logmel_forward(
            wave.data_ptr(), basis.data_ptr(), mel_first.data_ptr(), mel_bands.data_ptr(), out.data_ptr(),
            partials.data_ptr(), tickets.data_ptr(), 0 if stamps is None else stamps.data_ptr(),
            batch, int(bool(normalize)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"log-mel kernel launch failed with CUDA error {rc}")
    launch_count += 1
    return out
