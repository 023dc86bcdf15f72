"""Host-side WAV decode to fixed-length waveforms (counterpart of the JAX
package's ``data/audio_io.py``).

Decodes PCM WAV with the standard library's ``wave`` module into a float32
waveform in int16 sample range, padded or truncated to 20 000 samples
(1.25 s at 16 kHz). All spectral work then runs on the device
(``ops/logmel_cuda.py``). Compressed formats, resampling (ffmpeg) and the
threaded native decoder (``native/``) are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import os
import wave
from typing import Optional, Tuple

import numpy as np

SAMPLE_RATE = 16000
TARGET_DURATION = 1.25
TARGET_SAMPLES = int(TARGET_DURATION * SAMPLE_RATE)  # 20000


def _load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a PCM WAV file to a mono float waveform at its native rate.

    int16 sample values are used as they are (the models consume raw
    int16-range floats); 32-bit and 8-bit PCM are scaled to that range.
    """
    with wave.open(path, "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        sr = w.getframerate()
        frames = w.readframes(w.getnframes())
    if sampwidth == 2:
        data = np.frombuffer(frames, dtype="<i2").astype(np.float32)
    elif sampwidth == 4:
        data = np.frombuffer(frames, dtype="<i4").astype(np.float32) / 65536.0
    elif sampwidth == 1:
        data = (np.frombuffer(frames, dtype=np.uint8).astype(np.float32) - 128.0) * 256.0
    else:
        raise ValueError(f"Unsupported WAV sample width {sampwidth} in {path}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, sr


def load_waveform(
    path: str,
    sample_rate: int = SAMPLE_RATE,
    target_samples: Optional[int] = TARGET_SAMPLES,
) -> np.ndarray:
    """Load a WAV file as a mono float32 waveform, zero-padded or truncated
    to ``target_samples``."""
    ext = os.path.splitext(path)[1].lower()
    if ext != ".wav":
        raise NotImplementedError(
            f"decoding {ext} needs ffmpeg, which the PyTorch port does not use yet "
            "(ROADMAP.md); convert the clips to 16 kHz PCM WAV"
        )
    data, sr = _load_wav(path)
    if sr != sample_rate:
        raise NotImplementedError(
            f"WAV at {sr} Hz needs resampling, which the PyTorch port does not do yet "
            f"(ROADMAP.md): {path}"
        )
    if target_samples is not None:
        if data.shape[0] > target_samples:
            data = data[:target_samples]
        elif data.shape[0] < target_samples:
            data = np.pad(data, (0, target_samples - data.shape[0]))
    return np.ascontiguousarray(data, dtype=np.float32)


def write_wav(path: str, waveform: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    """Write a float waveform (int16 range) to a PCM16 WAV file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pcm = np.clip(waveform, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
