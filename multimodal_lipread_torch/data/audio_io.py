"""Host-side audio decode to fixed-length waveforms (counterpart of the JAX
package's ``data/audio_io.py``).

Decodes PCM WAV with the standard library's ``wave`` module, and compressed
formats (GLips ships ``.m4a``) or a WAV at another rate through an
``ffmpeg`` subprocess that resamples and downmixes to mono int16 PCM, into
a float32 waveform in int16 sample range, padded or truncated to 20 000
samples (1.25 s at 16 kHz). All spectral work then runs on the device
(``ops/logmel_cuda.py``). Batches of PCM16 WAVs go through the threaded
native decoder first (``data/native_io.py``, via
``pipelines.common.decode_waveforms``); this is the per-file path for what it
does not take. ``tools/transcode.py`` decodes a corpus once into a WAV
mirror with the same ffmpeg pipeline.
"""

from __future__ import annotations

import os
import shutil
import subprocess
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


def _ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def _load_via_ffmpeg(path: str, sample_rate: int) -> np.ndarray:
    """Decode any format ffmpeg reads → mono int16 PCM at ``sample_rate``,
    as float32 in int16 range (the resampling and downmix happen in
    ffmpeg)."""
    cmd = [
        "ffmpeg", "-v", "error", "-i", path,
        "-f", "s16le", "-acodec", "pcm_s16le",
        "-ac", "1", "-ar", str(sample_rate), "-",
    ]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(out, dtype="<i2").astype(np.float32)


def load_waveform(
    path: str,
    sample_rate: int = SAMPLE_RATE,
    target_samples: Optional[int] = TARGET_SAMPLES,
) -> np.ndarray:
    """Load an audio file as a mono float32 waveform, zero-padded or
    truncated to ``target_samples``. A WAV at ``sample_rate`` is read here;
    any other file, or a WAV at another rate, goes through ffmpeg, and
    raises ``RuntimeError`` where ffmpeg is not installed."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        data, sr = _load_wav(path)
        if sr != sample_rate:
            if not _ffmpeg_available():
                raise RuntimeError(f"WAV at {sr} Hz needs resampling but ffmpeg is unavailable: {path}")
            data = _load_via_ffmpeg(path, sample_rate)
    else:
        if not _ffmpeg_available():
            raise RuntimeError(
                f"Decoding {ext} requires ffmpeg, which is not installed. "
                f"Convert the dataset to 16 kHz WAV or install ffmpeg."
            )
        data = _load_via_ffmpeg(path, sample_rate)
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
