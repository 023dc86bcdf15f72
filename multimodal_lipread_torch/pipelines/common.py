"""Shared pipeline plumbing used by serving (counterpart of part of the JAX
package's ``pipelines/common.py``): host decode, log-mel features on the
device, and the model dtype knob. The dataset loaders and the trainer
wiring wait for the training slice (ROADMAP.md)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from multimodal_lipread_torch.data.audio_io import TARGET_SAMPLES, load_waveform
from multimodal_lipread_torch.ops.logmel_cuda import log_mel

MEL_BINS = 80


def compute_logmel_features(
    waves: np.ndarray, input_size: int = 117, chunk: int = 256, device: str = "cuda"
) -> np.ndarray:
    """(N, 20000) waveforms → (N, 80, input_size) normalized log-mel,
    computed on ``device`` in chunks of ``chunk`` clips.

    Normalization runs over the full (80, 126) spectrogram before the time
    slice.
    """
    out: List[np.ndarray] = []
    for start in range(0, waves.shape[0], chunk):
        batch = torch.from_numpy(np.ascontiguousarray(waves[start : start + chunk], np.float32)).to(device)
        mel = log_mel(batch, normalize=True)  # (b, 80, 126)
        out.append(mel[:, :MEL_BINS, :input_size].cpu().numpy())
    return np.concatenate(out, axis=0) if out else np.zeros((0, MEL_BINS, input_size), np.float32)


def decode_waveforms(paths: Sequence[str]) -> np.ndarray:
    """Host decode of WAV files to fixed 20,000-sample float32 waveforms."""
    if not paths:
        return np.zeros((0, TARGET_SAMPLES), np.float32)
    return np.stack([load_waveform(p) for p in paths])


def model_dtype(cfg) -> torch.dtype:
    """``model.dtype``: 'bfloat16' or float32 (the default)."""
    return torch.bfloat16 if str(cfg.get("model.dtype", "float32")) == "bfloat16" else torch.float32
