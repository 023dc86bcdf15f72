"""Synthetic mini-GLips audio corpus (the audio half of the JAX package's
``data/synthetic.py``, numpy only).

Writes ``<root>/lipread_files/<word>/<split>/<word>_NNNN-NNNN.wav`` (16 kHz
PCM16, 1.25 s) with class-conditional signals: a harmonic stack at a
class-specific pitch (up to 8 classes) or a two-tone grid code (more
classes), so models can fit the corpus. For the same arguments it writes
the same bytes as the JAX package's ``make_synthetic_glips`` called with
``with_lip_regions=False, with_cues=False``: the random stream is drawn in
the same order.
"""

from __future__ import annotations

import os
from typing import Sequence, Union

import numpy as np

from multimodal_lipread_torch.data.audio_io import SAMPLE_RATE, TARGET_SAMPLES, write_wav
from multimodal_lipread_torch.data.glips import SPLITS

DEFAULT_WORDS = ("abend", "bereits", "cirka", "dabei")


def _synth_waveform(
    rng: np.random.Generator, class_idx: int, num_classes: int, hardness: float = 0.0
) -> np.ndarray:
    """Class-separable waveform: harmonic stack at a class-specific pitch.

    ``hardness`` ∈ [0, 1] shrinks the inter-class pitch ratio, adds per-clip
    pitch jitter and timbre nuisance, raises the noise floor, and with
    probability 0.35·hardness takes the pitch from a random class while the
    label stays. Beyond 8 classes the pitch law would pass Nyquist, so the
    two-tone code of :func:`_synth_waveform_many` takes over."""
    if num_classes > 8:
        return _synth_waveform_many(rng, class_idx, num_classes, hardness)
    t = np.arange(TARGET_SAMPLES, dtype=np.float32) / SAMPLE_RATE
    if hardness > 0 and rng.uniform() < 0.35 * hardness:
        class_idx = int(rng.integers(num_classes))
    ratio = 1.5 - 0.32 * hardness
    f0 = 120.0 * (ratio**class_idx) + rng.uniform(-5, 5)
    if hardness > 0:
        f0 *= 1.0 + rng.normal(0.0, 0.11 * hardness)
    wave = np.zeros_like(t)
    for h in range(1, 4):
        amp = 0.5**h
        if hardness > 0:
            amp *= 1.0 + hardness * rng.uniform(-0.8, 0.8)
        wave += amp * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
    noise = 0.05 + 0.55 * hardness
    wave += noise * rng.standard_normal(TARGET_SAMPLES).astype(np.float32)
    envelope = np.minimum(1.0, 10 * t) * np.minimum(1.0, 10 * (t[-1] - t))
    return (wave * envelope * 8000.0).astype(np.float32)


def _synth_waveform_many(
    rng: np.random.Generator, class_idx: int, num_classes: int, hardness: float = 0.0
) -> np.ndarray:
    """Many-class waveform: the class as a pair of pure tones, one from a
    low band (110–900 Hz) and one from a disjoint high band (1.2–7 kHz), on
    a k × k grid (k = ceil(sqrt(num_classes))). ``hardness`` as in
    :func:`_synth_waveform`."""
    t = np.arange(TARGET_SAMPLES, dtype=np.float32) / SAMPLE_RATE
    if hardness > 0 and rng.uniform() < 0.35 * hardness:
        class_idx = int(rng.integers(num_classes))
    k = int(np.ceil(np.sqrt(num_classes)))
    i, j = class_idx // k, class_idx % k
    span = max(k - 1, 1)
    f_lo = 110.0 * (900.0 / 110.0) ** (i / span)
    f_hi = 1200.0 * (7000.0 / 1200.0) ** (j / span)
    jitter = 0.003 + 0.05 * hardness
    wave = np.zeros_like(t)
    for f0 in (f_lo, f_hi):
        f0 = f0 * (1.0 + rng.normal(0.0, jitter))
        amp = 0.5
        if hardness > 0:
            amp *= 1.0 + hardness * rng.uniform(-0.8, 0.8)
        wave += amp * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
    noise = 0.05 + 0.55 * hardness
    wave += noise * rng.standard_normal(TARGET_SAMPLES).astype(np.float32)
    envelope = np.minimum(1.0, 10 * t) * np.minimum(1.0, 10 * (t[-1] - t))
    return (wave * envelope * 8000.0).astype(np.float32)


def make_synthetic_glips(
    root: str,
    words: Sequence[str] = DEFAULT_WORDS,
    clips_per_split: int = 4,
    splits: Sequence[str] = SPLITS,
    seed: int = 0,
    hardness: Union[float, dict] = 0.0,
    label_noise: float = 0.0,
) -> str:
    """Write a synthetic GLips audio tree under ``root``; returns ``root``.

    ``hardness`` is a float or a mapping with an ``audio`` key (the JAX
    function's per-modality form). ``label_noise`` redraws the signal class
    of that fraction of train clips while the folder word (the label)
    stays. Sequence ids run ``0000-0001``, ``0002-0003``, ... over the whole
    corpus, wrapping at 10000."""
    if clips_per_split > 5000:
        raise ValueError(
            f"clips_per_split={clips_per_split} > 5000 would wrap the 4-digit "
            "sid space within one (word, split) directory and overwrite clips"
        )
    rng = np.random.default_rng(seed)
    h_audio = float(hardness.get("audio", 0.0)) if isinstance(hardness, dict) else float(hardness)
    words = sorted(words)
    seq_counter = 0
    for ci, word in enumerate(words):
        for split in splits:
            for _ in range(clips_per_split):
                sid = f"{seq_counter % 10000:04d}-{(seq_counter + 1) % 10000:04d}"
                seq_counter += 2
                sig_ci = ci
                if label_noise > 0 and split == "train" and rng.uniform() < label_noise:
                    sig_ci = int(rng.integers(len(words)))
                path = os.path.join(root, "lipread_files", word, split, f"{word}_{sid}.wav")
                write_wav(path, _synth_waveform(rng, sig_ci, len(words), h_audio))
    return root
