"""Synthetic GLips-shaped corpora made from the seed on the device and
written as files in the GLips layout:

    <root>/glips/lipread_files/<word>/train/<word>_NNNN-NNNN.wav
    <root>/glips_lip_regions/lipread_files/<word>/train/<word>_NNNN-NNNN.npy

A clip is 1.25 s of 16 kHz mono PCM16: a tone whose pitch depends on the
word, its third partial and noise. Lips are (29, 44, 44, 3) uint8 noise.
Every clip differs, so a row of a batch names its clip."""

from __future__ import annotations

import dataclasses
import math
import os
import wave
from typing import List, Optional

import numpy as np
import torch

WORDS = ("aber", "dann", "heute", "wieder")
SAMPLES = 20000
SAMPLE_RATE = 16000
LIP_SHAPE = (29, 44, 44, 3)
KEY = 64  # samples (or bytes) that name a clip


@dataclasses.dataclass
class Corpus:
    root: str
    audio_root: str
    lip_root: Optional[str]
    waves: np.ndarray  # (N, 20000) int16
    lips: Optional[np.ndarray]  # (N, 29, 44, 44, 3) uint8
    labels: np.ndarray  # (N,) int64, the index of the word in WORDS
    wav_paths: List[str]
    lip_paths: List[str]
    _keys: dict = dataclasses.field(default_factory=dict, repr=False)

    def identify(self, rows: np.ndarray, field: str = "waves") -> np.ndarray:
        """The clip of each row of ``rows`` (the same dtype and width as
        ``field``), by its leading values; -1 where no clip matches whole."""
        table = getattr(self, field).reshape(len(self.labels), -1)
        if field not in self._keys:
            self._keys[field] = {table[i, :KEY].tobytes(): i for i in range(len(table))}
        keys = self._keys[field]
        flat = rows.reshape(len(rows), -1)
        ids = np.array([keys.get(r[:KEY].tobytes(), -1) for r in flat], np.int64)
        for j, i in enumerate(ids):
            if i >= 0 and not np.array_equal(flat[j], table[i]):
                ids[j] = -1
        return ids


def _write_wav(path: str, pcm: np.ndarray) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm.astype("<i2").tobytes())


def make_corpus(root: str, n: int, seed: int, device: torch.device, lips: bool = False) -> Corpus:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + 7)
    labels = torch.arange(n, device=device) % len(WORDS)
    t = torch.arange(SAMPLES, device=device, dtype=torch.float32) / SAMPLE_RATE
    f0 = 180.0 + 90.0 * labels.float() + 40.0 * torch.rand(n, generator=gen, device=device) - 20.0
    phase = 2 * math.pi * torch.rand(n, 1, generator=gen, device=device)
    arg = 2 * math.pi * f0[:, None] * t[None]
    noise = torch.randn(n, SAMPLES, generator=gen, device=device)
    waves = 6000 * torch.sin(arg + phase) + 2500 * torch.sin(2.7 * arg) + 1500 * noise
    waves = waves.round().clamp(-32768, 32767).to(torch.int16).cpu().numpy()
    lip_arr = None
    if lips:
        lip_arr = torch.randint(0, 256, (n,) + LIP_SHAPE, generator=gen, device=device,
                                dtype=torch.uint8).cpu().numpy()
    labels = labels.cpu().numpy().astype(np.int64)
    audio_root = os.path.join(root, "glips")
    lip_root = os.path.join(root, "glips_lip_regions") if lips else None
    wav_paths, lip_paths = [], []
    for word in WORDS:
        os.makedirs(os.path.join(audio_root, "lipread_files", word, "train"), exist_ok=True)
        if lips:
            os.makedirs(os.path.join(lip_root, "lipread_files", word, "train"), exist_ok=True)
    for i in range(n):
        word = WORDS[labels[i]]
        stem = f"{word}_{i:04d}-{i + 1:04d}"
        path = os.path.join(audio_root, "lipread_files", word, "train", stem + ".wav")
        _write_wav(path, waves[i])
        wav_paths.append(path)
        if lips:
            lip_path = os.path.join(lip_root, "lipread_files", word, "train", stem + ".npy")
            np.save(lip_path, lip_arr[i])
            lip_paths.append(lip_path)
    return Corpus(root, audio_root, lip_root, waves, lip_arr, labels, wav_paths, lip_paths)
