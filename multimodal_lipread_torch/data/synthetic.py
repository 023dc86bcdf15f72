"""Synthetic mini-GLips corpus: audio clips, lip-region tensors and cue
descriptions, and rendered ``.mp4`` videos (the JAX package's
``data/synthetic.py``; numpy, and OpenCV for the videos only).

Writes ``<root>/lipread_files/<word>/<split>/<word>_NNNN-NNNN.wav`` (16 kHz
PCM16, 1.25 s), ``<root>_lip_regions/lipread_files/<word>/<split>/
<word>_NNNN-NNNN.npy`` ((29, 44, 44, 3) uint8) and
``<root>/Descriptions_{Emotion,Environment}/lipreading_analysis_results_
{mode}_{word}_{split}.json`` (lists of ``{word, sequence_id,
description}``) and ``<root>/lipread_files/<word>/<split>/<word>_NNNN-NNNN.mp4``
(the clip's lips rendered into the centre backend's box of 96 × 96
frames) with class-conditional signals, so models can fit the
corpus: for audio a harmonic stack at a class-specific pitch (up to 8
classes) or a two-tone grid code (more classes); for lips a class-specific
brightness and stripe period (up to 8 classes) or a brightness × stripe
grid code (more classes); for cues class-specific adjectives
(``cue_style='slice'``) or a mood × articulation word pair placed after
token 32 (``'compositional'``).
"""

from __future__ import annotations

import json
import os
from typing import Sequence, Union

import numpy as np

from multimodal_lipread_torch.data.audio_io import SAMPLE_RATE, TARGET_SAMPLES, write_wav
from multimodal_lipread_torch.data.glips import SPLITS, lip_regions_root

DEFAULT_WORDS = ("abend", "bereits", "cirka", "dabei")

_EMOTION_TEMPLATES = (
    "The speaker appears {adj} while articulating, with {feat} lip movement.",
    "A {adj} expression dominates; the mouth shows {feat} motion.",
    "Facial cues suggest a {adj} mood and {feat} articulation.",
)
_ENV_TEMPLATES = (
    "The speaker stands before a {adj} backdrop with {feat} lighting.",
    "An indoor scene with {adj} walls and {feat} illumination.",
    "The background looks {adj}; lighting is {feat}.",
)
_ADJ = ("calm", "tense", "neutral", "animated", "focused", "relaxed", "bright", "plain")
_FEAT = ("subtle", "pronounced", "rapid", "slow", "rhythmic", "steady", "soft", "sharp")

# the compositional style's marker words, disjoint from _ADJ/_FEAT and from
# each other
_MOOD = ("wistful", "jubilant", "stoic", "agitated", "serene", "brooding", "playful", "solemn")
_ARTIC = ("clipped", "drawled", "staccato", "flowing", "mumbled", "crisp", "halting", "emphatic")
_SCENE = ("cluttered", "sparse", "sunlit", "shadowed", "tiled", "curtained", "paneled", "mirrored")
_LIGHT = ("flickering", "diffuse", "harsh", "amber", "pale", "strobing", "dappled", "even")

_COMP_C1 = (
    "at first the speaker simply faces the camera and settles into position "
    "before the clip begins in earnest",
    "the recording opens with the speaker adjusting their stance while the "
    "frame holds steady on the face",
    "for the opening moments nothing stands out as the speaker waits quietly "
    "and the shot stays fixed in place",
)
_COMP_C2_EMOTION = (
    "early frames hint at a {weak} expression though the impression stays "
    "faint and hard to pin down",
    "an initial glance suggests something {weak} about the face but the "
    "signal is weak and easy to doubt",
    "there is a passing {weak} quality to the look yet it fades before it "
    "can be read with confidence",
)
_COMP_C2_ENV = (
    "early frames hint at a {weak} backdrop though the impression stays "
    "faint and hard to pin down",
    "an initial glance suggests something {weak} about the setting but the "
    "signal is weak and easy to doubt",
    "there is a passing {weak} quality to the room yet it fades before it "
    "can be read with confidence",
)
_COMP_C3_EMOTION = (
    "by the end the mood reads {mood} overall, a {mood} cast that lingers, "
    "while the articulation remains {artic}, even insistently {artic}, for "
    "the rest of the take",
    "once the word is spoken the expression settles into something {mood}, "
    "unmistakably {mood}, and the delivery turns {artic}, resolutely "
    "{artic}, until the cut",
    "the closing frames leave a {mood} impression, {mood} through and "
    "through, as the mouth keeps a {artic} rhythm, {artic} to the last "
    "moment",
)
_COMP_C3_ENV = (
    "by the end the scene reads {mood} overall, a {mood} cast that lingers, "
    "while the lighting remains {artic}, even insistently {artic}, for the "
    "rest of the take",
    "once the word is spoken the backdrop settles into something {mood}, "
    "unmistakably {mood}, and the illumination turns {artic}, resolutely "
    "{artic}, until the cut",
    "the closing frames leave a {mood} impression, {mood} through and "
    "through, as the lighting keeps a {artic} character, {artic} to the "
    "last moment",
)


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


def _synth_lip_sequence(
    rng: np.random.Generator, class_idx: int, num_classes: int = 4, hardness: float = 0.0
) -> np.ndarray:
    """(29, 44, 44, 3) uint8 frames with a class-specific brightness and
    horizontal stripe period over uniform pixel noise.

    ``hardness`` shrinks the brightness and stripe separation, adds a
    per-clip brightness and contrast nuisance and a random stripe phase,
    raises the noise, and with probability 0.5·hardness takes the whole
    signature from a random class while the label stays. Beyond 8 classes
    the class is a grid code: brightness level i of k and stripe period
    j + 2 (k = ceil(sqrt(num_classes)))."""
    if hardness > 0 and rng.uniform() < 0.5 * hardness:
        class_idx = int(rng.integers(num_classes))
    if num_classes > 8:
        k = int(np.ceil(np.sqrt(num_classes)))
        i, j = class_idx // k, class_idx % k
        base = 30.0 + (185.0 / max(k - 1, 1)) * i
        if hardness > 0:
            base = base + hardness * rng.uniform(-45, 45)
        noise_amp = 30 + 150 * hardness
        frames = rng.integers(0, max(1, int(noise_amp)), size=(29, 44, 44, 3), dtype=np.int64)
        yy = np.arange(44)[None, :, None, None]
        stripe_amp = 60.0 * (1.0 - 0.8 * hardness)
        phase = int(rng.integers(0, 2 + j)) if hardness > 0 else 0
        stripes = (((yy + phase) // (2 + j)) % 2) * stripe_amp
        contrast = 1.0 + hardness * rng.uniform(-0.3, 0.3) if hardness > 0 else 1.0
        return np.clip((base + frames + stripes) * contrast, 0, 255).astype(np.uint8)
    sep = 40.0 * (1.0 - 0.85 * hardness)
    base = 40 + sep * class_idx
    if hardness > 0:
        base = base + hardness * rng.uniform(-45, 45)
    noise_amp = 30 + 150 * hardness
    frames = rng.integers(0, max(1, int(noise_amp)), size=(29, 44, 44, 3), dtype=np.int64)
    yy = np.arange(44)[None, :, None, None]
    stripe_amp = 60.0 * (1.0 - 0.8 * hardness)
    phase = int(rng.integers(0, 2 + class_idx)) if hardness > 0 else 0
    stripes = (((yy + phase) // (2 + class_idx)) % 2) * stripe_amp
    contrast = 1.0 + hardness * rng.uniform(-0.3, 0.3) if hardness > 0 else 1.0
    return np.clip((base + frames + stripes) * contrast, 0, 255).astype(np.uint8)


def _synth_description(
    rng: np.random.Generator, mode: str, class_idx: int, num_classes: int = 4, hardness: float = 0.0
) -> str:
    """One of three templates per mode, with an adjective and a feature word
    from the class's slice of the 8-word vocabularies (stride
    ``8 // num_classes``; neighbouring slices overlap beyond 4 classes).
    With probability 0.65·hardness both words come from the whole
    vocabulary instead."""
    tmpl = (_EMOTION_TEMPLATES if mode == "emotion" else _ENV_TEMPLATES)[int(rng.integers(3))]
    if hardness > 0 and rng.uniform() < 0.65 * hardness:
        adj = _ADJ[int(rng.integers(len(_ADJ)))]
        feat = _FEAT[int(rng.integers(len(_FEAT)))]
    else:
        stride = max(1, len(_ADJ) // max(1, num_classes))
        adj = _ADJ[(stride * class_idx + int(rng.integers(2))) % len(_ADJ)]
        feat = _FEAT[(stride * class_idx + int(rng.integers(2))) % len(_FEAT)]
    return tmpl.format(adj=adj, feat=feat)


def _synth_description_compositional(
    rng: np.random.Generator, mode: str, class_idx: int, num_classes: int = 4, hardness: float = 0.0
) -> str:
    """Three clauses: an opening without signal, a clause with a weak marker
    word (the class's slice of ``_ADJ`` with probability
    max(0.1, 0.45 − 0.3·hardness), else any), and, after token 32, a mood
    word and an articulation word whose indices sum to the class modulo
    ``num_classes`` (both uniform with probability 0.5·hardness). Up to 8
    classes."""
    if num_classes > 8:
        raise ValueError(
            "compositional cue style supports <= 8 classes (8-word marker "
            f"vocabularies); got {num_classes}"
        )
    c1 = _COMP_C1[int(rng.integers(len(_COMP_C1)))]
    c2_t = (_COMP_C2_EMOTION if mode == "emotion" else _COMP_C2_ENV)[int(rng.integers(3))]
    c3_t = (_COMP_C3_EMOTION if mode == "emotion" else _COMP_C3_ENV)[int(rng.integers(3))]
    p_inform = max(0.1, 0.45 - 0.3 * hardness)
    if rng.uniform() < p_inform:
        stride = max(1, len(_ADJ) // max(1, num_classes))
        weak = _ADJ[(stride * class_idx + int(rng.integers(2))) % len(_ADJ)]
    else:
        weak = _ADJ[int(rng.integers(len(_ADJ)))]
    vocab_mood = (_MOOD if mode == "emotion" else _SCENE)[:num_classes]
    vocab_artic = (_ARTIC if mode == "emotion" else _LIGHT)[:num_classes]
    if hardness > 0 and rng.uniform() < 0.5 * hardness:
        mi = int(rng.integers(len(vocab_mood)))
        ai = int(rng.integers(len(vocab_artic)))
    else:
        mi = int(rng.integers(len(vocab_mood)))
        ai = (class_idx - mi) % num_classes
    return ". ".join((
        c1.capitalize(),
        c2_t.format(weak=weak).capitalize(),
        c3_t.format(mood=vocab_mood[mi], artic=vocab_artic[ai]).capitalize(),
    )) + "."


def _write_synth_video(path: str, lips: np.ndarray, frame_size=(96, 96)) -> None:
    """Render a lip sequence into an ``.mp4`` (OpenCV's ``mp4v``) whose
    centre-backend lip box (``data/lip_extraction._CenterBackend`` with the
    0.4 margin) carries the 44 × 44 signal, upscaled, on a grey frame: the
    raw-video counterpart of the ``.npy`` lip store, for the streaming video
    paths (host decode, then the crop on the host or on the device)."""
    import cv2

    os.makedirs(os.path.dirname(path), exist_ok=True)
    H, W = frame_size
    x0, y0, x1, y1 = W // 3, H // 2, 2 * W // 3, 5 * H // 6
    mh, mw = int((y1 - y0) * 0.4), int((x1 - x0) * 0.4)
    bx0, by0, bx1, by1 = max(0, x0 - mw), max(0, y0 - mh), min(W, x1 + mw), min(H, y1 + mh)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (W, H))
    for frame_rgb_44 in lips:
        frame = np.full((H, W, 3), 128, np.uint8)
        frame[by0:by1, bx0:bx1] = cv2.resize(frame_rgb_44, (bx1 - bx0, by1 - by0))
        writer.write(frame[..., ::-1])  # RGB → BGR for the encoder
    writer.release()


def make_synthetic_glips(
    root: str,
    words: Sequence[str] = DEFAULT_WORDS,
    clips_per_split: int = 4,
    splits: Sequence[str] = SPLITS,
    seed: int = 0,
    hardness: Union[float, dict] = 0.0,
    label_noise: float = 0.0,
    with_audio: bool = True,
    with_lip_regions: bool = False,
    with_cues: bool = False,
    cue_style: str = "slice",
    with_video: bool = False,
) -> str:
    """Write a synthetic GLips tree under ``root``; returns ``root``.

    ``with_audio`` writes the WAV clips, ``with_lip_regions`` the lip
    tensors into the mirror tree ``<root>_lip_regions``, ``with_cues`` one
    emotion and one environment description per clip into the cue store
    under ``root`` (``cue_style`` 'slice' or 'compositional'),
    ``with_video`` an ``.mp4`` per clip beside the WAVs, rendered from the
    clip's lip tensor (one draw feeds both stores); the default is audio
    only. ``hardness`` is a float or a mapping with ``audio``,
    ``video`` and ``cues`` keys (the JAX function's per-modality form). ``label_noise``
    redraws the signal class of that fraction of train clips while the
    folder word (the label) stays. Sequence ids run ``0000-0001``,
    ``0002-0003``, ... over the whole corpus, wrapping at 10000.

    One random stream is drawn per corpus, per clip in the JAX function's
    order (label noise, waveform, lips, then the emotion and the
    environment description), so for the same arguments the files are byte
    for byte those of the JAX package's ``make_synthetic_glips`` (whose
    defaults differ: there ``with_lip_regions`` and ``with_cues`` are
    true)."""
    if cue_style not in ("slice", "compositional"):
        raise ValueError(f"unknown cue_style {cue_style!r}")
    if clips_per_split > 5000:
        raise ValueError(
            f"clips_per_split={clips_per_split} > 5000 would wrap the 4-digit "
            "sid space within one (word, split) directory and overwrite clips"
        )
    rng = np.random.default_rng(seed)
    if isinstance(hardness, dict):
        h_audio, h_video = float(hardness.get("audio", 0.0)), float(hardness.get("video", 0.0))
        h_cues = float(hardness.get("cues", 0.0))
    else:
        h_audio = h_video = h_cues = float(hardness)
    words = sorted(words)
    lip_root = lip_regions_root(root)
    describe = _synth_description_compositional if cue_style == "compositional" else _synth_description
    cue_records = {(mode, word, split): [] for mode in ("emotion", "environment") for word in words
                   for split in splits}
    seq_counter = 0
    for ci, word in enumerate(words):
        for split in splits:
            for _ in range(clips_per_split):
                sid = f"{seq_counter % 10000:04d}-{(seq_counter + 1) % 10000:04d}"
                seq_counter += 2
                sig_ci = ci
                if label_noise > 0 and split == "train" and rng.uniform() < label_noise:
                    sig_ci = int(rng.integers(len(words)))
                if with_audio:
                    path = os.path.join(root, "lipread_files", word, split, f"{word}_{sid}.wav")
                    write_wav(path, _synth_waveform(rng, sig_ci, len(words), h_audio))
                if with_lip_regions or with_video:
                    lips = _synth_lip_sequence(rng, sig_ci, len(words), h_video)
                if with_lip_regions:
                    path = os.path.join(lip_root, "lipread_files", word, split, f"{word}_{sid}.npy")
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    np.save(path, lips)
                if with_video:
                    _write_synth_video(os.path.join(root, "lipread_files", word, split, f"{word}_{sid}.mp4"), lips)
                if with_cues:
                    for mode in ("emotion", "environment"):
                        cue_records[(mode, word, split)].append({
                            "word": word, "sequence_id": sid,
                            "description": describe(rng, mode, sig_ci, len(words), h_cues),
                        })
    if with_cues:
        for (mode, word, split), records in cue_records.items():
            folder = os.path.join(root, f"Descriptions_{mode.capitalize()}")
            os.makedirs(folder, exist_ok=True)
            with open(os.path.join(folder, f"lipreading_analysis_results_{mode}_{word}_{split}.json"), "w") as f:
                json.dump(records, f, indent=2)
    return root
