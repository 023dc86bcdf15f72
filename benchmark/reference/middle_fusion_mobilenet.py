"""Plain ``middle_fusion_mobilenet`` from raw waveforms and uint8 lips.

- Audio: the log-mel (``logmel.py``) cut to 80 × ``audio_input_size``,
  two 3 × 3 convolutions with bias (32, 64) → BatchNorm (eps 1e-5) → ReLU
  → 2 × 2 max-pool, flattened in (H, W, C) order: 64 · 20 · 29 = 37,120
  features at 117.
- Video: lips / 255, every frame through MobileNetV3-small (Howard et al.
  2019, torchvision's topology: a 3 × 3 stride-2 hardswish stem to 16, 11
  inverted residuals with squeeze-excite in 9, a 1 × 1 hardswish head to
  576, BatchNorm eps 1e-3, the global mean), a 1-layer BiLSTM of 256 over
  the 29 frames, its last step (512).
- Fusion: concat → Linear 37,632 → 512 → ReLU → Dropout 0.3 → Linear.

Departure from torchvision: the squeeze-excite's hidden width is
``make_divisible(expanded // 4)``, as the reference project's port has it."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import layers as L
from benchmark.reference.logmel import N_MELS, NUM_SAMPLES, log_mel

AUDIO_CHANNELS = (32, 64)
# kernel, expanded width, output width, squeeze-excite, activation, stride
V3_SMALL = (
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
)
FEATURES = 576
LSTM_HIDDEN = 256
FUSION_HIDDEN = 512
DROPOUT = 0.3
AUDIO_BN_EPS = 1e-5
V3_BN_EPS = 1e-3
ACTS = {"relu": F.relu, "hardswish": F.hardswish, "none": lambda x: x}


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


def _blocks():
    """(name, in, kernel, expanded, out, squeeze width or 0, act, stride)."""
    c = 16
    for i, (k, e, out, se, act, s) in enumerate(V3_SMALL):
        yield f"video_encoder.cnn.block{i}", c, k, e, out, make_divisible(e // 4) if se else 0, act, s
        c = out


def _audio_flat(cfg: dict) -> int:
    h, w = N_MELS, cfg["dataset"]["audio_input_size"]
    for _ in AUDIO_CHANNELS:
        h, w = h // 2, w // 2
    return AUDIO_CHANNELS[-1] * h * w


def param_spec(cfg: dict) -> dict:
    spec, c = {}, 1
    for i, ch in enumerate(AUDIO_CHANNELS):
        spec.update(L.conv_spec(f"audio_encoder.conv{i}", c, ch, 3))
        spec.update(L.bn_spec(f"audio_encoder.bn{i}", ch))
        c = ch

    def conv_bn(name, cin, cout, k, groups=1):
        spec.update(L.conv_spec(f"{name}.conv", cin, cout, k, groups, bias=False))
        spec.update(L.bn_spec(f"{name}.bn", cout))

    conv_bn("video_encoder.cnn.stem", 3, 16, 3)
    for name, cin, k, e, out, sq, _act, _s in _blocks():
        if e != cin:
            conv_bn(f"{name}.expand", cin, e, 1)
        conv_bn(f"{name}.depthwise", e, e, k, groups=e)
        if sq:
            spec.update(L.conv_spec(f"{name}.se.fc1", e, sq, 1))
            spec.update(L.conv_spec(f"{name}.se.fc2", sq, e, 1))
        conv_bn(f"{name}.project", e, out, 1)
    conv_bn("video_encoder.cnn.head", 96, FEATURES, 1)
    spec.update(L.lstm_spec("video_encoder.lstm.lstm", FEATURES, LSTM_HIDDEN, 1))
    spec.update(L.linear_spec("classifier.fc1", _audio_flat(cfg) + 2 * LSTM_HIDDEN, FUSION_HIDDEN))
    spec.update(L.linear_spec("classifier.fc2", FUSION_HIDDEN, cfg["dataset"]["num_classes"]))
    return spec


def features(cfg: dict, waves: torch.Tensor) -> torch.Tensor:
    return log_mel(waves)[:, :N_MELS, : cfg["dataset"]["audio_input_size"]]


def _conv_bn_act(p, name, x, train, act, stride=1, groups=1):
    return ACTS[act](L.batch_norm(p, f"{name}.bn", L.conv(p, f"{name}.conv", x, stride, groups), train, V3_BN_EPS))


def mobilenet_v3_small(p: L.Params, frames: torch.Tensor, train: bool) -> torch.Tensor:
    """(N, 3, H, W) → (N, 576)."""
    x = _conv_bn_act(p, "video_encoder.cnn.stem", frames, train, "hardswish", stride=2)
    for name, cin, _k, e, out, sq, act, s in _blocks():
        y = x if e == cin else _conv_bn_act(p, f"{name}.expand", x, train, act)
        y = _conv_bn_act(p, f"{name}.depthwise", y, train, act, stride=s, groups=e)
        if sq:
            squeeze = F.relu(L.conv(p, f"{name}.se.fc1", y.mean(dim=(2, 3), keepdim=True)))
            y = y * F.hardsigmoid(L.conv(p, f"{name}.se.fc2", squeeze))
        y = _conv_bn_act(p, f"{name}.project", y, train, "none")
        x = y + x if s == 1 and cin == out else y
    return _conv_bn_act(p, "video_encoder.cnn.head", x, train, "hardswish").mean(dim=(2, 3))


def forward(p: L.Params, cfg: dict, inputs: tuple, train: bool, generator=None) -> torch.Tensor:
    waves, lips = inputs
    y = features(cfg, waves)[:, None]
    for i in range(len(AUDIO_CHANNELS)):
        y = L.batch_norm(p, f"audio_encoder.bn{i}", L.conv(p, f"audio_encoder.conv{i}", y), train, AUDIO_BN_EPS)
        y = F.max_pool2d(F.relu(y), 2, 2)
    audio = y.permute(0, 2, 3, 1).flatten(1)
    b, t = lips.shape[:2]
    frames = (lips.to(audio.dtype) / 255.0).reshape((b * t,) + lips.shape[2:]).permute(0, 3, 1, 2)
    seq = mobilenet_v3_small(p, frames, train).reshape(b, t, FEATURES)
    video = L.bilstm(p, "video_encoder.lstm.lstm", seq, 1)[:, -1]
    h = F.relu(L.linear(p, "classifier.fc1", torch.cat([audio, video], dim=-1)))
    return L.linear(p, "classifier.fc2", L.dropout(h, DROPOUT, generator, train))


def example_inputs(batch: int) -> tuple:
    """Zeros of the raw inputs' shapes and dtypes, for counting FLOPs."""
    return (torch.zeros(batch, NUM_SAMPLES, dtype=torch.int16),
            torch.zeros(batch, 29, 44, 44, 3, dtype=torch.uint8))
