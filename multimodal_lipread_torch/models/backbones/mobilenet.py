"""MobileNetV2 and MobileNetV3-small backbones, torchvision's topology
(counterpart of the JAX package's ``models/backbones/mobilenet.py``).

- ``MobileNetV2``: a 3×3 stride-2 stem to 32 channels, 17 inverted-residual
  blocks (1×1 expansion, 3×3 depthwise, 1×1 linear projection; a residual
  where stride is 1 and the width is kept) and a 1×1 head to 1280
  channels; BatchNorm eps 1e-5, ReLU6. Returns the global mean (B, 1280).
- ``MobileNetV3Small``: a 3×3 stride-2 hardswish stem to 16 channels, 11
  inverted-residual blocks (ReLU or hardswish; block 0 has no expansion;
  squeeze-excite in 9 of them) and a 1×1 hardswish head to 576 channels;
  BatchNorm eps 1e-3. Returns the global mean (B, 576).

Input NCHW. Submodules carry the JAX names (``stem``, ``block{i}`` with
``expand``/``depthwise``/``se``/``project``, ``head``, each ConvBNAct
holding ``conv`` and ``bn``; the squeeze-excite's biased 1×1 convs are
``fc1``/``fc2``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_lipread_torch.nn.common import BatchNorm, conv2d

# t (expansion), c (width), n (blocks), s (stride of the first)
_SETTINGS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


_ACTS = {"relu6": F.relu6, "hardswish": F.hardswish, "relu": F.relu, "none": lambda x: x}


class ConvBNAct(nn.Module):
    """Conv (no bias, padding (k-1)/2) → BatchNorm (``bn_eps``: torchvision
    takes 1e-5 for V2, 1e-3 for V3) → ``act``: relu6, hardswish, relu or
    none."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1, groups: int = 1,
                 act: str = "relu6", bn_eps: float = 1e-5):
        super().__init__()
        if act not in _ACTS:
            raise ValueError(f"Unknown activation: {act}")
        self.act = act
        self.conv = nn.Conv2d(in_ch, features, kernel, stride, (kernel - 1) // 2, groups=groups, bias=False)
        self.bn = BatchNorm(features, eps=bn_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ACTS[self.act](self.bn(conv2d(self.conv, x)))


class InvertedResidualV2(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = in_ch * expand_ratio
        self.residual = stride == 1 and in_ch == features
        self.expand = ConvBNAct(in_ch, hidden, kernel=1) if expand_ratio != 1 else None
        self.depthwise = ConvBNAct(hidden, hidden, kernel=3, stride=stride, groups=hidden)
        self.project = ConvBNAct(hidden, features, kernel=1, act="none")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.expand is None else self.expand(x)
        y = self.project(self.depthwise(y))
        return y + x if self.residual else y


class MobileNetV2(nn.Module):
    """MobileNetV2 features over NCHW images of ``in_channels`` channels (3
    for lip frames, 1 for a log-mel image; the Flax module infers it)."""

    feature_dim = 1280

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.stem = ConvBNAct(in_channels, 32, kernel=3, stride=2)
        self.blocks = []
        c = 32
        for t, width, n, s in _SETTINGS:
            for i in range(n):
                name = f"block{len(self.blocks)}"
                self.add_module(name, InvertedResidualV2(c, width, s if i == 0 else 1, t))
                self.blocks.append(name)
                c = width
        self.head = ConvBNAct(c, self.feature_dim, kernel=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.head(x).mean(dim=(2, 3))


# kernel, expanded width, output width, squeeze-excite, activation, stride
_V3_SMALL_SETTINGS = (
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
_V3_BN_EPS = 1e-3


class SqueezeExcite(nn.Module):
    """x · hardsigmoid(fc2(relu(fc1(mean over H, W)))), ``fc1``/``fc2``
    biased 1×1 convs (the JAX ``_SqueezeExcite``)."""

    def __init__(self, channels: int, squeeze_channels: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze_channels, 1)
        self.fc2 = nn.Conv2d(squeeze_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(conv2d(self.fc1, x.mean(dim=(2, 3), keepdim=True)))
        return x * F.hardsigmoid(conv2d(self.fc2, s))


class InvertedResidualV3(nn.Module):
    def __init__(self, in_ch: int, kernel: int, expanded: int, features: int, use_se: bool, act: str,
                 stride: int):
        super().__init__()
        self.residual = stride == 1 and in_ch == features
        self.expand = (ConvBNAct(in_ch, expanded, kernel=1, act=act, bn_eps=_V3_BN_EPS)
                       if expanded != in_ch else None)
        self.depthwise = ConvBNAct(expanded, expanded, kernel=kernel, stride=stride, groups=expanded, act=act,
                                   bn_eps=_V3_BN_EPS)
        self.se = SqueezeExcite(expanded, _make_divisible(expanded // 4)) if use_se else None
        self.project = ConvBNAct(expanded, features, kernel=1, act="none", bn_eps=_V3_BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.depthwise(x if self.expand is None else self.expand(x))
        if self.se is not None:
            y = self.se(y)
        y = self.project(y)
        return y + x if self.residual else y


class MobileNetV3Small(nn.Module):
    """MobileNetV3-small features over 3-channel NCHW frames."""

    feature_dim = 576

    def __init__(self):
        super().__init__()
        self.stem = ConvBNAct(3, 16, kernel=3, stride=2, act="hardswish", bn_eps=_V3_BN_EPS)
        self.blocks = []
        c = 16
        for i, (k, e, width, se, act, s) in enumerate(_V3_SMALL_SETTINGS):
            self.add_module(f"block{i}", InvertedResidualV3(c, k, e, width, se, act, s))
            self.blocks.append(f"block{i}")
            c = width
        self.head = ConvBNAct(c, self.feature_dim, kernel=1, act="hardswish", bn_eps=_V3_BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.head(x).mean(dim=(2, 3))
