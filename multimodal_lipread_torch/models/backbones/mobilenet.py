"""MobileNetV2 backbone, torchvision's topology (counterpart of the JAX
package's ``models/backbones/mobilenet.py``; its ``MobileNetV3Small`` comes
with the audio_video slice, ROADMAP.md).

A 3×3 stride-2 stem to 32 channels, 17 inverted-residual blocks (1×1
expansion, 3×3 depthwise, 1×1 linear projection; a residual where stride
is 1 and the width is kept) and a 1×1 head to 1280 channels; BatchNorm
eps 1e-5, ReLU6. Input NCHW; returns the global mean (B, 1280).
Submodules carry the JAX names (``stem``, ``block{i}`` with
``expand``/``depthwise``/``project``, ``head``, each holding ``conv`` and
``bn``).
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


class ConvBNAct(nn.Module):
    """Conv (no bias, padding (k-1)/2) → BatchNorm → ReLU6 (``act="relu6"``)
    or nothing (``act="none"``)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1, groups: int = 1,
                 act: str = "relu6"):
        super().__init__()
        self.act = act
        self.conv = nn.Conv2d(in_ch, features, kernel, stride, (kernel - 1) // 2, groups=groups, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(conv2d(self.conv, x))
        return F.relu6(x) if self.act == "relu6" else x


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
    """MobileNetV2 features over 3-channel NCHW frames."""

    feature_dim = 1280

    def __init__(self):
        super().__init__()
        self.stem = ConvBNAct(3, 32, kernel=3, stride=2)
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
