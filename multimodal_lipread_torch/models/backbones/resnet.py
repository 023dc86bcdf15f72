"""ResNet-18/34/50 backbones, torchvision's topology (counterpart of the
JAX package's ``models/backbones/resnet.py``).

Stem: 7×7 stride-2 conv (pad 3) → BatchNorm → ReLU → 3×3 stride-2 max-pool
(pad 1, padded with −inf as Flax pads it); then four stages of
``BasicBlock`` (18, 34) or ``Bottleneck`` (50), the first block of stages
2–4 at stride 2, with a 1×1 conv + BatchNorm shortcut where the shape
changes. Convolutions have no bias; BatchNorm is Flax's (momentum 0.9,
eps 1e-5). Input NCHW; ``pool=True`` (the default) returns the global mean
(B, 512 or 2048), else the final map.

Submodules carry the JAX names (``conv1``, ``bn1``,
``layer{stage}_{block}`` with ``conv{k}``, ``bn{k}``, ``downsample_conv``,
``downsample_bn``). The JAX module wraps each BatchNorm in a ``_BN``
module, so its leaves sit at ``bn1/BatchNorm_0/...``; ``utils/jax_bridge.py``
drops that level.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_lipread_torch.nn.common import BatchNorm, conv2d


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(features)
        self.shortcut = stride != 1 or in_ch != features
        if self.shortcut:
            self.downsample_conv = nn.Conv2d(in_ch, features, 1, stride, bias=False)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(conv2d(self.conv1, x)))
        y = self.bn2(conv2d(self.conv2, y))
        identity = self.downsample_bn(conv2d(self.downsample_conv, x)) if self.shortcut else x
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        out_ch = features * self.expansion
        self.conv1 = nn.Conv2d(in_ch, features, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = nn.Conv2d(features, out_ch, 1, bias=False)
        self.bn3 = BatchNorm(out_ch)
        self.shortcut = stride != 1 or in_ch != out_ch
        if self.shortcut:
            self.downsample_conv = nn.Conv2d(in_ch, out_ch, 1, stride, bias=False)
            self.downsample_bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(conv2d(self.conv1, x)))
        y = F.relu(self.bn2(conv2d(self.conv2, y)))
        y = self.bn3(conv2d(self.conv3, y))
        identity = self.downsample_bn(conv2d(self.downsample_conv, x)) if self.shortcut else x
        return F.relu(y + identity)


_CONFIGS = {
    18: (BasicBlock, (2, 2, 2, 2), 512),
    34: (BasicBlock, (3, 4, 6, 3), 512),
    50: (Bottleneck, (3, 4, 6, 3), 2048),
}


class ResNet(nn.Module):
    """ResNet backbone over 3-channel NCHW frames."""

    def __init__(self, version: int = 18):
        super().__init__()
        if version not in _CONFIGS:
            raise ValueError(f"Invalid ResNet version: {version}")
        block_cls, stage_sizes, self.feature_dim = _CONFIGS[version]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        self.blocks = []
        c = 64
        for stage, (n_blocks, feats) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            for b in range(n_blocks):
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, block_cls(c, feats, 2 if (stage > 0 and b == 0) else 1))
                self.blocks.append(name)
                c = feats * block_cls.expansion

    def forward(self, x: torch.Tensor, pool: bool = True) -> torch.Tensor:
        x = F.relu(self.bn1(conv2d(self.conv1, x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3)) if pool else x
