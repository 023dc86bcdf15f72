"""VGG-BN backbones (11/13/16/19): torchvision's 'features' topology
(counterpart of the JAX package's ``models/backbones/vgg.py``).

Conv 3x3 → BatchNorm (Flax's: momentum 0.9, eps 1e-5, biased running
variance) → ReLU, MaxPool 2 at each "M". Input NCHW → the final feature map
NCHW (512 channels), in the input's dtype over float32 weights. Submodules
are named ``conv{k}``/``bn{k}`` as in the JAX module.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_lipread_torch.nn.common import BatchNorm, conv2d

_CFGS = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    13: (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
         512, 512, 512, 512, "M"),
}


class VGG(nn.Module):
    """VGG-BN feature extractor."""

    def __init__(self, version: int = 11, in_channels: int = 1):
        super().__init__()
        if version not in _CFGS:
            raise ValueError(f"Invalid VGG version: {version}")
        self.version = version
        c = in_channels
        k = 0
        for v in _CFGS[version]:
            if v == "M":
                continue
            self.add_module(f"conv{k}", nn.Conv2d(c, v, 3, padding=1))
            self.add_module(f"bn{k}", BatchNorm(v))
            c = v
            k += 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = 0
        for v in _CFGS[self.version]:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"bn{k}")(conv2d(getattr(self, f"conv{k}"), x)))
                k += 1
        return x
