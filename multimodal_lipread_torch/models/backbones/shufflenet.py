"""ShuffleNetV2 backbone (widths 0.5 and 1.0), torchvision's topology
(counterpart of the JAX package's ``models/backbones/shufflenet.py``).

Stem: 3×3 stride-2 conv → BatchNorm → ReLU → 3×3 stride-2 max-pool; three
stages of shuffle units (4, 8, 4; the first of each at stride 2 with a
depthwise + pointwise second branch); a 1×1 conv to 1024 channels. Input
NCHW; returns the global mean (B, 1024).

Submodules carry the JAX names (``conv1``, ``conv1_bn``,
``stage{s}_{i}`` with ``b1_dw``, ``b1_dw_bn``, ``b1_pw``, ``b1_pw_bn``,
``b2_pw1``, ... ``b2_pw2_bn``; ``conv5``, ``conv5_bn``); the JAX module's
``_BN``/``BatchNorm_0`` level is dropped by ``utils/jax_bridge.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_lipread_torch.nn.common import BatchNorm, conv2d

_STAGE_OUT = {
    0.5: ((48, 96, 192), 1024),
    1.0: ((116, 232, 464), 1024),
}
_REPEATS = (4, 8, 4)


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """NCHW channel shuffle: (B, g, C/g, H, W) with dims 1 and 2 swapped."""
    b, c, h, w = x.shape
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


class ShuffleUnit(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        branch = features // 2
        if stride != 1:  # only stride-2 units have the first branch
            self.b1_dw = nn.Conv2d(in_ch, in_ch, 3, 2, 1, groups=in_ch, bias=False)
            self.b1_dw_bn = BatchNorm(in_ch)
            self.b1_pw = nn.Conv2d(in_ch, branch, 1, bias=False)
            self.b1_pw_bn = BatchNorm(branch)
            b2_in = in_ch
        else:
            b2_in = in_ch // 2
        self.b2_pw1 = nn.Conv2d(b2_in, branch, 1, bias=False)
        self.b2_pw1_bn = BatchNorm(branch)
        self.b2_dw = nn.Conv2d(branch, branch, 3, stride, 1, groups=branch, bias=False)
        self.b2_dw_bn = BatchNorm(branch)
        self.b2_pw2 = nn.Conv2d(branch, branch, 1, bias=False)
        self.b2_pw2_bn = BatchNorm(branch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
        else:
            x1 = self.b1_dw_bn(conv2d(self.b1_dw, x))
            x1 = F.relu(self.b1_pw_bn(conv2d(self.b1_pw, x1)))
            x2 = x
        y = F.relu(self.b2_pw1_bn(conv2d(self.b2_pw1, x2)))
        y = self.b2_dw_bn(conv2d(self.b2_dw, y))
        y = F.relu(self.b2_pw2_bn(conv2d(self.b2_pw2, y)))
        return channel_shuffle(torch.cat([x1, y], dim=1), 2)


class ShuffleNetV2(nn.Module):
    """ShuffleNetV2 over 3-channel NCHW frames."""

    def __init__(self, width: float = 1.0):
        super().__init__()
        if width not in _STAGE_OUT:
            raise ValueError(f"Unsupported ShuffleNetV2 width: {width}")
        stage_out, self.feature_dim = _STAGE_OUT[width]
        self.conv1 = nn.Conv2d(3, 24, 3, 2, 1, bias=False)
        self.conv1_bn = BatchNorm(24)
        self.units = []
        c = 24
        for stage, (out_ch, reps) in enumerate(zip(stage_out, _REPEATS)):
            for i in range(reps):
                name = f"stage{stage + 2}_{i}"
                self.add_module(name, ShuffleUnit(c, out_ch, 2 if i == 0 else 1))
                self.units.append(name)
                c = out_ch
        self.conv5 = nn.Conv2d(c, self.feature_dim, 1, bias=False)
        self.conv5_bn = BatchNorm(self.feature_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1_bn(conv2d(self.conv1, x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.units:
            x = getattr(self, name)(x)
        return F.relu(self.conv5_bn(conv2d(self.conv5, x))).mean(dim=(2, 3))
