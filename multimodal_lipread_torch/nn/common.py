"""Common building blocks: adaptive pooling, MLPs and the classifier head
(counterpart of the JAX package's ``nn/common.py``).

Submodule names follow the JAX modules' (``dense{i}``, ``bn{i}``, ``out``;
``fc1``, ``bn``, ``fc2``) so that ``utils/jax_bridge.py`` maps parameters by
name. Tensors are NCHW / (B, F), PyTorch's layout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def adaptive_avg_pool2d(x: torch.Tensor, output_size: Sequence[Optional[int]]) -> torch.Tensor:
    """torch.nn.AdaptiveAvgPool2d on an NCHW tensor; a ``None`` entry of
    ``output_size`` keeps that dimension. Bin boundaries are torch's:
    start = floor(i*L/out), end = ceil((i+1)*L/out)."""
    h, w = x.shape[-2:]
    oh = h if output_size[0] is None else int(output_size[0])
    ow = w if output_size[1] is None else int(output_size[1])
    return F.adaptive_avg_pool2d(x, (oh, ow))


class MLP(nn.Module):
    """Linear → [BatchNorm] → ReLU → Dropout stack with a final Linear."""

    def __init__(
        self,
        in_features: int,
        hidden_sizes: Sequence[int],
        num_outputs: int,
        dropout_rate: float = 0.0,
        use_batchnorm: bool = False,
    ):
        super().__init__()
        self.hidden_sizes = tuple(hidden_sizes)
        self.dropout_rate = dropout_rate
        self.use_batchnorm = use_batchnorm
        d = in_features
        for i, h in enumerate(self.hidden_sizes):
            self.add_module(f"dense{i}", nn.Linear(d, h))
            if use_batchnorm:
                self.add_module(f"bn{i}", nn.BatchNorm1d(h, eps=1e-5, momentum=0.1))
            d = h
        self.out = nn.Linear(d, num_outputs)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.hidden_sizes)):
            x = getattr(self, f"dense{i}")(x)
            if self.use_batchnorm:
                x = getattr(self, f"bn{i}")(x)
            x = F.relu(x)
            if self.dropout_rate > 0:
                x = self.dropout(x)
        return self.out(x)


class ClassifierHead(nn.Module):
    """The recurring Linear → BN → ReLU → Dropout → Linear classifier."""

    def __init__(
        self,
        in_features: int,
        hidden_size: int,
        num_classes: int,
        dropout_rate: float = 0.5,
        use_batchnorm: bool = True,
    ):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_size)
        # Flax momentum 0.9 (weight of the old running value) is torch's 0.1
        self.bn = nn.BatchNorm1d(hidden_size, eps=1e-5, momentum=0.1) if use_batchnorm else None
        self.dropout = nn.Dropout(dropout_rate)
        self.fc2 = nn.Linear(hidden_size, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(x)
        if self.bn is not None:
            x = self.bn(x)
        x = self.dropout(F.relu(x))
        return self.fc2(x)
