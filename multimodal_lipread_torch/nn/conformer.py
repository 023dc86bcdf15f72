"""Conformer encoder blocks (counterpart of the JAX package's
``nn/conformer.py``, an extension beyond the reference zoo).

A block is a macaron half-step feed-forward, multi-head self-attention, a
convolution module and a second half-step feed-forward, then a LayerNorm:

- ``_FFN``: LayerNorm → Linear(4d) → swish → Dropout → Linear(d) → Dropout,
  added as ``x + 0.5 · y``;
- ``_ConvModule``: LayerNorm → Linear(2d) → GLU (``a · sigmoid(b)``, ``a``
  the first half) → depthwise Conv1d (k 7, ``SAME``: padding 3, groups d,
  biased) → BatchNorm over (B, d, T) → swish → Linear(d) → Dropout, added;
- the attention is the port's Flax-semantics ``MultiHeadDotProductAttention``
  (no dropout on the probabilities, Flax's default), then Dropout, added.

LayerNorms are Flax's (eps 1e-6). Submodule names are the JAX modules'
(``ffn1``, ``mhsa_ln``, ``mhsa``, ``conv`` with ``ln``/``pw1``/``dw``/``bn``/
``pw2``, ``ffn2``, ``final_ln``; the encoder's ``proj_in``, ``pos`` and
``block{i}``), so ``utils/jax_bridge.py`` maps their variables by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_lipread_torch.nn.attention import MultiHeadDotProductAttention, PositionalEncoding
from multimodal_lipread_torch.nn.common import BatchNorm, Dropout, LayerNorm, conv1d, linear


class _FFN(nn.Module):
    """Half-step macaron feed-forward."""

    def __init__(self, dim: int, dropout_rate: float = 0.1):
        super().__init__()
        self.ln = LayerNorm(dim)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dropout(F.silu(linear(self.fc1, self.ln(x))))
        return x + 0.5 * self.dropout(linear(self.fc2, y))


class _ConvModule(nn.Module):
    """LayerNorm → pointwise GLU → depthwise conv → BatchNorm → swish →
    pointwise, added to the input."""

    def __init__(self, dim: int, kernel_size: int = 7, dropout_rate: float = 0.1):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"SAME padding needs an odd kernel, not {kernel_size}")
        self.ln = LayerNorm(dim)
        self.pw1 = nn.Linear(dim, 2 * dim)
        self.dw = nn.Conv1d(dim, dim, kernel_size, padding=kernel_size // 2, groups=dim)
        self.bn = BatchNorm(dim)
        self.pw2 = nn.Linear(dim, dim)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = linear(self.pw1, self.ln(x)).chunk(2, dim=-1)
        y = conv1d(self.dw, (a * torch.sigmoid(b)).transpose(1, 2))  # (B, d, T)
        y = F.silu(self.bn(y)).transpose(1, 2)
        return x + self.dropout(linear(self.pw2, y))


class ConformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int = 4, conv_kernel: int = 7, dropout_rate: float = 0.1):
        super().__init__()
        self.ffn1 = _FFN(dim, dropout_rate)
        self.mhsa_ln = LayerNorm(dim)
        self.mhsa = MultiHeadDotProductAttention(dim, num_heads)
        self.dropout = Dropout(dropout_rate)
        self.conv = _ConvModule(dim, conv_kernel, dropout_rate)
        self.ffn2 = _FFN(dim, dropout_rate)
        self.final_ln = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ffn1(x)
        x = x + self.dropout(self.mhsa(self.mhsa_ln(x)))
        return self.final_ln(self.ffn2(self.conv(x)))


class ConformerEncoder(nn.Module):
    """Linear ``proj_in`` from ``in_features`` to ``d_model`` → sinusoidal
    positions → ``num_layers`` conformer blocks → (B, T, d_model)."""

    def __init__(self, in_features: int, d_model: int = 144, num_layers: int = 4, num_heads: int = 4,
                 conv_kernel: int = 7, dropout_rate: float = 0.1, max_len: int = 512):
        super().__init__()
        self.num_layers = num_layers
        self.proj_in = nn.Linear(in_features, d_model)
        self.pos = PositionalEncoding(d_model, max_len=max_len)
        for i in range(num_layers):
            self.add_module(f"block{i}", ConformerBlock(d_model, num_heads, conv_kernel, dropout_rate))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pos(linear(self.proj_in, x))
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x)
        return x
