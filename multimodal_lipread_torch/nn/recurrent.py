"""Bidirectional LSTM (counterpart of the JAX package's ``nn/recurrent.py``).

The JAX package runs its own fused scan; PyTorch's ``nn.LSTM`` (cuDNN on
the card) computes the same cell: gates packed i, f, g, o, with the input
and recurrent biases both added. The JAX parameters
``l{n}_{fwd,bwd}/{w_ih, w_hh, b_ih, b_hh}`` are stored (D, 4H) where torch
keeps (4H, D); ``utils/jax_bridge.py`` transposes them.
"""

from __future__ import annotations

import torch
from torch import nn


class BiLSTM(nn.Module):
    """Bidirectional multi-layer LSTM over (B, T, D) → (B, T, 2H).

    ``dropout`` is torch's inter-layer dropout (train time only)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1, dropout: float = 0.0):
        super().__init__()
        self.lstm = nn.LSTM(
            input_size, hidden_size, num_layers=num_layers, batch_first=True,
            bidirectional=True, dropout=dropout if num_layers > 1 else 0.0,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, _ = self.lstm(x)
        return out
