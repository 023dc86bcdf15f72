"""Bidirectional LSTM (counterpart of the JAX package's ``nn/recurrent.py``).

The JAX package runs its own fused scan; PyTorch's ``nn.LSTM`` (cuDNN on
the card) computes the same cell: gates packed i, f, g, o, with the input
and recurrent biases both added. The JAX parameters
``l{n}_{fwd,bwd}/{w_ih, w_hh, b_ih, b_hh}`` are stored (D, 4H) where torch
keeps (4H, D); ``utils/jax_bridge.py`` transposes them. Its initializer,
uniform on ±1/√H for every weight and bias, is the JAX package's too
(``nn.common.flax_init_`` redraws it from a generator).
"""

from __future__ import annotations

import torch
from torch import nn


class BiLSTM(nn.Module):
    """Bidirectional multi-layer LSTM over (B, T, D) → (B, T, 2H).

    The weights stay float32; an input of another dtype (bfloat16) runs
    the LSTM in that dtype on casts of them. ``dropout`` is torch's
    inter-layer dropout (train time only)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1, dropout: float = 0.0):
        super().__init__()
        self.lstm = nn.LSTM(
            input_size, hidden_size, num_layers=num_layers, batch_first=True,
            bidirectional=True, dropout=dropout if num_layers > 1 else 0.0,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lstm = self.lstm
        lstm._update_flat_weights()  # as nn.LSTM.forward does, after a weight was replaced
        h0 = x.new_zeros(2 * lstm.num_layers, x.shape[0], lstm.hidden_size)
        weights = [w.to(x.dtype) for w in lstm._flat_weights]  # the parameters themselves at float32
        out, _, _ = torch._VF.lstm(  # what nn.LSTM.forward calls
            x, (h0, h0), weights, lstm.bias, lstm.num_layers, lstm.dropout,
            self.training, lstm.bidirectional, lstm.batch_first,
        )
        return out
