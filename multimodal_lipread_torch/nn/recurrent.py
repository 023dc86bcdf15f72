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

from typing import List

import torch
from torch import nn

from multimodal_lipread_torch.nn.common import Dropout


class BiLSTM(nn.Module):
    """Bidirectional multi-layer LSTM over (B, T, D) → (B, T, 2H).

    The weights stay float32; an input of another dtype (bfloat16) runs
    the LSTM in that dtype on casts of them.

    ``dropout`` is applied to each layer's output except the last, in
    training only, as the JAX ``LSTM`` does. Its masks come from the port's
    ``Dropout`` (the trainer's generator), not from cuDNN's inter-layer
    dropout, which would draw from torch's global generator: with dropout
    in training the stack runs one layer at a time on slices of the one
    ``nn.LSTM``'s weights (the ``state_dict`` names do not change), and
    otherwise as one fused call."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1, dropout: float = 0.0):
        super().__init__()
        self.lstm = nn.LSTM(input_size, hidden_size, num_layers=num_layers, batch_first=True,
                            bidirectional=True)
        self.dropout = Dropout(dropout if num_layers > 1 else 0.0)

    def _stack(self, x: torch.Tensor, weights: List[torch.Tensor], num_layers: int) -> torch.Tensor:
        h0 = x.new_zeros(2 * num_layers, x.shape[0], self.lstm.hidden_size)
        out, _, _ = torch._VF.lstm(  # what nn.LSTM.forward calls
            x, (h0, h0), weights, True, num_layers, 0.0, self.training, True, True,
        )
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lstm = self.lstm
        lstm._update_flat_weights()  # as nn.LSTM.forward does, after a weight was replaced
        weights = [w.to(x.dtype) for w in lstm._flat_weights]  # the parameters themselves at float32
        if not (self.training and self.dropout.rate > 0.0):
            return self._stack(x, weights, lstm.num_layers)
        per_layer = len(weights) // lstm.num_layers  # w_ih, w_hh, b_ih, b_hh per direction
        for layer in range(lstm.num_layers):
            if layer:
                x = self.dropout(x)
            x = self._stack(x, weights[layer * per_layer : (layer + 1) * per_layer], 1)
        return x
