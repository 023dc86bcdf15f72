"""LSTM layers (counterpart of the JAX package's ``nn/recurrent.py``).

The JAX package runs its own fused scan; PyTorch's ``nn.LSTM`` (cuDNN on
the card) computes the same cell: gates packed i, f, g, o, with the input
and recurrent biases both added. The JAX parameters
``l{n}_{fwd,bwd}/{w_ih, w_hh, b_ih, b_hh}`` are stored (D, 4H) where torch
keeps (4H, D); ``utils/jax_bridge.py`` transposes them. Its initializer,
uniform on ±1/√H for every weight and bias, is the JAX package's too
(``nn.common.flax_init_`` redraws it from a generator).

- ``LSTM``: multi-layer, uni- or bidirectional, over (B, T, D); its
  parameters are ``nn.LSTM``'s, at the module's own scope (the JAX
  ``LSTM``'s ``l{n}_fwd``/``l{n}_bwd``);
- ``LSTMLayer``: one direction of one layer, optionally over the reversed
  sequence (the JAX ``LSTMLayer``, whose ``w_ih``/``w_hh``/``b_ih``/``b_hh``
  sit at its own scope);
- ``BiLSTM``: a bidirectional ``nn.LSTM`` under the name ``lstm``, as the
  JAX wrapper nests its ``LSTM``.

The weights stay float32; an input of another dtype (bfloat16) runs the
LSTM in that dtype on casts of them. Inter-layer ``dropout`` is applied to
each layer's output except the last, in training only, as the JAX
``LSTM`` (and torch) do. Its masks come from the port's ``Dropout`` (the
trainer's generator), not from cuDNN's inter-layer dropout, which would
draw from torch's global generator: with dropout in training the stack
runs one layer at a time on slices of the one ``nn.LSTM``'s weights, and
otherwise as one fused call.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from multimodal_lipread_torch.nn.common import Dropout


def _stack(lstm: nn.LSTM, x: torch.Tensor, weights: List[torch.Tensor], num_layers: int,
           training: bool) -> torch.Tensor:
    h0 = x.new_zeros((2 if lstm.bidirectional else 1) * num_layers, x.shape[0], lstm.hidden_size)
    out, _, _ = torch._VF.lstm(  # what nn.LSTM.forward calls
        x, (h0, h0), weights, True, num_layers, 0.0, training, lstm.bidirectional, True,
    )
    return out


def run_lstm(lstm: nn.LSTM, x: torch.Tensor, dropout: Dropout, training: bool) -> torch.Tensor:
    """``lstm`` (batch first) over ``x`` in ``x``'s dtype, ``dropout`` on
    every layer's output but the last when training."""
    lstm._update_flat_weights()  # as nn.LSTM.forward does, after a weight was replaced
    weights = [w.to(x.dtype) for w in lstm._flat_weights]  # the parameters themselves at float32
    if not (training and dropout.rate > 0.0):
        return _stack(lstm, x, weights, lstm.num_layers, training)
    per_layer = len(weights) // lstm.num_layers  # w_ih, w_hh, b_ih, b_hh per direction
    for layer in range(lstm.num_layers):
        if layer:
            x = dropout(x)
        x = _stack(lstm, x, weights[layer * per_layer : (layer + 1) * per_layer], 1, training)
    return x


class LSTM(nn.LSTM):
    """Multi-layer, optionally bidirectional LSTM over (B, T, D) →
    (B, T, H · directions), torch's ``nn.LSTM(batch_first=True)`` with the
    port's inter-layer dropout (``layer_dropout``; ignored for one layer)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1, bidirectional: bool = False,
                 dropout: float = 0.0):
        super().__init__(input_size, hidden_size, num_layers=num_layers, batch_first=True,
                         bidirectional=bidirectional)
        self.layer_dropout = Dropout(dropout if num_layers > 1 else 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return run_lstm(self, x, self.layer_dropout, self.training)


class LSTMLayer(nn.LSTM):
    """One LSTM direction over (B, T, D) → (B, T, H); ``reverse`` runs it
    over the time-reversed sequence and returns the outputs in input order."""

    def __init__(self, input_size: int, hidden_size: int, reverse: bool = False):
        super().__init__(input_size, hidden_size, batch_first=True)
        self.reverse = reverse

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        self._update_flat_weights()
        weights = [w.to(x.dtype) for w in self._flat_weights]
        if self.reverse:
            return _stack(self, x.flip(1), weights, 1, self.training).flip(1)
        return _stack(self, x, weights, 1, self.training)


class BiLSTM(nn.Module):
    """Bidirectional multi-layer LSTM over (B, T, D) → (B, T, 2H): an
    ``nn.LSTM`` named ``lstm`` and the inter-layer ``dropout``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1, dropout: float = 0.0):
        super().__init__()
        self.lstm = nn.LSTM(input_size, hidden_size, num_layers=num_layers, batch_first=True,
                            bidirectional=True)
        self.dropout = Dropout(dropout if num_layers > 1 else 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return run_lstm(self.lstm, x, self.dropout, self.training)
