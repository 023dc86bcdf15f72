"""On-device feature frontend (counterpart of the JAX package's
``models/frontend.py``)."""

from __future__ import annotations

import torch
from torch import nn

from multimodal_lipread_torch.ops.logmel_cuda import log_mel


class WaveToLogMel(nn.Module):
    """Wrap an audio model with the log-mel frontend on the device.

    Input: (B, 20000) waveforms → normalized log-mel sliced to
    (B, 80, input_size) → wrapped model. The log-mel always runs in float32
    (reduced precision corrupts the power spectrum at spectral nulls),
    whatever the wrapped model's dtype. Parameters nest one level deeper
    (``model.``), as in the JAX wrapper.
    """

    def __init__(self, model: nn.Module, input_size: int = 117):
        super().__init__()
        self.model = model
        self.input_size = input_size

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        mel = log_mel(wave.to(torch.float32).contiguous(), normalize=True)
        return self.model(mel[:, :80, : self.input_size])
