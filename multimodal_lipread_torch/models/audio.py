"""Audio-only models (counterpart of the JAX package's ``models/audio.py``).

Ported so far: ``vgg_lstm``. Input contract: (B, 80, input_size) normalized
log-mel; internally NCHW (B, 1, 80, T).

``dtype`` is the compute dtype, as a Flax module's: parameters and
BatchNorm statistics stay float32 for every ``dtype``, and with
``torch.bfloat16`` the convolutions, the LSTM and the linears run in bf16
(each layer casts its weights), the BatchNorm statistics in float32, and
the logits come out in bf16.
"""

from __future__ import annotations

import torch
from torch import nn

from multimodal_lipread_torch.models.backbones import VGG
from multimodal_lipread_torch.nn import BiLSTM, ClassifierHead


class VGGWithLSTMClassifier(nn.Module):
    """VGG-BN, collapse the time axis, BiLSTM over the mel-derived axis,
    classifier on the last step.

    The JAX model averages its NHWC map over W' (``jnp.mean(fmap, axis=2)``);
    in NCHW that is the mean over dim 3 and a permute to (B, H', 512).
    """

    def __init__(
        self,
        num_classes: int,
        version: int = 11,
        lstm_hidden: int = 128,
        lstm_layers: int = 2,
        dropout_rate: float = 0.3,
        use_batchnorm: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.vgg = VGG(version)
        self.lstm = BiLSTM(512, lstm_hidden, lstm_layers)
        self.classifier = ClassifierHead(2 * lstm_hidden, 128, num_classes, dropout_rate, use_batchnorm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fmap = self.vgg(x.to(self.dtype)[:, None])  # (B, 512, H', W')
        seq = fmap.mean(dim=3).permute(0, 2, 1)  # (B, H', 512)
        out = self.lstm(seq)
        return self.classifier(out[:, -1, :])


AUDIO_MODEL_NAMES = (
    "resnet", "resnet_lstm", "vgg", "vgg_lstm",
    "lstm_resnet", "lstm_resnet_attn", "lstm_resnet_trans",
    "conformer",
)
PORTED_AUDIO_MODELS = ("vgg_lstm",)


def get_audio_model(
    name: str,
    num_classes: int,
    version: int = 16,
    use_batchnorm: bool = True,
    dtype: torch.dtype = torch.float32,
) -> nn.Module:
    """Name → model registry. ``version`` defaults to 16, the shipped
    configuration's VGG depth."""
    if name == "vgg_lstm":
        return VGGWithLSTMClassifier(num_classes, version=version, use_batchnorm=use_batchnorm, dtype=dtype)
    if name in AUDIO_MODEL_NAMES:
        raise NotImplementedError(
            f"audio model '{name}' is not ported to PyTorch yet; ported: "
            f"{', '.join(PORTED_AUDIO_MODELS)} (see ROADMAP.md, Queue 1)"
        )
    raise ValueError(f"Unknown audio model: {name}")
