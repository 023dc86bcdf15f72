"""Audio-only models: the reference's seven and the conformer extension
(counterpart of the JAX package's ``models/audio.py``).

Registry names as the JAX package's: ``resnet``, ``resnet_lstm``, ``vgg``,
``vgg_lstm``, ``lstm_resnet``, ``lstm_resnet_attn``, ``lstm_resnet_trans``
and ``conformer``; ``use_batchnorm=False`` gives the reference's
``models_without_reg`` ablations. Input contract: (B, 80, input_size)
normalized log-mel; the convolutional models see it as the NCHW image
(B, 1, 80, T).

``input_size`` sizes what Flax infers lazily and ``nn.Linear`` cannot: the
lstm_resnet family's row BiLSTM reads each mel row (T values) as one step.

``dtype`` is the compute dtype, as a Flax module's: parameters and
BatchNorm statistics stay float32 for every ``dtype``, and with
``torch.bfloat16`` the convolutions, the LSTMs, the attention and the
linears run in bf16 (each layer casts its weights), the normalizations'
statistics in float32, and the logits come out in bf16. Submodule names
are the JAX modules', so ``utils/jax_bridge.py`` maps their variables by
name.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_lipread_torch.models.backbones import VGG, ResNet
from multimodal_lipread_torch.nn import BiLSTM, ClassifierHead
from multimodal_lipread_torch.nn.attention import AdditiveAttention, PositionalEncoding, TransformerEncoder
from multimodal_lipread_torch.nn.common import BatchNorm, Dropout, adaptive_avg_pool2d, linear
from multimodal_lipread_torch.nn.conformer import ConformerEncoder
from multimodal_lipread_torch.ops.logmel import N_MELS



class _AudioModel(nn.Module):
    dtype: torch.dtype

    def image(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 80, T) log-mel → the (B, 1, 80, T) image in the compute dtype."""
        return x.to(self.dtype)[:, None]


class AudioResNet(_AudioModel):
    """ResNet18 over the log-mel image → classifier head (512)."""

    def __init__(self, num_classes: int, dropout_rate: float = 0.5, use_batchnorm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.resnet = ResNet(18, in_channels=1)
        self.classifier = ClassifierHead(512, 512, num_classes, dropout_rate, use_batchnorm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.resnet(self.image(x)))


class AudioResNetLSTM(_AudioModel):
    """ResNet18 → a length-1 BiLSTM sequence → classifier head (256)."""

    def __init__(self, num_classes: int, lstm_hidden: int = 128, lstm_layers: int = 2, dropout_rate: float = 0.3,
                 use_batchnorm: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.resnet = ResNet(18, in_channels=1)
        self.lstm = BiLSTM(512, lstm_hidden, lstm_layers)
        self.classifier = ClassifierHead(2 * lstm_hidden, 256, num_classes, dropout_rate, use_batchnorm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.lstm(self.resnet(self.image(x))[:, None, :])
        return self.classifier(out[:, -1, :])


class VGGAudioClassifier(_AudioModel):
    """VGG-BN → adaptive (2, 3) average pool → flattened in CHW order
    (NCHW's own, which the JAX model transposes to) → classifier head (256)."""

    def __init__(self, num_classes: int, version: int = 11, dropout_rate: float = 0.5, use_batchnorm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.vgg = VGG(version)
        self.classifier = ClassifierHead(512 * 2 * 3, 256, num_classes, dropout_rate, use_batchnorm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = adaptive_avg_pool2d(self.vgg(self.image(x)), (2, 3))  # (B, 512, 2, 3)
        return self.classifier(pooled.flatten(1))


class VGGWithLSTMClassifier(_AudioModel):
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
        fmap = self.vgg(self.image(x))  # (B, 512, H', W')
        seq = fmap.mean(dim=3).permute(0, 2, 1)  # (B, H', 512)
        out = self.lstm(seq)
        return self.classifier(out[:, -1, :])


class _LSTMResNetStem(nn.Module):
    """The lstm_resnet family's stem: each mel row (T values) as a one-step
    sequence through a BiLSTM 64 × 2 → the (B, 1, 80, 128) image → ResNet18
    → Linear → [BatchNorm] → ReLU → Dropout."""

    def __init__(self, input_size: int, proj_dim: int = 256, dropout_rate: float = 0.3, use_batchnorm: bool = True):
        super().__init__()
        self.initial_bilstm = BiLSTM(input_size, 64, 2)
        self.resnet = ResNet(18, in_channels=1)
        self.fc = nn.Linear(512, proj_dim)
        self.fc_bn = BatchNorm(proj_dim) if use_batchnorm else None
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, mel_bins, t = x.shape
        rows = self.initial_bilstm(x.reshape(b * mel_bins, 1, t))  # (B·80, 1, 128)
        feats = self.resnet(rows.reshape(b, 1, mel_bins, rows.shape[-1]))  # NHWC (B, 80, 128, 1) as NCHW
        y = linear(self.fc, feats)
        if self.fc_bn is not None:
            y = self.fc_bn(y)
        return self.dropout(F.relu(y))


class LSTMResNet(_AudioModel):
    """Stem → a length-1 BiLSTM 128 × 2 → Linear."""

    def __init__(self, num_classes: int, input_size: int = 117, dropout_rate: float = 0.3,
                 use_batchnorm: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = _LSTMResNetStem(input_size, 256, dropout_rate, use_batchnorm)
        self.final_bilstm = BiLSTM(256, 128, 2)
        self.classifier = nn.Linear(256, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.final_bilstm(self.stem(x.to(self.dtype))[:, None, :])
        return linear(self.classifier, out[:, -1, :])


class DeepAudioNetWithAttention(_AudioModel):
    """Stem repeated into a 10-step sequence → BiLSTM 128 × 2 → additive
    attention over the steps → Linear."""

    def __init__(self, num_classes: int, input_size: int = 117, dropout_rate: float = 0.3,
                 use_batchnorm: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = _LSTMResNetStem(input_size, 256, dropout_rate, use_batchnorm)
        self.final_bilstm = BiLSTM(256, 128, 2)
        self.attention = AdditiveAttention(256, axis=1)
        self.classifier = nn.Linear(256, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = self.stem(x.to(self.dtype))[:, None, :].repeat(1, 10, 1)
        attended, _ = self.attention(self.final_bilstm(seq))
        return linear(self.classifier, attended)


class LSTMResNetWithTransformer(_AudioModel):
    """Stem repeated into a ``seq_len``-step sequence → sinusoidal positions
    → post-LN TransformerEncoder (FF 2048, dropout 0.1) → mean → Linear."""

    def __init__(self, num_classes: int, input_size: int = 117, transformer_dim: int = 256, num_heads: int = 4,
                 num_layers: int = 2, seq_len: int = 10, dropout_rate: float = 0.3, use_batchnorm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.seq_len = seq_len
        self.stem = _LSTMResNetStem(input_size, transformer_dim, dropout_rate, use_batchnorm)
        self.pos = PositionalEncoding(transformer_dim, max_len=seq_len)
        self.transformer = TransformerEncoder(transformer_dim, num_layers, num_heads)
        self.classifier = nn.Linear(transformer_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 4:
            x = x.squeeze(1)
        seq = self.stem(x.to(self.dtype))[:, None, :].repeat(1, self.seq_len, 1)
        return linear(self.classifier, self.transformer(self.pos(seq)).mean(dim=1))


class AudioConformer(_AudioModel):
    """Conformer over the mel time axis: (B, 80, T) as T steps of 80-d
    frames → ``ConformerEncoder`` → mean → Dropout → Linear (the JAX
    package's extension)."""

    def __init__(self, num_classes: int, d_model: int = 128, num_layers: int = 4, dropout_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = ConformerEncoder(N_MELS, d_model, num_layers, dropout_rate=dropout_rate)
        self.dropout = Dropout(dropout_rate)
        self.classifier = nn.Linear(d_model, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        enc = self.encoder(x.to(self.dtype).transpose(1, 2))
        return linear(self.classifier, self.dropout(enc.mean(dim=1)))


AUDIO_MODEL_NAMES = (
    "resnet", "resnet_lstm", "vgg", "vgg_lstm",
    "lstm_resnet", "lstm_resnet_attn", "lstm_resnet_trans",
    "conformer",
)


def get_audio_model(
    name: str,
    num_classes: int,
    input_size: int = 117,
    version: int = 16,
    use_batchnorm: bool = True,
    dtype: torch.dtype = torch.float32,
    d_model: Optional[int] = None,
) -> nn.Module:
    """Name → model, with the JAX registry's signature. ``version`` (the VGG
    depth) defaults to 16, the shipped configuration's; ``d_model`` is the
    conformer's width (128 when None)."""
    kw = dict(use_batchnorm=use_batchnorm, dtype=dtype)
    if name == "resnet":
        return AudioResNet(num_classes, **kw)
    if name == "resnet_lstm":
        return AudioResNetLSTM(num_classes, **kw)
    if name == "vgg":
        return VGGAudioClassifier(num_classes, version=version, **kw)
    if name == "vgg_lstm":
        return VGGWithLSTMClassifier(num_classes, version=version, **kw)
    if name == "lstm_resnet":
        return LSTMResNet(num_classes, input_size, **kw)
    if name == "lstm_resnet_attn":
        return DeepAudioNetWithAttention(num_classes, input_size, **kw)
    if name == "lstm_resnet_trans":
        return LSTMResNetWithTransformer(num_classes, input_size, **kw)
    if name == "conformer":
        return AudioConformer(num_classes, dtype=dtype, **({} if d_model is None else {"d_model": d_model}))
    raise ValueError(f"Unknown audio model: {name}")
