"""Video-only models: the reference's seven (counterpart of the JAX
package's ``models/video.py``).

Registry names as the JAX package's: ``vgg_lstm``, ``resnet_lstm``,
``shufflenet_lstm``, ``mobilenet_lstm``, ``resnet_attn``, ``cnn``,
``resnet_trans``. ``conformer`` (the JAX package's extension) waits for
``nn/conformer.py`` (ROADMAP.md, Queue 1 #7).

Input contract, the JAX one: lip sequences (B, T, H, W, C) as float in
[0, 1] (uint8 is scaled on the device by the trainer or the predictor).
Each frame is encoded by one batched call over (B·T, C, H, W), a
channels-last view of the input, and the per-frame features run through
the model's temporal head.

``dtype`` is the compute dtype, as a Flax module's: parameters and
BatchNorm statistics stay float32, and with ``torch.bfloat16`` the
convolutions, the LSTM, the attention and the linears run in bf16 while
the normalizations' statistics stay float32. Submodule names are the JAX
modules', so ``utils/jax_bridge.py`` maps their variables by name.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_lipread_torch.models.backbones import MobileNetV2, ResNet, ShuffleNetV2
from multimodal_lipread_torch.nn import BiLSTM
from multimodal_lipread_torch.nn.attention import (
    MultiHeadSelfAttention,
    PositionalEncoding,
    TransformerEncoder,
)
from multimodal_lipread_torch.nn.common import BatchNorm, Dropout, conv1d, conv2d, linear, time_distributed


def _frames(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) frames → the (N, C, H, W) view of them (channels-last
    in memory)."""
    return x.permute(0, 3, 1, 2)


class VGGLite(nn.Module):
    """Three conv blocks without BatchNorm → 128-d per frame (the JAX
    ``VGGLite``)."""

    feature_dim = 128

    def __init__(self):
        super().__init__()
        self.b1_conv0 = nn.Conv2d(3, 32, 3, padding=1)
        self.b1_conv1 = nn.Conv2d(32, 32, 3, padding=1)
        self.b2_conv0 = nn.Conv2d(32, 64, 3, padding=1)
        self.b2_conv1 = nn.Conv2d(64, 64, 3, padding=1)
        self.b3_conv0 = nn.Conv2d(64, 128, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(conv2d(self.b1_conv0, x))
        x = F.max_pool2d(F.relu(conv2d(self.b1_conv1, x)), 2, 2)  # 44 → 22
        x = F.relu(conv2d(self.b2_conv0, x))
        x = F.max_pool2d(F.relu(conv2d(self.b2_conv1, x)), 2, 2)  # 22 → 11
        return F.relu(conv2d(self.b3_conv0, x)).mean(dim=(2, 3))


class LSTMHead(nn.Module):
    """BiLSTM (hidden feature_dim/2, 2 layers, the model's dropout between
    them) → last step → ReLU → Dropout → Linear (the JAX ``_LSTMHead``)."""

    def __init__(self, in_features: int, feature_dim: int, num_classes: int, dropout_rate: float):
        super().__init__()
        self.lstm = BiLSTM(in_features, feature_dim // 2, 2, dropout=dropout_rate)
        self.dropout = Dropout(dropout_rate)
        self.fc = nn.Linear(2 * (feature_dim // 2), num_classes)

    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.lstm(seq)[:, -1, :])
        return linear(self.fc, self.dropout(x))


class _VideoModel(nn.Module):
    """Casts the input to the compute dtype and encodes every frame."""

    dtype: torch.dtype

    def encode(self, backbone: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return time_distributed(lambda f: backbone(_frames(f)), x.to(self.dtype))


class BackboneLSTM(_VideoModel):
    """A frame backbone under ``backbone_name`` → ``LSTMHead`` named
    ``head``: the JAX ``VGGLSTM``, ``ResNet2DBiLSTM``,
    ``ShuffleNet2DBiLSTM`` and ``MobileNetLSTM``."""

    def __init__(self, backbone_name: str, backbone: nn.Module, num_classes: int, feature_dim: int,
                 dropout_rate: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone_name = backbone_name
        self.add_module(backbone_name, backbone)
        self.head = LSTMHead(backbone.feature_dim, feature_dim, num_classes, dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.encode(getattr(self, self.backbone_name), x))


class ResNet2DAttention(_VideoModel):
    """ResNet frames → Linear to ``attention_dim`` → multi-head
    self-attention over time (its dropout on the probabilities too) → mean
    → ReLU → Dropout → Linear."""

    def __init__(self, num_classes: int, resnet_version: int = 18, attention_dim: int = 512,
                 num_heads: int = 4, dropout_rate: float = 0.3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.resnet = ResNet(resnet_version)
        self.proj_in = nn.Linear(self.resnet.feature_dim, attention_dim)
        self.attention = MultiHeadSelfAttention(attention_dim, num_heads, dropout_rate)
        self.dropout = Dropout(dropout_rate)
        self.fc = nn.Linear(attention_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = linear(self.proj_in, self.encode(self.resnet, x))
        pooled = F.relu(self.attention(seq).mean(dim=1))
        return linear(self.fc, self.dropout(pooled))


class ResNet2DTransformer(_VideoModel):
    """ResNet frames → Linear to ``transformer_dim`` → sinusoidal positions
    → post-LN TransformerEncoder (FF 4·dim) → mean → ReLU → Dropout →
    Linear."""

    def __init__(self, num_classes: int, resnet_version: int = 18, transformer_dim: int = 256,
                 num_layers: int = 2, num_heads: int = 4, dropout_rate: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.resnet = ResNet(resnet_version)
        self.proj_in = nn.Linear(self.resnet.feature_dim, transformer_dim)
        self.pos = PositionalEncoding(transformer_dim, max_len=200)
        self.transformer = TransformerEncoder(transformer_dim, num_layers, num_heads,
                                              dim_feedforward=4 * transformer_dim, dropout_rate=dropout_rate)
        self.dropout = Dropout(dropout_rate)
        self.fc = nn.Linear(transformer_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = self.pos(linear(self.proj_in, self.encode(self.resnet, x)))
        pooled = F.relu(self.transformer(seq).mean(dim=1))
        return linear(self.fc, self.dropout(pooled))


class CNNOnly(_VideoModel):
    """Per-frame conv/BatchNorm/ReLU stack (32, 64 with 2×2 max-pools, then
    128) → mean per frame → two temporal Conv1d (k 3) + BatchNorm + ReLU →
    mean over time → Dropout → Linear."""

    def __init__(self, num_classes: int, temporal_channels: int = 128, dropout_rate: float = 0.3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        c = 3
        for i, ch in enumerate((32, 64, 128)):
            self.add_module(f"conv{i}", nn.Conv2d(c, ch, 3, padding=1))
            self.add_module(f"bn{i}", BatchNorm(ch))
            c = ch
        for i in range(2):
            self.add_module(f"tconv{i}", nn.Conv1d(c, temporal_channels, 3, padding=1))
            self.add_module(f"tbn{i}", BatchNorm(temporal_channels))
            c = temporal_channels
        self.dropout = Dropout(dropout_rate)
        self.fc = nn.Linear(c, num_classes)

    def frame_cnn(self, y: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            y = F.relu(getattr(self, f"bn{i}")(conv2d(getattr(self, f"conv{i}"), y)))
            if i < 2:
                y = F.max_pool2d(y, 2, 2)
        return y.mean(dim=(2, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = time_distributed(lambda f: self.frame_cnn(_frames(f)), x.to(self.dtype)).transpose(1, 2)  # (B, C, T)
        for i in range(2):
            y = F.relu(getattr(self, f"tbn{i}")(conv1d(getattr(self, f"tconv{i}"), y)))
        return linear(self.fc, self.dropout(y.mean(dim=2)))


VIDEO_MODEL_NAMES = (
    "vgg_lstm", "resnet_lstm", "shufflenet_lstm", "mobilenet_lstm",
    "resnet_attn", "cnn", "resnet_trans",
    "conformer",
)


def get_video_model(
    name: str,
    num_classes: int,
    resnet_version: int = 18,
    shufflenet_version: str = "0.5x",
    feature_dim: Optional[int] = None,
    dropout: Optional[float] = None,
    dtype: torch.dtype = torch.float32,
) -> nn.Module:
    """Name → model, with the JAX registry's signature and per-model
    defaults (``feature_dim`` and ``dropout`` None take the model's own)."""
    fd = feature_dim

    def opt(default: float) -> float:
        return default if dropout is None else dropout

    if name == "vgg_lstm":
        return BackboneLSTM("vgglite", VGGLite(), num_classes, fd or 256, opt(0.5), dtype)
    if name == "resnet_lstm":
        return BackboneLSTM("resnet", ResNet(resnet_version), num_classes, fd or 1024, opt(0.5), dtype)
    if name == "shufflenet_lstm":
        width = 0.5 if shufflenet_version == "0.5x" else 1.0
        return BackboneLSTM("shufflenet", ShuffleNetV2(width), num_classes, fd or 512, opt(0.4), dtype)
    if name == "mobilenet_lstm":
        return BackboneLSTM("mobilenet", MobileNetV2(), num_classes, fd or 256, opt(0.3), dtype)
    if name == "resnet_attn":
        return ResNet2DAttention(num_classes, resnet_version=resnet_version, dropout_rate=opt(0.3), dtype=dtype)
    if name == "cnn":
        return CNNOnly(num_classes, dropout_rate=opt(0.3), dtype=dtype)
    if name == "resnet_trans":
        return ResNet2DTransformer(num_classes, resnet_version=resnet_version, dropout_rate=opt(0.2), dtype=dtype)
    if name == "conformer":
        raise NotImplementedError(
            "video model 'conformer' needs nn/conformer.py, which is not ported to PyTorch yet "
            "(ROADMAP.md, Queue 1 #7)"
        )
    raise ValueError(f"Unknown video model: {name}")
