"""Audio–video fusion models: the reference's seven (counterpart of the
JAX package's ``models/audio_video.py``).

Registry names as the JAX package's: ``early_fusion_resnet``,
``early_fusion_mobilenet``, ``late_fusion_mobilenet``,
``middle_fusion_mobilenet``, ``early_fusion_fast``, ``late_fusion_fast``,
``middle_fusion_fast``.

Inputs: ``audio`` (B, 80, input_size) normalized log-mel; ``video``
(B, T, 44, 44, 3) lip sequences in [0, 1] (uint8 is scaled on the device by
the trainer or the predictor). Every frame goes through the backbone in one
batched call over the (B·T, C, H, W) channels-last view.

Where the port must know a width that Flax infers lazily, it is computed
from ``input_size`` (the JAX pipeline's ``dataset.audio_input_size``): the
mid-fusion audio map is flattened in the JAX module's NHWC order, so
``middle_fusion_mobilenet`` at 117 fuses 64·20·29 = 37 120 audio features
with the video's 512 (``classifier.fc1`` 37 632 → 512).

The two "final hidden state" idioms of the reference are the JAX ones:
the BiLSTM output's last step (``last_step``), and torch's ``h_n`` concat,
the forward half at t = T−1 and the backward half at t = 0
(``bilstm_final_hidden``). The late-fusion models mix their two logits
with a learnable 0-d ``alpha`` (0.5 at initialization, at the top of the
parameter tree): ``alpha · audio + (1 − alpha) · video``.

``dtype`` is the compute dtype, as a Flax module's (parameters and
BatchNorm statistics stay float32). Submodule names are the JAX modules',
so ``utils/jax_bridge.py`` maps their variables by name.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_lipread_torch.models.backbones import MobileNetV3Small, ResNet
from multimodal_lipread_torch.nn import BiLSTM
from multimodal_lipread_torch.nn.common import BatchNorm, Dropout, conv2d, linear, time_distributed
from multimodal_lipread_torch.ops.logmel import N_MELS



def bilstm_final_hidden(out: torch.Tensor, hidden: int) -> torch.Tensor:
    """torch's ``h_n`` concat of a 1-layer BiLSTM's output (B, T, 2H) →
    (B, 2H): the forward direction's last output and the backward
    direction's output at t = 0."""
    return torch.cat([out[:, -1, :hidden], out[:, 0, hidden:]], dim=-1)


class _ConvStack(nn.Module):
    """3×3 convs (padding 1, biased) ``conv{i}`` → [BatchNorm ``bn{i}``] →
    ReLU → [2×2 max-pool] over the (B, 1, 80, T) mel image."""

    def __init__(self, channels: Sequence[int], pool_after: Sequence[bool], use_batchnorm: bool):
        super().__init__()
        self.pool_after = tuple(pool_after)
        self.use_batchnorm = use_batchnorm
        c = 1
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", nn.Conv2d(c, ch, 3, padding=1))
            if use_batchnorm:
                self.add_module(f"bn{i}", BatchNorm(ch))
            c = ch

    def convs(self, x: torch.Tensor) -> torch.Tensor:
        y = x[:, None]
        for i, pool in enumerate(self.pool_after):
            y = conv2d(getattr(self, f"conv{i}"), y)
            if self.use_batchnorm:
                y = getattr(self, f"bn{i}")(y)
            y = F.relu(y)
            if pool:
                y = F.max_pool2d(y, 2, 2)
        return y


class AudioCNNEncoder(_ConvStack):
    """Conv stack → global average pool → optional Linear ``fc``: the
    reference's AudioEncoder, AudioEncoderLate and AudioEncoderFast."""

    def __init__(self, channels: Sequence[int] = (32, 64, 128), pool_after: Sequence[bool] = (True, True, False),
                 use_batchnorm: bool = True, proj_dim: Optional[int] = 256):
        super().__init__(channels, pool_after, use_batchnorm)
        self.fc = nn.Linear(channels[-1], proj_dim) if proj_dim is not None else None
        self.feature_dim = proj_dim if proj_dim is not None else channels[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convs(x).mean(dim=(2, 3))
        return y if self.fc is None else linear(self.fc, y)


class AudioCNNMidEncoder(_ConvStack):
    """Conv stack, each block 2×2 max-pooled, flattened in the JAX module's
    NHWC order (H, W, C) → optional Linear ``fc``: the reference's
    mid-fusion audio feature."""

    def __init__(self, input_size: int, channels: Sequence[int] = (32, 64), use_batchnorm: bool = True,
                 proj_dim: Optional[int] = None):
        super().__init__(channels, (True,) * len(channels), use_batchnorm)
        h, w = N_MELS, input_size
        for _ in channels:
            h, w = h // 2, w // 2
        flat = channels[-1] * h * w
        self.fc = nn.Linear(flat, proj_dim) if proj_dim is not None else None
        self.feature_dim = proj_dim if proj_dim is not None else flat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convs(x).permute(0, 2, 3, 1).flatten(1)
        return y if self.fc is None else linear(self.fc, y)


class VideoSeqEncoder(nn.Module):
    """Per-frame backbone ``cnn`` (``resnet18`` or ``mobilenet_v3_small``) →
    BiLSTM ``lstm`` (dropout 0.2 between layers, which does nothing for one
    layer) → the last step (``last_step``) or torch's ``h_n`` concat
    (``final_hidden``)."""

    def __init__(self, backbone: str = "mobilenet_v3_small", lstm_hidden: int = 256, lstm_layers: int = 2,
                 summary: str = "last_step"):
        super().__init__()
        if backbone == "resnet18":
            self.cnn = ResNet(18)
        elif backbone == "mobilenet_v3_small":
            self.cnn = MobileNetV3Small()
        else:
            raise ValueError(f"Unknown video backbone: {backbone}")
        if summary not in ("last_step", "final_hidden"):
            raise ValueError(f"Unknown BiLSTM summary: {summary}")
        self.lstm_hidden = lstm_hidden
        self.summary = summary
        self.lstm = BiLSTM(self.cnn.feature_dim, lstm_hidden, lstm_layers, dropout=0.2)
        self.feature_dim = 2 * lstm_hidden

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        seq = time_distributed(lambda f: self.cnn(f.permute(0, 3, 1, 2)), video)
        out = self.lstm(seq)
        if self.summary == "last_step":
            return out[:, -1, :]
        return bilstm_final_hidden(out, self.lstm_hidden)


class _FusionMLP(nn.Module):
    """Linear ``fc1`` → ReLU → [Dropout] → Linear ``fc2``."""

    def __init__(self, in_features: int, hidden: int, num_classes: int, dropout_rate: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.dropout = Dropout(dropout_rate)
        self.fc2 = nn.Linear(hidden, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.fc2, self.dropout(F.relu(linear(self.fc1, x))))


class _AVModel(nn.Module):
    """Casts both inputs to the compute dtype."""

    dtype: torch.dtype

    def inputs(self, audio: torch.Tensor, video: torch.Tensor):
        return audio.to(self.dtype), video.to(self.dtype)


class _ConcatFusion(_AVModel):
    """concat(audio encoder, video encoder) → ``_FusionMLP`` ``classifier``."""

    def __init__(self, audio_encoder: nn.Module, video_encoder: VideoSeqEncoder, num_classes: int, hidden: int,
                 dropout_rate: float, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.audio_encoder = audio_encoder
        self.video_encoder = video_encoder
        self.classifier = _FusionMLP(audio_encoder.feature_dim + video_encoder.feature_dim, hidden, num_classes,
                                     dropout_rate)

    def forward(self, audio: torch.Tensor, video: torch.Tensor) -> torch.Tensor:
        audio, video = self.inputs(audio, video)
        fused = torch.cat([self.audio_encoder(audio), self.video_encoder(video)], dim=-1)
        return self.classifier(fused)


class _LateFusion(_AVModel):
    """Per-modality logits, ``alpha · audio + (1 − alpha) · video``."""

    def __init__(self, audio_encoder: nn.Module, video_encoder: VideoSeqEncoder, num_classes: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.audio_encoder = audio_encoder
        self.video_encoder = video_encoder
        self.audio_classifier = nn.Linear(audio_encoder.feature_dim, num_classes)
        self.video_classifier = nn.Linear(video_encoder.feature_dim, num_classes)
        self.alpha = nn.Parameter(torch.tensor(0.5))

    def forward(self, audio: torch.Tensor, video: torch.Tensor) -> torch.Tensor:
        audio, video = self.inputs(audio, video)
        a = linear(self.audio_classifier, self.audio_encoder(audio))
        v = linear(self.video_classifier, self.video_encoder(video))
        return self.alpha * a + (1.0 - self.alpha) * v


class EarlyFusionAV(_ConcatFusion):
    """Audio CNN 256 ⊕ ResNet18 + BiLSTM 256 × 2 → MLP 512 (dropout 0.3)."""

    def __init__(self, num_classes: int, input_size: int = 117, dtype: torch.dtype = torch.float32):
        super().__init__(AudioCNNEncoder(), VideoSeqEncoder("resnet18", 256, 2), num_classes, 512, 0.3, dtype)


class EarlyFusionAVMobileNet(_ConcatFusion):
    """Audio CNN 256 ⊕ MobileNetV3-small + BiLSTM 256 × 2 → MLP 512 (0.3)."""

    def __init__(self, num_classes: int, input_size: int = 117, dtype: torch.dtype = torch.float32):
        super().__init__(AudioCNNEncoder(), VideoSeqEncoder("mobilenet_v3_small", 256, 2), num_classes, 512, 0.3, dtype)


class LateFusionAVMobileNet(_LateFusion):
    """Audio CNN (32, 64) 256 and MobileNetV3-small + BiLSTM 256 (h_n), each
    to logits, mixed by ``alpha``."""

    def __init__(self, num_classes: int, input_size: int = 117, dtype: torch.dtype = torch.float32):
        super().__init__(AudioCNNEncoder((32, 64), (True, False), True, 256),
                         VideoSeqEncoder("mobilenet_v3_small", 256, 1, "final_hidden"), num_classes, dtype)


class MidFusionAVMobileNet(_ConcatFusion):
    """The flattened (32, 64) audio map ⊕ MobileNetV3-small + BiLSTM 256
    → MLP 512 (0.3)."""

    def __init__(self, num_classes: int, input_size: int = 117, dtype: torch.dtype = torch.float32):
        super().__init__(AudioCNNMidEncoder(input_size, (32, 64)),
                         VideoSeqEncoder("mobilenet_v3_small", 256, 1), num_classes, 512, 0.3, dtype)


class EarlyFusionFast(_ConcatFusion):
    """Audio CNN (16, 32), no BatchNorm, 128 ⊕ MobileNetV3-small + BiLSTM
    128 (h_n) → MLP 256."""

    def __init__(self, num_classes: int, input_size: int = 117, dtype: torch.dtype = torch.float32):
        super().__init__(AudioCNNEncoder((16, 32), (True, False), False, 128),
                         VideoSeqEncoder("mobilenet_v3_small", 128, 1, "final_hidden"), num_classes, 256, 0.0, dtype)


class LateFusionFast(_LateFusion):
    """Audio CNN (16,), no BatchNorm, 128 and MobileNetV3-small + BiLSTM 128
    (h_n), each to logits, mixed by ``alpha``."""

    def __init__(self, num_classes: int, input_size: int = 117, dtype: torch.dtype = torch.float32):
        super().__init__(AudioCNNEncoder((16,), (False,), False, 128),
                         VideoSeqEncoder("mobilenet_v3_small", 128, 1, "final_hidden"), num_classes, dtype)


class MidFusionFast(_ConcatFusion):
    """The flattened (16,) audio map, no BatchNorm, → Linear 128 ⊕
    MobileNetV3-small + BiLSTM 128 → MLP 256."""

    def __init__(self, num_classes: int, input_size: int = 117, dtype: torch.dtype = torch.float32):
        super().__init__(AudioCNNMidEncoder(input_size, (16,), False, 128),
                         VideoSeqEncoder("mobilenet_v3_small", 128, 1), num_classes, 256, 0.0, dtype)


_REGISTRY = {
    "early_fusion_resnet": EarlyFusionAV,
    "early_fusion_mobilenet": EarlyFusionAVMobileNet,
    "late_fusion_mobilenet": LateFusionAVMobileNet,
    "middle_fusion_mobilenet": MidFusionAVMobileNet,
    "early_fusion_fast": EarlyFusionFast,
    "late_fusion_fast": LateFusionFast,
    "middle_fusion_fast": MidFusionFast,
}
AV_MODEL_NAMES = tuple(_REGISTRY)


def get_av_model(name: str, num_classes: int, input_size: int = 117, dtype: torch.dtype = torch.float32) -> nn.Module:
    """Name → model. ``input_size`` is the log-mel's time width
    (``dataset.audio_input_size``), which sizes the mid-fusion models'
    first fusion layer."""
    if name not in _REGISTRY:
        raise ValueError(f"Unknown audio_video model: {name}")
    return _REGISTRY[name](num_classes, input_size=input_size, dtype=dtype)
