"""Video + textual-cue fusion models: the reference's seven (counterpart of
the JAX package's ``models/cues_video.py``).

Registry names as the JAX package's: ``early_fusion_mobile``,
``middle_fusion_mobile``, ``late_fusion_mobile``, ``early_fusion_resnet``,
``middle_fusion_resnet``, ``late_fusion_resnet``, ``test_model``.

Inputs, cue first: ``cue`` (B, cue_dim) sentence embedding (768-d mpnet by
default); ``video`` (B, T, 44, 44, 3) lip sequences in [0, 1] (uint8 is
scaled on the device by the trainer or the predictor). Every frame goes
through the backbone in one batched call over the (B·T, C, H, W)
channels-last view.

- ``VideoLSTMSeqEncoder``: a per-frame backbone ``cnn`` (MobileNetV2 →
  1280 or ResNet18 → 512) and a BiLSTM ``lstm`` (2 × 128, dropout 0.3
  between layers) returning the whole (B, T, 256) sequence. The mobile
  variants freeze the backbone and take one BiLSTM layer, the resnet
  variants train it and take two (``freeze_backbone`` overrides the
  variant's default);
- early fusion: the cue projected (``cue_proj`` 256, ReLU) queries the
  sequence (``SingleQueryAttention`` ``attn``) → ``fc1`` 256 → ReLU →
  Dropout(0.3) → ``fc2``;
- middle fusion: ``cue_fc`` → BatchNorm ``cue_bn`` → ReLU queries the
  sequence; [last step, attended] → ``fusion_fc`` 512 → ReLU →
  Dropout(0.4) → ``classifier``;
- late fusion: video logits (``video_head`` on the last step) and cue
  logits (``cue_fc1`` 256 → ReLU → ``cue_fc2``), mixed per example by the
  softmax of a two-way gate (``gate_fc1`` 64 → ReLU → ``gate_fc2`` 2) over
  their concat;
- ``test_model``: a trainable MobileNetV2 + 2-layer BiLSTM, last step ⊕ a
  BatchNorm'd two-layer cue MLP → ``fusion_fc`` 512 → BatchNorm → ReLU →
  Dropout(0.4) → ``classifier``.

A frozen backbone runs without gradients (the JAX ``stop_gradient``); its
parameters are frozen in the trainer by ``FROZEN_PARAM_PREFIXES``. Its
BatchNorms follow the model's train/eval mode, as the JAX module's
``bb_train = train`` (the reference's effective behaviour), unless
``frozen_bn_eval`` pins them to their running statistics through
``model.train()`` (the JAX ``bb_train = train and not (frozen and
frozen_bn_eval)``), which makes the frozen features per-sample
deterministic and so cacheable (``train/frozen_cache.py``).
``cached_features=True`` takes the backbone's (B, T, D) features in place
of the frames; ``return_frozen_features=True`` returns them.

``dtype`` is the compute dtype (parameters and BatchNorm statistics stay
float32). Submodule names are the JAX modules', so ``utils/jax_bridge.py``
maps the variables by name.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_lipread_torch.models.backbones import MobileNetV2, ResNet
from multimodal_lipread_torch.nn import BiLSTM
from multimodal_lipread_torch.nn.attention import SingleQueryAttention
from multimodal_lipread_torch.nn.common import BatchNorm, Dropout, linear, time_distributed

CUE_DIM = 768  # mpnet, cv_config.yaml's embed_model
FEATURE_DIM = 256


class FrameBackbone(nn.Module):
    """The per-frame backbone ``cnn`` of a lip encoder and how it is frozen
    (shared with ``models/audio_cues_video.py``): frozen, it runs without
    gradients, and with ``frozen_bn_eval`` it stays in eval mode whatever
    mode the model is put in."""

    def __init__(self, backbone: str, frozen: bool, frozen_bn_eval: bool):
        super().__init__()
        if backbone == "mobilenet_v2":
            self.cnn = MobileNetV2()
        elif backbone == "resnet18":
            self.cnn = ResNet(18)
        else:
            raise ValueError(f"Unknown video backbone: {backbone}")
        self.frozen = frozen
        self.frozen_bn_eval = frozen_bn_eval
        self.cnn_dim = self.cnn.feature_dim

    def train(self, mode: bool = True) -> "FrameBackbone":
        super().train(mode)
        if self.frozen and self.frozen_bn_eval:
            self.cnn.train(False)
        return self

    def frames(self, video: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) frames → (B, T, cnn_dim) features."""
        grad = contextlib.nullcontext() if not self.frozen else torch.no_grad()
        with grad:
            return time_distributed(lambda f: self.cnn(f.permute(0, 3, 1, 2)), video)


class VideoLSTMSeqEncoder(FrameBackbone):
    """Backbone ``cnn`` + BiLSTM ``lstm`` → the full (B, T, feature_dim)
    sequence."""

    def __init__(self, backbone: str = "mobilenet_v2", feature_dim: int = FEATURE_DIM,
                 freeze_backbone: bool = False, lstm_layers: int = 1, frozen_bn_eval: bool = False):
        super().__init__(backbone, freeze_backbone, frozen_bn_eval)
        self.lstm = BiLSTM(self.cnn_dim, feature_dim // 2, lstm_layers, dropout=0.3)
        self.feature_dim = 2 * (feature_dim // 2)

    def forward(self, video: torch.Tensor, cached_features: bool = False,
                return_cnn_features: bool = False) -> torch.Tensor:
        seq = video if cached_features else self.frames(video)
        if return_cnn_features:
            return seq
        return self.lstm(seq)


class _CueVideoModel(nn.Module):
    def __init__(self, backbone: str, freeze_backbone: bool, lstm_layers: int, frozen_bn_eval: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.video_encoder = VideoLSTMSeqEncoder(backbone, FEATURE_DIM, freeze_backbone, lstm_layers, frozen_bn_eval)

    def forward(self, cue: torch.Tensor, video: torch.Tensor, cached_features: bool = False,
                return_frozen_features: bool = False) -> torch.Tensor:
        cue, video = cue.to(self.dtype), video.to(self.dtype)
        if return_frozen_features:
            return self.video_encoder(video, return_cnn_features=True)
        return self.fuse(cue, self.video_encoder(video, cached_features))

    def fuse(self, cue: torch.Tensor, vseq: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class EarlyAttentionFusion(_CueVideoModel):
    """The projected cue queries the video sequence → MLP."""

    def __init__(self, num_classes: int, backbone: str = "mobilenet_v2", freeze_backbone: bool = True,
                 lstm_layers: int = 1, frozen_bn_eval: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(backbone, freeze_backbone, lstm_layers, frozen_bn_eval, dtype)
        self.cue_proj = nn.Linear(CUE_DIM, FEATURE_DIM)
        self.attn = SingleQueryAttention(FEATURE_DIM, FEATURE_DIM, FEATURE_DIM)
        self.fc1 = nn.Linear(FEATURE_DIM, 256)
        self.dropout = Dropout(0.3)
        self.fc2 = nn.Linear(256, num_classes)

    def fuse(self, cue: torch.Tensor, vseq: torch.Tensor) -> torch.Tensor:
        attended = self.attn(F.relu(linear(self.cue_proj, cue)), vseq)
        return linear(self.fc2, self.dropout(F.relu(linear(self.fc1, attended))))


class MiddleAttentionFusion(_CueVideoModel):
    """[video last step, the BatchNorm'd cue's attention over the sequence]
    → fusion MLP."""

    def __init__(self, num_classes: int, backbone: str = "mobilenet_v2", freeze_backbone: bool = False,
                 lstm_layers: int = 1, frozen_bn_eval: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(backbone, freeze_backbone, lstm_layers, frozen_bn_eval, dtype)
        self.cue_fc = nn.Linear(CUE_DIM, FEATURE_DIM)
        self.cue_bn = BatchNorm(FEATURE_DIM)
        self.attn = SingleQueryAttention(FEATURE_DIM, FEATURE_DIM, FEATURE_DIM)
        self.fusion_fc = nn.Linear(2 * FEATURE_DIM, 512)
        self.dropout = Dropout(0.4)
        self.classifier = nn.Linear(512, num_classes)

    def fuse(self, cue: torch.Tensor, vseq: torch.Tensor) -> torch.Tensor:
        c = F.relu(self.cue_bn(linear(self.cue_fc, cue)))
        fused = torch.cat([vseq[:, -1, :], self.attn(c, vseq)], dim=-1)
        return linear(self.classifier, self.dropout(F.relu(linear(self.fusion_fc, fused))))


class LateAttentionFusion(_CueVideoModel):
    """Per-modality logits mixed by a per-example softmax gate over two."""

    def __init__(self, num_classes: int, backbone: str = "mobilenet_v2", freeze_backbone: bool = True,
                 lstm_layers: int = 1, frozen_bn_eval: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(backbone, freeze_backbone, lstm_layers, frozen_bn_eval, dtype)
        self.video_head = nn.Linear(FEATURE_DIM, num_classes)
        self.cue_fc1 = nn.Linear(CUE_DIM, 256)
        self.cue_fc2 = nn.Linear(256, num_classes)
        self.gate_fc1 = nn.Linear(2 * num_classes, 64)
        self.gate_fc2 = nn.Linear(64, 2)

    def fuse(self, cue: torch.Tensor, vseq: torch.Tensor) -> torch.Tensor:
        v_logits = linear(self.video_head, vseq[:, -1, :])
        c_logits = linear(self.cue_fc2, F.relu(linear(self.cue_fc1, cue)))
        g = linear(self.gate_fc2, F.relu(linear(self.gate_fc1, torch.cat([v_logits, c_logits], dim=-1))))
        w = torch.softmax(g, dim=-1)  # over the two modalities, per example
        return w[:, 0:1] * v_logits + w[:, 1:2] * c_logits


class MultimodalCueVideoNet(nn.Module):
    """The plain concat baseline (``test_model``); like the JAX module it
    takes no ``cached_features`` or ``return_frozen_features``."""

    def __init__(self, num_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.video_encoder = VideoLSTMSeqEncoder("mobilenet_v2", FEATURE_DIM, False, 2)
        self.cue_fc1 = nn.Linear(CUE_DIM, 256)
        self.cue_bn = BatchNorm(256)
        self.cue_dropout = Dropout(0.3)
        self.cue_fc2 = nn.Linear(256, 256)
        self.fusion_fc = nn.Linear(FEATURE_DIM + 256, 512)
        self.fusion_bn = BatchNorm(512)
        self.dropout = Dropout(0.4)
        self.classifier = nn.Linear(512, num_classes)

    def forward(self, cue: torch.Tensor, video: torch.Tensor) -> torch.Tensor:
        cue, video = cue.to(self.dtype), video.to(self.dtype)
        vseq = self.video_encoder(video)
        c = self.cue_dropout(F.relu(self.cue_bn(linear(self.cue_fc1, cue))))
        fused = torch.cat([vseq[:, -1, :], linear(self.cue_fc2, c)], dim=-1)
        x = F.relu(self.fusion_bn(linear(self.fusion_fc, fused)))
        return linear(self.classifier, self.dropout(x))


# name → (class, backbone, the variant's freeze default, BiLSTM layers)
_VARIANTS = {
    "early_fusion_mobile": (EarlyAttentionFusion, "mobilenet_v2", True, 1),
    "middle_fusion_mobile": (MiddleAttentionFusion, "mobilenet_v2", True, 1),
    "late_fusion_mobile": (LateAttentionFusion, "mobilenet_v2", True, 1),
    "early_fusion_resnet": (EarlyAttentionFusion, "resnet18", False, 2),
    "middle_fusion_resnet": (MiddleAttentionFusion, "resnet18", False, 2),
    "late_fusion_resnet": (LateAttentionFusion, "resnet18", False, 2),
}


def get_cues_video_model(name: str, num_classes: int, dtype: torch.dtype = torch.float32,
                         frozen_bn_eval: bool = False, freeze_backbone: Optional[bool] = None) -> nn.Module:
    """Name → model, with the JAX registry's signature: ``freeze_backbone``
    None keeps each variant's default (frozen MobileNet, trainable ResNet),
    a bool overrides it (``model.freeze_backbone``); ``frozen_bn_eval`` acts
    on a frozen backbone only."""
    if name == "test_model":
        return MultimodalCueVideoNet(num_classes, dtype=dtype)
    if name not in _VARIANTS:
        raise ValueError(f"Unknown cues_video model: {name}")
    cls, backbone, frozen, layers = _VARIANTS[name]
    frozen = frozen if freeze_backbone is None else bool(freeze_backbone)
    return cls(num_classes, backbone, frozen, layers, frozen_bn_eval, dtype=dtype)


# the parameter subtrees the reference freezes (requires_grad=False), for
# TrainerConfig.frozen_param_prefixes
FROZEN_PARAM_PREFIXES = {
    "early_fusion_mobile": (("video_encoder", "cnn"),),
    "middle_fusion_mobile": (("video_encoder", "cnn"),),
    "late_fusion_mobile": (("video_encoder", "cnn"),),
}

CUES_VIDEO_MODEL_NAMES = tuple(_VARIANTS) + ("test_model",)
