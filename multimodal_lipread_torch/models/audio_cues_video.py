"""Audio + cue + video ("triple") fusion models: the reference's seven
(counterpart of the JAX package's ``models/audio_cues_video.py``).

Registry names as the JAX package's: ``early_fusion_mobile``,
``middle_fusion_mobile``, ``late_fusion_mobile``, ``early_fusion_resnet``,
``middle_fusion_resnet``, ``late_fusion_resnet``, ``test_model``.

Inputs: ``mel`` (B, 80, input_size) normalized log-mel, seen as a
one-channel (B, 1, 80, T) image; ``cue`` (B, cue_dim) sentence embedding;
``lip`` (B, T, 44, 44, 3) lip sequences in [0, 1].

- ``TripleAudioEncoder`` ``audio``: ResNet18 ``resnet`` over the mel image
  → 512;
- ``TripleCueEncoder`` ``cue``: ``fc1`` 256 → BatchNorm ``bn`` → ReLU, then
  for the "early" style Dropout(0.3) → ``fc2`` 256 → ReLU, for the "plain"
  style ``fc2`` alone;
- ``TripleVideoEncoder`` ``video``: a per-frame backbone ``cnn`` (MobileNetV2
  or ResNet18) and a BiLSTM ``lstm`` (2 × 128, dropout 0.3 between layers)
  → its last step (256);
- ``ModalityAttentionFusion`` ``attn``: M modality vectors stacked (B, M,
  D) → ``attn_fc1`` max(D/2, 1) → ReLU → ``attn_fc2`` 1 → softmax over the
  modality axis → weighted sum (returns it and the weights);
- early: audio, cue and video each projected to 256 (``ap``, ``cp``,
  ``vp``) → ``attn`` → ``fc1`` 256 → ReLU → Dropout(0.4) → ``fc2``;
- middle: the plain cue, audio and video projected (``ap``, ``vp``) →
  ``attn`` → ``fc1`` 512 → BatchNorm ``bn1`` → ReLU → Dropout(0.4) → ``fc2``;
- late: per-modality logits (``afc``, ``cfc``, ``vfc``) → ``attn`` over
  the logits;
- ``test_model``: the three encoders' concat → ``fc1`` 512 → ``bn1`` → ReLU
  → Dropout(0.4) → ``fc2``.

The early variants and ``middle_fusion_resnet`` freeze the audio ResNet
and the video backbone (one BiLSTM layer); the others train them (two
layers). A frozen encoder runs without gradients and its parameters are
frozen in the trainer by ``FROZEN_PARAM_PREFIXES``; its BatchNorms follow
the model's train/eval mode (the reference's effective behaviour: its
per-epoch ``model.train()`` undoes the ``BN.eval()`` of its construction)
unless ``frozen_bn_eval`` pins them to their running statistics through
``model.train()``. ``cached_features=True`` takes the audio encoder's
(B, 512) output and the video backbone's (B, T, D) features in place of
the mel and the frames; ``return_frozen_features=True`` returns them.

``dtype`` is the compute dtype (parameters and BatchNorm statistics stay
float32). Submodule names are the JAX modules', so ``utils/jax_bridge.py``
maps the variables by name.
"""

from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_lipread_torch.models.backbones import ResNet
from multimodal_lipread_torch.models.cues_video import CUE_DIM, FEATURE_DIM, FrameBackbone
from multimodal_lipread_torch.nn import BiLSTM
from multimodal_lipread_torch.nn.common import BatchNorm, Dropout, linear


class ModalityAttentionFusion(nn.Module):
    """Softmax over the modality axis of an MLP's score per modality; the
    weighted sum of the (B, M, D) stack → (fused (B, D), weights (B, M))."""

    def __init__(self, dim: int):
        super().__init__()
        self.attn_fc1 = nn.Linear(dim, max(dim // 2, 1))
        self.attn_fc2 = nn.Linear(max(dim // 2, 1), 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        stacked = torch.stack(list(feats), dim=1)  # (B, M, D)
        scores = linear(self.attn_fc2, F.relu(linear(self.attn_fc1, stacked))).squeeze(-1)  # (B, M)
        weights = torch.softmax(scores, dim=1)
        return (stacked * weights[..., None]).sum(dim=1), weights


class TripleAudioEncoder(nn.Module):
    """ResNet18 ``resnet`` over the one-channel mel image → (B, 512); frozen,
    it runs without gradients, and with ``frozen_bn_eval`` it stays in eval
    mode whatever mode the model is put in."""

    feature_dim = 512

    def __init__(self, frozen: bool = False, frozen_bn_eval: bool = False):
        super().__init__()
        self.resnet = ResNet(18, in_channels=1)
        self.frozen = frozen
        self.frozen_bn_eval = frozen_bn_eval

    def train(self, mode: bool = True) -> "TripleAudioEncoder":
        super().train(mode)
        if self.frozen and self.frozen_bn_eval:
            self.resnet.train(False)
        return self

    def forward(self, mel: torch.Tensor, cached_features: bool = False) -> torch.Tensor:
        if cached_features:  # already the (B, 512) encoder output
            return mel
        with torch.no_grad() if self.frozen else contextlib.nullcontext():
            return self.resnet(mel[:, None])


class TripleCueEncoder(nn.Module):
    """The reference's two cue MLPs: "early" Linear → BN → ReLU → Dropout(0.3)
    → Linear → ReLU, "plain" Linear → BN → ReLU → Linear."""

    def __init__(self, style: str = "early", cue_dim: int = CUE_DIM):
        super().__init__()
        if style not in ("early", "plain"):
            raise ValueError(f"Unknown cue encoder style: {style}")
        self.style = style
        self.fc1 = nn.Linear(cue_dim, 256)
        self.bn = BatchNorm(256)
        self.dropout = Dropout(0.3 if style == "early" else 0.0)
        self.fc2 = nn.Linear(256, 256)

    def forward(self, cue: torch.Tensor) -> torch.Tensor:
        x = linear(self.fc2, self.dropout(F.relu(self.bn(linear(self.fc1, cue)))))
        return F.relu(x) if self.style == "early" else x


class TripleVideoEncoder(FrameBackbone):
    """Backbone ``cnn`` + BiLSTM ``lstm`` → the last step (B, feature_dim)."""

    def __init__(self, backbone: str = "mobilenet_v2", feature_dim: int = FEATURE_DIM, frozen: bool = False,
                 frozen_bn_eval: bool = False, lstm_layers: int = 1):
        super().__init__(backbone, frozen, frozen_bn_eval)
        self.lstm = BiLSTM(self.cnn_dim, feature_dim // 2, lstm_layers, dropout=0.3)
        self.feature_dim = 2 * (feature_dim // 2)

    def forward(self, video: torch.Tensor, cached_features: bool = False,
                return_cnn_features: bool = False) -> torch.Tensor:
        seq = video if cached_features else self.frames(video)
        if return_cnn_features:
            return seq
        return self.lstm(seq)[:, -1, :]


class _TripleModel(nn.Module):
    """The audio and video encoders, frozen or not, and the cue encoder of
    ``cue_style``."""

    def __init__(self, video_backbone: str, frozen: bool, lstm_layers: int, frozen_bn_eval: bool,
                 cue_style: str, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.audio = TripleAudioEncoder(frozen, frozen_bn_eval)
        self.video = TripleVideoEncoder(video_backbone, FEATURE_DIM, frozen, frozen_bn_eval, lstm_layers)
        self.cue = TripleCueEncoder(cue_style)

    def forward(self, mel: torch.Tensor, cue: torch.Tensor, lip: torch.Tensor, cached_features: bool = False,
                return_frozen_features: bool = False):
        mel, cue, lip = mel.to(self.dtype), cue.to(self.dtype), lip.to(self.dtype)
        a = self.audio(mel, cached_features)
        if return_frozen_features:
            return a, self.video(lip, return_cnn_features=True)
        return self.fuse(a, self.cue(cue), self.video(lip, cached_features))

    def fuse(self, a: torch.Tensor, c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class MultimodalAttentionEarly(_TripleModel):
    def __init__(self, num_classes: int, video_backbone: str = "mobilenet_v2", frozen: bool = True,
                 lstm_layers: int = 1, frozen_bn_eval: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(video_backbone, frozen, lstm_layers, frozen_bn_eval, "early", dtype)
        self.ap = nn.Linear(TripleAudioEncoder.feature_dim, 256)
        self.cp = nn.Linear(256, 256)
        self.vp = nn.Linear(FEATURE_DIM, 256)
        self.attn = ModalityAttentionFusion(256)
        self.fc1 = nn.Linear(256, 256)
        self.dropout = Dropout(0.4)
        self.fc2 = nn.Linear(256, num_classes)

    def fuse(self, a: torch.Tensor, c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        fused, _ = self.attn([linear(self.ap, a), linear(self.cp, c), linear(self.vp, v)])
        return linear(self.fc2, self.dropout(F.relu(linear(self.fc1, fused))))


class MultimodalAttentionMiddle(_TripleModel):
    def __init__(self, num_classes: int, video_backbone: str = "mobilenet_v2", frozen: bool = False,
                 lstm_layers: int = 2, frozen_bn_eval: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(video_backbone, frozen, lstm_layers, frozen_bn_eval, "plain", dtype)
        self.ap = nn.Linear(TripleAudioEncoder.feature_dim, 256)
        self.vp = nn.Linear(FEATURE_DIM, 256)
        self.attn = ModalityAttentionFusion(256)
        self.fc1 = nn.Linear(256, 512)
        self.bn1 = BatchNorm(512)
        self.dropout = Dropout(0.4)
        self.fc2 = nn.Linear(512, num_classes)

    def fuse(self, a: torch.Tensor, c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        fused, _ = self.attn([linear(self.ap, a), c, linear(self.vp, v)])
        return linear(self.fc2, self.dropout(F.relu(self.bn1(linear(self.fc1, fused)))))


class MultimodalAttentionLate(_TripleModel):
    def __init__(self, num_classes: int, video_backbone: str = "mobilenet_v2", frozen: bool = False,
                 lstm_layers: int = 2, frozen_bn_eval: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(video_backbone, frozen, lstm_layers, frozen_bn_eval, "plain", dtype)
        self.afc = nn.Linear(TripleAudioEncoder.feature_dim, num_classes)
        self.cfc = nn.Linear(256, num_classes)
        self.vfc = nn.Linear(FEATURE_DIM, num_classes)
        self.attn = ModalityAttentionFusion(num_classes)

    def fuse(self, a: torch.Tensor, c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        fused, _ = self.attn([linear(self.afc, a), linear(self.cfc, c), linear(self.vfc, v)])
        return fused


class MultimodalThreeNet(nn.Module):
    """The plain concat baseline (``test_model``); like the JAX module it
    takes no ``cached_features`` or ``return_frozen_features``."""

    def __init__(self, num_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.audio = TripleAudioEncoder()
        self.cue = TripleCueEncoder()
        self.video = TripleVideoEncoder("mobilenet_v2", lstm_layers=2)
        self.fc1 = nn.Linear(TripleAudioEncoder.feature_dim + 256 + FEATURE_DIM, 512)
        self.bn1 = BatchNorm(512)
        self.dropout = Dropout(0.4)
        self.fc2 = nn.Linear(512, num_classes)

    def forward(self, mel: torch.Tensor, cue: torch.Tensor, lip: torch.Tensor) -> torch.Tensor:
        mel, cue, lip = mel.to(self.dtype), cue.to(self.dtype), lip.to(self.dtype)
        fused = torch.cat([self.audio(mel), self.cue(cue), self.video(lip)], dim=-1)
        return linear(self.fc2, self.dropout(F.relu(self.bn1(linear(self.fc1, fused)))))


# name → (class, video backbone, frozen encoders, BiLSTM layers)
_VARIANTS = {
    "early_fusion_mobile": (MultimodalAttentionEarly, "mobilenet_v2", True, 1),
    "middle_fusion_mobile": (MultimodalAttentionMiddle, "mobilenet_v2", False, 2),
    "late_fusion_mobile": (MultimodalAttentionLate, "mobilenet_v2", False, 2),
    "early_fusion_resnet": (MultimodalAttentionEarly, "resnet18", True, 1),
    "middle_fusion_resnet": (MultimodalAttentionMiddle, "resnet18", True, 1),
    "late_fusion_resnet": (MultimodalAttentionLate, "resnet18", False, 2),
}


def get_triple_model(name: str, num_classes: int, dtype: torch.dtype = torch.float32,
                     frozen_bn_eval: bool = False) -> nn.Module:
    """Name → model, with the JAX registry's signature; ``frozen_bn_eval``
    acts on the variants with frozen encoders only."""
    if name == "test_model":
        return MultimodalThreeNet(num_classes, dtype=dtype)
    if name not in _VARIANTS:
        raise ValueError(f"Unknown audio_cues_video model: {name}")
    cls, backbone, frozen, layers = _VARIANTS[name]
    return cls(num_classes, backbone, frozen, layers, frozen_bn_eval and frozen, dtype=dtype)


# the parameter subtrees the reference freezes (audio ResNet and video
# backbone), for TrainerConfig.frozen_param_prefixes
FROZEN_PARAM_PREFIXES = {
    "early_fusion_mobile": (("audio", "resnet"), ("video", "cnn")),
    "early_fusion_resnet": (("audio", "resnet"), ("video", "cnn")),
    "middle_fusion_resnet": (("audio", "resnet"), ("video", "cnn")),
}

TRIPLE_MODEL_NAMES = tuple(_VARIANTS) + ("test_model",)
