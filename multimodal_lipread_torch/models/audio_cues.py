"""Audio + textual-cue fusion models: the reference's seven (counterpart of
the JAX package's ``models/audio_cues.py``).

Registry names as the JAX package's: ``early_fusion_mobile``,
``middle_fusion_mobile``, ``late_fusion_mobile``, ``early_fusion_resnet``,
``middle_fusion_resnet``, ``late_fusion_resnet``, ``test_model``.

Inputs: ``mel`` (B, 80, T) normalized log-mel, seen as a one-channel
(B, 1, 80, T) image (the JAX module's NHWC (B, 80, T, 1)); ``cue``
(B, cue_dim) sentence embedding (768-d mpnet by default).

- the mel encoders: MobileNetV2 (→ 1280) or ResNet18 (→ 512) over that
  image; the cue encoder: Linear → 128, ReLU, Dropout(0.2);
- early fusion: concat → a gate tanh(``attn_fc1``) → ``attn_fc2`` (one
  score per example) → sigmoid, multiplied into the concat → Linear 256 →
  ReLU → Dropout(0.3) → Linear C. ``attn_fc2``'s bias starts at 2.0 (an
  open gate), as the JAX module's. The reference's gate is a softmax over
  the batch axis, which makes one example's output depend on the others;
  the early-fusion classes' ``batch_softmax_gate=True`` reproduces it
  (ROADMAP.md, Queue 3 #7);
- middle fusion: concat → one-token 4-head self-attention ``cross_attn`` →
  Linear 256 → ReLU → Dropout(0.3) → Linear C;
- late fusion: per-modality logits mixed by the softmax of a learnable
  2-vector ``late.attn_weights`` (ones at initialization);
- ``test_model``: ResNet18 audio ⊕ a BatchNorm'd two-layer cue MLP → Linear
  512 → BatchNorm → ReLU → Dropout(0.4) → Linear C.

``dtype`` is the compute dtype (parameters and BatchNorm statistics stay
float32). Submodule names are the JAX modules', so
``utils/jax_bridge.py`` maps the variables by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_lipread_torch.models.backbones import MobileNetV2, ResNet
from multimodal_lipread_torch.nn.attention import MultiHeadDotProductAttention
from multimodal_lipread_torch.nn.common import BatchNorm, Dropout, linear

CUE_DIM = 768  # mpnet, ac_config.yaml's embed_model


class MelMobileNetEncoder(nn.Module):
    """MobileNetV2 ``mobilenet`` over the one-channel mel image → (B, 1280)."""

    def __init__(self):
        super().__init__()
        self.mobilenet = MobileNetV2(in_channels=1)
        self.feature_dim = MobileNetV2.feature_dim

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.mobilenet(mel[:, None])


class MelResNetEncoder(nn.Module):
    """ResNet18 ``resnet`` over the one-channel mel image → (B, 512)."""

    def __init__(self):
        super().__init__()
        self.resnet = ResNet(18, in_channels=1)
        self.feature_dim = self.resnet.feature_dim

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.resnet(mel[:, None])


class CueProjEncoder(nn.Module):
    """Linear ``fc`` (cue_dim → 128) → ReLU → Dropout(0.2)."""

    def __init__(self, cue_dim: int = CUE_DIM, output_dim: int = 128):
        super().__init__()
        self.fc = nn.Linear(cue_dim, output_dim)
        self.dropout = Dropout(0.2)
        self.feature_dim = output_dim

    def forward(self, cue: torch.Tensor) -> torch.Tensor:
        return self.dropout(F.relu(linear(self.fc, cue)))


class _ClassifierMLP(nn.Module):
    """Linear ``fc1`` (→ 256) → ReLU → Dropout(0.3) → Linear ``fc2`` (→ C)."""

    def __init__(self, in_dim: int, num_classes: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, 256)
        self.dropout = Dropout(0.3)
        self.fc2 = nn.Linear(256, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.fc2, self.dropout(F.relu(linear(self.fc1, x))))


class _GatedEarlyFusion(_ClassifierMLP):
    """concat → gate → the classifier MLP (see the module docstring)."""

    def __init__(self, in_dim: int, num_classes: int, batch_softmax_gate: bool = False):
        super().__init__(in_dim, num_classes)
        self.batch_softmax_gate = batch_softmax_gate
        self.attn_fc1 = nn.Linear(in_dim, in_dim)
        self.attn_fc2 = nn.Linear(in_dim, 1)
        # an open gate at initialization (sigmoid(2) ≈ 0.88): a zero bias lets
        # Adam's first steps close the per-example gate for every example
        self.attn_fc2.flax_bias_init = 2.0
        with torch.no_grad():
            self.attn_fc2.bias.fill_(2.0)

    def forward(self, fused: torch.Tensor) -> torch.Tensor:
        s = linear(self.attn_fc2, torch.tanh(linear(self.attn_fc1, fused)))  # (B, 1)
        gate = torch.softmax(s, dim=0) if self.batch_softmax_gate else torch.sigmoid(s)
        return super().forward(fused * gate)


class _SelfAttnMidFusion(_ClassifierMLP):
    """concat → one-token multi-head self-attention → the classifier MLP."""

    def __init__(self, in_dim: int, num_classes: int, num_heads: int = 4):
        super().__init__(in_dim, num_classes)
        self.cross_attn = MultiHeadDotProductAttention(in_dim, num_heads)

    def forward(self, fused: torch.Tensor) -> torch.Tensor:
        return super().forward(self.cross_attn(fused[:, None, :])[:, 0, :])


class _ModalitySoftmaxLateFusion(nn.Module):
    """softmax(``attn_weights``)[0] · audio + [1] · cue logits."""

    def __init__(self):
        super().__init__()
        self.attn_weights = nn.Parameter(torch.ones(2))

    def forward(self, a_logits: torch.Tensor, c_logits: torch.Tensor) -> torch.Tensor:
        # in the weights' float32 (or wider), as JAX promotes bf16 logits
        dtype = torch.promote_types(a_logits.dtype, self.attn_weights.dtype)
        w = torch.softmax(self.attn_weights.to(dtype), dim=0)
        return w[0] * a_logits.to(dtype) + w[1] * c_logits.to(dtype)


class _AudioCueModel(nn.Module):
    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype

    def _cast(self, mel: torch.Tensor, cue: torch.Tensor):
        return mel.to(self.dtype), cue.to(self.dtype)


class _EarlyOrMiddleFusion(_AudioCueModel):
    """audio encoder ⊕ cue encoder → a fusion head."""

    def __init__(self, audio_encoder: nn.Module, fusion_cls, num_classes: int, dtype: torch.dtype, **fusion):
        super().__init__(dtype)
        self.audio_encoder = audio_encoder
        self.cue_encoder = CueProjEncoder()
        self.fusion = fusion_cls(audio_encoder.feature_dim + self.cue_encoder.feature_dim, num_classes, **fusion)

    def forward(self, mel: torch.Tensor, cue: torch.Tensor) -> torch.Tensor:
        mel, cue = self._cast(mel, cue)
        return self.fusion(torch.cat([self.audio_encoder(mel), self.cue_encoder(cue)], dim=-1))


class EarlyFusionAttentionMobile(_EarlyOrMiddleFusion):
    def __init__(self, num_classes: int, batch_softmax_gate: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(MelMobileNetEncoder(), _GatedEarlyFusion, num_classes, dtype,
                         batch_softmax_gate=batch_softmax_gate)


class MiddleFusionAttentionMobile(_EarlyOrMiddleFusion):
    def __init__(self, num_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__(MelMobileNetEncoder(), _SelfAttnMidFusion, num_classes, dtype)


class EarlyFusionAttentionResNet(_EarlyOrMiddleFusion):
    def __init__(self, num_classes: int, batch_softmax_gate: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(MelResNetEncoder(), _GatedEarlyFusion, num_classes, dtype,
                         batch_softmax_gate=batch_softmax_gate)


class MiddleFusionAttentionResNet(_EarlyOrMiddleFusion):
    def __init__(self, num_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__(MelResNetEncoder(), _SelfAttnMidFusion, num_classes, dtype)


class _LateFusion(_AudioCueModel):
    """Audio: encoder → ``audio_fc1`` 256 → ReLU → Dropout(0.3) →
    ``audio_fc2``; cue: ``cue_fc1`` 128 → ReLU → Dropout(0.2) → ``cue_fc2``;
    the two logits mixed by ``late``."""

    def __init__(self, audio_encoder: nn.Module, num_classes: int, dtype: torch.dtype):
        super().__init__(dtype)
        self.audio_encoder = audio_encoder
        self.audio_fc1 = nn.Linear(audio_encoder.feature_dim, 256)
        self.audio_fc2 = nn.Linear(256, num_classes)
        self.cue_fc1 = nn.Linear(CUE_DIM, 128)
        self.cue_fc2 = nn.Linear(128, num_classes)
        self.audio_dropout = Dropout(0.3)
        self.cue_dropout = Dropout(0.2)
        self.late = _ModalitySoftmaxLateFusion()

    def forward(self, mel: torch.Tensor, cue: torch.Tensor) -> torch.Tensor:
        mel, cue = self._cast(mel, cue)
        a = self.audio_dropout(F.relu(linear(self.audio_fc1, self.audio_encoder(mel))))
        c = self.cue_dropout(F.relu(linear(self.cue_fc1, cue)))
        return self.late(linear(self.audio_fc2, a), linear(self.cue_fc2, c))


class LateFusionAttentionMobile(_LateFusion):
    def __init__(self, num_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__(MelMobileNetEncoder(), num_classes, dtype)


class LateFusionAttentionResNet(_LateFusion):
    def __init__(self, num_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__(MelResNetEncoder(), num_classes, dtype)


class MultimodalNet(_AudioCueModel):
    """The plain concat baseline (``test_model``)."""

    def __init__(self, num_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.audio_encoder = MelResNetEncoder()
        self.cue_fc1 = nn.Linear(CUE_DIM, 256)
        self.cue_bn = BatchNorm(256)
        self.cue_dropout = Dropout(0.3)
        self.cue_fc2 = nn.Linear(256, 256)
        self.fc1 = nn.Linear(self.audio_encoder.feature_dim + 256, 512)
        self.bn1 = BatchNorm(512)
        self.dropout = Dropout(0.4)
        self.fc2 = nn.Linear(512, num_classes)

    def forward(self, mel: torch.Tensor, cue: torch.Tensor) -> torch.Tensor:
        mel, cue = self._cast(mel, cue)
        c = self.cue_dropout(F.relu(self.cue_bn(linear(self.cue_fc1, cue))))
        c = F.relu(linear(self.cue_fc2, c))
        x = linear(self.fc1, torch.cat([self.audio_encoder(mel), c], dim=-1))
        return linear(self.fc2, self.dropout(F.relu(self.bn1(x))))


_REGISTRY = {
    "early_fusion_mobile": EarlyFusionAttentionMobile,
    "middle_fusion_mobile": MiddleFusionAttentionMobile,
    "late_fusion_mobile": LateFusionAttentionMobile,
    "early_fusion_resnet": EarlyFusionAttentionResNet,
    "middle_fusion_resnet": MiddleFusionAttentionResNet,
    "late_fusion_resnet": LateFusionAttentionResNet,
    "test_model": MultimodalNet,
}
AUDIO_CUES_MODEL_NAMES = tuple(_REGISTRY)


def get_audio_cues_model(name: str, num_classes: int, dtype: torch.dtype = torch.float32) -> nn.Module:
    if name not in _REGISTRY:
        raise ValueError(f"Unknown audio_cues model: {name}")
    return _REGISTRY[name](num_classes, dtype=dtype)
