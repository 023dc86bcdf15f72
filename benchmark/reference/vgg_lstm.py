"""Plain ``vgg_lstm`` from raw waveforms: the log-mel (``logmel.py``) cut
to 80 × ``input_size``, VGG16-BN (Simonyan & Zisserman 2015, torchvision's
``features`` topology: 3 × 3 convolutions with bias → BatchNorm (eps 1e-5)
→ ReLU, 2 × 2 max-pools), the map averaged over time and read as a
sequence over the mel axis, a 2-layer BiLSTM of 128, its last step, and
the head Linear 256 → 128 → BatchNorm → ReLU → Dropout 0.3 → Linear.

Departures from a textbook VGG-LSTM, as the reference project builds it:
the convolutions keep their bias before BatchNorm, and the head is 128
wide with dropout 0.3 (the YAML's ``fc_hidden_size``, ``dropout`` and
``feature_dim`` are read by nothing)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import layers as L
from benchmark.reference.logmel import N_MELS, NUM_SAMPLES, log_mel

VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M")
LSTM_HIDDEN = 128
HEAD = 128
DROPOUT = 0.3
BN_EPS = 1e-5


def param_spec(cfg: dict) -> dict:
    spec, c, k = {}, 1, 0
    for v in VGG16:
        if v == "M":
            continue
        spec.update(L.conv_spec(f"vgg.conv{k}", c, v, 3))
        spec.update(L.bn_spec(f"vgg.bn{k}", v))
        c, k = v, k + 1
    spec.update(L.lstm_spec("lstm.lstm", 512, LSTM_HIDDEN, 2))
    spec.update(L.linear_spec("classifier.fc1", 2 * LSTM_HIDDEN, HEAD))
    spec.update(L.bn_spec("classifier.bn", HEAD))
    spec.update(L.linear_spec("classifier.fc2", HEAD, cfg["dataset"]["num_classes"]))
    return spec


def features(cfg: dict, waves: torch.Tensor) -> torch.Tensor:
    """(B, 20000) waveforms → (B, 80, input_size) model input."""
    return log_mel(waves)[:, :N_MELS, : cfg["dataset"]["input_size"]]


def forward(p: L.Params, cfg: dict, inputs: tuple, train: bool, generator=None) -> torch.Tensor:
    (waves,) = inputs
    x = features(cfg, waves)[:, None]
    k = 0
    for v in VGG16:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
        else:
            x = F.relu(L.batch_norm(p, f"vgg.bn{k}", L.conv(p, f"vgg.conv{k}", x), train, BN_EPS))
            k += 1
    seq = L.bilstm(p, "lstm.lstm", x.mean(dim=3).permute(0, 2, 1), 2)
    h = L.batch_norm(p, "classifier.bn", L.linear(p, "classifier.fc1", seq[:, -1]), train, BN_EPS)
    h = L.dropout(F.relu(h), DROPOUT, generator, train)
    return L.linear(p, "classifier.fc2", h)


def example_inputs(batch: int) -> tuple:
    """Zeros of the raw inputs' shapes and dtypes, for counting FLOPs."""
    return (torch.zeros(batch, NUM_SAMPLES, dtype=torch.int16),)
