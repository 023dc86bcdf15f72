"""Textual-cue classifiers: the reference's cue architectures and the BERT
fine-tune (counterpart of the JAX package's ``models/cues.py``).

Registry names and embedding kinds as the JAX package's
``CUE_MODEL_SPECS``:

- ``dense_nn``: MLP 512 → 256 → 256 over a MiniLM sentence embedding (384);
- ``minilm_lstm``: Linear 256 → a length-1 BiLSTM 128 → head (mpnet, 768);
- ``minilm_lstm_attn``: the same with additive attention over the BiLSTM
  output;
- ``multi_attn``: Linear 256 → one-token 4-head self-attention → head;
- ``transformer``: Linear 512 → two residual one-token 8-head
  self-attention layers → head, over the MiniLM ⊕ mpnet "ensemble" (1152);
- ``minilm_cnn_lstm``: token-level (B, 32, 768) → Conv1d [2, 3, 4] × 64,
  each max-pooled over time → BiLSTM → head;
- ``minilm_cnn_bilstm_attn``: the same with 4-head self-attention after
  the BiLSTM, mean-pooled;
- ``lstm_multi_attn``: token-level (distilbert) → BiLSTM → 4-head
  self-attention → mean → head;
- ``linear``: TF-IDF (≤ 5000 terms) → MLP 512 → 128;
- ``bert`` / ``bert_lite``: ``models/bert.BertClassifier`` on token ids;
  ``bert_lite`` computes in bf16 (parameters stay float32).

The head is Linear → 128 → ReLU → Dropout → Linear. Flax infers each input
width; here it is the embedding kind's width (``EMBED_DIMS``) unless the
caller gives ``input_dim`` (the TF-IDF width of ``linear`` is known only
after featurization). ``dtype`` is the compute dtype. Submodule names are
the JAX modules', so ``utils/jax_bridge.py`` maps the variables by name.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_lipread_torch.data.cues import EMBED_DIMS
from multimodal_lipread_torch.nn import MLP, BiLSTM, Dropout
from multimodal_lipread_torch.nn.attention import MultiHeadSelfAttention
from multimodal_lipread_torch.nn.common import conv1d, linear


class _Head(nn.Module):
    """Linear ``fc1`` (→ 128) → ReLU → Dropout → Linear ``fc2`` (→ C)."""

    def __init__(self, in_dim: int, num_classes: int, dropout_rate: float = 0.3):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, 128)
        self.dropout = Dropout(dropout_rate)
        self.fc2 = nn.Linear(128, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.fc2, self.dropout(F.relu(linear(self.fc1, x))))


class _CueModel(nn.Module):
    """The compute dtype, applied to float inputs (Flax's ``dtype=``)."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype


class DenseClassifier(MLP):
    """Linear ``dense{i}`` → ReLU → Dropout per hidden width, then ``out``."""

    def __init__(self, in_dim: int, num_classes: int, hidden_dims: Sequence[int] = (512, 256, 256),
                 dropout_rate: float = 0.3, dtype: torch.dtype = torch.float32):
        super().__init__(in_dim, hidden_dims, num_classes, dropout_rate)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.dtype))


class _InputDense(nn.Module):
    """Linear ``dense`` → ReLU → Dropout(0.2)."""

    def __init__(self, in_dim: int, dim: int = 256):
        super().__init__()
        self.dense = nn.Linear(in_dim, dim)
        self.dropout = Dropout(0.2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(F.relu(linear(self.dense, x)))


class LSTMClassifier(_CueModel):
    def __init__(self, in_dim: int, num_classes: int, hidden_dim: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.input_dense = _InputDense(in_dim)
        self.lstm = BiLSTM(256, hidden_dim, 1)
        self.head = _Head(2 * hidden_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.lstm(self.input_dense(x.to(self.dtype))[:, None, :])  # a length-1 sequence
        return self.head(out[:, -1, :])


class AttentionLSTMClassifier(_CueModel):
    def __init__(self, in_dim: int, num_classes: int, hidden_dim: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.input_dense = _InputDense(in_dim)
        self.lstm = BiLSTM(256, hidden_dim, 1)
        self.attention = nn.Linear(2 * hidden_dim, 1)
        self.head = _Head(2 * hidden_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.lstm(self.input_dense(x.to(self.dtype))[:, None, :])
        weights = torch.softmax(linear(self.attention, out), dim=1)  # (B, 1, 1)
        return self.head((weights * out).sum(dim=1))


class TransformerLiteClassifier(_CueModel):
    """One-token multi-head self-attention."""

    def __init__(self, in_dim: int, num_classes: int, hidden_dim: int = 256, num_heads: int = 4,
                 dropout_rate: float = 0.3, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.input_dense = nn.Linear(in_dim, hidden_dim)
        self.dropout = Dropout(dropout_rate)
        self.attention = MultiHeadSelfAttention(hidden_dim, num_heads)
        self.head = _Head(hidden_dim, num_classes, dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = self.dropout(F.relu(linear(self.input_dense, x.to(self.dtype))))[:, None, :]
        return self.head(self.attention(seq)[:, 0, :])


class MultiAttentionClassifier(_CueModel):
    """Stacked residual one-token self-attention."""

    def __init__(self, in_dim: int, num_classes: int, hidden_dim: int = 512, num_heads: int = 8,
                 num_layers: int = 2, dropout_rate: float = 0.3, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.num_layers = num_layers
        self.input_dense = nn.Linear(in_dim, hidden_dim)
        self.dropout = Dropout(dropout_rate)
        for i in range(num_layers):
            self.add_module(f"attn{i}", MultiHeadSelfAttention(hidden_dim, num_heads))
        self.head = _Head(hidden_dim, num_classes, dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = self.dropout(F.relu(linear(self.input_dense, x.to(self.dtype))))[:, None, :]
        for i in range(self.num_layers):
            seq = getattr(self, f"attn{i}")(seq) + seq
        return self.head(seq[:, 0, :])


class _MultiKernelConv(nn.Module):
    """Conv1d ``conv{k}`` (VALID) for k in [2, 3, 4], 64 filters each → ReLU
    → max over time, concatenated: (B, T, D) → (B, 192)."""

    def __init__(self, in_dim: int, kernel_sizes: Sequence[int] = (2, 3, 4), n_filters: int = 64):
        super().__init__()
        self.kernel_sizes = tuple(kernel_sizes)
        for k in self.kernel_sizes:
            self.add_module(f"conv{k}", nn.Conv1d(in_dim, n_filters, k))
        self.feature_dim = n_filters * len(self.kernel_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)  # (B, D, T)
        return torch.cat([F.relu(conv1d(getattr(self, f"conv{k}"), x)).amax(dim=-1) for k in self.kernel_sizes],
                         dim=-1)


class CNNLSTMClassifier(_CueModel):
    def __init__(self, in_dim: int, num_classes: int, hidden_dim: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.convs = _MultiKernelConv(in_dim)
        self.lstm = BiLSTM(self.convs.feature_dim, hidden_dim, 1)
        self.head = _Head(2 * hidden_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.lstm(self.convs(x.to(self.dtype))[:, None, :])
        return self.head(out[:, -1, :])


class CNNBiLSTMAttn(_CueModel):
    def __init__(self, in_dim: int, num_classes: int, hidden_dim: int = 128, num_heads: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.convs = _MultiKernelConv(in_dim)
        self.lstm = BiLSTM(self.convs.feature_dim, hidden_dim, 1)
        self.self_attn = MultiHeadSelfAttention(2 * hidden_dim, num_heads)
        self.head = _Head(2 * hidden_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.lstm(self.convs(x.to(self.dtype))[:, None, :])
        return self.head(self.self_attn(out).mean(dim=1))


class MultiHeadSelfAttentionLSTM(_CueModel):
    def __init__(self, in_dim: int, num_classes: int, hidden_dim: int = 128, num_heads: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.lstm = BiLSTM(in_dim, hidden_dim, 1)
        self.self_attn = MultiHeadSelfAttention(2 * hidden_dim, num_heads)
        self.head = _Head(2 * hidden_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.self_attn(self.lstm(x.to(self.dtype))).mean(dim=1))


class SimpleMLP(_CueModel):
    """TF-IDF baseline: ``fc1`` 512 → ``fc2`` 128 → ``out``, ReLU and
    dropout 0.2 between."""

    def __init__(self, in_dim: int, num_classes: int, dropout_rate: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.fc1 = nn.Linear(in_dim, 512)
        self.fc2 = nn.Linear(512, 128)
        self.out = nn.Linear(128, num_classes)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dropout(F.relu(linear(self.fc1, x.to(self.dtype))))
        x = self.dropout(F.relu(linear(self.fc2, x)))
        return linear(self.out, x)


# (class, embedding kind); the kinds: sentence 'minilm' | 'mpnet' |
# 'ensemble', token-level 'mpnet_tok' | 'distilbert_tok', 'tfidf' for the
# linear baseline, 'bert_tok' (token ids) for BERT
CUE_MODEL_SPECS = {
    "bert": (None, "bert_tok"),
    "bert_lite": (None, "bert_tok"),
    "dense_nn": (DenseClassifier, "minilm"),
    "minilm_lstm": (LSTMClassifier, "mpnet"),
    "minilm_lstm_attn": (AttentionLSTMClassifier, "mpnet"),
    "multi_attn": (TransformerLiteClassifier, "mpnet"),
    "transformer": (MultiAttentionClassifier, "ensemble"),
    "minilm_cnn_lstm": (CNNLSTMClassifier, "mpnet_tok"),
    "minilm_cnn_bilstm_attn": (CNNBiLSTMAttn, "mpnet_tok"),
    "lstm_multi_attn": (MultiHeadSelfAttentionLSTM, "distilbert_tok"),
    "linear": (SimpleMLP, "tfidf"),
}

CUE_MODEL_NAMES = tuple(CUE_MODEL_SPECS)


def cue_embedding_kind(name: str) -> str:
    return CUE_MODEL_SPECS[name][1]


def embedding_width(kind: str) -> int:
    """The feature width of an embedding kind ('mpnet' 768, 'minilm_tok'…
    per token); 'tfidf' and 'bert_tok' have none fixed."""
    base = kind[: -len("_tok")] if kind.endswith("_tok") else kind
    if base not in EMBED_DIMS:
        raise ValueError(f"embedding kind '{kind}' has no fixed width; pass input_dim")
    return EMBED_DIMS[base]


def get_cue_model(
    name: str, num_classes: int, dtype: torch.dtype = torch.float32, bert_size: str = "tiny",
    pipeline_stages: int = 0, input_dim: Optional[int] = None, mesh=None, num_microbatches: int = 0,
) -> nn.Module:
    """The registry's model ``name``; ``input_dim`` defaults to the width of
    its embedding kind. BERT at ``bert_size`` 'base', 'small' or else the
    tiny offline width (a warning says that the reference fine-tunes
    bert-base). ``pipeline_stages`` S > 1 builds the
    ``PipelinedBertClassifier`` over ``mesh`` (a ``(data, stage)`` mesh)
    with ``num_microbatches`` (S when 0); only BERT takes it, as in the JAX
    package."""
    if name not in CUE_MODEL_SPECS:
        raise ValueError(f"Unknown cue model: {name}")
    if pipeline_stages > 1 and name not in ("bert", "bert_lite"):
        raise ValueError(
            "training.pipeline_parallel > 1 is only supported for the BERT "
            f"cue models (got model.name={name!r})"
        )
    cls, kind = CUE_MODEL_SPECS[name]
    if cls is None:
        from multimodal_lipread_torch.models.bert import (
            BertClassifier,
            bert_base_config,
            bert_small_config,
            bert_tiny_config,
        )

        bert_dtype = torch.bfloat16 if name == "bert_lite" else dtype
        if bert_size not in ("base", "small"):
            import warnings

            warnings.warn(
                f"cue model '{name}' defaults to a tiny random-init BERT; the reference uses "
                "fine-tuned bert-base-uncased: set model.bert_size: base and graft pretrained "
                "weights (utils/torch_import.convert_hf_bert) for parity",
                stacklevel=2,
            )
        cfg = {"base": bert_base_config, "small": bert_small_config}.get(bert_size, bert_tiny_config)()
        if pipeline_stages > 1:
            from multimodal_lipread_torch.models.bert import PipelinedBertClassifier

            return PipelinedBertClassifier(cfg, num_classes, num_stages=pipeline_stages, mesh=mesh,
                                           num_microbatches=num_microbatches, dtype=bert_dtype)
        return BertClassifier(cfg, num_classes, dtype=bert_dtype)
    return cls(input_dim or embedding_width(kind), num_classes, dtype=dtype)
