"""Attention blocks and the positional encoding (counterpart of the JAX
package's ``nn/attention.py``).

- ``AdditiveAttention``: softmax(Linear(x)) weighted sum over an axis;
- ``PositionalEncoding``: the sinusoidal table, added to (B, T, D);
- ``MultiHeadDotProductAttention``: Flax's ``nn.MultiHeadDotProductAttention``
  for self-attention, written from ``linear``, ``matmul`` and ``softmax``;
- ``MultiHeadSelfAttention``, ``TransformerEncoderLayer`` (torch's post-LN
  layer with a ReLU FFN, as the JAX module writes it) and
  ``TransformerEncoder``;
- ``SingleQueryAttention``: one query vector per example attends over a
  (B, T, D) sequence (the cues_video fusion models).

``torch.nn.MultiheadAttention`` and ``nn.TransformerEncoderLayer`` are not
used: they pack their projections in one tensor, take LayerNorm's epsilon
at 1e-5 (Flax: 1e-6), draw dropout from torch's global generator and take a
fused path in eval. Here the projections are ``nn.Linear`` modules named
``query``/``key``/``value``/``out`` as in the JAX parameter tree (Flax keeps
their kernels as (D, heads, head_dim) and (heads, head_dim, D);
``utils/jax_bridge.py`` reshapes them), dropout is the port's ``Dropout``
and LayerNorm the port's, at 1e-6. Sequences are short (29 frames), so the
attention is plain products: the JAX package has no kernel for it either.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_lipread_torch.nn.common import Dropout, LayerNorm, linear


class AdditiveAttention(nn.Module):
    """Softmax(Linear(x)) over ``axis`` and the weighted sum over time.

    ``axis=1`` is the sequence axis; ``axis=0`` (the batch) reproduces the
    reference's audio_cues early fusion where that is asked for. Returns
    (weighted (B, D), weights (B, T))."""

    def __init__(self, dim: int, axis: int = 1):
        super().__init__()
        self.axis = axis
        self.attn = nn.Linear(dim, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        scores = linear(self.attn, x).squeeze(-1)  # (B, T)
        weights = torch.softmax(scores, dim=self.axis)
        return (x * weights[..., None]).sum(dim=1), weights


def sinusoid_table(dim: int, max_len: int) -> np.ndarray:
    """(max_len, dim) float32 table, computed as the JAX module's ``setup``."""
    pe = np.zeros((max_len, dim), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float32) * (-np.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: pe[:, 1::2].shape[1]])
    return pe


class PositionalEncoding(nn.Module):
    """Adds the sinusoidal table to (B, T, D). The table is a constant (a
    non-persistent buffer): it is in no ``state_dict`` and no checkpoint,
    as it is in no JAX parameter tree. The sum is taken in float32 (or
    wider) and returned in the input's dtype."""

    def __init__(self, dim: int, max_len: int = 5000):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(sinusoid_table(dim, max_len)), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x.to(torch.promote_types(x.dtype, torch.float32)) + self.pe[: x.shape[1]]).to(x.dtype)


class MultiHeadDotProductAttention(nn.Module):
    """Flax's ``nn.MultiHeadDotProductAttention`` applied to (x, x):

    q, k, v = x·W + b per head (head_dim = D / heads); q scaled by
    1/√head_dim; an optional boolean ``mask`` broadcast to (B, heads, T, T)
    (BERT's key mask is (B, 1, 1, T)) sets the logits where it is false to
    the compute dtype's lowest value, as Flax's ``jnp.where(mask, w,
    finfo(dtype).min)`` does, so a row with no key left gets a uniform
    softmax, not NaN; softmax over the keys; in training, dropout on the
    attention probabilities with one (T, T) mask shared over batch and
    heads (Flax's ``broadcast_dropout=True``); then the output projection
    over heads·head_dim.

    Tensor-parallel (``set_tensor_parallel(group, size)``, with the
    projections' weights already cut by ``parallel/mesh.place_state``): this
    rank holds ``num_heads / size`` heads, query, key and value are
    column-parallel (their input's gradient is all-reduced over ``group``)
    and the output projection row-parallel (its partial products are
    all-reduced, then its bias added)."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dimension {dim} is not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.total_heads = num_heads
        self.tp_group = None
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.dropout = Dropout(dropout_rate, broadcast_dims=(0, 1))

    def set_tensor_parallel(self, group, size: int) -> None:
        if self.total_heads % size:
            raise ValueError(f"{self.total_heads} heads do not split over tensor_parallel={size}")
        self.tp_group = group
        self.num_heads = self.total_heads // size

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        from multimodal_lipread_torch.parallel.mesh import copy_to_group, reduce_from_group

        b, t, _ = x.shape
        h = self.num_heads
        hd = self.query.weight.shape[0] // h
        xin = copy_to_group(x, self.tp_group)

        def heads(layer: nn.Linear) -> torch.Tensor:  # (B, heads, T, head_dim)
            return linear(layer, xin).reshape(b, t, h, hd).transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        q = q / math.sqrt(hd)
        logits = q @ k.transpose(-1, -2)  # (B, heads, T, T)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        weights = self.dropout(torch.softmax(logits, dim=-1))
        out = (weights @ v).transpose(1, 2).reshape(b, t, h * hd)
        if self.tp_group is None:
            return linear(self.out, out)
        partial = F.linear(out, self.out.weight.to(out.dtype))
        return reduce_from_group(partial, self.tp_group) + self.out.bias.to(out.dtype)


class SingleQueryAttention(nn.Module):
    """One query vector (B, D) attends over a sequence (B, T, D): learned
    ``query``/``key``/``value`` Linears (plain 2-D Dense kernels in the JAX
    tree), scores q·k scaled by dim^-0.5, softmax over T, and the weighted
    sum of the values → (B, dim)."""

    def __init__(self, query_dim: int, seq_dim: int, dim: int):
        super().__init__()
        self.dim = dim
        self.query = nn.Linear(query_dim, dim)
        self.key = nn.Linear(seq_dim, dim)
        self.value = nn.Linear(seq_dim, dim)

    def forward(self, query_vec: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
        q = linear(self.query, query_vec)  # (B, D)
        k, v = linear(self.key, seq), linear(self.value, seq)  # (B, T, D)
        scores = torch.einsum("bd,btd->bt", q, k) * (self.dim ** -0.5)
        return torch.einsum("bt,btd->bd", torch.softmax(scores, dim=-1), v)


class MultiHeadSelfAttention(nn.Module):
    """Self-attention over (B, T, D) → (B, T, D), the JAX module's wrapper
    (its parameters nest under ``mha``)."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.0):
        super().__init__()
        self.mha = MultiHeadDotProductAttention(dim, num_heads, dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mha(x)


class TransformerEncoderLayer(nn.Module):
    """torch's post-LN encoder layer as the JAX module writes it:
    x = norm1(x + dropout(attn(x))), then
    x = norm2(x + dropout(linear2(dropout(relu(linear1(x)))))); the layer's
    dropout also drops attention probabilities. ``dim_feedforward``
    defaults to torch's 2048."""

    def __init__(self, dim: int, num_heads: int, dim_feedforward: Optional[int] = None,
                 dropout_rate: float = 0.1):
        super().__init__()
        ff = dim_feedforward or 2048
        self.self_attn = MultiHeadDotProductAttention(dim, num_heads, dropout_rate)
        self.norm1 = LayerNorm(dim)
        self.linear1 = nn.Linear(dim, ff)
        self.linear2 = nn.Linear(ff, dim)
        self.norm2 = LayerNorm(dim)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.dropout(self.self_attn(x)))
        y = self.dropout(F.relu(linear(self.linear1, x)))
        return self.norm2(x + self.dropout(linear(self.linear2, y)))


class TransformerEncoder(nn.Module):
    """A stack of ``TransformerEncoderLayer`` named ``layer{i}``."""

    def __init__(self, dim: int, num_layers: int, num_heads: int,
                 dim_feedforward: Optional[int] = None, dropout_rate: float = 0.1):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(dim, num_heads, dim_feedforward, dropout_rate))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
        return x
