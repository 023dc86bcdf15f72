"""Common building blocks: time-distributed application, adaptive pooling,
BatchNorm, LayerNorm, dropout, MLPs, the classifier head and the
Flax-style initializers (counterpart of the JAX package's
``nn/common.py``).

Submodule names follow the JAX modules' (``dense{i}``, ``bn{i}``, ``out``;
``fc1``, ``bn``, ``fc2``) so that ``utils/jax_bridge.py`` maps parameters by
name. Tensors are NCHW / (B, F), PyTorch's layout.

Parameters and buffers stay float32 whatever the compute dtype: a layer
casts its weights to its input's dtype where it uses them (``linear``,
``conv1d``, ``conv2d``), as a Flax module with ``dtype=bfloat16`` computes
in bf16 from float32 parameters.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# Flax BatchNorm momentum: the weight of the old running value
BN_MOMENTUM = 0.9
BN_EPS = 1e-5
# Flax nn.LayerNorm's default epsilon (torch's is 1e-5)
LN_EPS = 1e-6
# lecun_normal draws a normal truncated to ±2 standard deviations and
# rescales it by this factor, the standard deviation of that truncated
# normal, so the result has variance 1/fan_in (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


def time_distributed(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Apply ``fn`` per frame: (B, T, ...) → (B, T, F...), as one call on
    the (B·T, ...) reshape."""
    b, t = x.shape[:2]
    out = fn(x.reshape((b * t,) + x.shape[2:]))
    return out.reshape((b, t) + out.shape[1:])


def adaptive_avg_pool2d(x: torch.Tensor, output_size: Sequence[Optional[int]]) -> torch.Tensor:
    """torch.nn.AdaptiveAvgPool2d on an NCHW tensor; a ``None`` entry of
    ``output_size`` keeps that dimension. Bin boundaries are torch's:
    start = floor(i*L/out), end = ceil((i+1)*L/out)."""
    h, w = x.shape[-2:]
    oh = h if output_size[0] is None else int(output_size[0])
    ow = w if output_size[1] is None else int(output_size[1])
    return F.adaptive_avg_pool2d(x, (oh, ow))


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` applied in ``x``'s dtype (float32 weights cast to it)."""
    return F.linear(x, layer.weight.to(x.dtype), _cast(layer.bias, x.dtype))


def conv1d(layer: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``layer`` applied in ``x``'s dtype (float32 weights cast to it)."""
    return F.conv1d(x, layer.weight.to(x.dtype), _cast(layer.bias, x.dtype),
                    layer.stride, layer.padding, layer.dilation, layer.groups)


def conv2d(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``layer`` applied in ``x``'s dtype (float32 weights cast to it)."""
    return F.conv2d(x, layer.weight.to(x.dtype), _cast(layer.bias, x.dtype),
                    layer.stride, layer.padding, layer.dilation, layer.groups)


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over dim 1 of a
    (B, C) or (B, C, ...) tensor.

    Training normalizes with the batch mean and the biased batch variance
    and updates ``running ← 0.9 · running + 0.1 · batch`` for both, the
    variance biased too (torch's BatchNorm would use the unbiased one);
    evaluation normalizes with the running statistics. Statistics and
    normalization run in float32 (or wider) and the result comes back in
    the input's dtype, as Flax's with ``dtype=bfloat16``. No ``num_batches_tracked``:
    Flax keeps none.

    ``group`` (set by a data-parallel trainer, ``None`` otherwise) takes the
    batch statistics over the global batch, as the JAX mesh does under
    GSPMD: per-channel sums and counts are all-reduced for the mean, then
    the squared deviations for the variance, both through a differentiable
    ``all_reduce`` so that the backward sees the global statistics too.
    ``nn.SyncBatchNorm`` is not used: it refuses CPU tensors.
    """

    def __init__(self, num_features: int, momentum: float = BN_MOMENTUM, eps: float = BN_EPS):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            y = F.batch_norm(xf, self.running_mean, self.running_var, self.weight, self.bias,
                             training=False, eps=self.eps)
            return y.to(x.dtype)
        if self.group is not None:
            return self._global_batch_norm(xf).to(x.dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=[0] + list(range(2, x.ndim)), correction=0)
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        y = F.batch_norm(xf, None, None, self.weight, self.bias, training=True, eps=self.eps)
        return y.to(x.dtype)

    def _global_batch_norm(self, xf: torch.Tensor) -> torch.Tensor:
        from multimodal_lipread_torch.parallel.mesh import all_reduce_sum

        dims = [0] + list(range(2, xf.ndim))
        shape = [1, -1] + [1] * (xf.ndim - 2)
        count = xf.new_full((1,), xf.numel() // xf.shape[1])
        sums = all_reduce_sum(torch.cat([xf.sum(dims), count]), self.group)
        n = sums[-1]
        mean = sums[:-1] / n
        dev = xf - mean.view(shape)
        var = all_reduce_sum((dev * dev).sum(dims), self.group) / n
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        return dev * torch.rsqrt(var + self.eps).view(shape) * self.weight.view(shape) + self.bias.view(shape)


class LayerNorm(nn.Module):
    """Flax's ``nn.LayerNorm(epsilon=eps)`` over the last dimension (Flax's
    default epsilon 1e-6; BERT takes 1e-12), statistics and normalization in
    float32 (or wider), the result in the input's dtype; scale 1 and bias 0
    at initialization. The variance is taken in two passes (Flax: E[x²] −
    E[x]², which loses digits where the mean is far larger than the
    spread)."""

    def __init__(self, num_features: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        return F.layer_norm(xf, self.weight.shape, self.weight, self.bias, self.eps).to(x.dtype)


class Embedding(nn.Embedding):
    """Flax's ``nn.Embed``: a (num_embeddings, features) float32 table
    looked up by integer ids (int32 or int64), the rows returned in
    ``dtype`` when one is given (Flax's ``dtype=``)."""

    def forward(self, ids: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        rows = F.embedding(ids, self.weight)
        return rows if dtype is None else rows.to(dtype)


class Dropout(nn.Module):
    """Inverted dropout whose masks come from ``self.generator`` when one
    is set (the trainer sets its own), else from torch's default one.

    ``broadcast_dims`` share one mask along those dimensions (Flax's
    ``nn.Dropout(broadcast_dims=...)``).

    ``data_shard`` = (index, count), set by a data-parallel trainer: ``x``
    is the ``index``-th of ``count`` equal slices of a global batch along
    dim 0 (batch-major, so a (B·T, ...) reshape counts too), and the mask
    is drawn for the global batch and sliced, so that every rank applies
    the masks of the one-rank run."""

    def __init__(self, rate: float, broadcast_dims: Sequence[int] = ()):
        super().__init__()
        self.rate = rate
        self.broadcast_dims = tuple(broadcast_dims)
        self.generator: Optional[torch.Generator] = None
        self.data_shard = (0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        if self.generator is None and not self.broadcast_dims:
            return F.dropout(x, self.rate, True)
        shape = [1 if d in self.broadcast_dims else n for d, n in enumerate(x.shape)]
        index, count = self.data_shard
        global_rows = count > 1 and 0 not in self.broadcast_dims
        if global_rows:
            shape[0] *= count
        keep = x.new_empty(shape).bernoulli_(1.0 - self.rate, generator=self.generator)
        if global_rows:
            keep = keep.narrow(0, index * x.shape[0], x.shape[0])
        return x * keep / (1.0 - self.rate)


class MLP(nn.Module):
    """Linear → [BatchNorm] → ReLU → Dropout stack with a final Linear."""

    def __init__(
        self,
        in_features: int,
        hidden_sizes: Sequence[int],
        num_outputs: int,
        dropout_rate: float = 0.0,
        use_batchnorm: bool = False,
    ):
        super().__init__()
        self.hidden_sizes = tuple(hidden_sizes)
        self.dropout_rate = dropout_rate
        self.use_batchnorm = use_batchnorm
        d = in_features
        for i, h in enumerate(self.hidden_sizes):
            self.add_module(f"dense{i}", nn.Linear(d, h))
            if use_batchnorm:
                self.add_module(f"bn{i}", BatchNorm(h))
            d = h
        self.out = nn.Linear(d, num_outputs)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.hidden_sizes)):
            x = linear(getattr(self, f"dense{i}"), x)
            if self.use_batchnorm:
                x = getattr(self, f"bn{i}")(x)
            x = self.dropout(F.relu(x))
        return linear(self.out, x)


class ClassifierHead(nn.Module):
    """The recurring Linear → BN → ReLU → Dropout → Linear classifier."""

    def __init__(
        self,
        in_features: int,
        hidden_size: int,
        num_classes: int,
        dropout_rate: float = 0.5,
        use_batchnorm: bool = True,
    ):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_size)
        self.bn = BatchNorm(hidden_size) if use_batchnorm else None
        self.dropout = Dropout(dropout_rate)
        self.fc2 = nn.Linear(hidden_size, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = linear(self.fc1, x)
        if self.bn is not None:
            x = self.bn(x)
        x = self.dropout(F.relu(x))
        return linear(self.fc2, x)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every parameter of ``module`` as Flax's defaults would, in
    place, from ``generator`` (a CPU generator; values are drawn on the CPU
    and copied to the parameters' device):

    - Conv (1-D, 2-D, grouped) and Linear weights: lecun-normal, a normal
      truncated at ±2σ scaled to variance 1/fan_in, where fan_in is one
      output's inputs (``weight[0].numel()``: (I/groups)·kh·kw for a conv,
      D for the attention's query/key/value, heads·head_dim for its
      output); biases 0, or a Linear's ``flax_bias_init`` where it sets one
      (Flax's ``bias_init=constant(...)``);
    - Embedding tables: Flax's embed init, variance-scaling 1.0 over the
      feature axis with a truncated normal, which is the same law (fan_in =
      features = ``weight[0].numel()``);
    - BatchNorm: scale 1, bias 0, running mean 0, running variance 1;
    - LayerNorm: scale 1, bias 0;
    - LSTM weights and biases: uniform on ±1/√H (``nn/recurrent.py`` of the
      JAX package).

    Modules are visited in registration order, so one seed gives one set
    of weights. A module of stacked layers (one with ``fresh_layer()`` and
    parameters whose leading axis is the layer, e.g. the pipelined BERT's
    ``encoder``) draws each layer in turn as that unstacked layer, so it
    starts from the weights of the per-layer model from the same seed.
    """

    def draw(p: torch.Tensor, fill) -> None:
        p.copy_(fill(torch.empty(p.shape, dtype=torch.float32)))

    inside_stacks: set = set()
    for m in module.modules():
        if id(m) in inside_stacks:
            continue
        if hasattr(m, "fresh_layer"):
            inside_stacks.update(id(c) for c in m.modules())
            stacked = dict(m.named_parameters())
            for i in range(next(iter(stacked.values())).shape[0]):
                layer = flax_init_(m.fresh_layer(), generator)
                for name, p in layer.named_parameters():
                    stacked[name][i].copy_(p)
            continue
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear, nn.Embedding)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            draw(m.weight, lambda t: nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator).mul_(std))
            if getattr(m, "bias", None) is not None:
                m.bias.fill_(getattr(m, "flax_bias_init", 0.0))
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.LSTM):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for w in m._flat_weights:
                draw(w, lambda t: t.uniform_(-bound, bound, generator=generator))
    return module
