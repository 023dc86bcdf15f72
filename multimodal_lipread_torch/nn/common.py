"""Common building blocks: adaptive pooling, BatchNorm, dropout, MLPs, the
classifier head and the Flax-style initializers (counterpart of the JAX
package's ``nn/common.py``).

Submodule names follow the JAX modules' (``dense{i}``, ``bn{i}``, ``out``;
``fc1``, ``bn``, ``fc2``) so that ``utils/jax_bridge.py`` maps parameters by
name. Tensors are NCHW / (B, F), PyTorch's layout.

Parameters and buffers stay float32 whatever the compute dtype: a layer
casts its weights to its input's dtype where it uses them (``linear``,
``conv2d``), as a Flax module with ``dtype=bfloat16`` computes in bf16 from
float32 parameters.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# Flax BatchNorm momentum: the weight of the old running value
BN_MOMENTUM = 0.9
BN_EPS = 1e-5
# lecun_normal draws a normal truncated to ±2 standard deviations and
# rescales it by this factor, the standard deviation of that truncated
# normal, so the result has variance 1/fan_in (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            y = F.batch_norm(xf, self.running_mean, self.running_var, self.weight, self.bias,
                             training=False, eps=self.eps)
            return y.to(x.dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=[0] + list(range(2, x.ndim)), correction=0)
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        y = F.batch_norm(xf, None, None, self.weight, self.bias, training=True, eps=self.eps)
        return y.to(x.dtype)


class Dropout(nn.Module):
    """Inverted dropout whose masks come from ``self.generator`` when one
    is set (the trainer sets its own), else from torch's default one."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        if self.generator is None:
            return F.dropout(x, self.rate, True)
        keep = torch.empty_like(x).bernoulli_(1.0 - self.rate, generator=self.generator)
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

    - Conv and Linear weights: lecun-normal, a normal truncated at ±2σ
      scaled to variance 1/fan_in; biases 0;
    - BatchNorm: scale 1, bias 0, running mean 0, running variance 1;
    - LSTM weights and biases: uniform on ±1/√H (``nn/recurrent.py`` of the
      JAX package).

    Modules are visited in registration order, so one seed gives one set
    of weights.
    """

    def draw(p: torch.Tensor, fill) -> None:
        p.copy_(fill(torch.empty(p.shape, dtype=torch.float32)))

    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            draw(m.weight, lambda t: nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator).mul_(std))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, nn.LSTM):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for w in m._flat_weights:
                draw(w, lambda t: t.uniform_(-bound, bound, generator=generator))
    return module
