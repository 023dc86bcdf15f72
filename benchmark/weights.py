"""Weights made by the benchmark from the seed, on the device, in one draw:
every tensor of a reference's parameter spec is a slice of one normal
vector from a ``torch.Generator`` on the device, scaled by its kind.
Both the program and the reference take these; neither makes its own."""

from __future__ import annotations

import math
from typing import Dict

import torch


def make(spec: Dict[str, tuple], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """``spec``: name → (shape, kind, fan_in). Convolution and linear
    weights He-normal (std √(2 / fan_in)), biases 0.01 N, LSTM tensors
    N(0, 1 / (3H)) (the variance of uniform ±1/√H), BatchNorm scales
    1 + 0.1 N and shifts 0.1 N, running means 0.1 N and variances
    1 + 0.1 |N|: eval-mode activations stay of order one through every
    layer, so every weight matters to the logits."""
    total = sum(math.prod(shape) for shape, _k, _f in spec.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, (shape, kind, fan_in) in spec.items():
        n = math.prod(shape)
        x = z[at : at + n].view(shape)
        at += n
        if kind == "weight":
            t = x * math.sqrt(2.0 / fan_in)
        elif kind == "bias":
            t = x * 0.01
        elif kind == "lstm":
            t = x / math.sqrt(3.0 * fan_in)
        elif kind == "bn_weight":
            t = 1.0 + 0.1 * x
        elif kind in ("bn_bias", "bn_mean"):
            t = 0.1 * x
        elif kind == "bn_var":
            t = 1.0 + 0.1 * x.abs()
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
        out[name] = t.contiguous()
    return out
