"""Plain layers over a flat parameter dict (``name → tensor``); the names
are the ``state_dict`` keys of the program's modules, so one set of weights
made by the benchmark loads into both."""

from __future__ import annotations

import wave as wave_mod
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def read_wav(path: str, samples: int = 20000) -> np.ndarray:
    """A mono PCM16 WAV → int16 (``samples``,), zero-padded or cut."""
    with wave_mod.open(path, "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError(f"{path}: not mono PCM16")
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    out = np.zeros(samples, np.int16)
    out[: min(samples, pcm.size)] = pcm[:samples]
    return out


def linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[f"{name}.weight"].t() + p[f"{name}.bias"]


def conv(p: Params, name: str, x: torch.Tensor, stride: int = 1, groups: int = 1) -> torch.Tensor:
    w = p[f"{name}.weight"]
    return F.conv2d(x, w, p.get(f"{name}.bias"), stride, (w.shape[-1] - 1) // 2, 1, groups)


def batch_norm(p: Params, name: str, x: torch.Tensor, train: bool, eps: float) -> torch.Tensor:
    """Flax's BatchNorm over dim 1: the batch's mean and biased variance in
    training, the running statistics in evaluation."""
    dims = [0] + list(range(2, x.ndim))
    shape = [1, -1] + [1] * (x.ndim - 2)
    if train:
        var, mean = torch.var_mean(x, dim=dims, correction=0)
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    scale = p[f"{name}.weight"] / torch.sqrt(var + eps)
    return (x - mean.view(shape)) * scale.view(shape) + p[f"{name}.bias"].view(shape)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator], train: bool) -> torch.Tensor:
    """Inverted dropout, the keep mask one Bernoulli draw of ``x``'s shape
    from ``generator``: the trainer's rule (one generator seeded with the
    training seed + 1, one draw per dropout layer in forward order)."""
    if not train or rate <= 0.0:
        return x
    keep = torch.empty(x.shape, dtype=x.dtype, device=x.device).bernoulli_(1.0 - rate, generator=generator)
    return x * keep / (1.0 - rate)


def _lstm_direction(x: torch.Tensor, w_ih, w_hh, b_ih, b_hh, reverse: bool) -> torch.Tensor:
    """One LSTM direction over (B, T, D): gates i, f, g, o; c = f·c + i·g,
    h = o·tanh(c), from zero states."""
    b, t, _ = x.shape
    hidden = w_hh.shape[1]
    xs = x @ w_ih.t() + (b_ih + b_hh)
    h = x.new_zeros(b, hidden)
    c = x.new_zeros(b, hidden)
    outs = [None] * t
    for step in (range(t - 1, -1, -1) if reverse else range(t)):
        i, f, g, o = (xs[:, step] + h @ w_hh.t()).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs[step] = h
    return torch.stack(outs, dim=1)


def bilstm(p: Params, name: str, x: torch.Tensor, layers: int) -> torch.Tensor:
    """A bidirectional stack over (B, T, D) → (B, T, 2H), ``nn.LSTM``'s
    parameter names; no dropout between layers."""
    for layer in range(layers):
        dirs = []
        for suffix, reverse in (("", False), ("_reverse", True)):
            args = [p[f"{name}.{k}_l{layer}{suffix}"] for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
            dirs.append(_lstm_direction(x, *args, reverse=reverse))
        x = torch.cat(dirs, dim=-1)
    return x


def lstm_spec(name: str, input_size: int, hidden: int, layers: int) -> Dict[str, tuple]:
    """``nn.LSTM(bidirectional=True)``'s parameters: name → (shape, kind, fan_in)."""
    spec = {}
    for layer in range(layers):
        d = input_size if layer == 0 else 2 * hidden
        for suffix in ("", "_reverse"):
            spec[f"{name}.weight_ih_l{layer}{suffix}"] = ((4 * hidden, d), "lstm", hidden)
            spec[f"{name}.weight_hh_l{layer}{suffix}"] = ((4 * hidden, hidden), "lstm", hidden)
            spec[f"{name}.bias_ih_l{layer}{suffix}"] = ((4 * hidden,), "lstm", hidden)
            spec[f"{name}.bias_hh_l{layer}{suffix}"] = ((4 * hidden,), "lstm", hidden)
    return spec


def conv_spec(name: str, cin: int, cout: int, k: int, groups: int = 1, bias: bool = True) -> Dict[str, tuple]:
    fan_in = cin // groups * k * k
    spec = {f"{name}.weight": ((cout, cin // groups, k, k), "weight", fan_in)}
    if bias:
        spec[f"{name}.bias"] = ((cout,), "bias", fan_in)
    return spec


def linear_spec(name: str, din: int, dout: int) -> Dict[str, tuple]:
    return {f"{name}.weight": ((dout, din), "weight", din), f"{name}.bias": ((dout,), "bias", din)}


def bn_spec(name: str, c: int) -> Dict[str, tuple]:
    return {f"{name}.weight": ((c,), "bn_weight", 1), f"{name}.bias": ((c,), "bn_bias", 1),
            f"{name}.running_mean": ((c,), "bn_mean", 1), f"{name}.running_var": ((c,), "bn_var", 1)}


def buffers(spec: Dict[str, tuple]) -> Sequence[str]:
    """The names that are statistics, not parameters."""
    return [n for n, (_s, kind, _f) in spec.items() if kind in ("bn_mean", "bn_var")]
