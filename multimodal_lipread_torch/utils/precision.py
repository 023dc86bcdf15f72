"""The precision a model's forward and backward run at.

PyTorch lets cuDNN convolutions and LSTMs run float32 work on TF32 tensor
cores by default (``torch.backends.cudnn.allow_tf32``), which keeps 10
mantissa bits of each input. The JAX package computes a float32 model in
float32, so :func:`model_precision` turns TF32 off for cuDNN and for cuBLAS
matmuls around the forward and backward of a float32 model, and restores
the process's setting afterwards. A bfloat16 model computes in bf16, which
TF32 does not touch, so nothing is changed for it.

:func:`timed_conv_engines` lets cuDNN time its convolution engines on each
new shape inside a block (``torch.backends.cudnn.benchmark``) instead of
taking its heuristic's first pick, unless the caller asked for
``cudnn.deterministic``; the trainer's forward and backward run under it.
cuDNN keeps one choice a shape, dtype and layout for the whole process,
and times only among the engines the block's precision allows: under
:func:`model_precision` a float32 model gets no TF32 engine.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
from torch import nn


def compute_dtype(model: nn.Module) -> torch.dtype:
    """The compute dtype a model declares (its own or a wrapped model's
    ``dtype`` attribute), float32 when none does."""
    for m in model.modules():
        dtype = getattr(m, "dtype", None)
        if isinstance(dtype, torch.dtype):
            return dtype
    return torch.float32


@contextlib.contextmanager
def model_precision(dtype: torch.dtype) -> Iterator[None]:
    """Full float32 (no TF32) for cuDNN and matmuls inside the block when
    ``dtype`` is float32; the previous setting is restored on exit."""
    if dtype != torch.float32:
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


@contextlib.contextmanager
def timed_conv_engines() -> Iterator[None]:
    """cuDNN picks each convolution's engine by timing the candidates on the
    first call of its shape inside the block; only
    ``torch.backends.cudnn.benchmark`` is set, and its previous value is
    restored on exit. Under ``cudnn.deterministic`` the caller's value
    stands: timing could pick other engines in another process, and runs
    that repeat bit for bit need the heuristic's pick."""
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark
    cudnn.benchmark = saved or not cudnn.deterministic
    try:
        yield
    finally:
        cudnn.benchmark = saved
