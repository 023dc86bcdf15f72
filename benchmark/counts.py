"""The benchmark's own counts of work: the log-mel's operations and bytes
for a launch of ``batch`` clips, and the FLOPs of the plain reference's
forward (and backward) at a cell's shapes."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import logmel as ref_logmel


def logmel_work(batch: int) -> tuple:
    """(operations, bytes) the log-mel needs for ``batch`` clips: the real
    DFT at 201 frequencies (a multiply and an add per sample, frequency and
    half) and the mel product over the filterbank's nonzero weights, both
    per frame; each waveform read and each (80, 126) map written once, and
    the DFT basis and the nonzero mel weights read once a launch."""
    nnz = int(np.count_nonzero(ref_logmel.mel_filterbank()))
    frames = ref_logmel.NUM_FRAMES
    ops = batch * frames * (2 * ref_logmel.N_FFT * 2 * ref_logmel.N_FREQS + 2 * nnz)
    nbytes = 4 * (batch * (ref_logmel.NUM_SAMPLES + ref_logmel.N_MELS * frames)
                  + ref_logmel.N_FFT * 2 * ref_logmel.N_FREQS + nnz)
    return ops, nbytes


def logmel_bound_s(batch: int, peaks: dict) -> float:
    """The least time the card could take: the larger of the operations at
    the float32 peak and the bytes at the memory bandwidth."""
    ops, nbytes = logmel_work(batch)
    return max(ops / peaks["fp32_flops"], nbytes / peaks["bytes_per_s"])


def flop_counter():
    """``FlopCounterMode`` with a grouped convolution's weight gradient
    counted per group (its own formula counts the full product over the
    channels, ``groups`` times too many for a depthwise convolution)."""
    import torch.utils.flop_counter as fc

    def conv_backward(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed,
                      output_padding, groups, output_mask, out_shape, **_):
        args = (grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed, output_padding, groups)
        total = fc.conv_backward_flop(*args, output_mask, out_val=out_shape)
        if groups == 1 or not output_mask[1]:
            return total
        weight = fc.conv_backward_flop(*args, [False, True, False], out_val=out_shape)
        return total - weight + weight // groups

    return fc.FlopCounterMode(display=False, custom_mapping={torch.ops.aten.convolution_backward: conv_backward})


def reference_flops(module, cfg: dict, spec: dict, example_inputs: tuple, train: bool) -> int:
    """FLOPs of the reference's forward (and, with ``train``, the backward
    to every parameter) on ``example_inputs``, counted on the CPU; no
    recompute is counted, since the reference recomputes nothing. Shapes
    alone decide the count, so it runs on the ``meta`` device."""
    params = {n: torch.empty(shape, device="meta", requires_grad=train and kind not in ("bn_mean", "bn_var"))
              for n, (shape, kind, _f) in spec.items()}
    example_inputs = tuple(x.to("meta") for x in example_inputs)
    counter = flop_counter()
    with counter:
        logits = module.forward(params, cfg, example_inputs, train, None)
        if train:
            torch.autograd.grad(logits.float().logsumexp(-1).sum(), [p for p in params.values() if p.requires_grad])
    return int(counter.get_total_flops())
