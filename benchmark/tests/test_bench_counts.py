"""The benchmark's counts of work against hand-computed values."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import counts, peaks  # noqa: E402
from benchmark.reference import logmel, vgg_lstm  # noqa: E402

H100 = peaks.PEAKS["H100"]


def test_logmel_work_by_hand():
    nnz = int(np.count_nonzero(logmel.mel_filterbank()))
    ops, nbytes = counts.logmel_work(1)
    assert ops == 126 * (2 * 400 * 2 * 201 + 2 * nnz)
    assert nbytes == 4 * (20000 + 80 * 126 + 400 * 402 + nnz)
    ops32, _ = counts.logmel_work(32)
    assert ops32 == 32 * ops


def test_logmel_bound_at_b32_is_operations_bound_0_0194_ms():
    # chip_smoke.py's logmel_bound_ms(32): 0.0194 ms, bound by operations
    ops, nbytes = counts.logmel_work(32)
    assert ops / H100["fp32_flops"] > nbytes / H100["bytes_per_s"]
    assert abs(counts.logmel_bound_s(32, H100) * 1e3 - 0.0194) < 5e-5


def test_vgg_forward_convolutions_by_hand():
    cfg = {"dataset": {"num_classes": 4, "input_size": 117}}
    h, w, c, conv = 80, 117, 1, 0
    for v in vgg_lstm.VGG16:
        if v == "M":
            h, w = h // 2, w // 2
        else:
            conv += 2 * h * w * c * v * 9
            c = v
    total = counts.reference_flops(vgg_lstm, cfg, vgg_lstm.param_spec(cfg), (torch.zeros(2, 20000, dtype=torch.int16),),
                                   train=False)
    # the rest: the log-mel's two DFT products and its mel product, the
    # BiLSTM's products (2 steps, 2 layers, 2 directions) and the head
    frames = 126
    rest = frames * (2 * 2 * 400 * 201 + 2 * 201 * 80)
    for d in (512, 256):
        rest += 2 * (2 * 2 * d * 512 + 2 * 2 * 128 * 512)
    rest += 2 * 256 * 128 + 2 * 128 * 4
    assert total == 2 * (conv + rest)


def test_grouped_convolution_weight_gradient_counted_per_group():
    x = torch.zeros(2, 8, 10, 10, requires_grad=True)
    wdw = torch.zeros(8, 1, 3, 3, requires_grad=True)
    with counts.flop_counter() as fc:
        torch.nn.functional.conv2d(x, wdw, padding=1, groups=8).sum().backward()
    forward = 2 * 2 * 10 * 10 * 8 * 9
    # forward, input gradient and weight gradient: each one product over a group's channels
    assert fc.get_total_flops() == 3 * forward
