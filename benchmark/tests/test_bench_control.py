"""The control of ``correct`` on the card: the plain reference computed with
TF32 on, put in the program's place, comes out not correct in every cell,
at the cell's widths and batch (a serve cell's pool and window are cut to
what a test run holds). TF32 exists on the card only, so these tests skip
elsewhere."""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import checks, control, harness  # noqa: E402

SPEC = harness.load_spec(ROOT)
SMALL = {"audio_vgg_lstm.serve": {"mix": {"pool": 64, "rate_per_s": 20.0, "check_requests": 8}}}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_tf32_control_comes_out_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control computes in TF32, which only a CUDA card has")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ctx = harness.Context(SPEC, harness.find_cell(SPEC, cell), 2**31 + 911, 2.0, False, torch.device("cuda"),
                          time.perf_counter(), overrides=SMALL.get(cell))
    try:
        kind = ctx.mix["kind"]
        numbers = control.train_control(ctx, "tf32") if kind == "train" else control.serve_control(ctx, "tf32")
    finally:
        ctx.close()
    judged = {k: v for k, v in numbers.items() if k in ctx.limits}
    correct, rows = checks.judge(judged, ctx.limits)
    assert not correct, rows
