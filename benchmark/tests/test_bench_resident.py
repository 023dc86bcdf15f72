"""The resident train cell, ``video_resnet_trans.crop_train``, on the CPU at
a small size: unbroken it is correct, traced it reports its per-layer
metrics and the result line's keys; with a fault planted in the program, a
crop box shifted by 2 pixels or one step of each group left out, it is not
correct; the control's variants are not correct either; each of the cell's
metric readers returns None where a run gives it nothing to read; and the
crop's byte count is ``chip_smoke.crop_bound``'s."""

import os
import sys
import time
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import checks, harness  # noqa: E402
from benchmark.drivers import train_resident  # noqa: E402

CELL = "video_resnet_trans.crop_train"
TINY = {"config": {"training": {"batch_size": 2, "steps_per_dispatch": 2}},
        "mix": {"clips": 8, "frames": 3, "frame_size": 48}}
SEED = 2**31 + 303
SPEC = harness.load_spec(ROOT)


def run(trace=False):
    return harness.run_cell(CELL, SEED, 1.0, trace, "cpu", overrides=TINY)


@pytest.fixture(scope="module")
def sound():
    return run()


def test_the_unbroken_run_is_correct(sound):
    assert sound["correct"] is True and sound["failed"] == 0
    assert set(sound["metrics"]) == {"train_clips_per_s", "setup_s"}
    assert sound["checks"]["rows_wrong"]["value"] == 0


def test_a_traced_run_reports_the_cells_metrics():
    result = run(trace=True)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert result["correct"] is True
    expected = {m["name"] for m in harness.cell_metrics(SPEC, CELL, trace=True)}
    assert {"crop_roofline.crop_train", "mfu.crop_train", "device.idle.crop_train",
            "trainer.group_host_ms.crop_train"} <= expected
    # the CPU has no crop kernel and no peaks; the idle share and the program's spans are there
    assert set(result["metrics"]) == {"device.idle.crop_train", "trainer.group_host_ms.crop_train"}


def _shifted_box(monkeypatch):
    from multimodal_lipread_torch.ops import crop_resize_cuda

    crop = crop_resize_cuda.device_crop

    def shifted(frames, boxes):
        shift = torch.tensor([2, 0, 2, 0], dtype=boxes.dtype, device=boxes.device)
        return crop(frames, (boxes + shift).clamp_max(frames.shape[-2]))

    monkeypatch.setattr(crop_resize_cuda, "device_crop", shifted)


def _dropped_step(monkeypatch):
    from multimodal_lipread_torch.train.trainer import Trainer

    run_group = Trainer._run_group

    def dropped(self, kind, ds, step, idxs, ws):
        if kind != "train":
            return run_group(self, kind, ds, step, idxs, ws)
        stats = run_group(self, kind, ds, step, idxs[:-1], ws[:-1])
        return torch.cat([stats, stats[-1:]])

    monkeypatch.setattr(Trainer, "_run_group", dropped)


CASES = [(_shifted_box, "loss_gap"), (_shifted_box, "window_loss_gap"), (_dropped_step, "window_delta_gap"),
         (_dropped_step, "window_losses_gap")]


@pytest.mark.parametrize("fault,number", CASES, ids=[f"{f.__name__[1:]}-{n}" for f, n in CASES])
def test_fault_comes_out_not_correct(sound, monkeypatch, fault, number):
    value, limit = sound["checks"][number]["value"], sound["checks"][number]["limit"]
    assert value <= limit, f"the unbroken run already fails {number}: {value} > {limit}"
    fault(monkeypatch)
    broken = run()
    assert broken["correct"] is False
    assert broken["checks"][number]["value"] > broken["checks"][number]["limit"]


@pytest.mark.parametrize("variant", ["shifted_box", "dropped_step"])
def test_control_variants_come_out_not_correct(variant):
    cell = harness.find_cell(SPEC, CELL)
    ctx = harness.Context(SPEC, cell, SEED, 1.0, False, torch.device("cpu"), time.perf_counter(), overrides=TINY)
    try:
        numbers = train_resident.control(ctx, variant)
    finally:
        ctx.close()
    correct, rows = checks.judge(numbers, ctx.limits)
    assert not correct, rows


class _Trace:
    window_s, busy_s = 2.0, 1.0
    op_seconds = {"void other_kernel()": 0.5}


def _view(**kw):
    base = {"trace": None, "steps": 0, "batch": 2, "window_s": 1.0, "flops_per_step": lambda: 1.0, "peaks": None,
            "cell": CELL, "crop_bound_s": lambda peaks: 1e-3}
    return types.SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("metric", ["crop_roofline.crop_train", "mfu.crop_train", "device.idle.crop_train",
                                    "trainer.group_host_ms.crop_train"])
def test_readers_return_none_with_nothing_to_read(metric):
    read = harness.load_reader(metric)
    assert read(_view()) is None  # an untraced run
    peaks = {"fp32_flops": 67e12, "bytes_per_s": 3.35e12}
    if metric == "crop_roofline.crop_train":
        assert read(_view(trace=_Trace(), steps=4, peaks=peaks)) is None  # no crop kernel in the trace
        assert read(_view(trace=_Trace(), steps=4, peaks=peaks, crop_bound_s=None)) is None
        kernel = type("T", (_Trace,), {"op_seconds": {"void crop_resize_pad_kernel<3, false>()": 4e-3}})()
        assert read(_view(trace=kernel, steps=4, peaks=peaks)) == pytest.approx(25.0)
    if metric == "mfu.crop_train":
        assert read(_view(trace=_Trace(), steps=4)) is None  # a card the peaks table does not hold


def test_crop_bytes_are_chip_smokes_crop_bound():
    """``crop_counts`` on the reference's sampling counts what
    ``chip_smoke.crop_bound`` counts on the program's, on its box cases."""
    import numpy as np

    import chip_smoke
    from benchmark import crop_counts

    boxes = torch.from_numpy(chip_smoke.crop_boxes(np.random.default_rng(5), 464, 256, 256))
    _ms, _kind, nbytes = chip_smoke.crop_bound((464, 256, 256, 3), boxes, False)
    assert crop_counts.launch_bytes(int(crop_counts.frame_bytes(boxes, 256, 256).sum()), 464) == nbytes
