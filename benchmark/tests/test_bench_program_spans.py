"""The per-layer metrics that read the program's own spans and counters
(``multimodal_lipread_torch/utils/trace.py``): a traced run of each cell on
the CPU at a small size reports all of them, the served padding share
equals the one the schedule gives, and every reader gives nothing (and
raises nothing) where the program has no such module, recorded no session
or lacks its span or counter."""

import importlib
import os
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.drivers import serve  # noqa: E402

TINY = {
    "audio_vgg_lstm.train": {"config": {"training": {"batch_size": 4}, "dataset": {"num_workers": 2}},
                             "mix": {"clips": 12}},
    "audio_vgg_lstm.serve": {"mix": {"pool": 12, "rate_per_s": 3.0, "clips_max": 4, "batch_size": 4,
                                     "check_requests": 3, "workers": 2}},
}
SEED = 2**31 + 29
SPEC = harness.load_spec(ROOT)
PROGRAM = {
    "audio_vgg_lstm.train": ["trainer.forward_host_ms.train", "trainer.backward_host_ms.train",
                             "trainer.optimizer_host_ms.train", "loader.waited_share.train",
                             "loader.native_wait_ms.train"],
    "audio_vgg_lstm.serve": ["serve.pad_share", "serve.decode_ms", "serve.h2d_ms", "serve.launch_ms",
                             "serve.device_wait_ms"],
}
READERS = [name for names in PROGRAM.values() for name in names]


def test_the_spec_names_each_reader_for_its_one_cell():
    by_name = {m["name"]: m for m in SPEC["per_layer"]}
    for cell, names in PROGRAM.items():
        for name in names:
            assert by_name[name]["workloads"] == [cell]
            assert by_name[name]["source"] in ("program_span", "program_counter")


@pytest.mark.parametrize("cell", list(PROGRAM))
def test_a_traced_run_reports_the_programs_metrics(cell):
    result = harness.run_cell(cell, SEED, 1.0, True, "cpu", overrides=TINY[cell])
    assert result["correct"], result["checks"]
    metrics = {n: m["value"] for n, m in result["metrics"].items()}
    assert set(PROGRAM[cell]) <= set(metrics)
    for name in PROGRAM[cell]:
        assert metrics[name] >= 0.0, name
    if cell == "audio_vgg_lstm.train":
        assert 0.0 <= metrics["loader.waited_share.train"] <= 100.0
        return
    mix = harness._merge(harness.load_json("traffic", "open_poisson"), TINY[cell]["mix"])
    due, ids = serve.schedule(mix, SEED, 1.0)
    assert result["failed"] == 0 and result["attempted"] == len(due)
    clips = sum(len(i) for i in ids)
    assert metrics["serve.pad_share"] == pytest.approx(100.0 * (1.0 - clips / (mix["batch_size"] * len(due))))


@pytest.mark.parametrize("name", READERS)
def test_a_reader_gives_nothing_without_the_programs_module(name, monkeypatch):
    import multimodal_lipread_torch.utils as utils

    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "multimodal_lipread_torch.utils.trace", None)
    with pytest.raises(ImportError):
        importlib.import_module("multimodal_lipread_torch.utils.trace")
    assert harness.load_reader(name)(types.SimpleNamespace(trace=object())) is None


@pytest.mark.parametrize("session", [None, {"spans": [], "counters": {}}], ids=["no_session", "empty"])
@pytest.mark.parametrize("name", READERS)
def test_a_reader_gives_nothing_without_its_span_or_counter(name, session, monkeypatch):
    from multimodal_lipread_torch.utils import trace

    monkeypatch.setattr(trace, "last_session", lambda: session)
    assert harness.load_reader(name)(types.SimpleNamespace(trace=object())) is None
    assert harness.load_reader(name)(types.SimpleNamespace(trace=None)) is None
