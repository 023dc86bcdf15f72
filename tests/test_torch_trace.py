"""The port's spans and counters (``utils/trace.py``) on the CPU: nothing
recorded or kept with the profiler off; nesting, request ids and threads
under it; one session per traced window; the spans on the clock of the
profiler's own events. Then the layers that carry them: the train step's
phases and the loader's waits (threaded and inline, streamed from the
native prefetcher, in graphed groups and in a ``training.profile_dir``
trace), and the predictor's request with its padding counted."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_parity_utils import one_torch_thread  # noqa: F401 (autouse)

from multimodal_lipread_torch import serving
from multimodal_lipread_torch.data.glips import scan_glips
from multimodal_lipread_torch.data.grain_loader import NativeStreamingDataset
from multimodal_lipread_torch.nn.common import MLP
from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig
from multimodal_lipread_torch.utils import trace

NUM_CLASSES = 4


def _traced():
    return profile(activities=[ProfilerActivity.CPU])


def _names(session, name):
    return [s for s in session["spans"] if s["name"] == name]


def test_off_records_nothing_and_keeps_no_session():
    assert not torch.autograd.profiler._is_profiler_enabled
    before = trace._session
    kept = trace.last_session()
    with trace.span("off.outer", new_request=True, rows=3) as s:
        assert s is None
        with trace.span("off.inner"):
            trace.count("off.count", 5)
    assert trace._session is before
    assert trace.last_session() == kept
    assert getattr(trace._local, "stack", []) == []


def test_spans_nest_and_share_their_request():
    with _traced():
        with trace.span("outer", new_request=True, rows=2):
            with trace.span("middle"):
                with trace.span("inner"):
                    trace.count("hits")
                trace.count("hits", 2)
        with trace.span("alone"):
            pass
    session = trace.last_session()
    (outer,), (middle,), (inner,), (alone,) = (_names(session, n) for n in ("outer", "middle", "inner", "alone"))
    assert outer["parent"] is None and middle["parent"] == outer["id"] and inner["parent"] == middle["id"]
    assert outer["request"] == middle["request"] == inner["request"] == outer["id"]
    assert alone["parent"] is None and alone["request"] is None
    assert outer["attrs"] == {"rows": 2} and inner["attrs"] == {}
    assert outer["start_ns"] <= middle["start_ns"] <= inner["start_ns"] < inner["end_ns"] <= outer["end_ns"]
    assert session["counters"] == {"hits": 3}


def test_threads_keep_their_own_stacks_and_requests():
    barrier = threading.Barrier(4)

    def serve(tid):
        for _ in range(5):
            with trace.span("t.request", new_request=True, tid=tid):
                barrier.wait(timeout=30)
                with trace.span("t.child", tid=tid):
                    barrier.wait(timeout=30)
                    trace.count("t.children")

    with _traced():
        threads = [threading.Thread(target=serve, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    session = trace.last_session()
    requests = {s["id"]: s for s in _names(session, "t.request")}
    children = _names(session, "t.child")
    assert len(requests) == 20 and len(children) == 20
    assert session["counters"] == {"t.children": 20}
    for child in children:
        parent = requests[child["parent"]]
        assert child["request"] == parent["id"] and child["attrs"] == parent["attrs"]
        assert child["thread"] == parent["thread"]
    assert len({s["thread"] for s in requests.values()}) == 4


def test_each_window_is_its_own_session():
    with _traced():
        with trace.span("first"):
            trace.count("first.count")
    first = trace.last_session()
    with _traced():
        with trace.span("second"):
            trace.count("second.count")
    second = trace.last_session()
    assert [s["name"] for s in first["spans"]] == ["first"] and first["counters"] == {"first.count": 1}
    assert [s["name"] for s in second["spans"]] == ["second"] and second["counters"] == {"second.count": 1}


def test_storage_is_bounded(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with _traced():
        for _ in range(5):
            with trace.span("many"):
                pass
    session = trace.last_session()
    assert len(session["spans"]) == 3 and session["counters"] == {"trace.spans_dropped": 2}


def test_spans_share_the_profilers_clock():
    with _traced() as prof:
        with trace.span("clock.outer"):
            torch.ones(64).sum()
            with trace.span("clock.inner"):
                torch.ones(64).cumsum(0)
    session = trace.last_session()
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name().startswith("clock.")}
    assert set(events) == {"clock.outer", "clock.inner"}
    for s in session["spans"]:
        e = events[s["name"]]
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        assert s["start_ns"] <= start + 1_000_000 and end <= s["end_ns"] + 1_000_000, (s, start, end)
        assert s["start_ns"] - 1_000_000 <= start and end - 1_000_000 <= s["end_ns"]


# --- the layers -----------------------------------------------------------


def _dataset(n, seed=0, dim=12):
    rng = np.random.default_rng(seed)
    return ArrayDataset((rng.standard_normal((n, dim)).astype(np.float32),), rng.integers(0, NUM_CLASSES, n))


def _trainer(tmp_path, **cfg):
    model = MLP(12, (16,), NUM_CLASSES, dropout_rate=0.0, use_batchnorm=True)
    config = TrainerConfig(model_name="m", num_classes=NUM_CLASSES, batch_size=8, learning_rate=1e-2, seed=3,
                           metrics_dir=str(tmp_path / "metrics"), checkpoints_dir=str(tmp_path / "ckpt"),
                           **{"epochs": 1, "test_every_epoch": False, **cfg})
    return Trainer(model, config, device="cpu")


def _assert_steps(session, steps):
    step_spans = _names(session, "trainer.step")
    assert len(step_spans) == steps
    ids = {s["id"] for s in step_spans}
    for phase in ("trainer.forward", "trainer.backward", "trainer.optimizer"):
        spans = _names(session, phase)
        assert len(spans) == steps and {s["parent"] for s in spans} == ids, phase
    return step_spans


@pytest.mark.parametrize("prefetch", [0, 2], ids=["inline", "threaded"])
def test_train_epoch_records_the_step_phases_and_the_loaders_waits(tmp_path, prefetch):
    trainer = _trainer(tmp_path, host_prefetch=prefetch)
    trainer.ensure_initialized()
    with _traced():
        trainer.train_epoch(_dataset(36), np.random.default_rng(0))
    session = trace.last_session()
    _assert_steps(session, 5)
    waits = _names(session, "loader.wait")
    assert len(waits) == 5 + 1  # one a batch, and the last finds the epoch's end
    assert all(w["parent"] is None for w in waits)
    counters = session["counters"]
    assert counters["loader.batches"] == 5 and 0 <= counters.get("loader.batches_waited", 0) <= 5
    if prefetch == 0:
        assert counters["loader.batches_waited"] == 5


def test_grouped_dispatch_records_its_groups(tmp_path):
    trainer = _trainer(tmp_path, device_resident=True, steps_per_dispatch=2)
    trainer.ensure_initialized()
    with _traced():
        trainer.train_epoch(_dataset(40), np.random.default_rng(0))
    session = trace.last_session()
    groups = _names(session, "trainer.group")
    assert [g["attrs"] for g in groups] == [{"kind": "train", "steps": 2}] * 2
    steps = _assert_steps(session, 5)
    # the first step, on new shapes, lies in its trainer.conv_tune span inside the first group
    (tune,) = _names(session, "trainer.conv_tune")
    assert tune["parent"] == groups[0]["id"] and session["counters"]["trainer.conv_tune_rounds"] == 1
    parents = [tune["parent"] if s["parent"] == tune["id"] else s["parent"] for s in steps]
    assert sorted(p for p in parents if p is not None) == sorted(
        [g["id"] for g in groups] * 2)  # the fifth, a tail, runs on its own


def test_a_streamed_epoch_records_the_native_waits(glips_root):
    index = scan_glips(glips_root)
    dataset = NativeStreamingDataset(index.by_split("train"), index.class_to_idx, "wav", (20000,), n_threads=2)
    try:
        with _traced():
            batches = list(dataset.epoch_batches(0, True, 3))
        waits = _names(trace.last_session(), "loader.native_next")
    finally:
        dataset.close()
    assert len(batches) >= 2 and len(waits) == len(batches) + 1
    assert all(w["end_ns"] >= w["start_ns"] for w in waits)


class _Echo(torch.nn.Module):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


def test_a_request_counts_its_padding_under_one_request():
    predictor = serving.Predictor(_Echo(), batch_size=8, device="cpu")
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    with _traced():
        got = predictor.predict_logits(x)
    np.testing.assert_array_equal(got, x)
    session = trace.last_session()
    assert session["counters"] == {"serve.rows": 5, "serve.rows_padded": 3}
    (request,) = _names(session, "serve.request")
    assert request["attrs"] == {"rows": 5} and request["request"] == request["id"]
    inside = [s for s in session["spans"] if s is not request]
    assert sorted(s["name"] for s in inside) == ["serve.d2h", "serve.forward", "serve.h2d", "serve.pad"]
    assert {s["request"] for s in inside} == {request["id"]}


def test_profile_dir_trace_holds_the_spans(tmp_path):
    trainer = _trainer(tmp_path, epochs=1, host_prefetch=0, profile_dir=str(tmp_path / "trace"))
    trainer.fit(_dataset(16), _dataset(8, seed=1), progress=None)
    with open(tmp_path / "trace" / "m_epoch1.trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"trainer.step", "trainer.forward", "trainer.backward", "trainer.optimizer", "loader.wait"} <= names


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]], ids=["one", "two_replicas"])
def test_a_cpu_predictor_captures_nothing(devices):
    predictor = serving.Predictor(_Echo(), batch_size=4, device="cpu", devices=devices)
    x = np.arange(14, dtype=np.float32).reshape(7, 2)
    with _traced():
        got = predictor.predict_logits(x)
        again = predictor.predict_logits(x)
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(again, x)
    session = trace.last_session()
    assert session["counters"] == {"serve.rows": 14, "serve.rows_padded": 2}
    assert len(_names(session, "serve.forward")) == 2 * 2 * len(predictor.replicas)
    assert all(r.stream is None and not r.fixed for r in predictor.replicas)


def test_a_batch_alone_waits_for_the_batches_in_flight():
    # the predictor's gate around a capture: it waits for the batches in
    # flight and holds back those that come while it waits or runs
    gate, seen = serving._Gate(), []
    inside, asked, go = threading.Event(), threading.Event(), threading.Event()

    def among(name, wait=None):
        with gate.among():
            seen.append(name)
            if wait is not None:
                inside.set()
                wait.wait(5)

    def alone():
        asked.set()
        with gate.alone():
            seen.append("alone")

    first = threading.Thread(target=among, args=("first", go))
    first.start()
    assert inside.wait(5)
    capture = threading.Thread(target=alone)
    capture.start()
    assert asked.wait(5)
    with gate.cond:
        assert gate.cond.wait_for(lambda: gate.asking, timeout=5)
    later = threading.Thread(target=among, args=("later",))
    later.start()
    go.set()
    for t in (first, capture, later):
        t.join(5)
    assert seen == ["first", "alone", "later"]
