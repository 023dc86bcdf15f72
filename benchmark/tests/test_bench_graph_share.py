"""The reader of ``serve.graph_share`` on synthetic sessions of the
program's spans and counters: 100 where every served forward was a CUDA
graph's replay, the share where some ran eagerly, and nothing (and no
error) where the session has no ``serve.replays``, as the CPU's and a
program without graphs' sessions, or no forward, or where the program has
no trace module or recorded no session."""

import importlib
import os
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

NAME = "serve.graph_share"
TRACED = types.SimpleNamespace(trace=object())


def _session(forwards, replays=None, requests=None):
    spans = [{"name": "serve.request"}] * (forwards if requests is None else requests)
    spans += [{"name": n} for n in ("serve.h2d", "serve.forward", "serve.d2h") for _ in range(forwards)]
    return {"spans": spans, "counters": {"serve.rows": 32 * forwards,
                                         **({} if replays is None else {"serve.replays": replays})}}


def _read(session, monkeypatch, view=TRACED):
    from multimodal_lipread_torch.utils import trace

    monkeypatch.setattr(trace, "last_session", lambda: session)
    return harness.load_reader(NAME)(view)


def test_the_spec_names_the_reader_for_the_serve_cell():
    (entry,) = [m for m in harness.load_spec(ROOT)["per_layer"] if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "%", "better": "higher", "source": "program_counter",
                     "layer": "serving.py Predictor forward", "moves": "serve_p50_ms",
                     "workloads": ["audio_vgg_lstm.serve"]}


@pytest.mark.parametrize("forwards, replays, share", [(2550, 2550, 100.0), (4, 3, 75.0), (10, 0, 0.0)])
def test_the_share_of_forwards_replayed(forwards, replays, share, monkeypatch):
    assert _read(_session(forwards, replays), monkeypatch) == pytest.approx(share)


def test_two_replicas_count_a_forward_each(monkeypatch):
    # data-parallel serving: each replica's share of a batch is a forward and a replay
    assert _read(_session(2 * 7, 2 * 7, requests=7), monkeypatch) == pytest.approx(100.0)


@pytest.mark.parametrize("session", [
    None, {"spans": [], "counters": {}}, _session(12), _session(0, 0)],
    ids=["no_session", "empty", "no_replays_counter", "no_forward"])
def test_nothing_where_nothing_was_replayed_or_served(session, monkeypatch):
    assert _read(session, monkeypatch) is None
    assert _read(session, monkeypatch, types.SimpleNamespace(trace=None)) is None


def test_nothing_without_the_programs_module(monkeypatch):
    import multimodal_lipread_torch.utils as utils

    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "multimodal_lipread_torch.utils.trace", None)
    with pytest.raises(ImportError):
        importlib.import_module("multimodal_lipread_torch.utils.trace")
    assert harness.load_reader(NAME)(TRACED) is None
