"""The harness: ``BENCHMARK.json`` against the contract it is written to,
every cell's configuration, mix, limits and metric readers found by name
from data, the result line's keys, and a run without a card failing
without a result."""

import importlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

SPEC = harness.load_spec(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY = {
    "audio_vgg_lstm.train": {"config": {"training": {"batch_size": 4}, "dataset": {"num_workers": 2}},
                             "mix": {"clips": 12}},
    "audio_vgg_lstm.serve": {"mix": {"pool": 12, "rate_per_s": 3.0, "clips_max": 4, "batch_size": 4,
                                     "check_requests": 3, "workers": 2}},
}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"] and SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"), entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry and group != "end_to_end" and not (group == "per_layer" and key == "source"):
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    assert len(names) == len(set(names))
    for config in SPEC["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in config["reduced"]) and len(config["reduced"]) <= 16
        assert config["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, config["file"]))
    for cell in SPEC["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"} and cell["chips"] in (1, 4)
        assert NAME.match(cell["traffic"]) and NAME.match(cell["config"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert m["moves"] in [x["name"] for x in harness.cell_metrics(SPEC, cell, trace=False)], (m["name"], cell)
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
    for cell in SPEC["workloads"]:
        reported = [m["name"] for m in harness.cell_metrics(SPEC, cell["name"], trace=False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.cell_metrics(SPEC, cell["name"], trace=True)


@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_cell_found_by_name_from_data(cell):
    entry = harness.find_cell(SPEC, cell)
    config = harness.load_json("configs", entry["config"])
    mix = harness.load_json("traffic", entry["traffic"])
    limits = harness.load_json("limits", cell)
    importlib.import_module(f"benchmark.pipelines.{config['pipeline']}")
    importlib.import_module(f"benchmark.reference.{config['reference']}")
    driver = importlib.import_module(f"benchmark.drivers.{mix['kind']}")
    assert callable(driver.run) and limits
    for m in harness.cell_metrics(SPEC, cell, trace=True):
        assert callable(harness.load_reader(m["name"]))


def test_every_metric_reader_is_named_by_the_spec():
    metrics = {m["name"] for m in SPEC["per_layer"]}
    readers = {f[:-3] for f in os.listdir(os.path.join(ROOT, "benchmark", "metrics")) if f.endswith(".py")}
    assert readers == metrics


@pytest.mark.parametrize("cell", ["audio_vgg_lstm.train", "audio_vgg_lstm.serve"])
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_result_line_keys(cell, trace):
    result = harness.run_cell(cell, 2**31 + 17, 1.0, trace, "cpu", overrides=TINY[cell])
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    for name, check in result["checks"].items():
        assert set(check) == {"value", "limit"}
    expected = {m["name"] for m in harness.cell_metrics(SPEC, cell, trace)}
    assert set(result["metrics"]) <= expected
    if not trace:
        assert set(result["metrics"]) == expected
    else:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(result["device"])


def _run_cli(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "audio_vgg_lstm.train", "--seed",
                           str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=env)


def test_without_a_card_no_result_and_no_cpu_fallback():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run_cli(ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = _run_cli(str(tmp_path), env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    # past the look for a card, the run stops at the missing program
    code = ("from benchmark import harness; harness.run_cell('audio_vgg_lstm.serve', 1, 1.0, False, 'cpu', "
            "spec=harness.load_spec('.'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and "multimodal_lipread_torch" in out.stderr
