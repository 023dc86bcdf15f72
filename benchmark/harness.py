"""The harness: finds a cell of ``BENCHMARK.json`` by name, and its
configuration, traffic mix, limits and per-layer metric readers by the
names the file gives; runs the mix's driver; and prints the result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Files, each found by its name:

- ``benchmark/configs/<config>.json``: the configuration as the program
  reads it (``Config.from_dict``), plus ``source``, ``reduced``,
  ``assumed``, the ``pipeline`` adapter (``benchmark/pipelines/<name>.py``)
  and the plain ``reference`` model (``benchmark/reference/<name>.py``);
- ``benchmark/traffic/<traffic>.json``: the mix's ``kind``
  (``benchmark/drivers/<kind>.py``) and its parameters;
- ``benchmark/limits/<cell>.json``: the limit of each number compared;
- ``benchmark/metrics/<metric>.py``: ``read(view) -> float | None``.

A run on the card prints, as its last stdout line, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (with
``--trace 1`` also ``breakdown``) and last ``checks``, each number compared
beside its limit; the same numbers are the last lines of stderr."""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import types
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "benchmark")
# top-level modules that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "multimodal_lipread_tpu")


class NoCard(RuntimeError):
    pass


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH_DIR, kind, f"{name}.json")) as f:
        return json.load(f)


def load_reader(metric: str):
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    module_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{len(metric)}_{abs(hash(metric))}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end ones untraced,
    its per-layer ones traced (those that list it, or, without a list,
    every cell that reports the end-to-end metric they move)."""
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """One run: the cell's files, the seed, the device, the weights, and a
    scratch directory under ``TMPDIR`` (removed at the end)."""

    def __init__(self, spec: dict, cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
                 overrides: Optional[dict] = None):
        import torch

        from multimodal_lipread_torch.config import Config

        self.spec, self.cell, self.seed, self.seconds, self.trace = spec, cell, int(seed), float(seconds), trace
        self.device, self.t_start = torch.device(device), t_start
        overrides = overrides or {}
        self.config = _merge(load_json("configs", cell["config"]), overrides.get("config", {}))
        self.mix = _merge(load_json("traffic", cell["traffic"]), overrides.get("mix", {}))
        self.limits = load_json("limits", cell["name"])
        self.adapter = importlib.import_module(f"benchmark.pipelines.{self.config['pipeline']}")
        self.reference = importlib.import_module(f"benchmark.reference.{self.config['reference']}")
        self.driver = importlib.import_module(f"benchmark.drivers.{self.mix['kind']}")
        program = json.loads(json.dumps(self.config))
        program["training"]["seed"] = self.seed
        self.program_config = Config.from_dict(program)
        self.ref_spec = self.reference.param_spec(self.config)
        self.workdir = tempfile.mkdtemp(prefix="bench-", dir=os.environ.get("TMPDIR"))
        self.setup_s = None
        self.memory_peak = 0
        self.tf32 = False
        from benchmark import weights

        self.weights = weights.make(self.ref_spec, self.seed, self.device)
        self.phase("imports and weights")

    def path(self, name: str) -> str:
        return os.path.join(self.workdir, name)

    def trainable_names(self) -> list:
        return [n for n, (_s, kind, _f) in self.ref_spec.items() if kind not in ("bn_mean", "bn_var")]

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark_setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start

    def read_memory_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        import gc

        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @contextlib.contextmanager
    def reference_precision(self):
        """The reference's float32: TF32 off (on only for the control)."""
        import torch

        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def reference_flops(self, batch: int, train: bool) -> int:
        from benchmark import counts

        return counts.reference_flops(self.reference, self.config, self.ref_spec,
                                      self.reference.example_inputs(batch), train)

    def phase(self, name: str) -> None:
        """Log how far into the run a phase of set-up ended."""
        self.note(f"{name} done at {time.perf_counter() - self.t_start:.3f} s")

    def note(self, line: str) -> None:
        print(f"[bench] {line}", file=sys.stderr, flush=True)

    def close(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              f"--id={device.index or 0}"], capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, overrides: Optional[dict] = None, tf32: bool = False,
             spec: Optional[dict] = None) -> dict:
    """Run one cell and return its result (without printing). The command
    line always runs on the card; tests pass ``device="cpu"`` and small
    ``overrides`` of the configuration and the mix."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or load_spec()
    cell = find_cell(spec, name)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    # the configurations state float32 without TF32, as the program runs it
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ctx = Context(spec, cell, seed, seconds, trace, dev, t_start, overrides)
    ctx.tf32 = tf32
    info = device_info(dev)
    try:
        out = ctx.driver.run(ctx)
    finally:
        ctx.close()
    from benchmark import checks, peaks

    correct, rows = checks.judge(out["numbers"], ctx.limits)
    correct = correct and out["failed"] == 0
    metrics = {}
    view = types.SimpleNamespace(**out["view"], peaks=peaks.for_device(info["kind"]), cell=name)
    for m in cell_metrics(spec, name, trace):
        if m["name"] == "setup_s":
            value = ctx.setup_s
        elif not trace:
            value = out["e2e"].get(m["name"])
        else:
            value = load_reader(m["name"])(view)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    info["memory_peak_bytes"] = ctx.memory_peak
    result = {"correct": bool(correct), "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": info}
    if trace and view.trace is not None:
        ctx.note(f"log-mel launches placed {len(view.trace.logmel_launches)}, not placed {view.trace.logmel_unread}")
        info["busy_s"] = view.trace.busy_s
        info["window_s"] = view.trace.window_s
        result["breakdown"] = view.trace.breakdown()
    result["checks"] = {n: {"value": v if math.isfinite(v) else None, "limit": lim} for n, v, lim in rows}
    return result


def parse_args(argv):
    parser = argparse.ArgumentParser(description="Run one cell of the port's benchmark on the card.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    try:
        spec = load_spec()
        cell = find_cell(spec, args.workload)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise NoCard(f"the cell needs {cell['chips']} CUDA card(s); "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start, spec=spec)
        loaded = forbidden_modules()
        if loaded:
            raise RuntimeError(f"the run loaded {', '.join(loaded)}")
    except NoCard as e:
        print(f"[bench] no result: {e}", file=sys.stderr)
        return 2
    except Exception:  # noqa: BLE001 — no result line on any failure
        traceback.print_exc()
        print("[bench] no result: the run failed", file=sys.stderr)
        return 1
    for name, check in result["checks"].items():
        print(f"[check] {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
