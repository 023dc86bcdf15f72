"""What the benchmark's files may import, compared by whole top-level
module name (``multimodal_lipread_torch`` is not ``multimodal_lipread_tpu``):
nothing of JAX or the JAX package anywhere, and nothing of the program in
the plain reference."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "yaml", "msgpack", "multimodal_lipread_tpu"}


def _sources(sub=""):
    for dirpath, _dirs, files in os.walk(os.path.join(BENCH, sub)):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_top_level_names_are_compared_whole():
    assert "multimodal_lipread_torch" not in FORBIDDEN
    assert top_level_imports.__name__  # the scan below splits on the first dot only


@pytest.mark.parametrize("path", list(_sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    found = top_level_imports(path) & FORBIDDEN
    assert not found, f"{os.path.relpath(path, BENCH)} imports {sorted(found)}"


@pytest.mark.parametrize("path", list(_sources("reference")), ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    found = top_level_imports(path)
    assert "multimodal_lipread_torch" not in found
    assert found <= {"__future__", "functools", "typing", "wave", "math", "numpy", "torch", "benchmark"}, found
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("benchmark"):
            assert node.module.startswith("benchmark.reference"), node.module


def test_a_run_loads_no_jax():
    """The port's modules that a run imports load none of the forbidden ones."""
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); from benchmark import harness; "
            "import multimodal_lipread_torch.serving, multimodal_lipread_torch.train.trainer, "
            "multimodal_lipread_torch.pipelines.audio, multimodal_lipread_torch.pipelines.audio_video, "
            "multimodal_lipread_torch.data.grain_loader; "
            "import benchmark.drivers.train, benchmark.drivers.serve, benchmark.pipelines.audio; "
            "print(harness.forbidden_modules())" % os.path.dirname(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"} | {"PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
