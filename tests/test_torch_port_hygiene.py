"""The PyTorch port stands alone: no module of ``multimodal_lipread_torch``,
and neither ``chip_smoke.py``, ``tests/test_torch_cuda.py`` nor the multi-process tests'
ranks (``tests/torch_dist_worker.py``), imports JAX, Flax, Optax or the JAX package, and
``chip_smoke.py`` needs none of the packages the card machine may lack."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "multimodal_lipread_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "multimodal_lipread_tpu")
NOT_ON_THE_CARD_MACHINE = ("yaml", "msgpack", "ninja")


def _port_files():
    out = []
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    # chip_smoke.py and the card-only tests run where JAX is not installed;
    # the multi-process tests' ranks must not import it either
    return sorted(out) + [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "tests", "test_torch_cuda.py"),
                          os.path.join(REPO, "tests", "torch_dist_worker.py")]


def _imports(path, top_level_only=False):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    nodes = tree.body if top_level_only else ast.walk(tree)
    names = []
    for node in nodes:
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_file_imports_no_jax(path):
    bad = [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_chip_smoke_needs_only_the_card_machines_packages():
    names = _imports(os.path.join(REPO, "chip_smoke.py"))
    bad = [n for n in names if any(n == m or n.startswith(m + ".") for m in NOT_ON_THE_CARD_MACHINE)]
    assert not bad, f"chip_smoke.py imports {bad}"


def test_yaml_is_imported_only_inside_functions():
    # Config.from_dict must work where PyYAML is missing
    for path in _port_files():
        assert "yaml" not in _imports(path, top_level_only=True), path


def test_port_never_uses_torch_cpp_extension():
    for path in _port_files():
        with open(path) as f:
            assert "cpp_extension" not in f.read(), path


def test_port_never_imports_scikit_learn():
    # scikit-learn is no dependency of the port: the cue pipeline's TF-IDF is
    # its own (data/tfidf.py); only the CPU tests hold it to scikit-learn
    for path in _port_files():
        assert "sklearn" not in {n.split(".")[0] for n in _imports(path)}, path


def test_plotting_is_imported_only_inside_functions():
    # the card machine has no matplotlib: training must import without it
    for path in _port_files():
        assert not {"matplotlib", "pandas"} & {n.split(".")[0] for n in _imports(path, top_level_only=True)}, path


def test_port_never_imports_pandas():
    # the card machine has no pandas: the plots read the CSV logs with csv
    for path in _port_files():
        assert "pandas" not in {n.split(".")[0] for n in _imports(path)}, path


def test_opencv_is_imported_only_inside_functions():
    # the lip extraction and the .mp4 writer need cv2; nothing else may
    # depend on it being installed
    for path in _port_files():
        assert "cv2" not in {n.split(".")[0] for n in _imports(path, top_level_only=True)}, path
