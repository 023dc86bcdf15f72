"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py).

Both sides get the same weights: the JAX model is initialized, its
variables are redrawn from a seed with numpy (He-scaled kernels, BatchNorm
scales near 1 and plausible running statistics, so deep eval-mode forwards
keep non-degenerate activations and every parameter matters), and the port's
module loads them through ``utils/jax_bridge.py``.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
import pytest
import torch

from multimodal_lipread_torch.utils.jax_bridge import state_dict_from_jax


def _draw(name: str, shape: tuple, rng: np.random.Generator) -> np.ndarray:
    if name == "kernel":  # HWIO conv or (in, out) dense
        fan_in = int(np.prod(shape[:-1]))
        return rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
    if name in ("w_ih", "w_hh", "b_ih", "b_hh"):
        bound = 1.0 / np.sqrt(shape[-1] // 4)
        return rng.uniform(-bound, bound, shape)
    if name == "scale":
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if name == "bias":
        return 0.05 * rng.standard_normal(shape)
    if name == "mean":
        return 0.1 * rng.standard_normal(shape)
    if name == "var":
        return 1.0 + 0.1 * rng.uniform(size=shape)
    raise KeyError(f"no drawing law for leaf '{name}'")


def random_variables(model, *inputs, seed: int = 0, init_kwargs: Optional[dict] = None) -> dict:
    """Draw every variable of ``model`` (Flax) on ``inputs`` from ``seed``.

    Only the variables' shapes are taken from ``model.init``
    (``jax.eval_shape``: traced, not run). ``init_kwargs`` go to
    ``model.init``: ``train=False`` unless given (a module without a
    ``train`` argument takes ``{}`` or its own)."""
    key = jax.random.PRNGKey(0)
    kwargs = {"train": False} if init_kwargs is None else init_kwargs
    shapes = jax.eval_shape(lambda: model.init({"params": key, "dropout": key}, *inputs, **kwargs))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        return _draw(path[-1].key, tuple(leaf.shape), rng).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def load_bridged(module: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Load JAX ``variables`` into the port's ``module`` (strict) in eval mode."""
    sd = state_dict_from_jax(variables["params"], variables.get("batch_stats", {}))
    module.load_state_dict(sd, strict=True)
    return module.eval()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test module's torch work on one intra-op thread. With the
    tests spread over several processes (``pytest -n 6``), torch's default
    of one OpenMP thread per core in each of them slows its many small
    operations by one or two orders of magnitude (threads wait at every
    operation's barrier for peers that are not scheduled). A test file
    uses it by importing it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
