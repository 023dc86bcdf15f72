"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py).

Both sides get the same weights: the JAX model is initialized, its
variables are redrawn from a seed with numpy (He-scaled kernels, BatchNorm
scales near 1 and plausible running statistics, so deep eval-mode forwards
keep non-degenerate activations and every parameter matters), and the port's
module loads them through ``utils/jax_bridge.py``.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from multimodal_lipread_torch.utils.jax_bridge import state_dict_from_jax


def _draw(name: str, a: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    shape = a.shape
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


def random_variables(model, *inputs, seed: int = 0) -> dict:
    """Init ``model`` (Flax) on ``inputs`` and redraw every leaf from ``seed``."""
    key = jax.random.PRNGKey(0)
    variables = model.init({"params": key, "dropout": key}, *inputs, train=False)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        return _draw(path[-1].key, np.asarray(leaf), rng).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.tree_util.tree_map(np.asarray, dict(variables)))


def load_bridged(module: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Load JAX ``variables`` into the port's ``module`` (strict) in eval mode."""
    sd = state_dict_from_jax(variables["params"], variables.get("batch_stats", {}))
    module.load_state_dict(sd, strict=True)
    return module.eval()
