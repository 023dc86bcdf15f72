"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py).

Both sides get the same weights: the JAX model is initialized, its
variables are redrawn from a seed with numpy (He-scaled kernels, BatchNorm
scales near 1 and plausible running statistics, so deep eval-mode forwards
keep non-degenerate activations and every parameter matters), and the port's
module loads them through ``utils/jax_bridge.py``.
"""

from __future__ import annotations

import inspect
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
    if name == "alpha":  # the late-fusion models' 0-d mixing weight
        return rng.uniform(0.2, 0.8, shape)
    if name == "attn_weights":  # the audio_cues late fusion's (2,) logits of the mix
        return rng.uniform(0.5, 1.5, shape)
    if name == "embedding":  # a Flax Embed table (num_embeddings, features)
        return rng.standard_normal(shape) * 0.5
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


def running_from_jax(tree, prefix=""):
    """JAX batch_stats → {port running-statistic name: array}."""
    if "mean" in tree:
        return {prefix + "running_mean": tree["mean"], prefix + "running_var": tree["var"]}
    out = {}
    for key, child in tree.items():
        out.update(running_from_jax(child, prefix if key == "BatchNorm_0" else f"{prefix}{key}."))
    return out


def train_mode_f64(jmodel_f64, v, pm, *inputs):
    """Train-mode forward in float64 on both sides (``jax.enable_x64``; the
    port's module widened in place, its dropout at rate 0): the port's
    output, the JAX output, and the running statistics each updated."""
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        key = jax.random.PRNGKey(0)  # asked for by attention in training; unused with jax_dropout_off
        out = jax.jit(lambda v, *x: jmodel_f64.apply(v, *x, train=True, mutable=["batch_stats"],
                                                     rngs={"dropout": key}))(
            v64, *(x.astype(np.float64) for x in inputs))
        want = np.asarray(out[0])
        running = running_from_jax(jax.tree_util.tree_map(np.asarray, out[1].get("batch_stats", {})))
    pm = no_dropout(pm.double().train())
    if hasattr(pm, "dtype"):
        pm.dtype = torch.float64
    with torch.no_grad():
        got = pm(*(torch.from_numpy(x).double() for x in inputs)).numpy()
    ours = {k: t.numpy() for k, t in pm.state_dict().items() if "running_" in k}
    return got, want, ours, running


def assert_running(ours, running, tol=1e-4):
    assert set(ours) == set(running)
    for key, t in ours.items():
        np.testing.assert_allclose(t, running[key], rtol=tol, atol=tol, err_msg=key)


@pytest.fixture
def jax_dropout_off(monkeypatch):
    """Every ``flax.linen.Dropout`` passes its input through and attention
    drops no probabilities, for a train-mode comparison of JAX models whose
    dropout rates are fixed (the port's are set to rate 0 alongside: masks
    cannot agree across packages)."""
    import flax.linen
    from flax.linen import attention

    weights = attention.dot_product_attention_weights
    signature = inspect.signature(weights)

    def deterministic_weights(*args, **kwargs):
        bound = signature.bind(*args, **kwargs)
        bound.arguments["deterministic"] = True
        return weights(*bound.args, **bound.kwargs)

    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *args, **kwargs: x)
    monkeypatch.setattr(attention, "dot_product_attention_weights", deterministic_weights)


def no_dropout(module: torch.nn.Module) -> torch.nn.Module:
    """Set every port ``Dropout`` of ``module`` to rate 0."""
    from multimodal_lipread_torch.nn.common import Dropout

    for m in module.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return module


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
