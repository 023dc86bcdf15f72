"""The port's conformer (``nn/conformer.py``) and unidirectional LSTMs
(``nn/recurrent.LSTM``, ``LSTMLayer``) against the JAX package's at the
same weights (bridged from the JAX variables, see
tests/torch_parity_utils.py), on the CPU at B=2 and 5 steps: the block and
the encoder in eval mode in float32 at 1e-4 and in train mode (batch
statistics; dropout 0) in float64 at 1e-4; the block's parameter gradients
in float64 against ``jax.grad`` at 1e-8 of each tensor's largest entry;
the LSTMs in float32 at 1e-4, with torch's inter-layer dropout rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_utils import (  # noqa: F401 (fixtures)
    assert_running,
    load_bridged,
    one_torch_thread,
    random_variables,
    train_mode_f64,
)

from multimodal_lipread_tpu.nn import conformer as jconf
from multimodal_lipread_tpu.nn import recurrent as jrec

from multimodal_lipread_torch.nn import LSTM, LSTMLayer
from multimodal_lipread_torch.nn import conformer as pconf
from multimodal_lipread_torch.nn.common import flax_init_

TOL = 1e-4
B, T, D = 2, 5, 16


def _seq(seed=0, d=D):
    return np.random.default_rng(seed).standard_normal((B, T, d)).astype(np.float32)


@pytest.mark.parametrize("kind", ["block", "encoder"])
def test_conformer_matches_jax(kind):
    x = _seq(1, D if kind == "block" else 12)
    if kind == "block":
        jm, jm64 = jconf.ConformerBlock(num_heads=4, dropout_rate=0.0), \
            jconf.ConformerBlock(num_heads=4, dropout_rate=0.0, dtype=jnp.float64)
        pm = pconf.ConformerBlock(D, num_heads=4, dropout_rate=0.0)
    else:
        jm, jm64 = (jconf.ConformerEncoder(D, num_layers=2, dropout_rate=0.0, dtype=dt)
                    for dt in (jnp.float32, jnp.float64))
        pm = pconf.ConformerEncoder(12, D, num_layers=2, dropout_rate=0.0)
    v = random_variables(jm, x, seed=2)
    pm = load_bridged(pm, v)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, T, D)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    got, want, ours, running = train_mode_f64(jm64, v, pm, x)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert_running(ours, running)


def test_conformer_block_gradient_matches_jax_in_float64():
    x = _seq(3)
    w = np.random.default_rng(4).standard_normal((B, T, D))
    jm = jconf.ConformerBlock(num_heads=4, dropout_rate=0.0, dtype=jnp.float64)
    v = random_variables(jconf.ConformerBlock(num_heads=4, dropout_rate=0.0), x, seed=5)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)

        def loss(params):
            out, _ = jm.apply({"params": params, "batch_stats": v64["batch_stats"]}, x.astype(np.float64),
                              train=True, mutable=["batch_stats"])
            return jnp.sum(out * w)

        grads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(v64["params"]))
    pm = load_bridged(pconf.ConformerBlock(D, num_heads=4, dropout_rate=0.0), v).double().train()
    (pm(torch.from_numpy(x).double()) * torch.from_numpy(w)).sum().backward()
    with jax.enable_x64(True):
        exact = {k: torch.from_numpy(np.asarray(t, np.float64)) for k, t in _bridge_f64(grads).items()}
    assert set(exact) == {k for k, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        scale = float(exact[name].abs().max())
        # gradients that are exactly zero, rounding noise in both: the softmax
        # cancels the key bias (q·b is the same for every key), and the
        # training BatchNorm after the depthwise conv cancels its bias
        if name in ("mhsa.key.bias", "conv.dw.bias"):
            assert float(p.grad.abs().max()) < 1e-12 and scale < 1e-12
            continue
        assert float((p.grad - exact[name]).abs().max()) <= 1e-8 * scale, name


def _bridge_f64(tree):
    """The bridge's mapping in float64 (it emits float32)."""
    from multimodal_lipread_torch.utils import jax_bridge

    saved = jax_bridge._t
    jax_bridge._t = lambda a: torch.from_numpy(np.array(a, dtype=np.float64, order="C"))
    try:
        return jax_bridge.state_dict_from_jax(tree)
    finally:
        jax_bridge._t = saved


def test_conv_module_details():
    m = pconf._ConvModule(8, kernel_size=7)
    assert m.dw.padding == (3,) and m.dw.groups == 8 and m.dw.bias is not None
    with pytest.raises(ValueError):
        pconf._ConvModule(8, kernel_size=6)
    # the GLU keeps the first half, gated by the second
    flax_init_(m, torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(_seq(6, 8))
    a, b = torch.nn.functional.linear(m.ln(x), m.pw1.weight, m.pw1.bias).chunk(2, dim=-1)
    with torch.no_grad():
        torch.nn.init.zeros_(m.pw2.weight)
        torch.nn.init.zeros_(m.pw2.bias)
        torch.testing.assert_close(m(x), x)  # a zero pointwise output leaves the residual
    assert a.shape == b.shape == (B, T, 8)


@pytest.mark.parametrize("layers, bidirectional", [(1, False), (2, False), (2, True)])
def test_lstm_matches_jax(layers, bidirectional):
    x = _seq(7, 6)
    jm = jrec.LSTM(5, num_layers=layers, bidirectional=bidirectional)
    v = random_variables(jm, x, seed=8, init_kwargs={})
    pm = load_bridged(LSTM(6, 5, num_layers=layers, bidirectional=bidirectional), v)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x))(v, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, T, 5 * (2 if bidirectional else 1))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_matches_jax(reverse):
    x = _seq(9, 6)
    jm = jrec.LSTMLayer(5, reverse=reverse)
    v = random_variables(jm, x, seed=10, init_kwargs={})
    pm = load_bridged(LSTMLayer(6, 5, reverse=reverse), v)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x))(v, x))
    with torch.no_grad():
        np.testing.assert_allclose(pm(torch.from_numpy(x)).numpy(), want, rtol=TOL, atol=TOL)


def test_lstm_dropout_is_torchs_rule():
    # between layers only, in training only, none for one layer; masks from
    # the port's Dropout (the trainer's generator)
    x = torch.from_numpy(_seq(11, 6))
    one = flax_init_(LSTM(6, 5, num_layers=1, dropout=0.5), torch.Generator().manual_seed(0))
    assert one.layer_dropout.rate == 0.0
    two = flax_init_(LSTM(6, 5, num_layers=2, dropout=0.5), torch.Generator().manual_seed(0)).train()
    two.layer_dropout.generator = torch.Generator().manual_seed(3)
    a = two(x)
    two.layer_dropout.generator.manual_seed(3)
    assert torch.equal(a, two(x))
    assert not torch.equal(a, two.eval()(x))
    assert two.dropout == 0.0  # cuDNN's own inter-layer dropout is never used
    assert set(two.state_dict()) == set(torch.nn.LSTM(6, 5, 2).state_dict())
