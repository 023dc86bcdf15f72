"""The port's attention blocks, LayerNorm and positional encoding against
the JAX package's (``nn/attention.py``), at the same weights (bridged from
the JAX variables, see tests/torch_parity_utils.py), in float32 at 1e-5;
and the pieces the video slice added to ``nn/common.py`` and the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from torch_parity_utils import load_bridged, one_torch_thread, random_variables  # noqa: F401 (autouse)

from multimodal_lipread_tpu.nn import attention as jattn
from multimodal_lipread_tpu.nn import common as jcommon

from multimodal_lipread_torch.nn import common as pcommon
from multimodal_lipread_torch.nn.attention import (
    AdditiveAttention,
    MultiHeadSelfAttention,
    PositionalEncoding,
    TransformerEncoder,
    TransformerEncoderLayer,
    sinusoid_table,
)
from multimodal_lipread_torch.nn.common import Dropout, LayerNorm, flax_init_, time_distributed
from multimodal_lipread_torch.utils.jax_bridge import state_dict_from_jax

TOL = 1e-5
B, T, D = 3, 7, 16


def _x(seed, shape=(B, T, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _run(module, x):
    with torch.no_grad():
        out = module(torch.from_numpy(x))
    return out


@pytest.mark.parametrize("dim, max_len", [(16, 50), (256, 200), (7, 9)])
def test_positional_encoding_matches_jax(dim, max_len):
    x = _x(1, (2, 5, dim))
    jm = jattn.PositionalEncoding(dim, max_len=max_len)
    want = np.asarray(jm.apply({}, x))
    pm = PositionalEncoding(dim, max_len=max_len)
    np.testing.assert_allclose(_run(pm, x).numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(pm.pe.numpy(), sinusoid_table(dim, max_len))
    assert pm.state_dict() == {}  # a constant, as in the JAX module: in no checkpoint


@pytest.mark.parametrize("axis", [1, 0])
def test_additive_attention_matches_jax(axis):
    x = _x(2)
    jm = jattn.AdditiveAttention(axis=axis)
    v = random_variables(jm, x, seed=2, init_kwargs={})
    jw, jweights = jm.apply(v, x)
    pm = load_bridged(AdditiveAttention(D, axis=axis), v)
    pw, pweights = _run(pm, x)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pweights.numpy(), np.asarray(jweights), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("heads", [1, 4])
def test_multi_head_self_attention_matches_jax(heads, train):
    # train mode with dropout 0: the same function (no mask can match the JAX keys)
    x = _x(3)
    jm = jattn.MultiHeadSelfAttention(heads, dropout_rate=0.0)
    v = random_variables(jm, x, seed=3, init_kwargs={})
    want = np.asarray(jm.apply(v, x, deterministic=not train))
    pm = load_bridged(MultiHeadSelfAttention(D, heads), v).train(train)
    assert sorted(pm.state_dict()) == sorted(
        f"mha.{p}.{w}" for p in ("query", "key", "value", "out") for w in ("weight", "bias"))
    np.testing.assert_allclose(_run(pm, x).numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("ff", [None, 32])
def test_transformer_encoder_layer_matches_jax(ff, train):
    x = _x(4)
    jm = jattn.TransformerEncoderLayer(num_heads=4, dim_feedforward=ff, dropout_rate=0.0)
    v = random_variables(jm, x, seed=4, init_kwargs={})
    want = np.asarray(jm.apply(v, x, deterministic=not train))
    pm = load_bridged(TransformerEncoderLayer(D, 4, ff, dropout_rate=0.0), v).train(train)
    np.testing.assert_allclose(_run(pm, x).numpy(), want, rtol=TOL, atol=TOL)


def test_transformer_encoder_matches_jax():
    x = _x(5)
    jm = jattn.TransformerEncoder(num_layers=2, num_heads=4, dim_feedforward=4 * D)
    v = random_variables(jm, x, seed=5, init_kwargs={})
    pm = load_bridged(TransformerEncoder(D, 2, 4, 4 * D), v)
    np.testing.assert_allclose(_run(pm, x).numpy(), np.asarray(jm.apply(v, x)), rtol=TOL, atol=TOL)


def test_layer_norm_matches_flax():
    # Flax's default epsilon is 1e-6; a row of variance 1e-6 shows it. (Flax
    # takes the variance as E[x²] - E[x]², the port two-pass: they part
    # where the mean is far larger than the spread; these rows have mean ~0.)
    x = _x(6, (4, D)) * np.array([[1.0], [1e-3], [10.0], [1.0]], np.float32)
    jm = fnn.LayerNorm()
    v = random_variables(jm, x, seed=6, init_kwargs={})
    pm = load_bridged(LayerNorm(D), v)
    np.testing.assert_allclose(_run(pm, x).numpy(), np.asarray(jm.apply(v, x)), rtol=TOL, atol=TOL)
    got = pm(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and pm.weight.dtype == torch.float32


def test_attention_dropout_is_one_mask_per_step_from_the_generator():
    # Flax's broadcast_dropout: one (T, T) mask shared by the batch and the
    # heads; the masks come from the trainer's generator, not torch's global one
    pm = MultiHeadSelfAttention(D, 4, dropout_rate=0.5).train()
    flax_init_(pm, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.repeat(_x(7, (1, T, D)), 3, axis=0))
    gen = torch.Generator().manual_seed(3)
    pm.mha.dropout.generator = gen
    state = torch.get_rng_state()
    out = pm(x)
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])
    gen.manual_seed(3)
    assert torch.equal(pm(x), out)
    gen.manual_seed(4)
    assert not torch.equal(pm(x), out)
    assert torch.equal(pm.eval()(x), pm(x))  # no dropout in eval


@pytest.mark.parametrize("shape, dims", [((4, 3, 5), (0,)), ((2, 3, 4, 4), (0, 1)), ((6, 5), ())])
def test_dropout_broadcast_dims(shape, dims):
    drop = Dropout(0.5, broadcast_dims=dims).train()
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(torch.ones(shape))
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
    for d in dims:
        assert torch.equal(y, y.narrow(d, 0, 1).expand_as(y))


def test_time_distributed_matches_jax():
    x = _x(8, (2, 3, 4, 5))

    def fn(frames):
        return frames.reshape(frames.shape[0], -1)[:, :6] * 2.0

    want = np.asarray(jcommon.time_distributed(fn, jnp.asarray(x)))
    got = time_distributed(fn, torch.from_numpy(x))
    assert got.shape == (2, 3, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bridge_maps_attention_conv1d_and_depthwise_kernels():
    rng = np.random.default_rng(9)
    heads, hd = 4, 5
    params = {
        "self_attn": {
            "query": {"kernel": rng.standard_normal((D, heads, hd)), "bias": rng.standard_normal((heads, hd))},
            "out": {"kernel": rng.standard_normal((heads, hd, D)), "bias": rng.standard_normal(D)},
        },
        "tconv0": {"kernel": rng.standard_normal((3, 6, 8)), "bias": rng.standard_normal(8)},
        "dw": {"conv": {"kernel": rng.standard_normal((3, 3, 1, 12))}},
        "norm1": {"scale": rng.standard_normal(D), "bias": rng.standard_normal(D)},
        "bn1": {"BatchNorm_0": {"scale": rng.standard_normal(4), "bias": rng.standard_normal(4)}},
    }
    stats = {"bn1": {"BatchNorm_0": {"mean": rng.standard_normal(4), "var": rng.random(4)}}}
    sd = state_dict_from_jax(params, stats)
    q, o = params["self_attn"]["query"], params["self_attn"]["out"]
    np.testing.assert_allclose(sd["self_attn.query.weight"].numpy(), q["kernel"].reshape(D, -1).T, rtol=1e-6)
    np.testing.assert_allclose(sd["self_attn.query.bias"].numpy(), q["bias"].reshape(-1), rtol=1e-6)
    np.testing.assert_allclose(sd["self_attn.out.weight"].numpy(), o["kernel"].reshape(-1, D).T, rtol=1e-6)
    k = params["tconv0"]["kernel"]
    assert sd["tconv0.weight"].shape == (8, 6, 3)
    np.testing.assert_allclose(sd["tconv0.weight"][2, 4, 1].item(), k[1, 4, 2], rtol=1e-6)
    assert sd["dw.conv.weight"].shape == (12, 1, 3, 3)
    assert set(sd) >= {"norm1.weight", "norm1.bias", "bn1.weight", "bn1.running_mean", "bn1.running_var"}
    assert "norm1.running_mean" not in sd


def test_flax_init_covers_layer_norm_conv1d_grouped_conv_and_attention():
    net = torch.nn.ModuleDict({
        "enc": TransformerEncoderLayer(64, 4, 128),
        "tconv": torch.nn.Conv1d(32, 48, 3),
        "dw": torch.nn.Conv2d(96, 96, 3, groups=96),
    })
    for p in net.parameters():
        torch.nn.init.constant_(p, 7.0)
    flax_init_(net, torch.Generator().manual_seed(0))
    enc = net["enc"]
    for norm in (enc.norm1, enc.norm2):
        assert torch.equal(norm.weight, torch.ones(64)) and torch.equal(norm.bias, torch.zeros(64))
    fan_ins = {"tconv": 32 * 3, "dw": 9, "enc.self_attn.query": 64, "enc.self_attn.out": 64,
               "enc.linear2": 128}
    mods = dict(net.named_modules())
    for name, fan_in in fan_ins.items():
        w = mods[name].weight
        assert w[0].numel() == fan_in
        assert abs(float(w.detach().std()) * np.sqrt(fan_in) - 1.0) < 0.1 + 3 / np.sqrt(w.numel()), name
        assert torch.equal(mods[name].bias, torch.zeros_like(mods[name].bias)), name
    # the same law as Flax's lecun_normal for a DenseGeneral (fan-in D for q/k/v)
    jm = fnn.MultiHeadDotProductAttention(num_heads=4)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 5, 64)), jnp.zeros((1, 5, 64)))["params"]
    for name in ("query", "out"):
        want_std = float(np.asarray(v[name]["kernel"]).std())
        got_std = float(mods[f"enc.self_attn.{name}"].weight.detach().std())
        assert got_std == pytest.approx(want_std, rel=0.1), name


def test_dropout_without_broadcast_draws_the_same_masks_as_before():
    # an unbroadcast Dropout under the trainer's generator: one Bernoulli
    # draw per element, so a saved generator state resumes the same masks
    x = torch.from_numpy(_x(10, (5, 9)))
    drop = Dropout(0.3).train()
    drop.generator = torch.Generator().manual_seed(1)
    keep = torch.empty_like(x).bernoulli_(0.7, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(drop(x), x * keep / 0.7, rtol=0, atol=0)


def test_common_conv1d_runs_in_the_inputs_dtype():
    layer = torch.nn.Conv1d(4, 6, 3, padding=1)
    x = torch.from_numpy(_x(11, (2, 4, 9)))
    torch.testing.assert_close(pcommon.conv1d(layer, x), layer(x))
    assert pcommon.conv1d(layer, x.to(torch.bfloat16)).dtype == torch.bfloat16
