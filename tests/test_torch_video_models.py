"""The port's seven video models against the JAX package's at the same
weights (bridged from the JAX variables, see tests/torch_parity_utils.py),
at B=2, T=3 (the models take any length), 44 × 44 × 3, at 1e-4 on the
logits: in eval mode in float32, and in train mode (dropout 0, batch
statistics) in float64 on both sides, with the running statistics it
updates (in float32 the train-mode BatchNorms over 6 frames part both
packages from float64 by more than 1e-4: tests/test_torch_video_backbones.py).
Also the registry, the resnet_trans gradient against float64, bf16 compute
over float32 parameters, and the BiLSTM's inter-layer dropout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_parity_utils import load_bridged, one_torch_thread, random_variables  # noqa: F401 (autouse)

from multimodal_lipread_tpu.models import video as jvideo

from multimodal_lipread_torch.models import video as pvideo
from multimodal_lipread_torch.nn import BiLSTM, Dropout
from multimodal_lipread_torch.nn.common import flax_init_

TOL = 1e-4
B, T = 2, 3
PORTED = [n for n in jvideo.VIDEO_MODEL_NAMES if n != "conformer"]


def _lips(seed=0, b=B, t=T):
    return np.random.default_rng(seed).random((b, t, 44, 44, 3), np.float32)


def _running_f64(tree, prefix=""):
    """JAX batch_stats → {port running-statistic name: array}."""
    if "mean" in tree:
        return {prefix + "running_mean": tree["mean"], prefix + "running_var": tree["var"]}
    out = {}
    for key, child in tree.items():
        out.update(_running_f64(child, prefix if key == "BatchNorm_0" else f"{prefix}{key}."))
    return out


@pytest.mark.parametrize("name", PORTED)
def test_video_model_matches_jax(name):
    x = _lips(1)
    jm = jvideo.get_video_model(name, 4, dropout=0.0)
    v = random_variables(jm, x, seed=2)
    pm = load_bridged(pvideo.get_video_model(name, 4, dropout=0.0), v)

    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, 4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    j64 = jvideo.get_video_model(name, 4, dropout=0.0, dtype=jnp.float64)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        out = jax.jit(lambda v, x: j64.apply(v, x, train=True, mutable=["batch_stats"]))(v64, x.astype(np.float64))
        want = np.asarray(out[0])
        running = _running_f64(jax.tree_util.tree_map(np.asarray, out[1].get("batch_stats", {})))
    pm = pm.double().train()
    pm.dtype = torch.float64
    with torch.no_grad():
        got = pm(torch.from_numpy(x).double()).numpy()
    assert want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    ours = {k: t for k, t in pm.state_dict().items() if "running_" in k}
    assert set(ours) == set(running)
    for key, t in ours.items():
        np.testing.assert_allclose(t.numpy(), running[key], rtol=TOL, atol=TOL, err_msg=key)


@pytest.mark.parametrize("name", PORTED)
def test_registry_defaults_match_jax(name):
    jm = jvideo.get_video_model(name, 4)
    pm = pvideo.get_video_model(name, 4)
    rates = {m.rate for m in pm.modules() if isinstance(m, Dropout)}
    assert rates == {jm.dropout_rate}
    assert pm.dtype == torch.float32


def test_registry_names_and_refusals():
    assert pvideo.VIDEO_MODEL_NAMES == jvideo.VIDEO_MODEL_NAMES
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pvideo.get_video_model("conformer", 4)
    with pytest.raises(ValueError):
        pvideo.get_video_model("nope", 4)
    # the registry's knobs reach the models
    assert pvideo.get_video_model("resnet_lstm", 4, feature_dim=64, resnet_version=34).head.fc.in_features == 64
    assert pvideo.get_video_model("shufflenet_lstm", 4, shufflenet_version="1.0x").shufflenet.feature_dim == 1024


def test_resnet_trans_gradient_matches_float64():
    """One gradient of the port's resnet_trans (dropout 0) in float32
    against the same in float64: within 1e-4 of each tensor's largest
    entry. In eval mode: with BatchNorm on the batch statistics of the
    test's 6 frames, the weight gradients are sums that cancel to a few
    per cent of their terms, and the float32 result then moves by 1-20 %
    with the summation order (the CPU's thread count); the train-mode
    function is held to the JAX model in float64
    (test_video_model_matches_jax). (The attention's key bias adds q·b to
    every score of a query alike, which the softmax cancels: its gradient
    is exactly zero, rounding noise in both.)"""
    x = torch.from_numpy(_lips(3))
    y = torch.tensor([1, 3])
    grads = {}
    for dtype in (torch.float32, torch.float64):
        pm = flax_init_(pvideo.get_video_model("resnet_trans", 4, dropout=0.0, dtype=dtype),
                        torch.Generator().manual_seed(0))
        pm.to(dtype).eval()
        F.cross_entropy(pm(x.to(dtype)), y).backward()
        grads[dtype] = {k: p.grad.double() for k, p in pm.named_parameters()}
    for name, exact in grads[torch.float64].items():
        if name.endswith("self_attn.key.bias"):
            assert float(exact.abs().max()) < 1e-12, name
            continue
        err = float((grads[torch.float32][name] - exact).abs().max() / exact.abs().max().clamp_min(1e-30))
        assert err <= 1e-4, (name, err)


def test_bfloat16_forward_keeps_float32_parameters():
    x = torch.from_numpy(_lips(4))
    f32 = flax_init_(pvideo.get_video_model("resnet_trans", 4), torch.Generator().manual_seed(1)).eval()
    bf16 = pvideo.get_video_model("resnet_trans", 4, dtype=torch.bfloat16).eval()
    bf16.load_state_dict(f32.state_dict())
    with torch.no_grad():
        got, want = bf16(x), f32(x)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert all(t.dtype == torch.float32 for t in list(bf16.parameters()) + list(bf16.buffers()))
    # bf16 keeps ~3 significant digits through 17 convolutions and 2 layers
    torch.testing.assert_close(got.float(), want, rtol=0.1, atol=0.1 * float(want.abs().max()))


def _bilstm(dropout=0.5, seed=0):
    lstm = BiLSTM(6, 5, num_layers=2, dropout=dropout)
    flax_init_(lstm, torch.Generator().manual_seed(seed))
    return lstm.train()


def test_bilstm_dropout_masks_come_from_its_generator():
    lstm = _bilstm()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 4, 6)).astype(np.float32))
    gen = torch.Generator()
    lstm.dropout.generator = gen
    state = torch.get_rng_state()
    gen.manual_seed(1)
    a = lstm(x)
    gen.manual_seed(1)
    b = lstm(x)
    gen.manual_seed(2)
    c = lstm(x)
    assert torch.equal(torch.get_rng_state(), state)  # torch's global generator untouched
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(lstm.eval()(x), lstm(x))  # eval: no dropout


def test_bilstm_dropout_is_on_each_layers_output_but_the_last():
    # the JAX LSTM's rule (nn/recurrent.py): layer 0's output, masked from
    # the generator, is layer 1's input; the state_dict is one nn.LSTM's
    lstm = _bilstm()
    assert set(lstm.state_dict()) == {f"lstm.{k}" for k in torch.nn.LSTM(6, 5, 2, bidirectional=True).state_dict()}
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 4, 6)).astype(np.float32))
    layers = [torch.nn.LSTM(6 if i == 0 else 10, 5, 1, batch_first=True, bidirectional=True) for i in range(2)]
    sd = lstm.lstm.state_dict()
    for i, layer in enumerate(layers):
        layer.load_state_dict({k.replace(f"_l{i}", "_l0"): v for k, v in sd.items() if f"_l{i}" in k})
    lstm.dropout.generator = torch.Generator().manual_seed(7)
    got = lstm(x)
    h = layers[0](x)[0]
    keep = torch.empty(h.shape).bernoulli_(0.5, generator=torch.Generator().manual_seed(7))
    want = layers[1](h * keep / 0.5)[0]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_bilstm_without_dropout_is_the_fused_call():
    lstm = _bilstm(dropout=0.0)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 5, 6)).astype(np.float32))
    torch.testing.assert_close(lstm(x), lstm.lstm(x)[0], rtol=0, atol=0)
    assert lstm.lstm.dropout == 0.0  # cuDNN's own inter-layer dropout is never used
