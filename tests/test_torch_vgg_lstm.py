"""The port's vgg_lstm model and its layers against the JAX package's, at
the same weights (bridged from the JAX variables, see
tests/torch_parity_utils.py), in eval mode and float32, at 1e-4."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_utils as G
from torch_parity_utils import load_bridged, random_variables

from multimodal_lipread_tpu.models import audio as jaudio
from multimodal_lipread_tpu.models.backbones import VGG as JVGG
from multimodal_lipread_tpu.models.frontend import WaveToLogMel as JWaveToLogMel
from multimodal_lipread_tpu.nn import common as jcommon
from multimodal_lipread_tpu.nn.recurrent import BiLSTM as JBiLSTM
from multimodal_lipread_tpu.utils.torch_import import convert_vgg_bn

from multimodal_lipread_torch.models import audio as paudio
from multimodal_lipread_torch.models.backbones import VGG
from multimodal_lipread_torch.models.frontend import WaveToLogMel
from multimodal_lipread_torch.nn import MLP, BiLSTM, ClassifierHead, adaptive_avg_pool2d
from multimodal_lipread_torch.utils.jax_bridge import state_dict_from_jax

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
TOL = 1e-4


def _run(module, *xs):
    with torch.no_grad():
        return module(*(torch.from_numpy(x) for x in xs)).float().numpy()


@pytest.mark.parametrize("size", [(2, 3), (None, 1), (1, None), (5, 4), (7, 13)])
def test_adaptive_avg_pool2d_matches_jax(size):
    x = np.random.default_rng(0).standard_normal((2, 7, 13, 3)).astype(np.float32)  # NHWC
    want = np.asarray(jcommon.adaptive_avg_pool2d(jnp.asarray(x), size))
    got = adaptive_avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), size).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("use_batchnorm", [True, False])
def test_classifier_head_matches_jax(use_batchnorm):
    x = np.random.default_rng(1).standard_normal((3, 24)).astype(np.float32)
    jm = jcommon.ClassifierHead(16, 5, 0.5, use_batchnorm)
    v = random_variables(jm, x, seed=1)
    pm = load_bridged(ClassifierHead(24, 16, 5, 0.5, use_batchnorm), v)
    np.testing.assert_allclose(_run(pm, x), np.asarray(jm.apply(v, x, train=False)), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("use_batchnorm", [True, False])
def test_mlp_matches_jax(use_batchnorm):
    x = np.random.default_rng(2).standard_normal((3, 10)).astype(np.float32)
    jm = jcommon.MLP((12, 6), 4, 0.2, use_batchnorm)
    v = random_variables(jm, x, seed=2)
    pm = load_bridged(MLP(10, (12, 6), 4, 0.2, use_batchnorm), v)
    np.testing.assert_allclose(_run(pm, x), np.asarray(jm.apply(v, x, train=False)), rtol=TOL, atol=TOL)


def test_bilstm_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 6, 10)).astype(np.float32)
    jm = JBiLSTM(8, num_layers=2)
    v = random_variables(jm, x, seed=3)
    pm = load_bridged(BiLSTM(10, 8, num_layers=2), v)
    np.testing.assert_allclose(_run(pm, x), np.asarray(jm.apply(v, x)), rtol=TOL, atol=TOL)


def test_bilstm_matches_lstm_golden():
    z = np.load(os.path.join(GOLDENS, "lstm.npz"))
    sd = G.synth_state(G.lstm_spec(**G.LSTM_CFG), G.SEED)
    pm = BiLSTM(G.LSTM_CFG["input_size"], G.LSTM_CFG["hidden"], G.LSTM_CFG["num_layers"])
    pm.load_state_dict({f"lstm.{k}": torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    np.testing.assert_allclose(_run(pm.eval(), z["x"]), z["want"], atol=1e-5, rtol=1e-4)


def test_vgg11_matches_golden_through_the_bridge():
    # torchvision names → JAX tree (torch_import) → port (jax_bridge)
    z = np.load(os.path.join(GOLDENS, "vgg11.npz"))
    variables = convert_vgg_bn(G.synth_state(G.vgg11_bn_features_spec(), G.SEED), version=11)
    pm = VGG(11, in_channels=3)
    pm.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]), strict=True)
    got = _run(pm.eval(), z["x"]).transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, z["want_nhwc"], atol=2e-4, rtol=1e-3)


def test_vgg_backbone_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 32, 40, 1)).astype(np.float32)  # NHWC
    jm = JVGG(11)
    v = random_variables(jm, x, seed=4)
    pm = load_bridged(VGG(11), v)
    got = _run(pm, x.transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x, train=False)), rtol=TOL, atol=TOL)


@pytest.mark.parametrize(
    "version, hidden, batch",
    [(11, 16, 2), (16, 128, 1)],  # small, and the served width (VGG16-BN, hidden 128)
)
def test_vgg_lstm_matches_jax(version, hidden, batch):
    x = np.random.default_rng(5).standard_normal((batch, 80, 117)).astype(np.float32)
    jm = jaudio.VGGWithLSTMClassifier(4, version=version, lstm_hidden=hidden)
    v = random_variables(jm, x, seed=5)
    pm = load_bridged(paudio.VGGWithLSTMClassifier(4, version=version, lstm_hidden=hidden), v)
    got = _run(pm, x)
    assert got.shape == (batch, 4)
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x, train=False)), rtol=TOL, atol=TOL)


def test_wave_to_logmel_matches_jax():
    rng = np.random.default_rng(6)
    wave = (rng.standard_normal((2, 20000)) * 1000).astype(np.float32)
    jm = JWaveToLogMel(jaudio.VGGWithLSTMClassifier(4, version=11, lstm_hidden=16), input_size=117)
    v = random_variables(jm, wave, seed=6)
    pm = load_bridged(WaveToLogMel(paudio.VGGWithLSTMClassifier(4, version=11, lstm_hidden=16), 117), v)
    assert any(k.startswith("model.vgg.") for k in pm.state_dict())
    np.testing.assert_allclose(_run(pm, wave), np.asarray(jm.apply(v, wave, train=False)), rtol=TOL, atol=TOL)


def test_get_audio_model_builds_vgg_lstm():
    m = paudio.get_audio_model("vgg_lstm", 4)
    assert isinstance(m, paudio.VGGWithLSTMClassifier)
    assert hasattr(m.vgg, "conv12") and not hasattr(m.vgg, "conv13")  # VGG16: 13 convs
    assert m.lstm.lstm.hidden_size == 128 and m.lstm.lstm.num_layers == 2


@pytest.mark.parametrize("name", [n for n in jaudio.AUDIO_MODEL_NAMES if n != "vgg_lstm"])
def test_get_audio_model_unported_names_point_at_roadmap(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        paudio.get_audio_model(name, 4)


def test_get_audio_model_unknown_name():
    with pytest.raises(ValueError):
        paudio.get_audio_model("nope", 4)


def test_vgg_lstm_bfloat16_tracks_float32():
    # model.dtype: bfloat16 casts the whole model; bf16 keeps ~3 significant digits
    x = np.random.default_rng(7).standard_normal((2, 80, 117)).astype(np.float32)
    v = random_variables(jaudio.VGGWithLSTMClassifier(4, version=11), x, seed=7)
    f32 = load_bridged(paudio.get_audio_model("vgg_lstm", 4, version=11), v)
    bf16 = load_bridged(paudio.get_audio_model("vgg_lstm", 4, version=11, dtype=torch.bfloat16), v)
    assert all(p.dtype == torch.bfloat16 for p in bf16.parameters())
    with torch.no_grad():
        assert bf16(torch.from_numpy(x)).dtype == torch.bfloat16
    np.testing.assert_allclose(_run(bf16, x), _run(f32, x), rtol=5e-2, atol=5e-2)
