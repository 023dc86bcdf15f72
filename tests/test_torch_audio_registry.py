"""The port's eight audio models against the JAX package's at the same
weights (bridged from the JAX variables, see tests/torch_parity_utils.py),
on the CPU at B=2 over an 80 × 32 log-mel (the VGGs pool 32 steps down to
one): in eval mode in float32 at 1e-4 on the logits, and in train mode
(batch statistics, dropout off on both sides) in float64 at 1e-4 with the
running statistics it updates; ``use_batchnorm=False`` too. Also the
registry's signature and what the audio pipeline and serving pass it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_utils import (  # noqa: F401 (fixtures)
    assert_running,
    jax_dropout_off,
    load_bridged,
    one_torch_thread,
    random_variables,
    train_mode_f64,
)

from multimodal_lipread_tpu.models import audio as jaudio

from multimodal_lipread_torch import serving
from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.models import audio as paudio
from multimodal_lipread_torch.nn.common import Dropout

TOL = 1e-4
B, MEL_T = 2, 32


def _mel(seed=0, t=MEL_T):
    return np.random.default_rng(seed).standard_normal((B, 80, t)).astype(np.float32)


def _kw(name):
    # vgg / vgg_lstm at VGG11 (the registry's 16 is held by test_torch_vgg_lstm.py)
    return {"version": 11} if name.startswith("vgg") else {}


@pytest.mark.parametrize("name", jaudio.AUDIO_MODEL_NAMES)
def test_audio_model_matches_jax(name, jax_dropout_off):
    x = _mel(1)
    jm = jaudio.get_audio_model(name, 4, input_size=MEL_T, **_kw(name))
    v = random_variables(jm, x, seed=2)
    pm = load_bridged(paudio.get_audio_model(name, 4, input_size=MEL_T, **_kw(name)), v)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, 4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    j64 = jaudio.get_audio_model(name, 4, input_size=MEL_T, dtype=jnp.float64, **_kw(name))
    got, want, ours, running = train_mode_f64(j64, v, pm, x)
    assert want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert_running(ours, running)


@pytest.mark.parametrize("name", ["resnet", "vgg", "lstm_resnet_attn"])
def test_audio_model_without_batchnorm_matches_jax(name):
    # the reference's models_without_reg ablations
    x = _mel(3)
    jm = jaudio.get_audio_model(name, 4, input_size=MEL_T, use_batchnorm=False, **_kw(name))
    v = random_variables(jm, x, seed=4)
    pm = load_bridged(paudio.get_audio_model(name, 4, input_size=MEL_T, use_batchnorm=False, **_kw(name)), v)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x))
    with torch.no_grad():
        np.testing.assert_allclose(pm(torch.from_numpy(x)).numpy(), want, rtol=TOL, atol=TOL)


def test_registry_matches_jax():
    assert paudio.AUDIO_MODEL_NAMES == jaudio.AUDIO_MODEL_NAMES
    for name in paudio.AUDIO_MODEL_NAMES:
        got, want = paudio.get_audio_model(name, 4), jaudio.get_audio_model(name, 4)
        assert type(got).__name__ == type(want).__name__
        rates = {m.rate for m in got.modules() if isinstance(m, Dropout) and m.rate > 0}
        assert rates <= {getattr(want, "dropout_rate", None), 0.1}  # the transformer layers' own 0.1
    with pytest.raises(ValueError):
        paudio.get_audio_model("nope", 4)
    assert paudio.get_audio_model("conformer", 4).classifier.in_features == 128
    assert paudio.get_audio_model("conformer", 4, d_model=144).classifier.in_features == 144
    assert paudio.get_audio_model("lstm_resnet", 4, input_size=100).stem.initial_bilstm.lstm.input_size == 100
    assert paudio.get_audio_model("vgg", 4, version=13).vgg.version == 13


def test_serving_builds_the_audio_model_the_pipeline_trains():
    cfg = Config.from_dict({"dataset": {"num_classes": 5, "input_size": 60},
                            "model": {"name": "conformer", "d_model": 64}})
    m = serving.build_audio_model(cfg)
    assert isinstance(m, paudio.AudioConformer) and m.classifier.in_features == 64
    cfg = Config.from_dict({"dataset": {"num_classes": 5, "input_size": 60}, "model": {"name": "lstm_resnet_trans"}})
    assert serving.build_audio_model(cfg).stem.initial_bilstm.lstm.input_size == 60
