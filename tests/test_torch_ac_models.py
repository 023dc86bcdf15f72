"""The port's audio + cue fusion models against the JAX package's at the
same weights (bridged from the JAX variables), on the CPU at B=3 on a
log-mel of 80 × 40 and 768-d cue embeddings: every registry model, and the
two early-fusion models with the reference's batch-softmax gate too, in
eval mode in float32 at 1e-4 on the logits and in train mode (batch
statistics, dropout off on both sides: ``jax_dropout_off``) in float64 at
1e-4 with the running statistics it updates. Also MobileNetV2 over one
channel, the open-gate bias and the late fusion's weights at
initialization, the registry and bf16."""

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

from multimodal_lipread_tpu.models import audio_cues as jac
from multimodal_lipread_tpu.models.backbones import MobileNetV2 as JMobileNetV2

from multimodal_lipread_torch.models import audio_cues as pac
from multimodal_lipread_torch.models.backbones import MobileNetV2
from multimodal_lipread_torch.nn.common import flax_init_

TOL = 1e-4
B, MEL_T = 3, 40


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 80, MEL_T)).astype(np.float32),
            rng.standard_normal((B, 768)).astype(np.float32) * 0.05)


CASES = [(name, False) for name in jac.AUDIO_CUES_MODEL_NAMES] + [
    ("early_fusion_mobile", True), ("early_fusion_resnet", True)]


def _jax_model(name, gate, dtype=jnp.float32):
    if gate:
        return jac.get_audio_cues_model(name, 4, dtype=dtype).clone(batch_softmax_gate=True)
    return jac.get_audio_cues_model(name, 4, dtype=dtype)


@pytest.mark.parametrize("name,gate", CASES, ids=[f"{n}{'-batch_softmax' if g else ''}" for n, g in CASES])
def test_audio_cues_model_matches_jax(name, gate, jax_dropout_off):
    mel, cue = _inputs(1)
    jm = _jax_model(name, gate)
    v = random_variables(jm, mel, cue, seed=2)
    pm = load_bridged(pac._REGISTRY[name](4, batch_softmax_gate=True) if gate else pac.get_audio_cues_model(name, 4), v)
    want = np.asarray(jax.jit(lambda v, a, c: jm.apply(v, a, c, train=False))(v, mel, cue))
    with torch.no_grad():
        got = pm(torch.from_numpy(mel), torch.from_numpy(cue)).numpy()
    assert got.shape == want.shape == (B, 4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    got, want, ours, running = train_mode_f64(_jax_model(name, gate, jnp.float64), v, pm, mel, cue)
    assert want.dtype == np.float64 and ours
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert_running(ours, running)


def test_mobilenet_v2_over_one_channel_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 80, 117, 1)).astype(np.float32)
    jm = JMobileNetV2()
    v = random_variables(jm, x, seed=4)
    pm = load_bridged(MobileNetV2(in_channels=1), v)
    assert pm.stem.conv.weight.shape == (32, 1, 3, 3)  # the JAX stem kernel (3, 3, 1, 32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, False))(v, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 1280)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert MobileNetV2().stem.conv.in_channels == 3


def test_open_gate_and_late_weights_at_initialization():
    m = flax_init_(pac.get_audio_cues_model("early_fusion_mobile", 4), torch.Generator().manual_seed(0))
    assert torch.equal(m.fusion.attn_fc2.bias, torch.full((1,), 2.0))
    assert not m.fusion.attn_fc1.bias.any() and not m.fusion.fc1.bias.any()
    late = flax_init_(pac.get_audio_cues_model("late_fusion_resnet", 4), torch.Generator().manual_seed(0))
    assert torch.equal(late.late.attn_weights, torch.ones(2))
    jv = jax.eval_shape(lambda: jac.get_audio_cues_model("early_fusion_mobile", 4).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)}, *_inputs()))
    assert jv["params"]["fusion"]["attn_fc2"]["bias"].shape == (1,)


def test_batch_softmax_gate_couples_the_batch():
    mel, cue = (torch.from_numpy(a) for a in _inputs(5))
    for gate, coupled in ((False, False), (True, True)):
        m = flax_init_(pac.EarlyFusionAttentionResNet(4, batch_softmax_gate=gate),
                       torch.Generator().manual_seed(1)).eval()
        with torch.no_grad():
            whole, first = m(mel, cue)[:1], m(mel[:1], cue[:1])
        assert torch.allclose(whole, first, atol=1e-6) != coupled


def test_registry_matches_jax():
    assert pac.AUDIO_CUES_MODEL_NAMES == jac.AUDIO_CUES_MODEL_NAMES
    for name in pac.AUDIO_CUES_MODEL_NAMES:
        assert type(pac.get_audio_cues_model(name, 4)).__name__ == type(jac.get_audio_cues_model(name, 4)).__name__
    with pytest.raises(ValueError):
        pac.get_audio_cues_model("nope", 4)
    m = pac.get_audio_cues_model("middle_fusion_mobile", 4)
    assert m.fusion.cross_attn.query.in_features == 1408 and m.cue_encoder.fc.in_features == 768
    assert sum(p.numel() for p in m.parameters()) == 10_618_948


def test_audio_cues_bfloat16_keeps_float32_parameters():
    mel, cue = (torch.from_numpy(a) for a in _inputs(6))
    for name in ("middle_fusion_mobile", "late_fusion_resnet"):
        m = pac.get_audio_cues_model(name, 4, dtype=torch.bfloat16).eval()
        with torch.no_grad():
            out = m(mel, cue)
        assert torch.isfinite(out).all()
        assert all(t.dtype == torch.float32 for t in list(m.parameters()) + list(m.buffers()))
