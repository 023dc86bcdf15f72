"""The port's audio + cue + video fusion models against the JAX package's
at the same weights (bridged from the JAX variables), on the CPU at B=3 on
a log-mel of 80 × 40, 768-d cue embeddings and 4 lip frames of 44 × 44 × 3:
every registry model in eval mode in float32 at 1e-4 on the logits, and in
train mode (batch statistics, dropout off on both sides:
``jax_dropout_off``) in float64 at B=2 on 80 × 24 mels and 32 × 32 frames
(XLA:CPU's float64 convolutions take seconds at the eval shapes) at 1e-4
with the running statistics it updates, for the variants with frozen
encoders with ``frozen_bn_eval`` off and on (on, the frozen encoders' statistics do not move). Also
``ModalityAttentionFusion`` alone (a softmax over the modality axis), the
frozen encoders' eval mode through ``model.train()``, ``cached_features`` /
``return_frozen_features``, the registry and bf16."""

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

from multimodal_lipread_tpu.models import audio_cues_video as jacv

from multimodal_lipread_torch.models import audio_cues_video as pacv

TOL = 1e-4
B, T, MEL_T = 3, 4, 40
FROZEN = ("early_fusion_mobile", "early_fusion_resnet", "middle_fusion_resnet")


def _inputs(seed=0, b=B, size=44, mel_t=MEL_T):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 80, mel_t)).astype(np.float32),
            rng.standard_normal((b, 768)).astype(np.float32) * 0.05,
            rng.uniform(0.0, 1.0, (b, T, size, size, 3)).astype(np.float32))


def _pair(name, seed=2, frozen_bn_eval=False):
    jm = jacv.get_triple_model(name, 4, frozen_bn_eval=frozen_bn_eval)
    v = random_variables(jm, *_inputs(), seed=seed)
    return jm, v, load_bridged(pacv.get_triple_model(name, 4, frozen_bn_eval=frozen_bn_eval), v)


@pytest.mark.parametrize("name", jacv.TRIPLE_MODEL_NAMES)
def test_triple_model_eval_matches_jax(name):
    inputs = _inputs(1)
    jm, v, pm = _pair(name)
    want = np.asarray(jax.jit(lambda v, *x: jm.apply(v, *x, train=False))(v, *inputs))
    with torch.no_grad():
        got = pm(*(torch.from_numpy(x) for x in inputs)).numpy()
    assert got.shape == want.shape == (B, 4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


TRAIN_CASES = [(n, False) for n in jacv.TRIPLE_MODEL_NAMES] + [(n, True) for n in FROZEN]


@pytest.mark.parametrize("name,frozen_bn_eval", TRAIN_CASES,
                         ids=[f"{n}{'-frozen_bn_eval' if f else ''}" for n, f in TRAIN_CASES])
def test_triple_model_train_mode_matches_jax(name, frozen_bn_eval, jax_dropout_off):
    inputs = _inputs(3, b=2, size=32, mel_t=24)  # XLA:CPU's float64 convolutions are slow
    jm, v, pm = _pair(name, frozen_bn_eval=frozen_bn_eval)
    j64 = jacv.get_triple_model(name, 4, dtype=jnp.float64, frozen_bn_eval=frozen_bn_eval)
    got, want, ours, running = train_mode_f64(j64, v, pm, *inputs)
    assert want.dtype == np.float64 and ours
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert_running(ours, running)
    before = {k: t.numpy() for k, t in load_bridged(pacv.get_triple_model(name, 4), v).state_dict().items()}
    for prefix in ("audio.resnet.", "video.cnn."):
        moved = [k for k in ours if k.startswith(prefix) and not np.array_equal(ours[k], before[k])]
        assert bool(moved) != frozen_bn_eval, prefix


def test_modality_attention_fusion_matches_jax():
    rng = np.random.default_rng(4)
    feats = [rng.standard_normal((5, 6)).astype(np.float32) * s for s in (1.0, 3.0, 0.5)]
    jm = jacv.ModalityAttentionFusion()
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), feats))
    assert v["params"]["attn_fc1"]["kernel"].shape == (6, 3)  # hidden max(d // 2, 1)
    pm = load_bridged(pacv.ModalityAttentionFusion(6), v)
    jfused, jweights = jm.apply(v, feats)
    with torch.no_grad():
        fused, weights = pm([torch.from_numpy(f) for f in feats])
    assert weights.shape == (5, 3)  # one weight per modality, per example
    np.testing.assert_allclose(weights.sum(dim=1).numpy(), np.ones(5), rtol=1e-6)
    np.testing.assert_allclose(weights.numpy(), np.asarray(jweights), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(fused.numpy(), np.asarray(jfused), rtol=TOL, atol=TOL)
    with torch.no_grad():  # an example's weights do not depend on the others
        _, first = pm([torch.from_numpy(f[:1]) for f in feats])
    torch.testing.assert_close(first, weights[:1])
    assert pacv.ModalityAttentionFusion(1).attn_fc1.out_features == 1


def test_frozen_encoders_stay_in_eval_mode_through_train():
    m = pacv.get_triple_model("middle_fusion_resnet", 4, frozen_bn_eval=True).train()
    assert m.training and m.cue.training and m.video.lstm.training
    assert not m.audio.resnet.training and not m.video.cnn.training
    assert not any(x.training for x in m.audio.resnet.modules())
    for name, fbe in (("early_fusion_mobile", False), ("late_fusion_mobile", True)):  # frozen, BN train / not frozen
        t = pacv.get_triple_model(name, 4, frozen_bn_eval=fbe).train()
        assert t.audio.resnet.training and t.video.cnn.training


def test_frozen_encoders_get_no_gradient_and_cached_features_match():
    mel, cue, lip = (torch.from_numpy(a) for a in _inputs(5))
    _, _, pm = _pair("early_fusion_resnet", frozen_bn_eval=True)
    pm.train()
    audio, video = pm(mel, cue, lip, return_frozen_features=True)
    assert audio.shape == (B, 512) and video.shape == (B, T, 512)
    torch.manual_seed(0)
    direct = pm(mel, cue, lip)
    torch.manual_seed(0)
    cached = pm(audio, cue, video, cached_features=True)
    torch.testing.assert_close(cached, direct, rtol=0, atol=0)
    direct.sum().backward()
    assert all(p.grad is None for p in list(pm.audio.resnet.parameters()) + list(pm.video.cnn.parameters()))
    assert pm.video.lstm.lstm.weight_ih_l0.grad is not None and pm.cue.fc1.weight.grad is not None


def test_registry_matches_jax():
    assert pacv.TRIPLE_MODEL_NAMES == jacv.TRIPLE_MODEL_NAMES
    assert pacv.FROZEN_PARAM_PREFIXES == jacv.FROZEN_PARAM_PREFIXES
    for name in pacv.TRIPLE_MODEL_NAMES:
        m = pacv.get_triple_model(name, 4)
        assert type(m).__name__ == type(jacv.get_triple_model(name, 4)).__name__
        if name != "test_model":
            assert m.audio.frozen == m.video.frozen == (name in FROZEN)
            assert m.video.lstm.lstm.num_layers == (1 if name in FROZEN else 2)
    with pytest.raises(ValueError):
        pacv.get_triple_model("nope", 4)
    late = pacv.get_triple_model("late_fusion_mobile", 4)
    assert late.cue.style == "plain" and late.attn.attn_fc1.out_features == 2
    assert pacv.get_triple_model("early_fusion_mobile", 4).cue.style == "early"
    assert sum(p.numel() for p in late.parameters()) == 15_500_505


def test_triple_bfloat16_keeps_float32_parameters():
    mel, cue, lip = (torch.from_numpy(a) for a in _inputs(6))
    m = pacv.get_triple_model("middle_fusion_mobile", 4, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        out = m(mel, cue, lip)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert all(t.dtype == torch.float32 for t in list(m.parameters()) + list(m.buffers()))
