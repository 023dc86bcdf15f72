"""The port's video + cue fusion models against the JAX package's at the
same weights (bridged from the JAX variables), on the CPU at B=3 on 4 lip
frames of 44 × 44 × 3 and 768-d cue embeddings: every registry model in
eval mode in float32 at 1e-4 on the logits, and in train mode (batch
statistics, dropout off on both sides: ``jax_dropout_off``) in float64 at
B=2 on 32 × 32 frames (XLA:CPU's float64 convolutions take seconds at the
eval shapes) at 1e-4 with the running statistics it updates, for the frozen mobile variants
with ``frozen_bn_eval`` off and on (on, the frozen backbone's statistics do
not move). Also ``SingleQueryAttention`` alone (its 2-D Dense kernels take
the bridge's Dense branch), the frozen backbone's eval mode through
``model.train()``, ``cached_features`` / ``return_frozen_features``, the
registry, ``freeze_backbone`` and bf16."""

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

from multimodal_lipread_tpu.models import cues_video as jcv
from multimodal_lipread_tpu.nn import SingleQueryAttention as JSingleQueryAttention

from multimodal_lipread_torch.models import cues_video as pcv
from multimodal_lipread_torch.nn.attention import SingleQueryAttention
from multimodal_lipread_torch.utils.jax_bridge import state_dict_from_jax

TOL = 1e-4
B, T = 3, 4
FROZEN = ("early_fusion_mobile", "middle_fusion_mobile", "late_fusion_mobile")


def _inputs(seed=0, b=B, size=44):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 768)).astype(np.float32) * 0.05,
            rng.uniform(0.0, 1.0, (b, T, size, size, 3)).astype(np.float32))


def _pair(name, seed=2, frozen_bn_eval=False):
    jm = jcv.get_cues_video_model(name, 4, frozen_bn_eval=frozen_bn_eval)
    v = random_variables(jm, *_inputs(), seed=seed)
    return jm, v, load_bridged(pcv.get_cues_video_model(name, 4, frozen_bn_eval=frozen_bn_eval), v)


@pytest.mark.parametrize("name", jcv.CUES_VIDEO_MODEL_NAMES)
def test_cues_video_model_eval_matches_jax(name):
    cue, lip = _inputs(1)
    jm, v, pm = _pair(name)
    want = np.asarray(jax.jit(lambda v, c, x: jm.apply(v, c, x, train=False))(v, cue, lip))
    with torch.no_grad():
        got = pm(torch.from_numpy(cue), torch.from_numpy(lip)).numpy()
    assert got.shape == want.shape == (B, 4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


TRAIN_CASES = [(n, False) for n in jcv.CUES_VIDEO_MODEL_NAMES] + [(n, True) for n in FROZEN]


@pytest.mark.parametrize("name,frozen_bn_eval", TRAIN_CASES,
                         ids=[f"{n}{'-frozen_bn_eval' if f else ''}" for n, f in TRAIN_CASES])
def test_cues_video_model_train_mode_matches_jax(name, frozen_bn_eval, jax_dropout_off):
    cue, lip = _inputs(3, b=2, size=32)  # XLA:CPU's float64 convolutions are slow
    jm, v, pm = _pair(name, frozen_bn_eval=frozen_bn_eval)
    j64 = jcv.get_cues_video_model(name, 4, dtype=jnp.float64, frozen_bn_eval=frozen_bn_eval)
    got, want, ours, running = train_mode_f64(j64, v, pm, cue, lip)
    assert want.dtype == np.float64 and ours
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert_running(ours, running)
    before = {k: t.numpy() for k, t in load_bridged(pcv.get_cues_video_model(name, 4), v).state_dict().items()}
    cnn_moved = [k for k in ours if k.startswith("video_encoder.cnn.") and not np.array_equal(ours[k], before[k])]
    assert bool(cnn_moved) != (frozen_bn_eval and name in FROZEN)


def test_single_query_attention_matches_jax():
    rng = np.random.default_rng(4)
    q, seq = rng.standard_normal((3, 16)).astype(np.float32), rng.standard_normal((3, 5, 24)).astype(np.float32)
    jm = JSingleQueryAttention(32)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), q, seq))
    assert v["params"]["query"]["kernel"].shape == (16, 32)  # 2-D Dense kernels, not MHA (D, heads, head_dim)
    sd = state_dict_from_jax(v["params"])
    np.testing.assert_array_equal(sd["query.weight"].numpy(), v["params"]["query"]["kernel"].T)
    np.testing.assert_array_equal(sd["key.weight"].numpy(), v["params"]["key"]["kernel"].T)
    pm = SingleQueryAttention(16, 24, 32)
    pm.load_state_dict(sd, strict=True)
    want = np.asarray(jm.apply(v, q, seq))
    with torch.no_grad():
        got = pm(torch.from_numpy(q), torch.from_numpy(seq)).numpy()
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_frozen_backbone_stays_in_eval_mode_through_train():
    m = pcv.get_cues_video_model("early_fusion_mobile", 4, frozen_bn_eval=True).train()
    assert m.training and m.video_encoder.lstm.training and not m.video_encoder.cnn.training
    assert not any(x.training for x in m.video_encoder.cnn.modules())
    m.eval().train()
    assert not m.video_encoder.cnn.training
    for name, fbe in (("early_fusion_mobile", False), ("early_fusion_resnet", True)):  # not frozen / frozen in eval
        assert pcv.get_cues_video_model(name, 4, frozen_bn_eval=fbe).train().video_encoder.cnn.training


def test_frozen_backbone_gets_no_gradient_and_cached_features_match():
    cue, lip = (torch.from_numpy(a) for a in _inputs(5))
    _, _, pm = _pair("middle_fusion_mobile", frozen_bn_eval=True)
    pm.train()
    feats = pm(cue, lip, return_frozen_features=True)
    assert feats.shape == (B, T, 1280) and not feats.requires_grad
    torch.manual_seed(0)
    direct = pm(cue, lip)
    torch.manual_seed(0)
    cached = pm(cue, feats, cached_features=True)
    torch.testing.assert_close(cached, direct, rtol=0, atol=0)
    direct.sum().backward()
    assert all(p.grad is None for p in pm.video_encoder.cnn.parameters())
    assert pm.video_encoder.lstm.lstm.weight_ih_l0.grad is not None


def test_registry_and_freeze_backbone():
    assert pcv.CUES_VIDEO_MODEL_NAMES == jcv.CUES_VIDEO_MODEL_NAMES
    assert pcv.FROZEN_PARAM_PREFIXES == jcv.FROZEN_PARAM_PREFIXES
    for name in pcv.CUES_VIDEO_MODEL_NAMES:
        assert type(pcv.get_cues_video_model(name, 4)).__name__ == type(jcv.get_cues_video_model(name, 4)).__name__
    with pytest.raises(ValueError):
        pcv.get_cues_video_model("nope", 4)
    assert pcv.get_cues_video_model("early_fusion_mobile", 4).video_encoder.frozen
    assert not pcv.get_cues_video_model("early_fusion_mobile", 4, freeze_backbone=False).video_encoder.frozen
    assert pcv.get_cues_video_model("late_fusion_resnet", 4, freeze_backbone=True).video_encoder.frozen
    m = pcv.get_cues_video_model("middle_fusion_resnet", 4)
    assert m.video_encoder.lstm.lstm.num_layers == 2 and m.video_encoder.lstm.dropout.rate == 0.3
    assert pcv.get_cues_video_model("middle_fusion_mobile", 4).video_encoder.lstm.dropout.rate == 0.0
    assert sum(p.numel() for p in m.parameters()) == 12_888_644


def test_cues_video_bfloat16_keeps_float32_parameters():
    cue, lip = (torch.from_numpy(a) for a in _inputs(6))
    m = pcv.get_cues_video_model("late_fusion_mobile", 4, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        out = m(cue, lip)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert all(t.dtype == torch.float32 for t in list(m.parameters()) + list(m.buffers()))
