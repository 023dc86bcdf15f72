"""The port's audio-video fusion models and MobileNetV3-small against the
JAX package's at the same weights (bridged from the JAX variables, see
tests/torch_parity_utils.py), on the CPU at B=2, T=3 frames of 44 × 44 × 3
and a log-mel of 80 × 32 (the mid-fusion models are built for that width):
in eval mode in float32 at 1e-4 on the logits, and in train mode (batch
statistics, dropout off on both sides: ``jax_dropout_off``) in float64 at
1e-4, with the running
statistics it updates. In float32 a train-mode MobileNetV3 normalizes its
last maps (2 × 2 at 44 × 44 input) over a handful of values per channel,
where both packages part from float64 by more than 1e-4. Also
MobileNetV3-small against the torchvision-shaped stand-in of
tests/test_torch_import_mobilenet.py through the port's converter, the
registry, the two BiLSTM summaries, the 0-d ``alpha`` and the mid-fusion
flatten order."""

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
    running_from_jax,
    train_mode_f64,
)

from multimodal_lipread_tpu.models import audio_video as jav
from multimodal_lipread_tpu.models.backbones import MobileNetV3Small as JMobileNetV3Small

from multimodal_lipread_torch.models import audio_video as pav
from multimodal_lipread_torch.models.backbones import MobileNetV3Small
from multimodal_lipread_torch.nn.common import flax_init_
from multimodal_lipread_torch.utils.torch_import import convert_mobilenet_v3_small

TOL = 1e-4
B, T, MEL_T = 2, 3, 32


def _inputs(seed=0, b=B, t=T, mel_t=MEL_T):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 80, mel_t)).astype(np.float32),
            rng.random((b, t, 44, 44, 3), np.float32))


# --- MobileNetV3-small --------------------------------------------------------


def test_mobilenet_v3_small_matches_jax():
    x = np.random.default_rng(1).random((6, 44, 44, 3), np.float32)
    jm = JMobileNetV3Small()
    v = random_variables(jm, x, seed=3)
    pm = load_bridged(MobileNetV3Small(), v)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, False))(v, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (6, 576)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    jm64 = JMobileNetV3Small(dtype=jnp.float64)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        out, upd = jax.jit(lambda v, x: jm64.apply(v, x, True, mutable=["batch_stats"]))(v64, x.astype(np.float64))
        want, running = np.asarray(out), running_from_jax(jax.tree_util.tree_map(np.asarray, upd["batch_stats"]))
    pm = pm.double().train()
    with torch.no_grad():
        got = pm(torch.from_numpy(x).double().permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert_running({k: t.numpy() for k, t in pm.state_dict().items() if "running_" in k}, running)


def test_mobilenet_v3_small_matches_the_torchvision_layout():
    from test_torch_import_mobilenet import _TorchMobileNetV3Small, _randomize_bn_stats

    torch.manual_seed(0)
    tmodel = _TorchMobileNetV3Small().eval()
    _randomize_bn_stats(tmodel)
    pm = MobileNetV3Small().eval()
    pm.load_state_dict(convert_mobilenet_v3_small(tmodel.state_dict()), strict=True)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 3, 44, 44)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(pm(x), tmodel(x), rtol=TOL, atol=TOL)


def test_mobilenet_v3_small_details():
    m = MobileNetV3Small()
    bns = [mod for mod in m.modules() if hasattr(mod, "eps")]
    assert bns and all(bn.eps == 1e-3 for bn in bns)  # torchvision's V3 eps, not V2's 1e-5
    assert m.block0.expand is None and m.block1.expand is not None  # block 0 keeps its width
    assert m.block0.se.fc1.out_channels == 8 and m.block3.se.fc1.out_channels == 24  # _make_divisible(e // 4)
    assert m.block0.se.fc1.bias is not None
    assert [m.get_submodule(f"block{i}").residual for i in range(11)] == [False, False, True, False, True, True,
                                                                        False, True, False, True, True]
    # the library's activations are the JAX relu6(x + 3) / 6 and x times it
    from multimodal_lipread_tpu.models.backbones import mobilenet as jmobilenet

    x = np.linspace(-5, 5, 101, dtype=np.float32)
    np.testing.assert_allclose(torch.nn.functional.hardsigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(jmobilenet._hardsigmoid(x)), rtol=0, atol=1e-7)
    np.testing.assert_allclose(torch.nn.functional.hardswish(torch.from_numpy(x)).numpy(),
                               np.asarray(jmobilenet._hardswish(x)), rtol=0, atol=1e-6)


# --- the seven fusion models ------------------------------------------------


@pytest.mark.parametrize("name", jav.AV_MODEL_NAMES)
def test_av_model_matches_jax(name, jax_dropout_off):
    audio, video = _inputs(1)
    jm = jav.get_av_model(name, 4)
    v = random_variables(jm, audio, video, seed=2)
    pm = load_bridged(pav.get_av_model(name, 4, input_size=MEL_T), v)
    want = np.asarray(jax.jit(lambda v, a, x: jm.apply(v, a, x, train=False))(v, audio, video))
    with torch.no_grad():
        got = pm(torch.from_numpy(audio), torch.from_numpy(video)).numpy()
    assert got.shape == want.shape == (B, 4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    got, want, ours, running = train_mode_f64(jav.get_av_model(name, 4, dtype=jnp.float64), v, pm, audio, video)
    assert want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert_running(ours, running)


def test_registry_matches_jax():
    assert pav.AV_MODEL_NAMES == jav.AV_MODEL_NAMES
    for name in pav.AV_MODEL_NAMES:
        assert type(pav.get_av_model(name, 4)).__name__ == type(jav.get_av_model(name, 4)).__name__
    with pytest.raises(ValueError):
        pav.get_av_model("nope", 4)
    with pytest.raises(ValueError):
        pav.VideoSeqEncoder("vgg")


def test_middle_fusion_widths_follow_the_input_size():
    # av_config.yaml at 117: a 64·20·29 = 37 120-d audio map ⊕ 512
    m = pav.get_av_model("middle_fusion_mobilenet", 4)
    assert m.classifier.fc1.in_features == 37632 and m.classifier.fc1.out_features == 512
    assert 19.2e6 < m.classifier.fc1.weight.numel() + m.classifier.fc1.bias.numel() < 19.4e6
    assert pav.get_av_model("middle_fusion_fast", 4).audio_encoder.fc.in_features == 16 * 40 * 58
    narrow = pav.get_av_model("middle_fusion_mobilenet", 4, input_size=100)
    assert narrow.classifier.fc1.in_features == 64 * 20 * 25 + 512


def test_mid_fusion_flattens_in_the_nhwc_order():
    # the JAX module flattens its (B, H, W, C) map: feature (h, w, c) sits
    # at (h·W + w)·C + c
    enc = pav.AudioCNNMidEncoder(8, (2,), use_batchnorm=False)
    mel = torch.zeros(1, 80, 8)
    with torch.no_grad():
        enc.conv0.weight.zero_()
        enc.conv0.bias.copy_(torch.tensor([1.0, 2.0]))
        mel[0, 6, 2] = 100.0  # pools into (h, w) = (3, 1) of the 40 × 4 map
        enc.conv0.weight[0, 0, 1, 1] = 1.0
        flat = enc(mel)
    assert flat.shape == (1, 40 * 4 * 2)
    assert int(flat.argmax()) == (3 * 4 + 1) * 2 + 0


def test_bilstm_summaries():
    out = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    got = pav.bilstm_final_hidden(out, 2)
    want = jav.bilstm_final_hidden(jnp.asarray(out.numpy()), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    torch.testing.assert_close(got, torch.cat([out[:, -1, :2], out[:, 0, 2:]], dim=-1))


@pytest.mark.parametrize("name", ["late_fusion_mobilenet", "late_fusion_fast"])
def test_late_fusion_alpha(name):
    m = flax_init_(pav.get_av_model(name, 4, input_size=MEL_T), torch.Generator().manual_seed(0))
    assert m.alpha.shape == () and float(m.alpha.detach()) == 0.5  # the initializers leave it at 0.5
    assert "alpha" in dict(m.named_parameters())
    audio, video = (torch.from_numpy(x) for x in _inputs(3))
    m.eval()
    with torch.no_grad():
        a = m.audio_classifier(m.audio_encoder(audio))
        v = m.video_classifier(m.video_encoder(video))
        m.alpha.fill_(0.25)
        torch.testing.assert_close(m(audio, video), 0.25 * a + 0.75 * v)


def test_av_model_bfloat16_keeps_float32_parameters():
    audio, video = (torch.from_numpy(x) for x in _inputs(4))
    f32 = flax_init_(pav.get_av_model("early_fusion_fast", 4), torch.Generator().manual_seed(1)).eval()
    bf16 = pav.get_av_model("early_fusion_fast", 4, dtype=torch.bfloat16).eval()
    bf16.load_state_dict(f32.state_dict())
    with torch.no_grad():
        got, want = bf16(audio, video), f32(audio, video)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert all(t.dtype == torch.float32 for t in list(bf16.parameters()) + list(bf16.buffers()))
    torch.testing.assert_close(got.float(), want, rtol=0.1, atol=0.1 * float(want.abs().max()))
