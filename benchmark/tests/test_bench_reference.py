"""The benchmark's plain reference against the program, on the CPU at small
sizes: the WAV reader, the log-mel, both models' forward passes with the
benchmark's weights, and Adam with coupled L2."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import data, weights  # noqa: E402
from benchmark.reference import layers, logmel, middle_fusion_mobilenet, train, vgg_lstm  # noqa: E402

CFG = {"dataset": {"num_classes": 4, "input_size": 117, "audio_input_size": 117}}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return data.make_corpus(str(tmp_path_factory.mktemp("corpus")), 6, 11, torch.device("cpu"), lips=True)


def test_read_wav_matches_the_program(corpus):
    from multimodal_lipread_torch.data.audio_io import load_waveform

    for i, path in enumerate(corpus.wav_paths):
        ours = layers.read_wav(path)
        assert np.array_equal(ours, corpus.waves[i])
        np.testing.assert_array_equal(load_waveform(path), ours.astype(np.float32))


def test_logmel_matches_the_program_in_float64(corpus):
    from multimodal_lipread_torch.ops.logmel_cuda import log_mel_float64

    waves = torch.from_numpy(corpus.waves)
    # the program's float64 evaluation reads its float32 tables upcast
    ours = logmel.log_mel(waves.double())
    np.testing.assert_allclose(ours.numpy(), log_mel_float64(waves).numpy(), atol=2e-5, rtol=0)
    # float32 loses digits where the power spectrum cancels (spectral nulls)
    ours32 = logmel.log_mel(waves)
    np.testing.assert_allclose(ours32.numpy(), log_mel_float64(waves).numpy(), atol=1e-3, rtol=0)


def test_mel_filterbank_matches_the_program():
    from multimodal_lipread_torch.ops.logmel import mel_filterbank

    np.testing.assert_allclose(logmel.mel_filterbank(), mel_filterbank(), atol=1e-7)


def _program_model(name):
    if name == "vgg_lstm":
        from multimodal_lipread_torch.models.audio import get_audio_model
        from multimodal_lipread_torch.models.frontend import WaveToLogMel

        return WaveToLogMel(get_audio_model("vgg_lstm", 4, input_size=117, version=16)), "model."
    from multimodal_lipread_torch.models.audio_video import get_av_model

    return get_av_model("middle_fusion_mobilenet", 4, input_size=117), ""


@pytest.mark.parametrize("module", [vgg_lstm, middle_fusion_mobilenet], ids=["vgg_lstm", "middle_fusion_mobilenet"])
@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
def test_forward_matches_the_program(corpus, module, train_mode):
    from multimodal_lipread_torch.nn.common import Dropout

    name = module.__name__.rsplit(".", 1)[1]
    spec = module.param_spec(CFG)
    w = weights.make(spec, 3, torch.device("cpu"))
    model, prefix = _program_model(name)
    model.load_state_dict({prefix + n: t for n, t in w.items()}, strict=True)
    model.train(train_mode)
    gen_program, gen_reference = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = gen_program
    waves = torch.from_numpy(corpus.waves[:4])
    if name == "vgg_lstm":
        inputs, program_inputs = (waves,), (waves.float(),)
    else:
        from multimodal_lipread_torch.ops.logmel import log_mel_reference

        lips = torch.from_numpy(corpus.lips[:4])
        inputs = (waves, lips)
        program_inputs = (log_mel_reference(waves.float())[:, :80, :117], lips.float() / 255.0)
    with torch.no_grad():
        ours = module.forward(w, CFG, inputs, train_mode, gen_reference)
        theirs = model(*program_inputs)
    scale = float(ours.abs().max())
    np.testing.assert_allclose(theirs.numpy(), ours.numpy(), atol=1e-4 * scale, rtol=0)


def test_adam_with_coupled_l2_matches_torch():
    torch.manual_seed(0)
    layer = torch.nn.Linear(5, 3)
    params = {"w.weight": layer.weight.detach().clone(), "w.bias": layer.bias.detach().clone()}

    class Tiny:
        @staticmethod
        def forward(p, cfg, inputs, train_mode, generator):
            return layers.linear(p, "w", inputs[0])

    batches = [((torch.randn(4, 5),), torch.randint(0, 3, (4,)), torch.ones(4)) for _ in range(3)]
    out = train.train_steps(Tiny, {}, params, ["w.weight", "w.bias"], batches, 1e-2, 1e-2, None)
    opt = torch.optim.Adam(layer.parameters(), lr=1e-2, weight_decay=1e-2)
    losses = []
    for (x,), y, wts in batches:
        loss = (torch.nn.functional.cross_entropy(layer(x), y, reduction="none") * wts).sum() / wts.sum()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(out["losses"], losses, rtol=1e-6)
    deltas = [(layer.weight - params["w.weight"]).norm().item(), (layer.bias - params["w.bias"]).norm().item()]
    np.testing.assert_allclose(out["delta_norms"], deltas, rtol=1e-5)


def test_param_specs_name_every_tensor_of_the_program():
    for module in (vgg_lstm, middle_fusion_mobilenet):
        model, prefix = _program_model(module.__name__.rsplit(".", 1)[1])
        theirs = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        ours = {prefix + n: tuple(s) for n, (s, _k, _f) in module.param_spec(CFG).items()}
        assert ours == theirs
