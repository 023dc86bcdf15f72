"""The port's audio serving path against the JAX package's, plus its host
pieces (config, WAV decode, GLips scan, checkpoints).

The end-to-end case: one set of vgg_lstm weights, a JAX checkpoint served by
the JAX ``predict_audio_clips`` and a port checkpoint (made through the
bridge) served by the port's, on the synthetic GLips tree, in both the
features-first and the streaming (``WaveToLogMel``) branch."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from torch_parity_utils import load_bridged, random_variables

from multimodal_lipread_tpu import serving as jserving
from multimodal_lipread_tpu.config import Config as JConfig
from multimodal_lipread_tpu.data import audio_io as jaudio_io
from multimodal_lipread_tpu.data.glips import scan_glips as jscan_glips
from multimodal_lipread_tpu.models.audio import get_audio_model as jget_audio_model
from multimodal_lipread_tpu.models.frontend import WaveToLogMel as JWaveToLogMel
from multimodal_lipread_tpu.pipelines.common import compute_logmel_features as jfeatures
from multimodal_lipread_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint

from multimodal_lipread_torch import serving
from multimodal_lipread_torch.config import Config, coerce_yaml_scalar, load_config
from multimodal_lipread_torch.data import audio_io
from multimodal_lipread_torch.data.glips import scan_glips
from multimodal_lipread_torch.ops import logmel_cuda
from multimodal_lipread_torch.pipelines.common import (
    compute_logmel_features,
    decode_waveforms,
    model_dtype,
)
from multimodal_lipread_torch.train.checkpoint import (
    load_checkpoint,
    load_module_state,
    module_state,
    save_checkpoint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


def _cfg(root, streaming):
    return {
        "dataset": {"root_dir": root, "num_classes": 4, "input_size": 117, "streaming": streaming},
        "model": {"name": "vgg_lstm", "version": 11},
    }


@pytest.fixture(scope="module", params=[False, True], ids=["features_first", "streaming"])
def served(request, glips_root, tmp_path_factory):
    """Both packages serve the test split from one set of weights."""
    streaming = request.param
    tmp = tmp_path_factory.mktemp("serve")
    clips = [e.path for e in jscan_glips(glips_root).by_split("test")]
    waves = jaudio_io.load_waveform(clips[0])[None]
    jmodel = jget_audio_model("vgg_lstm", 4, version=11)
    example = waves if streaming else jfeatures(waves)
    if streaming:
        jmodel = JWaveToLogMel(jmodel, input_size=117)
    v = random_variables(jmodel, example, seed=11)
    tree = {"epoch": 3, "val_acc": 0.5, "scheduler_lr": 1e-4,
            "state": {"params": v["params"], "batch_stats": v["batch_stats"]}}
    jckpt = str(tmp / "jax_best.msgpack")
    jsave_checkpoint(jckpt, tree)
    want = jserving.predict_audio_clips(JConfig.from_dict(_cfg(glips_root, streaming)), jckpt, clips, batch_size=16)

    cfg = Config.from_dict(_cfg(glips_root, streaming))
    pmodel = load_bridged(serving.build_audio_model(cfg), v)
    pckpt = str(tmp / "torch_best.pt")
    save_checkpoint(pckpt, {**tree, "state": module_state(pmodel)})
    return cfg, pckpt, clips, want


def test_predict_audio_clips_matches_jax(served):
    cfg, ckpt, clips, want = served
    got = serving.predict_audio_clips(cfg, ckpt, clips, batch_size=16, device="cpu")
    assert [r["path"] for r in got] == clips
    np.testing.assert_allclose([r["logits"] for r in got], [r["logits"] for r in want], rtol=TOL, atol=TOL)
    assert [r["prediction"] for r in got] == [r["prediction"] for r in want]
    assert [r["word"] for r in got] == [r["word"] for r in want]


def test_ragged_last_chunk_changes_nothing(served):
    cfg, ckpt, clips, _ = served
    full = serving.predict_audio_clips(cfg, ckpt, clips, batch_size=16, device="cpu")
    ragged = serving.predict_audio_clips(cfg, ckpt, clips, batch_size=5, device="cpu")  # 16 = 3*5 + 1
    np.testing.assert_allclose([r["logits"] for r in ragged], [r["logits"] for r in full], rtol=1e-5, atol=1e-5)


def test_serving_cli(served, tmp_path, capsys):
    cfg, ckpt, clips, want = served
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg.config, f)
    serving.main(["--pipeline", "audio", "--config", path, "--checkpoint", ckpt,
                  "--batch-size", "4", "--device", "cpu", *clips[:3]])
    out = json.loads(capsys.readouterr().out)
    assert [r["prediction"] for r in out] == [r["prediction"] for r in want[:3]]


def test_serving_does_not_launch_the_kernel_on_cpu(served):
    cfg, ckpt, clips, _ = served
    before = logmel_cuda.launch_count
    serving.predict_audio_clips(cfg, ckpt, clips[:2], batch_size=2, device="cpu")
    assert logmel_cuda.launch_count == before


class _Echo(torch.nn.Module):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


@pytest.mark.parametrize(
    "dtype, scale", [(np.uint8, 1 / 255.0), (np.int16, 1.0), (np.float32, 1.0)]
)
def test_predictor_casts_inputs_on_the_device(dtype, scale):
    x = np.arange(14, dtype=dtype).reshape(7, 2)
    got = serving.Predictor(_Echo(), batch_size=3, device="cpu").predict_logits(x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, x.astype(np.float32) * scale, rtol=1e-6)


def test_predictor_predict_is_argmax():
    x = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    p = serving.Predictor(_Echo(), batch_size=2, device="cpu")
    np.testing.assert_array_equal(p.predict(x), x.argmax(-1))


def test_checkpoint_roundtrip_keeps_the_layout(tmp_path):
    model = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.BatchNorm1d(2))
    model[1].running_mean.fill_(0.25)
    path = str(tmp_path / "m.pt")
    save_checkpoint(path, {"epoch": 1, "state": module_state(model), "val_acc": 0.75, "scheduler_lr": 5e-4})
    tree = load_checkpoint(path)
    assert set(tree) == {"epoch", "state", "val_acc", "scheduler_lr"}
    assert set(tree["state"]) == {"params", "batch_stats"}
    assert "1.running_mean" in tree["state"]["batch_stats"] and "0.weight" in tree["state"]["params"]
    fresh = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.BatchNorm1d(2))
    load_module_state(fresh, tree["state"])
    for a, b in zip(model.state_dict().values(), fresh.state_dict().values()):
        torch.testing.assert_close(a, b)
    with pytest.raises(RuntimeError):
        load_module_state(torch.nn.Linear(3, 3), tree["state"])


def test_config_matches_jax_on_the_shipped_audio_config():
    path = os.path.join(REPO, "configs", "audio_config.yaml")
    assert load_config(path).config == JConfig(path).get_all()


def test_config_dot_paths():
    cfg = Config.from_dict({"model": {"name": "vgg_lstm"}})
    assert cfg.get("model.name") == "vgg_lstm" and cfg.get("model.missing", 3) == 3
    cfg.set("training.lr", 1e-3)
    assert cfg.get("training.lr") == 1e-3
    assert coerce_yaml_scalar("5e-4") == 5e-4 and coerce_yaml_scalar("abc") == "abc"
    assert model_dtype(cfg) is torch.float32
    cfg.set("model.dtype", "bfloat16")
    assert model_dtype(cfg) is torch.bfloat16


def test_scan_glips_matches_jax(glips_root):
    got, want = scan_glips(glips_root), jscan_glips(glips_root)
    assert got.classes == want.classes
    assert [(e.word, e.split, e.sequence_id, e.path) for e in got.entries] == [
        (e.word, e.split, e.sequence_id, e.path) for e in want.entries
    ]


def test_decode_matches_jax(glips_root):
    clips = [e.path for e in jscan_glips(glips_root).by_split("val")]
    want = np.stack([jaudio_io.load_waveform(p) for p in clips])
    np.testing.assert_array_equal(decode_waveforms(clips), want)


@pytest.mark.parametrize("n", [100, 20000, 25000])
def test_wav_roundtrip_pads_and_truncates(tmp_path, n):
    wave = np.random.default_rng(n).integers(-30000, 30000, n).astype(np.float32)
    path = str(tmp_path / "a" / "x.wav")
    audio_io.write_wav(path, wave)
    got = audio_io.load_waveform(path)
    assert got.shape == (20000,) and got.dtype == np.float32
    k = min(n, 20000)
    np.testing.assert_array_equal(got[:k], wave[:k])
    assert not got[k:].any()


def test_load_waveform_refuses_what_needs_ffmpeg(tmp_path, monkeypatch):
    # without ffmpeg on PATH, a compressed clip and an off-rate WAV raise as
    # in the JAX package (tests/test_torch_audio_io.py runs them through a
    # stand-in ffmpeg)
    monkeypatch.setenv("PATH", str(tmp_path / "no_tools"))
    with pytest.raises(RuntimeError, match="requires ffmpeg"):
        audio_io.load_waveform(str(tmp_path / "x.m4a"))
    path = str(tmp_path / "slow.wav")
    audio_io.write_wav(path, np.zeros(100, np.float32), sample_rate=8000)
    with pytest.raises(RuntimeError, match="needs resampling but ffmpeg is unavailable"):
        audio_io.load_waveform(path)


def test_compute_logmel_features_chunks(glips_root):
    clips = [e.path for e in jscan_glips(glips_root).by_split("val")]
    waves = decode_waveforms(clips)
    got = compute_logmel_features(waves, chunk=5, device="cpu")
    assert got.shape == (len(clips), 80, 117)
    np.testing.assert_allclose(got, np.asarray(jfeatures(waves)), rtol=TOL, atol=TOL)
