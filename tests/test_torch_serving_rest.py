"""The rest of the port's serving (``serving.py``) on the CPU:

- ``load_test`` returns the JAX function's keys, and its percentiles follow
  the JAX rule on fixed latencies; it runs client threads on a resident
  ``Predictor``, with a ``device_preproc`` too (the crop's plain version);
- ``export_pipeline``'s program (``torch.export``) holds the log-mel
  operator ``mlt::log_mel``, and its logits equal the ``Predictor``'s; uint8
  lips export as float32 / 255; the TF-IDF cue model is refused;
- a checkpoint read memory-mapped into a model built on the ``meta`` device
  gives the tensors and the logits of ``load_checkpoint`` into a built
  model, bit for bit, BatchNorm statistics and frozen encoders included;
  a cue checkpoint of 3 words serves without ``dataset.num_classes``;
- request ``.npy`` files load through the native loader byte for byte;
- ``cli``'s entry functions dispatch to the modules' mains."""

import json
import sys

import numpy as np
import pytest
import torch

from torch_parity_utils import one_torch_thread  # noqa: F401 (autouse)

from multimodal_lipread_tpu import serving as jserving

from multimodal_lipread_torch import cli, serving
from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data.glips import lip_regions_root, scan_glips, scan_lip_regions
from multimodal_lipread_torch.nn.common import flax_init_
from multimodal_lipread_torch.ops.crop_resize import crop_resize_pad_reference
from multimodal_lipread_torch.pipelines.common import decode_waveforms
from multimodal_lipread_torch.train.checkpoint import (
    load_checkpoint,
    load_module_state,
    module_state,
    save_checkpoint,
)

LOAD_TEST_KEYS = {"num_threads", "requests", "batch", "throughput_clips_per_s", "p50_ms", "p90_ms", "p99_ms",
                  "max_ms", "wall_s"}


def _checkpoint(model, path, seed=0, **extra) -> str:
    flax_init_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # BatchNorm statistics away from their init
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(seed + 1))
            elif name.endswith("running_mean"):
                buf.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(seed + 2))
    save_checkpoint(path, {"epoch": 1, "val_acc": 0.5, "state": module_state(model), **extra})
    return path


# --- load_test -----------------------------------------------------------------


def test_latency_summary_follows_the_jax_rule():
    lats = np.random.default_rng(0).permutation(np.arange(1, 38)) * 1e-3  # 37 requests, 1..37 ms
    got = serving.latency_summary(lats, batch=8, num_threads=4, wall_s=0.5)
    srt = np.sort(lats)
    n = len(srt)
    for p in (50, 90, 99):  # the JAX package's index rule
        assert got[f"p{p}_ms"] == pytest.approx(srt[min(n - 1, int(round(p / 100 * (n - 1))))] * 1e3)
    assert (got["p50_ms"], got["p90_ms"], got["p99_ms"], got["max_ms"]) == pytest.approx((19, 33, 37, 37))
    assert got["requests"] == 37 and got["throughput_clips_per_s"] == pytest.approx(8 * 37 / 0.5)


def test_load_test_has_the_jax_keys(glips_root):
    class Doubler:  # the JAX load_test's view of a Predictor
        mesh = None
        variables = None

        def _forward(self):
            return lambda variables, x: x * 2

    want = jserving.load_test(Doubler(), (np.zeros((4, 3), np.float32),), num_threads=2, requests_per_thread=2)
    from multimodal_lipread_torch.models.video import get_video_model

    predictor = serving.Predictor(get_video_model("cnn", 4), batch_size=2, device="cpu")
    lips = serving.load_lips([e.path for e in scan_lip_regions(lip_regions_root(glips_root)).by_split("val")][:2])
    got = serving.load_test(predictor, (lips[:, :3],), num_threads=3, requests_per_thread=2)
    assert set(got) == set(want) == LOAD_TEST_KEYS
    assert got["requests"] == 6 and got["batch"] == 2 and got["num_threads"] == 3
    assert 0 < got["p50_ms"] <= got["p90_ms"] <= got["p99_ms"] <= got["max_ms"] and got["wall_s"] > 0


def test_load_test_runs_the_device_preproc():
    from multimodal_lipread_torch.models.video import get_video_model
    from multimodal_lipread_torch.ops import crop_resize_cuda

    calls = []

    def crop(frames, boxes):
        calls.append(frames.shape)
        return (crop_resize_pad_reference(frames.flatten(0, 1), boxes.flatten(0, 1)).view(*frames.shape[:2], 44, 44, 3),)

    rng = np.random.default_rng(1)
    frames = rng.integers(0, 255, (2, 3, 64, 64, 3), dtype=np.uint8)
    boxes = np.tile(np.array([8, 8, 40, 30], np.int32), (2, 3, 1))
    predictor = serving.Predictor(get_video_model("cnn", 4), batch_size=2, device="cpu", device_preproc=crop)
    before = crop_resize_cuda.launch_count
    got = serving.load_test(predictor, (frames, boxes), num_threads=2, requests_per_thread=2)
    assert got["requests"] == 4 and len(calls) == 5  # the warm-up and 4 requests
    assert crop_resize_cuda.launch_count == before  # the plain version on the CPU


# --- export --------------------------------------------------------------------


@pytest.fixture(scope="module")
def streaming_audio(glips_root, tmp_path_factory):
    """A dataset.streaming vgg_lstm (WaveToLogMel) checkpoint and test clips."""
    tmp = tmp_path_factory.mktemp("export")
    cfg = Config.from_dict({"dataset": {"root_dir": glips_root, "num_classes": 4, "streaming": True},
                            "model": {"name": "vgg_lstm", "version": 11}})
    ckpt = _checkpoint(serving.build_audio_model(cfg), str(tmp / "vgg_lstm_best.pt"), seed=3)
    clips = [e.path for e in scan_glips(glips_root).by_split("test")][:4]
    return cfg, ckpt, clips, tmp


def test_exported_audio_program_holds_the_log_mel_op(streaming_audio):
    cfg, ckpt, clips, tmp = streaming_audio
    out = str(tmp / "audio.pt2")
    program = serving.export_pipeline(cfg, ckpt, "audio", out, batch_size=4, device="cpu")
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert "mlt.log_mel.default" in targets
    loaded = torch.export.load(out)
    assert "mlt.log_mel.default" in {str(n.target) for n in loaded.graph.nodes if n.op == "call_function"}
    waves = decode_waveforms(clips)
    with torch.no_grad():
        got = loaded.module()(torch.from_numpy(waves)).numpy()
    want = serving.Predictor.from_checkpoint(serving.build_audio_model(cfg), ckpt, batch_size=4,
                                             device="cpu").predict_logits(waves)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    served = serving.predict_audio_clips(cfg, ckpt, clips, batch_size=4, device="cpu")
    np.testing.assert_array_equal([r["logits"] for r in served], want)


def test_export_cli_and_float_lips(glips_root, tmp_path, capsys):
    import yaml

    from multimodal_lipread_torch.models.video import get_video_model

    data = {"dataset": {"root_dir": glips_root, "num_classes": 4}, "model": {"name": "cnn"}}
    ckpt = _checkpoint(get_video_model("cnn", 4), str(tmp_path / "cnn_best.pt"), seed=5)
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(data, f)
    out = str(tmp_path / "video.pt2")
    serving.main(["--pipeline", "video", "--config", cfg_path, "--checkpoint", ckpt, "--batch-size", "2",
                  "--device", "cpu", "--export", out])
    assert json.loads(capsys.readouterr().out) == {"exported": out, "pipeline": "video"}
    lips = serving.load_lips([e.path for e in scan_lip_regions(lip_regions_root(glips_root)).by_split("test")][:2])
    program = torch.export.load(out).module()
    assert [n.meta["val"].dtype for n in torch.export.load(out).graph.nodes if n.op == "placeholder"][-1] == \
        torch.float32
    with torch.no_grad():
        got = program(torch.from_numpy(lips.astype(np.float32) / 255.0)).numpy()
    want = serving.Predictor.from_checkpoint(get_video_model("cnn", 4), ckpt, batch_size=2,
                                             device="cpu").predict_logits(lips)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_export_refuses_the_tfidf_cue_model():
    cfg = Config.from_dict({"model": {"name": "linear"}})
    with pytest.raises(ValueError, match="TF-IDF"):
        serving._example_inputs("cues", cfg, 2)
    shapes = {k: [a.shape for a in serving._example_inputs(k, Config.from_dict({"model": {"name": "bert"}}), 2)]
              for k in ("audio_video", "cues", "cues_video")}
    assert shapes == {"audio_video": [(2, 80, 117), (2, 29, 44, 44, 3)], "cues": [(2, 32)],
                      "cues_video": [(2, 768), (2, 29, 44, 44, 3)]}
    assert [a.dtype for a in jserving._example_inputs("cues", Config.from_dict({"model": {"name": "bert"}}), 2)] \
        == [np.int32] == [a.dtype for a in serving._example_inputs("cues", Config.from_dict({"model": {"name": "bert"}}), 2)]


# --- the per-call load -------------------------------------------------------------------


@pytest.mark.parametrize("pipeline, name", [("video", "cnn"), ("cues", "transformer"),
                                            ("cues_video", "early_fusion_mobile")])
def test_meta_mmap_load_is_bit_equal_to_load_checkpoint(tmp_path, pipeline, name):
    from multimodal_lipread_torch.models.cues_video import FROZEN_PARAM_PREFIXES

    cfg = Config.from_dict({"dataset": {"num_classes": 4}, "model": {"name": name}})
    ckpt = _checkpoint(serving.build_model(pipeline, cfg), str(tmp_path / "m.pt"), seed=7)
    old = serving.build_model(pipeline, cfg)
    load_module_state(old, load_checkpoint(ckpt)["state"])
    with torch.device("meta"):
        new = serving.build_model(pipeline, cfg)
    assert next(new.parameters()).is_meta
    new = serving.assign_state(new, serving.read_checkpoint(ckpt)[0], "cpu")
    want, got = old.state_dict(), new.state_dict()
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert [p.requires_grad for p in new.parameters()] == [p.requires_grad for p in old.parameters()]
    if pipeline == "cues_video":  # the frozen encoder, its BatchNorm statistics included
        (prefix,) = [".".join(p) + "." for p in FROZEN_PARAM_PREFIXES[name]]
        assert any(k.startswith(prefix) and k.endswith("running_mean") for k in got)
    rng = np.random.default_rng(0)
    inputs = tuple(rng.integers(0, 255, a.shape, dtype=np.uint8) if a.dtype == np.uint8
                   else rng.standard_normal(a.shape).astype(a.dtype) for a in serving._example_inputs(pipeline, cfg, 2))
    a = serving.Predictor(old, batch_size=2, device="cpu").predict_logits(*inputs)
    b = serving.Predictor(new, batch_size=2, device="cpu").predict_logits(*inputs)
    np.testing.assert_array_equal(a, b)


def test_a_cue_checkpoint_of_three_words_serves_without_num_classes(tmp_path):
    from multimodal_lipread_torch.models.cues import get_cue_model

    ckpt = _checkpoint(get_cue_model("dense_nn", 3), str(tmp_path / "dense.pt"), classes=["b", "c", "d"])
    texts = []
    for i, t in enumerate(("ein ruhiger Sprecher", "laut und schnell")):
        texts.append(str(tmp_path / f"cue{i}.txt"))
        with open(texts[-1], "w") as f:
            f.write(t)
    cfg = Config.from_dict({"model": {"name": "dense_nn"}, "dataset": {"cache_dir": str(tmp_path / "cache")}})
    got = serving.predict_clips(cfg, ckpt, "cues", [[t] for t in texts], batch_size=2, device="cpu")
    assert all(len(r["logits"]) == 3 and r["word"] == ["b", "c", "d"][r["prediction"]] for r in got)
    assert serving.read_checkpoint(ckpt)[1] == ["b", "c", "d"]
    with pytest.raises(RuntimeError, match="size mismatch"):  # the config's 4 without the checkpoint's words
        serving.Predictor.from_checkpoint(serving.build_model("cues", cfg), ckpt, device="cpu")


def test_assign_state_names_what_the_checkpoint_leaves_unset(tmp_path):
    from multimodal_lipread_torch.models.video import get_video_model

    ckpt = _checkpoint(get_video_model("cnn", 4), str(tmp_path / "cnn.pt"))
    state = serving.read_checkpoint(ckpt)[0]
    first = next(iter(state["params"]))
    state["params"].pop(first)
    with torch.device("meta"):
        model = get_video_model("cnn", 4)
    with pytest.raises(RuntimeError, match=first):
        serving.assign_state(model, state, "cpu")


# --- request .npy loads ----------------------------------------------------------------


def test_request_lips_load_byte_equal(glips_root, tmp_path):
    paths = [e.path for e in scan_lip_regions(lip_regions_root(glips_root)).by_split("test")]
    got = serving.load_lips(paths)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.stack([np.load(p) for p in paths]))
    # a float file in [0, 1] goes through np.load and is scaled as the JAX featurization scales it
    np.save(tmp_path / "float.npy", np.load(paths[0]).astype(np.float32) / 255.0)
    mixed = paths[1:3] + [str(tmp_path / "float.npy")]
    cfg = {"dataset": {"root_dir": glips_root}}
    from multimodal_lipread_tpu.config import Config as JConfig

    want = jserving._featurize_modalities("video", JConfig.from_dict(cfg), [[p] for p in mixed])[0]
    np.testing.assert_array_equal(serving.load_lips(mixed), want)


# --- cli -----------------------------------------------------------------------------


def test_cli_entry_functions_dispatch(monkeypatch, tmp_path):
    import importlib

    seen = []
    for dotted in ("pipelines.audio", "pipelines.cues_video", "data.lip_extraction", "data.frame_extraction",
                   "tools.data_clean", "tools.transcode", "serving", "utils.visualize"):
        mod = importlib.import_module(f"multimodal_lipread_torch.{dotted}")
        monkeypatch.setattr(mod, "main", lambda *a, _d=dotted, **k: seen.append((_d, a, k)))
    cfg = tmp_path / "c.yaml"
    cfg.write_text("dataset:\n  num_classes: 3\n")
    monkeypatch.setattr(sys, "argv", ["mlt", "--config", str(cfg), "--set", "training.epochs=1", "--device", "cpu"])
    assert cli.audio() == 0 and cli.cues_video() == 0
    assert [s[0] for s in seen] == ["pipelines.audio", "pipelines.cues_video"]
    config = seen[0][1][0]
    assert config.get("dataset.num_classes") == 3 and config.get("training.epochs") == 1
    assert seen[0][2] == {"resume": False, "device": "cpu"}
    for fn in (cli.lip_extract, cli.frame_extract, cli.data_clean, cli.transcode, cli.serve, cli.plot):
        assert fn() == 0
    assert [s[0] for s in seen[2:]] == ["data.lip_extraction", "data.frame_extraction", "tools.data_clean",
                                        "tools.transcode", "serving", "utils.visualize"]
    with pytest.raises(NotImplementedError, match="remote API"):
        cli.cue_generate()
    assert set(cli.PIPELINES) == set(serving.PIPELINES) and all(callable(getattr(cli, p)) for p in cli.PIPELINES)
