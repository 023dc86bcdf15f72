"""The port's audio training pipeline against the JAX package's, on the
CPU: the synthetic corpus byte for byte, ``load_audio_datasets`` (the port
runs its plain log-mel on the CPU; held at 1e-4, the log-mel kernel's
bound), the CLI parsing and the config helpers, and fits of
``pipelines.audio.main`` end to end."""

import os

import numpy as np
import pytest
import torch
import yaml

from multimodal_lipread_tpu.config import Config as JConfig
from multimodal_lipread_tpu.data.synthetic import make_synthetic_glips as jmake_synthetic_glips
from multimodal_lipread_tpu.pipelines import common as jcommon

from multimodal_lipread_torch import serving
from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data.glips import scan_glips
from multimodal_lipread_torch.data.synthetic import DEFAULT_WORDS, make_synthetic_glips
from multimodal_lipread_torch.pipelines import audio as paudio_pipeline
from multimodal_lipread_torch.pipelines.common import (
    default_dirs,
    load_audio_datasets,
    parse_cli,
    trainer_extras,
)
from multimodal_lipread_torch.train.checkpoint import load_checkpoint
from multimodal_lipread_torch.train.trainer import TrainerConfig

TOL = 1e-4


def _tree_bytes(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("kwargs", [
    dict(clips_per_split=2, seed=0),
    dict(clips_per_split=2, seed=3, hardness={"audio": 0.6, "video": 0.9}, label_noise=0.5),
    dict(clips_per_split=1, seed=1, words=[f"w{i:02d}" for i in range(10)], hardness=0.3),
], ids=["default", "hard_noisy", "many_class"])
def test_synthetic_wavs_equal_jax(tmp_path, kwargs):
    ours = make_synthetic_glips(str(tmp_path / "torch" / "GLips"), **kwargs)
    theirs = jmake_synthetic_glips(str(tmp_path / "jax" / "GLips"), with_lip_regions=False,
                                   with_cues=False, **kwargs)
    got, want = _tree_bytes(ours), _tree_bytes(theirs)
    assert sorted(got) == sorted(want) and len(got) > 0
    assert all(got[k] == want[k] for k in want)


def test_load_audio_datasets_matches_jax(glips_root):
    got, gindex = load_audio_datasets(glips_root, device="cpu")
    want, windex = jcommon.load_audio_datasets(glips_root)
    assert gindex.classes == windex.classes
    assert [e.path for e in gindex.entries] == [e.path for e in windex.entries]
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(got[split].labels, want[split].labels)
        assert got[split].inputs[0].shape == want[split].inputs[0].shape == (16, 80, 117)
        np.testing.assert_allclose(got[split].inputs[0], want[split].inputs[0], rtol=TOL, atol=TOL)


def test_scan_glips_words_and_splits_match_jax(glips_root):
    from multimodal_lipread_tpu.data.glips import scan_glips as jscan_glips

    for kwargs in (dict(words=["cirka", "abend"]), dict(splits=("val",))):
        got, want = scan_glips(glips_root, **kwargs), jscan_glips(glips_root, **kwargs)
        assert got.classes == want.classes and got.class_to_idx == want.class_to_idx
        assert [e.key for e in got.entries] == [e.key for e in want.entries]
        assert [e.path for e in got.by_split("val")] == [e.path for e in want.by_split("val")]


def _yaml(tmp_path, data):
    path = tmp_path / "cfg.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(data, f)
    return str(path)


def test_parse_cli_matches_jax(tmp_path, monkeypatch):
    path = _yaml(tmp_path, {"training": {"epochs": 10, "learning_rate": 0.0005}, "model": {"name": "vgg_lstm"}})
    args = ["--config", path, "--set", "training.epochs=3", "--set", "training.learning_rate=1e-3",
            "--set", "model.dtype=bfloat16", "--resume"]
    monkeypatch.setattr("sys.argv", ["audio", *args])
    want = jcommon.parse_cli()
    got = parse_cli(argv=[*args, "--device", "cpu"])
    assert got.get("_cli.device") == "cpu"
    got.config.pop("_cli")
    want.config.pop("_cli")
    assert got.get_all() == want.get_all()
    assert got.get("training.learning_rate") == 1e-3 and got.get("training.epochs") == 3
    assert parse_cli(argv=["--config", path]).get("_cli.device") == "cuda"  # the card unless asked


def test_config_save_round_trips_like_jax(tmp_path):
    data = {"dataset": {"root_dir": "/data/GLips_4", "num_classes": 4}, "training": {"learning_rate": 5e-4}}
    Config.from_dict(data).save(str(tmp_path / "ours.yaml"))
    JConfig.from_dict(data).save(str(tmp_path / "theirs.yaml"))
    assert (tmp_path / "ours.yaml").read_text() == (tmp_path / "theirs.yaml").read_text()


def test_default_dirs_and_trainer_extras_match_jax():
    cfg = {"output": {"base_dir": "runs/x"}, "training": {"warmup_epochs": 1.5, "host_prefetch": 0}}
    assert default_dirs(Config.from_dict(cfg), "audio") == jcommon.default_dirs(JConfig.from_dict(cfg), "audio")
    ours, theirs = trainer_extras(Config.from_dict(cfg)), jcommon.trainer_extras(JConfig.from_dict(cfg))
    assert ours == {k: v for k, v in theirs.items() if k != "dropout_rng_impl"}
    TrainerConfig(model_name="m", num_classes=4, **ours)  # every extra is a TrainerConfig field
    with pytest.raises(NotImplementedError, match="Queue 3"):
        trainer_extras(Config.from_dict({"training": {"dropout_rng_impl": "threefry2x32"}}))


def _cfg(root, base, **training):
    return Config.from_dict({
        "dataset": {"root_dir": root, "num_classes": 4, "input_size": 117},
        "model": {"name": "vgg_lstm", "version": 11},
        "training": {"batch_size": 8, "epochs": 3, "learning_rate": 1e-3, "weight_decay": 1e-4,
                     "seed": 0, **training},
        "output": {"base_dir": base, "plots": False},
    })


def test_main_fit_learns_and_its_checkpoint_serves(tmp_path):
    root = make_synthetic_glips(str(tmp_path / "GLips_4"), clips_per_split=6, seed=2)
    base = str(tmp_path / "run")
    result = paudio_pipeline.main(_cfg(root, base), device="cpu")
    losses = [h["train_loss"] for h in result["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    best = os.path.join(base, "models_trained", "vgg_lstm_best.pt")
    assert result["best_checkpoint"] == best and "final_test_acc" in result
    with open(os.path.join(base, "metrics", "vgg_lstm_training_log.txt")) as f:
        assert f.read().splitlines()[-1].startswith("Final Test Loss: ")
    tree = load_checkpoint(best)
    assert all(p.dtype == torch.float32 for p in tree["state"]["params"].values())
    clips = [e.path for e in scan_glips(root).by_split("test")]
    served = serving.predict_audio_clips(_cfg(root, base), best, clips, batch_size=8, device="cpu")
    assert len(served) == len(clips) and all(np.isfinite(r["logits"]).all() for r in served)


def test_main_refuses_what_is_not_ported(tmp_path, monkeypatch):
    # dataset.loader_backend: native is ported; an .m4a clip needs the WAV
    # mirror, and without ffmpeg the mirror raises before any training
    # (tests/test_torch_native_stream.py trains the native branch)
    root = make_synthetic_glips(str(tmp_path / "GLips_4"), clips_per_split=1, seed=2)
    clip = scan_glips(root).by_split("train")[0].path
    os.replace(clip, clip[: -len(".wav")] + ".m4a")
    monkeypatch.setenv("PATH", str(tmp_path / "no_tools"))
    for key, value, item in (("dataset.loader_backend", "native", "ffmpeg is not installed"),):
        cfg = _cfg(root, str(tmp_path / "run"))
        cfg.set("dataset.streaming", True)
        cfg.set("dataset.wav_cache_dir", str(tmp_path / "mirror"))
        cfg.set(key, value)
        with pytest.raises(RuntimeError, match=item):
            paudio_pipeline.main(cfg, device="cpu")
    assert not os.path.exists(tmp_path / "run")


@pytest.mark.slow
def test_audio_model_generalizes(tmp_path):
    # the port's counterpart of tests/test_learning.py::test_audio_model_generalizes
    root = make_synthetic_glips(str(tmp_path / "GLips_gen"), words=DEFAULT_WORDS, clips_per_split=16, seed=1)
    cfg = _cfg(root, str(tmp_path / "run"), batch_size=16, epochs=8)
    result = paudio_pipeline.main(cfg, device="cpu")
    assert result["final_test_acc"] >= 70.0, result
