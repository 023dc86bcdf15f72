"""The port's audio_video pipeline against the JAX package's, on the CPU:
``load_av_datasets`` (the same pairs and labels, the lips byte for byte,
the mels at 1e-4: the port's plain log-mel on the CPU), the trainer's
steps on ``middle_fusion_fast`` against the JAX trainer's (its MLP has no
dropout and its BiLSTM one layer, so no dropout runs), ``main`` end to end
with an exact ``--resume``, ``model.pretrained`` through ``main``, and
``predict_clips(pipeline="audio_video")`` on ``wav,npy`` groups against
the JAX predictor, the CLI, and serving at an ``audio_input_size`` other
than 117 (the JAX serving reads ``dataset.input_size`` there; the port
reads the training pipeline's key)."""

import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from torch_parity_utils import load_bridged, one_torch_thread, random_variables  # noqa: F401 (autouse)

from multimodal_lipread_tpu import serving as jserving
from multimodal_lipread_tpu.config import Config as JConfig
from multimodal_lipread_tpu.data import glips as jglips
from multimodal_lipread_tpu.models import audio_video as jav
from multimodal_lipread_tpu.pipelines import audio_video as jav_pipeline
from multimodal_lipread_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from multimodal_lipread_tpu.train.trainer import ArrayDataset as JArrayDataset
from multimodal_lipread_tpu.train.trainer import Trainer as JTrainer
from multimodal_lipread_tpu.train.trainer import TrainerConfig as JTrainerConfig

from multimodal_lipread_torch import serving
from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data import glips as pglips
from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
from multimodal_lipread_torch.models import audio_video as pav
from multimodal_lipread_torch.nn.common import flax_init_
from multimodal_lipread_torch.pipelines import audio_video as pav_pipeline
from multimodal_lipread_torch.pipelines.common import parse_cli
from multimodal_lipread_torch.train.checkpoint import load_checkpoint, module_state, save_checkpoint
from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig
from multimodal_lipread_torch.utils.jax_bridge import state_dict_from_jax

TOL = 1e-4
LOSS_RTOL = 1e-4


def test_align_modalities_matches_jax(glips_root):
    audio = pglips.scan_glips(glips_root)
    lips = pglips.scan_lip_regions(pglips.lip_regions_root(glips_root))
    jaudio = jglips.scan_glips(glips_root)
    jlips = jglips.scan_lip_regions(jglips.lip_regions_root(glips_root))
    assert audio.by_key().keys() == jaudio.by_key().keys()
    for split in (None, "train", "test"):
        got = pglips.align_modalities(audio, lips, split=split)
        want = jglips.align_modalities(jaudio, jlips, split=split)
        assert [tuple(e.path for e in g) for g in got] == [tuple(e.path for e in w) for w in want]
        assert got and all(a.key == v.key for a, v in got)
    missing = pglips.GlipsIndex(root="x", classes=lips.classes, entries=lips.entries[1:])
    assert len(pglips.align_modalities(audio, missing)) == len(audio.entries) - 1


def test_load_av_datasets_matches_jax(glips_root):
    lip_root = pglips.lip_regions_root(glips_root)
    got, gclasses = pav_pipeline.load_av_datasets(glips_root, lip_root, device="cpu")
    want, wclasses = jav_pipeline.load_av_datasets(glips_root, lip_root)
    assert gclasses == wclasses
    for split in ("train", "val", "test"):
        (gm, gl), (wm, wl) = got[split].inputs, want[split].inputs
        np.testing.assert_array_equal(got[split].labels, want[split].labels)
        assert gm.shape == wm.shape == (16, 80, 117) and gl.dtype == np.uint8 and gl.shape == (16, 29, 44, 44, 3)
        np.testing.assert_allclose(gm, wm, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(gl, wl)
    narrow, _ = pav_pipeline.load_av_datasets(glips_root, lip_root, input_size=40, splits=("val",), device="cpu")
    assert list(narrow) == ["val"] and narrow["val"].inputs[0].shape == (16, 80, 40)
    np.testing.assert_array_equal(narrow["val"].inputs[0], got["val"].inputs[0][:, :, :40])


# --- the trainer on middle_fusion_fast, against the JAX trainer --------------

N_TRAIN, BATCH, T, MEL_T = 20, 8, 3, 32


def _av_data(n, seed):
    """Mels and uint8 lips whose level follows the class."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, n).astype(np.int32)
    mels = (rng.standard_normal((n, 80, MEL_T)) + labels[:, None, None]).astype(np.float32)
    lips = rng.integers(0, 120, (n, T, 44, 44, 3)) + 40 * labels[:, None, None, None, None]
    return (mels, lips.astype(np.uint8)), labels


def test_step_losses_match_the_jax_trainer(tmp_path):
    x, y = _av_data(N_TRAIN, 1)
    common = dict(model_name="middle_fusion_fast", num_classes=4, batch_size=BATCH, epochs=1, learning_rate=1e-4,
                  weight_decay=0.0, scheduler_factor=1.0, seed=0)
    jmodel = jav.get_av_model("middle_fusion_fast", 4)
    jt = JTrainer(jmodel, JTrainerConfig(**common, metrics_dir=str(tmp_path / "jm"),
                                         checkpoints_dir=str(tmp_path / "jc")))
    jt.init_state(x)
    v = random_variables(jmodel, x[0][:2], x[1][:2].astype(np.float32) / 255.0, seed=5)
    host = jax.tree_util.tree_map(np.asarray, jt.state)
    jt.state = jt._place({**host, "params": v["params"], "batch_stats": v["batch_stats"]})
    pt = Trainer(pav.get_av_model("middle_fusion_fast", 4, input_size=MEL_T),
                 TrainerConfig(**common, metrics_dir=str(tmp_path / "pm"), checkpoints_dir=str(tmp_path / "pc")),
                 device="cpu")
    pt.init_state()
    pt.model.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]), strict=True)
    jt._build_steps()
    jlosses, plosses = [], []
    for (ji, jl, jw), (pi, pl, pw) in zip(jt._batches(JArrayDataset(x, y), True, np.random.default_rng(7)),
                                          pt.batches(ArrayDataset(x, y), True, np.random.default_rng(7))):
        np.testing.assert_array_equal(pi[1].numpy(), np.asarray(ji[1]))
        jt.state, loss, _c, _n, w = jt._train_step(jt.state, ji, jl, jw, jt._dropout_rng(1))
        jlosses.append(float(loss) / float(w))
        loss_sum, _c, _n, wsum = pt.train_step(pi, pl, pw).tolist()
        plosses.append(loss_sum / wsum)
    assert len(plosses) == 3
    np.testing.assert_allclose(plosses, jlosses, rtol=LOSS_RTOL)


# --- pipelines.audio_video.main ----------------------------------------------


@pytest.fixture(scope="module")
def av_corpus(tmp_path_factory):
    """The synthetic corpus with lips cut to their first 3 frames (the
    models take any length), so that the CPU fits below stay short."""
    root = make_synthetic_glips(str(tmp_path_factory.mktemp("av") / "GLips_4"), clips_per_split=4, seed=3,
                                with_lip_regions=True)
    for entry in pglips.scan_lip_regions(pglips.lip_regions_root(root)).entries:
        np.save(entry.path, np.load(entry.path)[:3])
    return root


def _cfg(root, base, name="late_fusion_fast", epochs=2, **extra):
    return Config.from_dict({
        "dataset": {"root_dir": root, "num_classes": 4, "audio_input_size": 117, **extra.pop("dataset", {})},
        "model": {"name": name, **extra.pop("model", {})},
        "training": {"batch_size": 8, "epochs": epochs, "learning_rate": 1e-3, "seed": 0, **extra},
        "output": {"base_dir": base, "plots": False},
    })


def test_main_trains_and_resumes_exactly(av_corpus, tmp_path):
    whole = pav_pipeline.main(_cfg(av_corpus, str(tmp_path / "whole")), device="cpu")
    hist = whole["history"]
    assert len(hist) == 2 and all(np.isfinite([h["train_loss"] for h in hist]))
    assert [h["lr"] for h in hist] == [1e-3, 1e-3]  # no LR schedule
    ckpts = os.path.join(str(tmp_path / "whole"), "models_trained")
    assert sorted(os.listdir(ckpts)) == ["late_fusion_fast_best.pt", "late_fusion_fast_checkpoint.pt"]
    assert "alpha" in load_checkpoint(os.path.join(ckpts, "late_fusion_fast_best.pt"))["state"]["params"]
    with open(os.path.join(str(tmp_path / "whole"), "metrics", "late_fusion_fast_training_log.txt")) as f:
        assert f.read().splitlines()[-1].startswith("Final Test Loss: ")
    torch.manual_seed(123)
    pav_pipeline.main(_cfg(av_corpus, str(tmp_path / "cut"), epochs=1), device="cpu")
    resumed = pav_pipeline.main(_cfg(av_corpus, str(tmp_path / "cut")), resume=True, device="cpu")
    keys = ("epoch", "train_loss", "train_acc", "val_loss", "val_acc", "test_loss", "test_acc", "lr")
    assert [[h[k] for k in keys] for h in resumed["history"]] == [[h[k] for k in keys] for h in hist[1:]]
    assert resumed["final_test_loss"] == whole["final_test_loss"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where there is no card")
def test_main_and_serving_run_on_the_card_unless_asked(av_corpus, tmp_path):
    # no fallback: without a card the default device raises, before training
    base = str(tmp_path / "run")
    with pytest.raises((RuntimeError, AssertionError)):
        pav_pipeline.main(_cfg(av_corpus, base, epochs=1))
    assert not os.path.exists(os.path.join(base, "models_trained"))
    with pytest.raises((RuntimeError, AssertionError)):
        serving.predict_clips(_cfg(av_corpus, base), "x.pt", "audio_video", _groups(av_corpus)[:1])


def test_main_through_the_cli_parser(av_corpus, tmp_path):
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(_cfg(av_corpus, str(tmp_path / "run"), epochs=1).config, f)
    cfg = parse_cli(argv=["--config", path, "--set", "model.name=early_fusion_fast", "--set", "training.epochs=1",
                          "--device", "cpu"])
    result = pav_pipeline.main(cfg, resume=bool(cfg.get("_cli.resume")), device=cfg.get("_cli.device"))
    assert result["best_checkpoint"].endswith("early_fusion_fast_best.pt")
    assert parse_cli(argv=["--config", path]).get("_cli.device") == "cuda"  # the card unless asked


def test_main_grafts_a_video_checkpoint(av_corpus, tmp_path, monkeypatch):
    from multimodal_lipread_torch.models.video import get_video_model

    video = flax_init_(get_video_model("resnet_attn", 4), torch.Generator().manual_seed(3))
    path = str(tmp_path / "resnet_attn_best.pt")
    save_checkpoint(path, {"epoch": 1, "state": module_state(video), "val_acc": 50.0})
    fits = []
    monkeypatch.setattr(Trainer, "fit", lambda self, *a, **k: fits.append(self) or {"history": []})
    cfg = _cfg(av_corpus, str(tmp_path / "run"), "early_fusion_resnet", model={"pretrained": [
        {"arch": "checkpoint", "path": path, "source_submodule": ["resnet"], "submodule": ["video_encoder", "cnn"]}]})
    pav_pipeline.main(cfg, device="cpu")
    (trainer,) = fits
    got, want = trainer.model.video_encoder.cnn.state_dict(), video.resnet.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    cfg.set("model.pretrained", [{"arch": "checkpoint", "path": path, "submodule": ["video_encoder", "cnn"]}])
    with pytest.raises(ValueError, match="mismatch"):  # the whole video model is not a backbone
        pav_pipeline.main(cfg, device="cpu")


# --- serving -----------------------------------------------------------------


def _groups(root, split="test"):
    audio = pglips.scan_glips(root)
    lips = pglips.scan_lip_regions(pglips.lip_regions_root(root))
    return [[a.path, v.path] for a, v in pglips.align_modalities(audio, lips, split=split)]


@pytest.fixture(scope="module")
def av_served(glips_root, tmp_path_factory):
    """The JAX package and the port serve the test clips from one set of
    late_fusion_fast weights."""
    tmp = tmp_path_factory.mktemp("serve_av")
    data = {"dataset": {"root_dir": glips_root, "num_classes": 4, "input_size": 117, "audio_input_size": 117},
            "model": {"name": "late_fusion_fast"}}
    groups = _groups(glips_root)
    mel = np.zeros((1, 80, 117), np.float32)
    lips = np.load(groups[0][1])[None].astype(np.float32) / 255.0
    v = random_variables(jav.get_av_model("late_fusion_fast", 4), mel, lips, seed=13)
    tree = {"epoch": 1, "val_acc": 0.5, "scheduler_lr": 1e-4,
            "state": {"params": v["params"], "batch_stats": v["batch_stats"]}}
    jckpt = str(tmp / "late_fusion_fast_best.msgpack")
    jsave_checkpoint(jckpt, tree)
    want = jserving.predict_clips(JConfig.from_dict(data), jckpt, "audio_video", groups, batch_size=8)
    cfg = Config.from_dict(data)
    pckpt = str(tmp / "late_fusion_fast_best.pt")
    save_checkpoint(pckpt, {**tree, "state": module_state(load_bridged(serving.build_model("audio_video", cfg), v))})
    return cfg, pckpt, groups, want


def test_predict_clips_audio_video_matches_jax(av_served):
    cfg, ckpt, groups, want = av_served
    got = serving.predict_clips(cfg, ckpt, "audio_video", groups, batch_size=8, device="cpu")
    assert [r["paths"] for r in got] == [r["paths"] for r in want] == groups
    np.testing.assert_allclose([r["logits"] for r in got], [r["logits"] for r in want], rtol=TOL, atol=TOL)
    assert [r["prediction"] for r in got] == [r["prediction"] for r in want]
    assert [r["word"] for r in got] == [r["word"] for r in want] and got[0]["word"] is not None
    ragged = serving.predict_clips(cfg, ckpt, "audio_video", groups, batch_size=5, device="cpu")
    np.testing.assert_allclose([r["logits"] for r in ragged], [r["logits"] for r in got], rtol=1e-5, atol=1e-5)


def test_av_featurization_matches_jax(av_served):
    cfg, _ckpt, groups, _want = av_served
    mels, lips = serving._featurize_modalities("audio_video", cfg, groups, device="cpu")
    jmels, jlips = jserving._featurize_modalities("audio_video", JConfig.from_dict(cfg.config), groups)
    assert mels.shape == (len(groups), 80, 117) and lips.dtype == np.uint8
    np.testing.assert_allclose(mels, jmels, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(lips, jlips)
    with pytest.raises(ValueError, match="2 files per clip"):
        serving._featurize_modalities("audio_video", cfg, [[groups[0][0]]], device="cpu")


def test_serving_cli_audio_video(av_served, tmp_path, capsys):
    cfg, ckpt, groups, want = av_served
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg.config, f)
    serving.main(["--pipeline", "audio_video", "--config", path, "--checkpoint", ckpt,
                  "--batch-size", "4", "--device", "cpu", *[",".join(g) for g in groups[:3]]])
    out = json.loads(capsys.readouterr().out)
    assert [r["prediction"] for r in out] == [r["prediction"] for r in want[:3]]


def test_serving_reads_the_training_pipelines_audio_input_size(glips_root, tmp_path):
    # audio_input_size 100 with input_size left at 117: the port featurizes
    # and builds at 100, as pipelines.audio_video trains
    data = {"dataset": {"root_dir": glips_root, "num_classes": 4, "audio_input_size": 100},
            "model": {"name": "middle_fusion_fast"}}
    cfg = Config.from_dict(data)
    model = serving.build_model("audio_video", cfg)
    assert model.audio_encoder.fc.in_features == 16 * 40 * 50
    groups = _groups(glips_root)[:3]
    mels, _ = serving._featurize_modalities("audio_video", cfg, groups, device="cpu")
    assert mels.shape == (3, 80, 100)
    flax_init_(model, torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "m.pt")
    save_checkpoint(ckpt, {"epoch": 1, "state": module_state(model), "val_acc": 0.0})
    out = serving.predict_clips(cfg, ckpt, "audio_video", groups, batch_size=2, device="cpu")
    assert len(out) == 3 and all(np.isfinite(r["logits"]).all() for r in out)
