"""The port's video pipeline against the JAX package's, on the CPU: the
synthetic lip corpus byte for byte, the lip-region scan and loaders,
``resolve_lip_root``, the trainer's steps on the ``cnn`` model against the
JAX trainer's (dropout off, as tests/test_torch_trainer.py holds vgg_lstm),
``pipelines.video.main`` end to end (checkpoints, logs,
``test_results.txt``, an exact resume with dropout on), and
``predict_clips(pipeline="video")`` against the JAX predictor."""

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
from multimodal_lipread_tpu.data.synthetic import make_synthetic_glips as jmake_synthetic_glips
from multimodal_lipread_tpu.models import video as jvideo
from multimodal_lipread_tpu.pipelines import common as jcommon
from multimodal_lipread_tpu.pipelines import video as jvideo_pipeline
from multimodal_lipread_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from multimodal_lipread_tpu.train.trainer import ArrayDataset as JArrayDataset
from multimodal_lipread_tpu.train.trainer import Trainer as JTrainer
from multimodal_lipread_tpu.train.trainer import TrainerConfig as JTrainerConfig
from multimodal_lipread_tpu.utils.metrics_log import MetricLogger as JMetricLogger

from multimodal_lipread_torch import serving
from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data import glips as pglips
from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
from multimodal_lipread_torch.models import video as pvideo
from multimodal_lipread_torch.pipelines import common as pcommon
from multimodal_lipread_torch.pipelines import video as pvideo_pipeline
from multimodal_lipread_torch.train.checkpoint import load_checkpoint, module_state, save_checkpoint
from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig
from multimodal_lipread_torch.utils.jax_bridge import state_dict_from_jax

TOL = 1e-4
LOSS_RTOL = 1e-4
HISTORY_RTOL = 5e-3  # as tests/test_torch_trainer.py: after 3 to 9 Adam steps in float32


def _tree_bytes(*roots):
    out = {}
    for root in roots:
        for d, _dirs, files in os.walk(root):
            for name in files:
                path = os.path.join(d, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, os.path.dirname(root))] = f.read()
    return out


@pytest.mark.parametrize("kwargs", [
    dict(clips_per_split=2, seed=0, with_lip_regions=True),
    dict(clips_per_split=2, seed=3, with_lip_regions=True, hardness={"audio": 0.6, "video": 0.9}, label_noise=0.5),
    dict(clips_per_split=1, seed=1, with_lip_regions=True, words=[f"w{i:02d}" for i in range(10)], hardness=0.3),
    dict(clips_per_split=2, seed=2, with_audio=False, with_lip_regions=True, hardness=0.4),
    dict(clips_per_split=2, seed=4),
], ids=["audio_and_lips", "hard_noisy", "many_class", "lips_only", "audio_only"])
def test_synthetic_corpus_equals_jax(tmp_path, kwargs):
    jkwargs = {"with_lip_regions": False, **kwargs}
    ours = make_synthetic_glips(str(tmp_path / "torch" / "GLips"), **kwargs)
    theirs = jmake_synthetic_glips(str(tmp_path / "jax" / "GLips"), with_cues=False, **jkwargs)
    got = _tree_bytes(ours, pglips.lip_regions_root(ours))
    want = _tree_bytes(theirs, jglips.lip_regions_root(theirs))
    assert sorted(got) == sorted(want) and len(got) > 0
    assert any(k.endswith(".npy") for k in want) == kwargs.get("with_lip_regions", False)
    assert all(got[k] == want[k] for k in want)


@pytest.mark.parametrize("root", ["/data/GLips_4", "/data/GLips_4/", "rel/GLips"])
def test_lip_regions_root_matches_jax(root):
    assert pglips.lip_regions_root(root) == jglips.lip_regions_root(root)


def test_scan_lip_regions_and_load_video_datasets_match_jax(glips_root):
    lip_root = jglips.lip_regions_root(glips_root)
    got, want = pglips.scan_lip_regions(lip_root), jglips.scan_lip_regions(lip_root)
    assert got.classes == want.classes and got.root == want.root
    assert [(e.key, e.path) for e in got.entries] == [(e.key, e.path) for e in want.entries]
    ours, oindex = pcommon.load_video_datasets(lip_root)
    theirs, tindex = jcommon.load_video_datasets(lip_root)
    assert [e.path for e in oindex.entries] == [e.path for e in tindex.entries]
    for split in ("train", "val", "test"):
        (a,), (b,) = ours[split].inputs, theirs[split].inputs
        assert a.dtype == np.uint8 and a.shape == (16, 29, 44, 44, 3)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours[split].labels, theirs[split].labels)
    assert pcommon.load_lip_sequences([]).shape == jcommon.load_lip_sequences([]).shape


def test_scan_lip_regions_refuses_what_jax_refuses(tmp_path):
    lips = np.zeros((29, 44, 44, 3), np.uint8)
    for sub in ("a", "b"):  # the same (word, sid, split) twice
        d = tmp_path / "lips" / sub / "abend" / "train"
        d.mkdir(parents=True)
        np.save(d / "abend_0000-0001.npy", lips)
    for scan in (pglips.scan_lip_regions, jglips.scan_lip_regions):
        with pytest.raises(RuntimeError, match="Duplicate"):
            scan(str(tmp_path / "lips"))
        with pytest.raises(FileNotFoundError):
            scan(str(tmp_path / "missing"))
    with pytest.raises(RuntimeError, match="No lip-region files"):
        pcommon.load_video_datasets(str(tmp_path / "lips" / "a"))


def test_resolve_lip_root_matches_jax(tmp_path):
    wrapped = tmp_path / "GLips"
    (wrapped / "lipread_files").mkdir(parents=True)
    bare = tmp_path / "Bare"
    bare.mkdir()
    for data in ({"dataset": {"root_dir": str(wrapped)}}, {"dataset": {"root_dir": str(bare)}},
                 {"dataset": {"root_dir": str(bare), "lip_regions_root": "/x/y"}}):
        assert pvideo_pipeline.resolve_lip_root(Config.from_dict(data)) == \
            jvideo_pipeline.resolve_lip_root(JConfig.from_dict(data))


# --- the trainer on the cnn model, against the JAX trainer ------------------

N_TRAIN, BATCH, T = 20, 8, 3


def _lips_data(n, seed):
    """uint8 lips whose brightness follows the class."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, n).astype(np.int32)
    x = rng.integers(0, 120, (n, T, 44, 44, 3)) + 40 * labels[:, None, None, None, None]
    return x.astype(np.uint8), labels


@pytest.fixture(scope="module")
def cnn_trained(tmp_path_factory):
    """Both trainers from bridged weights: 3 steps (8 + 8 + 4 real rows
    and 4 at weight 0), then a 2-epoch fit."""
    tmp = tmp_path_factory.mktemp("cnn")
    x, y = _lips_data(N_TRAIN, 1)
    splits = {name: _lips_data(12, s) for name, s in (("val", 2), ("test", 3))}
    common = dict(model_name="cnn", num_classes=4, batch_size=BATCH, epochs=2, learning_rate=1e-4,
                  weight_decay=1e-5, scheduler_mode="max", scheduler_patience=0, seed=0, log_txt_header=True,
                  rolling_checkpoint=True)
    jmodel = jvideo.get_video_model("cnn", 4, dropout=0.0)
    jt = JTrainer(jmodel, JTrainerConfig(**common, metrics_dir=str(tmp / "jax" / "m"),
                                         checkpoints_dir=str(tmp / "jax" / "c")))
    jt.init_state((x,))
    v = random_variables(jmodel, x[:2].astype(np.float32) / 255.0, seed=5)
    host = jax.tree_util.tree_map(np.asarray, jt.state)
    jt.state = jt._place({**host, "params": v["params"], "batch_stats": v["batch_stats"]})
    pt = Trainer(pvideo.get_video_model("cnn", 4, dropout=0.0),
                 TrainerConfig(**common, metrics_dir=str(tmp / "torch" / "m"), checkpoints_dir=str(tmp / "torch" / "c")),
                 device="cpu")
    pt.init_state()
    pt.model.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]), strict=True)

    jt._build_steps()
    jds, pds = JArrayDataset((x,), y), ArrayDataset((x,), y)
    jlosses, plosses = [], []
    for (ji, jl, jw), (pi, pl, pw) in zip(jt._batches(jds, True, np.random.default_rng(7)),
                                          pt.batches(pds, True, np.random.default_rng(7))):
        np.testing.assert_array_equal(pi[0].numpy(), np.asarray(ji[0]))
        jt.state, loss, _c, _n, w = jt._train_step(jt.state, ji, jl, jw, jt._dropout_rng(1))
        jlosses.append(float(loss) / float(w))
        loss_sum, _c, _n, wsum = pt.train_step(pi, pl, pw).tolist()
        plosses.append(loss_sum / wsum)
    jt._global_step = 3
    jfit = jt.fit(jds, JArrayDataset((splits["val"][0],), splits["val"][1]),
                  JArrayDataset((splits["test"][0],), splits["test"][1]), progress=None)
    pfit = pt.fit(pds, ArrayDataset((splits["val"][0],), splits["val"][1]),
                  ArrayDataset((splits["test"][0],), splits["test"][1]), progress=None)
    return dict(jlosses=jlosses, plosses=plosses, jfit=jfit, pfit=pfit, tmp=tmp)


def test_cnn_step_losses_match_the_jax_trainer(cnn_trained):
    assert len(cnn_trained["plosses"]) == 3
    np.testing.assert_allclose(cnn_trained["plosses"], cnn_trained["jlosses"], rtol=LOSS_RTOL)


def test_cnn_fit_matches_the_jax_trainer(cnn_trained):
    jh, ph = cnn_trained["jfit"]["history"], cnn_trained["pfit"]["history"]
    assert [h["lr"] for h in ph] == pytest.approx([h["lr"] for h in jh], rel=1e-12)
    for key in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose([h[key] for h in ph], [h[key] for h in jh], rtol=HISTORY_RTOL, err_msg=key)
    for key in ("train_acc", "val_acc", "test_acc"):
        assert [h[key] for h in ph] == [h[key] for h in jh], key
    tmp = cnn_trained["tmp"]
    for name in ("cnn_training_log.csv", "cnn_training_log.txt"):
        with open(tmp / "jax" / "m" / name) as f:
            want = f.read().splitlines()
        with open(tmp / "torch" / "m" / name) as f:
            got = f.read().splitlines()
        assert len(got) == len(want) and got[0] == want[0], name


# --- pipelines.video.main ----------------------------------------------------


@pytest.fixture(scope="module")
def lip_corpus(tmp_path_factory):
    """The synthetic lip corpus cut to its first 3 frames (the models take
    any length), so that the CPU fits below stay short."""
    root = make_synthetic_glips(str(tmp_path_factory.mktemp("lips") / "GLips_4"), clips_per_split=4, seed=3,
                                with_audio=False, with_lip_regions=True)
    for entry in pglips.scan_lip_regions(pglips.lip_regions_root(root)).entries:
        np.save(entry.path, np.load(entry.path)[:3])
    return root


def _cfg(root, base, name="cnn", epochs=2, **model):
    return Config.from_dict({
        "dataset": {"root_dir": root, "num_classes": 4},
        "model": {"name": name, **model},
        "training": {"batch_size": 8, "epochs": epochs, "learning_rate": 1e-3, "seed": 0},
        "output": {"base_dir": base, "plots": False},
    })


def test_main_writes_the_references_files(lip_corpus, tmp_path):
    base = str(tmp_path / "run")
    result = pvideo_pipeline.main(_cfg(lip_corpus, base), device="cpu")
    ckpts = os.path.join(base, "models_trained")
    assert sorted(os.listdir(ckpts)) == ["cnn_best.pt", "cnn_checkpoint.pt", "test_results.txt"]
    assert result["best_checkpoint"] == os.path.join(ckpts, "cnn_best.pt")
    with open(os.path.join(ckpts, "test_results.txt")) as f:
        assert f.read() == (f"Final Test Loss: {result['final_test_loss']:.4f}\n"
                            f"Final Test Acc: {result['final_test_acc']:.2f}%\n"
                            f"Best Val Acc: {result['best_val_acc']:.2f}%\n")
    JMetricLogger(str(tmp_path / "banner"), "cnn", txt_header=True)  # the JAX logger's banner
    with open(tmp_path / "banner" / "cnn_training_log.txt") as f:
        banner = f.read()
    with open(os.path.join(base, "metrics", "cnn_training_log.txt")) as f:
        log = f.read()
    assert banner and log.startswith(banner) and log.splitlines()[-1].startswith("Final Test Loss: ")
    assert load_checkpoint(os.path.join(ckpts, "cnn_checkpoint.pt"))["epoch"] == 2
    assert [h["lr"] for h in result["history"]] == [1e-3, 1e-3]


def test_main_resumes_exactly_with_lstm_dropout(lip_corpus, tmp_path):
    # vgg_lstm: dropout 0.5 between the BiLSTM's layers and before the
    # classifier, all from the trainer's generator, which the rolling
    # checkpoint saves; torch's global generator is reseeded in between
    whole = pvideo_pipeline.main(_cfg(lip_corpus, str(tmp_path / "whole"), "vgg_lstm", 2), device="cpu")
    torch.manual_seed(123)
    pvideo_pipeline.main(_cfg(lip_corpus, str(tmp_path / "cut"), "vgg_lstm", 1), device="cpu")
    torch.manual_seed(456)
    resumed = pvideo_pipeline.main(_cfg(lip_corpus, str(tmp_path / "cut"), "vgg_lstm", 2), resume=True, device="cpu")
    keys = ("epoch", "train_loss", "train_acc", "val_loss", "val_acc", "test_loss", "test_acc", "lr")
    assert [[h[k] for k in keys] for h in resumed["history"]] == [[h[k] for k in keys] for h in whole["history"][1:]]
    assert resumed["final_test_loss"] == whole["final_test_loss"]
    # and the masks did draw: training loss differs from a dropout-free fit's
    nodrop = pvideo_pipeline.main(_cfg(lip_corpus, str(tmp_path / "nodrop"), "vgg_lstm", 1, dropout=0.0),
                                  device="cpu")
    assert nodrop["history"][0]["train_loss"] != whole["history"][0]["train_loss"]


@pytest.mark.parametrize("key, value, item", [
    ("dataset.streaming", True, "#11"), ("dataset.device_crop", True, "#8.5"),
    ("dataset.host_crop_streaming", True, "#11"),
])
def test_main_refuses_what_is_not_ported(tmp_path, key, value, item):
    cfg = _cfg(str(tmp_path), str(tmp_path / "run"))
    cfg.set(key, value)
    with pytest.raises(NotImplementedError, match=item):
        pvideo_pipeline.main(cfg, device="cpu")


# --- serving -----------------------------------------------------------------


@pytest.fixture(scope="module")
def video_served(glips_root, tmp_path_factory):
    """The JAX package and the port serve the test lips from one set of cnn weights."""
    tmp = tmp_path_factory.mktemp("serve_video")
    data = {"dataset": {"root_dir": glips_root, "num_classes": 4}, "model": {"name": "cnn"}}
    lips = [e.path for e in jglips.scan_lip_regions(jglips.lip_regions_root(glips_root)).by_split("test")]
    x = np.load(lips[0])[None].astype(np.float32) / 255.0
    v = random_variables(jvideo.get_video_model("cnn", 4), x, seed=13)
    tree = {"epoch": 1, "val_acc": 0.5, "scheduler_lr": 1e-4,
            "state": {"params": v["params"], "batch_stats": v["batch_stats"]}}
    jckpt = str(tmp / "cnn_best.msgpack")
    jsave_checkpoint(jckpt, tree)
    want = jserving.predict_clips(JConfig.from_dict(data), jckpt, "video", [[p] for p in lips], batch_size=8)
    cfg = Config.from_dict(data)
    pckpt = str(tmp / "cnn_best.pt")
    save_checkpoint(pckpt, {**tree, "state": module_state(load_bridged(serving.build_model("video", cfg), v))})
    return cfg, pckpt, lips, want


def test_predict_clips_video_matches_jax(video_served):
    cfg, ckpt, lips, want = video_served
    got = serving.predict_clips(cfg, ckpt, "video", [[p] for p in lips], batch_size=8, device="cpu")
    assert [r["paths"] for r in got] == [r["paths"] for r in want] == [[p] for p in lips]
    np.testing.assert_allclose([r["logits"] for r in got], [r["logits"] for r in want], rtol=TOL, atol=TOL)
    assert [r["prediction"] for r in got] == [r["prediction"] for r in want]
    assert [r["word"] for r in got] == [r["word"] for r in want] and got[0]["word"] is not None
    ragged = serving.predict_clips(cfg, ckpt, "video", [[p] for p in lips], batch_size=5, device="cpu")
    np.testing.assert_allclose([r["logits"] for r in ragged], [r["logits"] for r in got], rtol=1e-5, atol=1e-5)


def test_serving_cli_video(video_served, tmp_path, capsys):
    cfg, ckpt, lips, want = video_served
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg.config, f)
    serving.main(["--pipeline", "video", "--config", path, "--checkpoint", ckpt,
                  "--batch-size", "4", "--device", "cpu", *lips[:3]])
    out = json.loads(capsys.readouterr().out)
    assert [r["prediction"] for r in out] == [r["prediction"] for r in want[:3]]


def test_video_featurization_matches_jax(glips_root, tmp_path):
    lips = [e.path for e in jglips.scan_lip_regions(jglips.lip_regions_root(glips_root)).by_split("val")][:3]
    floats = str(tmp_path / "f.npy")
    np.save(floats, np.load(lips[0]).astype(np.float32) / 255.0)  # a float file in [0, 1]
    groups = [[p] for p in lips + [floats]]
    cfg = {"dataset": {"root_dir": glips_root}}
    (got,) = serving._featurize_modalities("video", Config.from_dict(cfg), groups)
    (want,) = jserving._featurize_modalities("video", JConfig.from_dict(cfg), groups)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pipeline", ["cues", "audio_cues", "cues_video", "audio_cues_video"])
def test_other_pipelines_point_at_roadmap(pipeline):
    cfg = Config.from_dict({})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serving.build_model(pipeline, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serving.predict_clips(cfg, "x.pt", pipeline, [["a", "b"]], device="cpu")
    with pytest.raises(ValueError):
        serving.build_model("nope", cfg)
