"""The port's cues_video and audio_cues_video pipelines against the JAX
package's, on the CPU.

- ``load_cue_video_datasets`` and ``load_triple_datasets`` on a synthetic
  tree whose label spaces differ (one word has audio and cues but no lips):
  the same classes (the aligned train words for cues_video, the audio
  index's for audio_cues_video), labels, cue embeddings and lips, and the
  mels at 1e-4 (the port's plain log-mel on the CPU); a val word outside
  the train split's classes raises in both;
- each pipeline's ``main`` with ``early_fusion_mobile``: the logs, the best
  and rolling checkpoints and an exact ``--resume``; under
  ``training.cache_frozen_features`` the same history as under
  ``training.frozen_bn_eval``; the schema (``train.*`` first), the recipe
  and ``model.freeze_backbone``;
- serving: ``_featurize_modalities`` as the JAX one, ``build_model`` and
  ``predict_clips`` for both pipelines against the JAX model on the JAX
  featurization at 1e-4, and the CLI.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
import yaml

from torch_parity_utils import load_bridged, one_torch_thread, random_variables  # noqa: F401

from multimodal_lipread_tpu import serving as jserving
from multimodal_lipread_tpu.config import Config as JConfig
from multimodal_lipread_tpu.pipelines import audio_cues_video as jacv_pipeline
from multimodal_lipread_tpu.pipelines import cues_video as jcv_pipeline

from multimodal_lipread_torch import serving
from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data.cues import load_cue_records
from multimodal_lipread_torch.data.glips import align_modalities, lip_regions_root, scan_glips, scan_lip_regions
from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
from multimodal_lipread_torch.models.cues_video import FROZEN_PARAM_PREFIXES as CV_FROZEN
from multimodal_lipread_torch.pipelines import audio_cues_video as pacv_pipeline
from multimodal_lipread_torch.pipelines import cues_video as pcv_pipeline
from multimodal_lipread_torch.train.checkpoint import module_state, save_checkpoint
from multimodal_lipread_torch.train.trainer import Trainer

TOL = 1e-4
PIPELINES = {"cues_video": pcv_pipeline, "audio_cues_video": pacv_pipeline}


@pytest.fixture(autouse=True)
def no_hf_cache(tmp_path, monkeypatch):
    """An empty Hugging Face cache: both packages take the hashing embedder."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hf_hub"))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_synthetic_glips(str(tmp_path_factory.mktemp("fusion3") / "GLips_4"), clips_per_split=2, seed=5,
                                with_lip_regions=True, with_cues=True)


@pytest.fixture(scope="module")
def split_labels(tmp_path_factory):
    """A tree where 'abend' has audio and cues but no lips."""
    root = make_synthetic_glips(str(tmp_path_factory.mktemp("labels") / "GLips_4"), clips_per_split=2, seed=6,
                                with_lip_regions=True, with_cues=True)
    shutil.rmtree(os.path.join(lip_regions_root(root), "lipread_files", "abend"))
    return root


# --- data ----------------------------------------------------------------------


def _assert_same(got, want, mel_col=None):
    assert sorted(got) == sorted(want) == ["test", "train", "val"]
    for split in got:
        np.testing.assert_array_equal(got[split].labels, want[split].labels)
        assert len(got[split].inputs) == len(want[split].inputs)
        for i, (g, w) in enumerate(zip(got[split].inputs, want[split].inputs)):
            assert g.shape == w.shape and g.dtype == w.dtype
            if i == mel_col:
                np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
            else:
                np.testing.assert_array_equal(g, w)


def test_loaders_match_jax_where_the_label_spaces_differ(split_labels, tmp_path):
    root = split_labels
    lip_root = lip_regions_root(root)
    got, gclasses = pcv_pipeline.load_cue_video_datasets(root, lip_root, cache_dir=str(tmp_path / "p"))
    want, wclasses = jcv_pipeline.load_cue_video_datasets(root, lip_root, cache_dir=str(tmp_path / "j"))
    assert gclasses == wclasses == ["bereits", "cirka", "dabei"]  # the aligned train words
    _assert_same(got, want)
    assert got["train"].inputs[0].shape == (6, 768) and got["train"].inputs[1].shape == (6, 29, 44, 44, 3)
    assert got["train"].inputs[1].dtype == np.uint8 and set(got["train"].labels) == {0, 1, 2}
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))

    got, gclasses = pacv_pipeline.load_triple_datasets(root, root, lip_root, device="cpu")
    want, wclasses = jacv_pipeline.load_triple_datasets(root, root, lip_root)
    assert gclasses == wclasses == ["abend", "bereits", "cirka", "dabei"]  # the audio index's
    _assert_same(got, want, mel_col=0)
    assert got["val"].inputs[0].shape == (6, 80, 117) and set(got["val"].labels) == {1, 2, 3}
    narrow, _ = pacv_pipeline.load_triple_datasets(root, root, lip_root, input_size=40, splits=("test",),
                                                   device="cpu")
    assert list(narrow) == ["test"] and narrow["test"].inputs[0].shape == (6, 80, 40)


def test_a_val_word_outside_the_train_classes_raises(tmp_path):
    root = make_synthetic_glips(str(tmp_path / "G"), clips_per_split=1, seed=2, with_lip_regions=True, with_cues=True)
    os.remove(os.path.join(root, "Descriptions_Emotion", "lipreading_analysis_results_emotion_cirka_train.json"))
    lip_root = lip_regions_root(root)
    for loader in (pcv_pipeline.load_cue_video_datasets, jcv_pipeline.load_cue_video_datasets):
        with pytest.raises(ValueError, match="cirka"):
            loader(root, lip_root)
    # the triple pipeline takes its classes from the audio index: the clips without a cue drop out
    got, classes = pacv_pipeline.load_triple_datasets(root, root, lip_root, splits=("train", "val"), device="cpu")
    assert classes == ["abend", "bereits", "cirka", "dabei"] and len(got["train"]) == 3 and len(got["val"]) == 4


# --- main ----------------------------------------------------------------------


def _cfg(root, base, pipeline, name="early_fusion_mobile", epochs=2, **training):
    return Config.from_dict({
        "dataset": {"root_dir": root, "cue_root": root, "input_size": 117, "embed_model": "mpnet",
                    "cache_dir": os.path.join(base, "cache"), "num_classes": 4},
        "model": {"name": name},
        "training": {"batch_size": 8, "learning_rate": 1e-4, "weight_decay": 1e-5, "epochs": epochs, "seed": 0,
                     **training},
        "output": {"base_dir": base, "plots": False},
    })


@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_main_trains_and_resumes_exactly(corpus, tmp_path, pipeline):
    main = PIPELINES[pipeline].main
    whole = main(_cfg(corpus, str(tmp_path / "whole"), pipeline), device="cpu")
    hist = whole["history"]
    assert len(hist) == 2 and all(np.isfinite([h["train_loss"] for h in hist])) and "test_loss" in hist[0]
    ckpts = os.path.join(str(tmp_path / "whole"), "models_trained")
    assert sorted(os.listdir(ckpts)) == ["early_fusion_mobile_best.pt", "early_fusion_mobile_checkpoint.pt"]
    with open(os.path.join(str(tmp_path / "whole"), "metrics", "early_fusion_mobile_training_log.txt")) as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("Training Log") and lines[-1].startswith("Final Test Loss: ")
    torch.manual_seed(123)
    main(_cfg(corpus, str(tmp_path / "cut"), pipeline, epochs=1), device="cpu")
    resumed = main(_cfg(corpus, str(tmp_path / "cut"), pipeline), resume=True, device="cpu")
    keys = ("epoch", "train_loss", "train_acc", "val_loss", "val_acc", "test_loss", "test_acc", "lr")
    assert [[h[k] for k in keys] for h in resumed["history"]] == [[h[k] for k in keys] for h in hist[1:]]
    assert resumed["final_test_loss"] == whole["final_test_loss"]


@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_main_cached_features_follow_the_frozen_bn_eval_run(corpus, tmp_path, pipeline):
    main = PIPELINES[pipeline].main
    seen = []
    fit = Trainer.fit

    def capture(self, *args, **kwargs):
        seen.append(self)
        return fit(self, *args, **kwargs)

    Trainer.fit = capture
    try:
        ref = main(_cfg(corpus, str(tmp_path / "a"), pipeline, epochs=1, frozen_bn_eval=True), device="cpu")
        got = main(_cfg(corpus, str(tmp_path / "b"), pipeline, epochs=1, cache_frozen_features=True), device="cpu")
    finally:
        Trainer.fit = fit
    assert seen[0]._apply_kwargs == {} and seen[1]._apply_kwargs == {"cached_features": True}
    for a, b in zip(ref["history"], got["history"]):
        for k in ("train_loss", "val_loss", "test_loss"):
            assert b[k] == pytest.approx(a[k], rel=1e-5)
    assert got["final_test_loss"] == pytest.approx(ref["final_test_loss"], rel=1e-5)


def _captured(monkeypatch):
    seen = []
    monkeypatch.setattr(Trainer, "fit", lambda self, *a, **k: seen.append(self) or {"history": []})
    return seen


def test_cues_video_main_schema_and_freeze_backbone(corpus, tmp_path, monkeypatch):
    seen = _captured(monkeypatch)
    base = _cfg(corpus, str(tmp_path / "a"), "cues_video", name="middle_fusion_resnet").config
    pcv_pipeline.main(Config.from_dict(base), device="cpu")
    ref = {**base, "train": {"model_name": "late_fusion_mobile", "batch": 4, "lr": 3e-4, "epochs": 7,
                             "weight_decay": 0.0, "seed": 5, "metrics_dir": str(tmp_path / "m"),
                             "save_dir": str(tmp_path / "s")}}
    pcv_pipeline.main(Config.from_dict(ref), device="cpu")
    for freeze in (False, True):
        pcv_pipeline.main(Config.from_dict({**base, "model": {"name": "late_fusion_mobile", "freeze_backbone": freeze},
                                            "training": {**base["training"], "cache_frozen_features": True}}),
                          device="cpu")
    pcv_pipeline.main(Config.from_dict({**base, "model": {"name": "early_fusion_resnet", "freeze_backbone": True}}),
                      device="cpu")
    default, schema, unfrozen, frozen, resnet = seen
    a, b = default.config, schema.config
    assert (a.model_name, a.batch_size, a.learning_rate, a.weight_decay, a.epochs) == (
        "middle_fusion_resnet", 8, 1e-4, 1e-5, 2)
    assert (b.model_name, b.batch_size, b.learning_rate, b.weight_decay, b.epochs, b.seed) == (
        "late_fusion_mobile", 4, 3e-4, 0.0, 7, 5)
    assert b.metrics_dir == str(tmp_path / "m") and b.checkpoints_dir == str(tmp_path / "s")
    assert (a.scheduler_mode, a.scheduler_factor, a.scheduler_patience) == ("min", 0.5, 3)
    assert a.test_every_epoch and a.rolling_checkpoint and a.log_txt_header
    assert a.frozen_param_prefixes == () and not default.model.video_encoder.frozen
    assert schema.config.frozen_param_prefixes == CV_FROZEN["late_fusion_mobile"]
    assert unfrozen.config.frozen_param_prefixes == () and not unfrozen.model.video_encoder.frozen
    assert unfrozen._apply_kwargs == {}  # freeze_backbone: false turns the cache off
    assert frozen.config.frozen_param_prefixes == (("video_encoder", "cnn"),) and frozen.model.video_encoder.frozen
    assert frozen._apply_kwargs == {"cached_features": True} and frozen.model.video_encoder.frozen_bn_eval
    assert resnet.config.frozen_param_prefixes == (("video_encoder", "cnn"),) and resnet.model.video_encoder.frozen
    bad = _cfg(corpus, str(tmp_path / "c"), "cues_video")
    bad.set("dataset.num_classes", 5)
    with pytest.raises(ValueError, match="5 classes"):
        pcv_pipeline.main(bad, device="cpu")


def test_audio_cues_video_main_schema(corpus, tmp_path, monkeypatch):
    seen = _captured(monkeypatch)
    base = _cfg(corpus, str(tmp_path / "a"), "audio_cues_video", name="late_fusion_mobile").config
    pacv_pipeline.main(Config.from_dict(base), device="cpu")
    pacv_pipeline.main(Config.from_dict({**base, "training": {"epochs": 1}, "train": {
        "model_name": "middle_fusion_resnet", "batch": 4, "lr": 1e-5}}), device="cpu")
    late, mid = seen
    a, b = late.config, mid.config
    assert (a.model_name, a.batch_size, a.learning_rate, a.weight_decay) == ("late_fusion_mobile", 8, 1e-4, 1e-5)
    assert (b.model_name, b.batch_size, b.learning_rate, b.weight_decay, b.epochs) == (
        "middle_fusion_resnet", 4, 1e-5, 0.0, 1)  # weight decay 0 unless set
    assert (a.scheduler_mode, a.scheduler_factor, a.scheduler_patience) == ("min", 0.5, 3)
    assert a.rolling_checkpoint and a.test_every_epoch and a.log_txt_header
    assert a.frozen_param_prefixes == () and b.frozen_param_prefixes == (("audio", "resnet"), ("video", "cnn"))
    assert mid.model.audio.frozen and mid.model.video.frozen and not late.model.audio.frozen


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where there is no card")
def test_main_runs_on_the_card_unless_asked(corpus, tmp_path):
    for pipeline, module in PIPELINES.items():
        with pytest.raises((RuntimeError, AssertionError)):
            module.main(_cfg(corpus, str(tmp_path / pipeline), pipeline, epochs=1))


# --- serving -------------------------------------------------------------------


def _groups(root, tmp, audio, count=5):
    cue_map = {r.key: r for r in load_cue_records(root, "emotion")}
    pairs = [(a, v) for a, v in align_modalities(scan_glips(root), scan_lip_regions(lip_regions_root(root)),
                                                 split="test") if a.key in cue_map][:count]
    os.makedirs(tmp, exist_ok=True)
    groups = []
    for i, (a, v) in enumerate(pairs):
        text = os.path.join(tmp, f"cue_{i}.txt")
        with open(text, "w") as f:
            f.write(cue_map[a.key].description + "\n")
        groups.append(([a.path] if audio else []) + [text, v.path])
    return groups


def _served(pipeline, tmp, name, inputs, data):
    """One set of weights for ``name``: the JAX model and its variables, and
    a port checkpoint of them."""
    jmodel = jserving.build_model(pipeline, JConfig.from_dict(data))
    v = random_variables(jmodel, *inputs, seed=13)
    cfg = Config.from_dict(data)
    ckpt = os.path.join(tmp, f"{name}_best.pt")
    save_checkpoint(ckpt, {"epoch": 1, "val_acc": 0.5,
                           "state": module_state(load_bridged(serving.build_model(pipeline, cfg), v))})
    return cfg, JConfig.from_dict(data), ckpt, jmodel, v


@pytest.mark.parametrize("pipeline,name", [("cues_video", "late_fusion_mobile"),
                                           ("audio_cues_video", "early_fusion_mobile")])
def test_predict_clips_serves_both_pipelines_as_jax(corpus, tmp_path, pipeline, name):
    audio = pipeline == "audio_cues_video"
    groups = _groups(corpus, str(tmp_path / "texts"), audio)
    data = {"dataset": {"root_dir": corpus, "num_classes": 4, "input_size": 117, "embed_model": "mpnet"},
            "model": {"name": name}}
    cue, lip = np.zeros((1, 768), np.float32), np.zeros((1, 29, 44, 44, 3), np.float32)
    example = (np.zeros((1, 80, 117), np.float32), cue, lip) if audio else (cue, lip)
    cfg, jcfg, pckpt, jmodel, v = _served(pipeline, str(tmp_path), name, example, data)
    got_inputs = serving._featurize_modalities(pipeline, cfg, groups, device="cpu")
    want_inputs = jserving._featurize_modalities(pipeline, jcfg, groups)
    assert len(got_inputs) == len(want_inputs) == len(serving._PIPELINE_INPUTS[pipeline])
    for code, g, w in zip(serving._PIPELINE_INPUTS[pipeline], got_inputs, want_inputs):
        assert g.shape == np.asarray(w).shape
        if code == "a":
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        else:
            np.testing.assert_array_equal(g, w)
    assert got_inputs[-1].dtype == np.uint8
    # the JAX model on the JAX featurization, lips scaled on the device as its predictor scales them
    scaled = [np.asarray(w, np.float32) / 255.0 if np.asarray(w).dtype == np.uint8 else w for w in want_inputs]
    want = np.asarray(jax.jit(lambda v, *x: jmodel.apply(v, *x, train=False))(v, *scaled))
    got = serving.predict_clips(cfg, pckpt, pipeline, groups, batch_size=4, device="cpu")
    assert [r["paths"] for r in got] == groups
    np.testing.assert_allclose([r["logits"] for r in got], want, rtol=TOL, atol=TOL)
    assert [r["word"] for r in got] == [jserving._class_names(jcfg)[int(i)] for i in want.argmax(-1)]
    with pytest.raises(ValueError, match=f"{len(groups[0])} files per clip"):
        serving._featurize_modalities(pipeline, cfg, [groups[0][:-1]], device="cpu")


def test_serving_cli_prints_both_pipelines_predictions(corpus, tmp_path, capsys):
    groups = _groups(corpus, str(tmp_path / "texts"), False, count=3)
    data = {"dataset": {"root_dir": corpus, "num_classes": 4}, "train": {"model_name": "early_fusion_resnet"}}
    cfg = Config.from_dict(data)
    model = serving.build_model("cues_video", cfg)
    assert type(model).__name__ == "EarlyAttentionFusion" and model.video_encoder.lstm.lstm.num_layers == 2
    from multimodal_lipread_torch.nn.common import flax_init_

    flax_init_(model, torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "m.pt")
    save_checkpoint(ckpt, {"epoch": 1, "val_acc": 0.5, "state": module_state(model)})
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(data, f)
    serving.main(["--pipeline", "cues_video", "--config", path, "--checkpoint", ckpt, "--device", "cpu",
                  *[",".join(g) for g in groups]])
    out = json.loads(capsys.readouterr().out)
    want = serving.Predictor.from_checkpoint(serving.build_model("cues_video", cfg), ckpt, device="cpu").predict(
        *serving._featurize_modalities("cues_video", cfg, groups, device="cpu"))
    assert [r["prediction"] for r in out] == want.tolist() and len(out) == 3
    assert type(serving.build_model("audio_cues_video", Config.from_dict({}))).__name__ == "MultimodalAttentionLate"


def test_served_words_come_from_the_trained_label_space(split_labels, tmp_path):
    # cues_video trains on the aligned train words, not on the corpus's:
    # the checkpoint names them, and serving reads its head width and its
    # words from it (ROADMAP.md Queue 3 #12)
    base = str(tmp_path / "run")
    cfg = _cfg(split_labels, base, "cues_video", epochs=1)
    cfg.set("dataset.num_classes", 3)
    best = pcv_pipeline.main(cfg, device="cpu")["best_checkpoint"]
    tree = torch.load(best, weights_only=True)
    assert tree["classes"] == ["bereits", "cirka", "dabei"]
    serve_cfg = Config.from_dict({"dataset": {"root_dir": split_labels, "embed_model": "mpnet",
                                              "cache_dir": os.path.join(base, "cache")},
                                  "model": {"name": "early_fusion_mobile"}})  # no num_classes
    groups = _groups(split_labels, str(tmp_path / "texts"), False)
    served = serving.predict_clips(serve_cfg, best, "cues_video", groups, batch_size=4, device="cpu")
    assert len(served) == len(groups) > 0 and all(len(r["logits"]) == 3 for r in served)
    assert all(r["word"] == tree["classes"][r["prediction"]] for r in served)
    # a checkpoint that names no classes falls back to the corpus's words
    del tree["classes"]
    save_checkpoint(str(tmp_path / "old.pt"), tree)
    serve_cfg.set("dataset.num_classes", 3)
    old = serving.predict_clips(serve_cfg, str(tmp_path / "old.pt"), "cues_video", groups, batch_size=4,
                                device="cpu")
    assert [r["logits"] for r in old] == [r["logits"] for r in served]
    assert all(r["word"] == ["abend", "bereits", "cirka", "dabei"][r["prediction"]] for r in old)
