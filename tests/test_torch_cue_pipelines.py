"""The port's cues and audio_cues pipelines against the JAX package's, on
the CPU: ``load_cue_classification_data`` for every featurization kind
(the same splits, labels and features; TF-IDF against the JAX package's
scikit-learn at 1e-6) and with the file splits, the balanced class weights,
``load_audio_cue_datasets`` (the same clips and labels, the cue embeddings
bit-equal, the mels at 1e-4: the port's plain log-mel on the CPU), the
trainer's first 3 steps against the JAX trainer's on BERT (tiny) and on
``late_fusion_resnet`` with dropout off on both sides, at 1e-4 relative,
``main`` end to end for both pipelines (train/val logs without a test for
cues; best and rolling checkpoints and an exact ``--resume`` for
audio_cues), ``predict_clips`` and the CLI for ``cues`` and ``audio_cues``
against the JAX predictor at 1e-4, int32 token ids through the trainer and
the predictor, and what raises (tensor or pipeline parallel > 1, serving
the TF-IDF model)."""

import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from torch_parity_utils import jax_dropout_off, load_bridged, no_dropout, one_torch_thread, random_variables  # noqa: F401

from multimodal_lipread_tpu import serving as jserving
from multimodal_lipread_tpu.config import Config as JConfig
from multimodal_lipread_tpu.models import audio_cues as jac
from multimodal_lipread_tpu.models import cues as jcue_models
from multimodal_lipread_tpu.pipelines import audio_cues as jac_pipeline
from multimodal_lipread_tpu.pipelines import cues as jcues_pipeline
from multimodal_lipread_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from multimodal_lipread_tpu.train.trainer import ArrayDataset as JArrayDataset
from multimodal_lipread_tpu.train.trainer import Trainer as JTrainer
from multimodal_lipread_tpu.train.trainer import TrainerConfig as JTrainerConfig

from multimodal_lipread_torch import serving
from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data.cues import load_cue_records
from multimodal_lipread_torch.data.glips import scan_glips
from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
from multimodal_lipread_torch.models import audio_cues as pac
from multimodal_lipread_torch.models import cues as pcue_models
from multimodal_lipread_torch.pipelines import audio_cues as pac_pipeline
from multimodal_lipread_torch.pipelines import cues as pcues_pipeline
from multimodal_lipread_torch.pipelines.common import parse_cli, trainer_extras
from multimodal_lipread_torch.train.checkpoint import load_checkpoint, module_state, save_checkpoint
from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig
from multimodal_lipread_torch.utils.jax_bridge import state_dict_from_jax

TOL = 1e-4
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def no_hf_cache(tmp_path, monkeypatch):
    """An empty Hugging Face cache: both packages take the hashing backends."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hf_hub"))


# --- data ----------------------------------------------------------------------


@pytest.mark.parametrize("kind,bert_size", [("minilm", "tiny"), ("ensemble", "tiny"), ("mpnet_tok", "tiny"),
                                            ("bert_tok", "tiny"), ("bert_tok", "base"), ("tfidf", "tiny")])
def test_load_cue_classification_data_matches_jax(glips_root, tmp_path, kind, bert_size):
    kw = dict(val_fraction=0.1, seed=42, bert_size=bert_size)
    got, gclasses = pcues_pipeline.load_cue_classification_data(glips_root, "emotion", kind, str(tmp_path / "p"), **kw)
    want, wclasses = jcues_pipeline.load_cue_classification_data(glips_root, "emotion", kind, str(tmp_path / "j"),
                                                                 **kw)
    assert gclasses == wclasses and sorted(got) == sorted(want) == ["train", "val"]
    assert len(got["val"]) == 5 and len(got["train"]) == 43  # 48 records, 10 % to val
    for split in got:
        np.testing.assert_array_equal(got[split].labels, want[split].labels)
        (g,), (w,) = got[split].inputs, want[split].inputs
        assert g.dtype == w.dtype and g.shape == w.shape
        if kind == "tfidf":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)


def test_load_cue_classification_data_file_splits_match_jax(glips_root):
    got, _ = pcues_pipeline.load_cue_classification_data(glips_root, "environment", "minilm", use_file_splits=True)
    want, _ = jcues_pipeline.load_cue_classification_data(glips_root, "environment", "minilm", use_file_splits=True)
    assert sorted(got) == sorted(want) == ["test", "train", "val"]
    for split in got:
        np.testing.assert_array_equal(got[split].labels, want[split].labels)
        np.testing.assert_array_equal(got[split].inputs[0], want[split].inputs[0])


def test_balanced_class_weights_match_jax():
    labels = np.array([0, 0, 0, 1, 2, 2, 3, 3, 3, 3], np.int32)
    for c in (4, 5):
        got = pcues_pipeline.balanced_class_weights(labels, c)
        np.testing.assert_array_equal(got, jcues_pipeline.balanced_class_weights(labels, c))
        assert got.dtype == np.float32


def test_load_audio_cue_datasets_matches_jax(glips_root, tmp_path):
    got, gclasses = pac_pipeline.load_audio_cue_datasets(glips_root, glips_root, cache_dir=str(tmp_path / "p"),
                                                         device="cpu")
    want, wclasses = jac_pipeline.load_audio_cue_datasets(glips_root, glips_root, cache_dir=str(tmp_path / "j"))
    assert gclasses == wclasses
    for split in ("train", "val", "test"):
        (gm, gc), (wm, wc) = got[split].inputs, want[split].inputs
        np.testing.assert_array_equal(got[split].labels, want[split].labels)
        assert gm.shape == wm.shape == (16, 80, 117) and gc.shape == wc.shape == (16, 768)
        np.testing.assert_allclose(gm, wm, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(gc, wc)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))
    narrow, _ = pac_pipeline.load_audio_cue_datasets(glips_root, glips_root, input_size=40, splits=("val",),
                                                     device="cpu")
    assert list(narrow) == ["val"] and narrow["val"].inputs[0].shape == (16, 80, 40)


def test_audio_clips_without_a_cue_are_left_out(tmp_path):
    root = make_synthetic_glips(str(tmp_path / "G"), clips_per_split=2, seed=1, with_cues=True)
    folder = os.path.join(root, "Descriptions_Emotion")
    name = "lipreading_analysis_results_emotion_abend_train.json"
    with open(os.path.join(folder, name)) as f:
        records = json.load(f)
    with open(os.path.join(folder, name), "w") as f:
        json.dump(records[:1], f)
    got, _ = pac_pipeline.load_audio_cue_datasets(root, root, splits=("train",), device="cpu")
    want, _ = jac_pipeline.load_audio_cue_datasets(root, root, splits=("train",))
    assert len(got["train"]) == len(want["train"]) == 7
    np.testing.assert_array_equal(got["train"].inputs[1], want["train"].inputs[1])


# --- the trainer, against the JAX trainer ------------------------------------------


def _step_losses(jmodel, pmodel, x, y, v, tmp_path, **cfg):
    common = dict(num_classes=4, batch_size=8, epochs=1, weight_decay=0.0, scheduler_factor=1.0, seed=0, **cfg)
    jt = JTrainer(jmodel, JTrainerConfig(**common, metrics_dir=str(tmp_path / "jm"),
                                         checkpoints_dir=str(tmp_path / "jc")))
    jt.init_state(x)
    host = jax.tree_util.tree_map(np.asarray, jt.state)
    jt.state = jt._place({**host, "params": v["params"], "batch_stats": v.get("batch_stats", {})})
    pt = Trainer(no_dropout(pmodel), TrainerConfig(**common, metrics_dir=str(tmp_path / "pm"),
                                                   checkpoints_dir=str(tmp_path / "pc")), device="cpu")
    pt.init_state()
    pt.model.load_state_dict(state_dict_from_jax(v["params"], v.get("batch_stats", {})), strict=True)
    jt._build_steps()
    jlosses, plosses = [], []
    for (ji, jl, jw), (pi, pl, pw) in zip(jt._batches(JArrayDataset(x, y), True, np.random.default_rng(7)),
                                          pt.batches(ArrayDataset(x, y), True, np.random.default_rng(7))):
        assert [p.dtype for p in pi] == [torch.from_numpy(np.array(a)).dtype for a in ji]  # ids stay int32
        jt.state, loss, _c, _n, w = jt._train_step(jt.state, ji, jl, jw, jt._dropout_rng(1))
        jlosses.append(float(loss) / float(w))
        loss_sum, _c, _n, wsum = pt.train_step(pi, pl, pw).tolist()
        plosses.append(loss_sum / wsum)
    return plosses, jlosses


def test_bert_steps_match_the_jax_trainer(tmp_path, jax_dropout_off):
    rng = np.random.default_rng(1)
    y = rng.integers(0, 4, 20).astype(np.int32)
    ids = np.zeros((20, 16), np.int32)
    for i, label in enumerate(y):  # class-dependent token runs, padded
        n = 4 + i % 9
        ids[i, :n] = [1] + list(3 + 100 * label + rng.integers(0, 50, n - 2)) + [2]
    jmodel = jcue_models.get_cue_model("bert", 4, bert_size="small")
    v = random_variables(jmodel, ids[:2], seed=3)
    weights = pcues_pipeline.balanced_class_weights(y, 4)
    plosses, jlosses = _step_losses(jmodel, pcue_models.get_cue_model("bert", 4, bert_size="small"), (ids,), y, v,
                                    tmp_path, model_name="bert", learning_rate=5e-5, class_weights=weights)
    assert len(plosses) == 3
    np.testing.assert_allclose(plosses, jlosses, rtol=LOSS_RTOL)


def test_audio_cues_steps_match_the_jax_trainer(tmp_path, jax_dropout_off):
    # at ac_config's mel width 117: on an 80 x 32 mel the last ResNet stage
    # normalizes 24 values per channel at B=8, and the two packages' float32
    # train-mode batch statistics, amplified by Adam's first step, part by
    # 1.2e-3 at step 2
    rng = np.random.default_rng(2)
    y = rng.integers(0, 4, 20).astype(np.int32)
    mels = (rng.standard_normal((20, 80, 117)) + y[:, None, None]).astype(np.float32)
    cues = (rng.standard_normal((20, 768)) * 0.05 + 0.02 * y[:, None]).astype(np.float32)
    jmodel = jac.get_audio_cues_model("late_fusion_resnet", 4)
    v = random_variables(jmodel, mels[:2], cues[:2], seed=4)
    plosses, jlosses = _step_losses(jmodel, pac.get_audio_cues_model("late_fusion_resnet", 4), (mels, cues), y, v,
                                    tmp_path, model_name="late_fusion_resnet", learning_rate=1e-4)
    assert len(plosses) == 3
    np.testing.assert_allclose(plosses, jlosses, rtol=LOSS_RTOL)


def test_int32_ids_cross_uncast(tmp_path):
    ids = np.arange(12, dtype=np.int32).reshape(3, 4)
    t = serving._to_device(ids, torch.device("cpu"))
    assert t.dtype == torch.int32 and torch.equal(t, torch.from_numpy(ids))
    trainer = Trainer(torch.nn.Linear(1, 1), TrainerConfig(model_name="m", num_classes=4,
                                                           metrics_dir=str(tmp_path / "m")), device="cpu")
    assert trainer._prepare(t) is t
    m = pcue_models.get_cue_model("bert", 4, bert_size="small")
    seen = []
    m.embeddings.word_embeddings.register_forward_pre_hook(lambda mod, args: seen.append(args[0].dtype))
    serving.Predictor(m, batch_size=2, device="cpu").predict_logits(ids)  # 3 rows: one padded batch
    assert seen == [torch.int32, torch.int32]


def test_trainer_extras_take_a_pipelines_warmup():
    assert trainer_extras(Config.from_dict({}))["warmup_epochs"] == 0.0
    assert trainer_extras(Config.from_dict({}), default_warmup_epochs=2.0)["warmup_epochs"] == 2.0
    assert trainer_extras(Config.from_dict({"training": {"warmup_epochs": 0}}), 2.0)["warmup_epochs"] == 0
    assert trainer_extras(Config.from_dict({"train": {"warmup_epochs": 1.5}}), 2.0)["warmup_epochs"] == 1.5


# --- main ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def cue_corpus(tmp_path_factory):
    return make_synthetic_glips(str(tmp_path_factory.mktemp("cues") / "GLips_4"), clips_per_split=4, seed=3,
                                with_cues=True)


def _cues_cfg(root, base, name="bert", epochs=2, **training):
    return Config.from_dict({
        "dataset": {"root_dir": root, "cue_root": root, "cue_mode": "emotion", "cache_dir": os.path.join(base, "c")},
        "model": {"name": name, "bert_size": "small"},
        "training": {"batch_size": 8, "epochs": epochs, "learning_rate": 1e-3, "seed": 0, **training},
        "output": {"base_dir": base, "plots": False},
    })


def test_cues_main_logs_train_and_val_only(cue_corpus, tmp_path):
    base = str(tmp_path / "run")
    result = pcues_pipeline.main(_cues_cfg(cue_corpus, base), device="cpu")
    hist = result["history"]
    assert len(hist) == 2 and all(np.isfinite([h["train_loss"] for h in hist])) and "test_loss" not in hist[0]
    assert "final_test_loss" not in result
    # linear_warmup over 2 epochs of 6 steps: 1 warmup step, then down to 0
    assert hist[-1]["lr"] == 0.0 and hist[0]["lr"] > 0
    assert sorted(os.listdir(os.path.join(base, "models_trained"))) == ["bert_best.pt", "bert_checkpoint.pt"]
    with open(os.path.join(base, "metrics", "bert_training_log.csv")) as f:
        assert f.readline().strip().split(",") == ["epoch", "train_loss", "train_acc", "val_loss", "val_acc"]
    assert os.path.isdir(os.path.join(base, "metrics"))


def test_cues_main_with_file_splits_tests_and_resumes(cue_corpus, tmp_path):
    whole = pcues_pipeline.main(_cues_cfg(cue_corpus, str(tmp_path / "whole"), "dense_nn"), device="cpu")
    assert whole["history"][0]["lr"] == 1e-3  # the sentence models keep their LR
    pcues_pipeline.main(_cues_cfg(cue_corpus, str(tmp_path / "cut"), "dense_nn", epochs=1), device="cpu")
    resumed = pcues_pipeline.main(_cues_cfg(cue_corpus, str(tmp_path / "cut"), "dense_nn"), resume=True,
                                  device="cpu")
    keys = ("epoch", "train_loss", "train_acc", "val_loss", "val_acc", "lr")
    assert [[h[k] for k in keys] for h in resumed["history"]] == [[h[k] for k in keys] for h in whole["history"][1:]]
    cfg = _cues_cfg(cue_corpus, str(tmp_path / "files"), "linear", epochs=1)
    cfg.set("dataset.use_file_splits", True)
    result = pcues_pipeline.main(cfg, device="cpu")
    assert np.isfinite(result["final_test_loss"])  # the file splits give a test split


def test_cues_main_refuses_model_parallel_runs(cue_corpus, tmp_path):
    # in one process: a degree of 2 does not divide a world of one rank (the
    # multi-rank runs: tests/test_torch_tensor_parallel.py, test_torch_pipeline_parallel.py)
    with pytest.raises(ValueError, match="must divide the 1 ranks"):
        pcues_pipeline.main(_cues_cfg(cue_corpus, str(tmp_path / "a"), tensor_parallel=2), device="cpu")
    with pytest.raises(ValueError, match="must divide the 1 ranks"):
        pcues_pipeline.main(_cues_cfg(cue_corpus, str(tmp_path / "b"), pipeline_parallel=2), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        pcues_pipeline.main(_cues_cfg(cue_corpus, str(tmp_path / "c"), tensor_parallel=2, pipeline_parallel=2),
                            device="cpu")
    with pytest.raises(ValueError, match="only supported for the BERT"):
        pcues_pipeline.main(_cues_cfg(cue_corpus, str(tmp_path / "d"), "dense_nn", tensor_parallel=2), device="cpu")


def test_cues_main_through_the_cli_parser(cue_corpus, tmp_path):
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(_cues_cfg(cue_corpus, str(tmp_path / "run"), epochs=1).config, f)
    cfg = parse_cli(argv=["--config", path, "--set", "model.name=multi_attn", "--set", "training.epochs=1",
                          "--device", "cpu"])
    pcues_pipeline.main(cfg, device=cfg.get("_cli.device"))
    assert os.path.isfile(os.path.join(str(tmp_path / "run"), "models_trained", "multi_attn_best.pt"))


def _ac_cfg(root, base, epochs=2, name="middle_fusion_mobile"):
    return Config.from_dict({
        "dataset": {"root_dir": root, "cue_root": root, "input_size": 117, "embed_model": "mpnet",
                    "cache_dir": os.path.join(base, "cache"), "num_classes": 4},
        "model": {"name": name},
        "train": {"batch": 8, "lr": 1e-3, "epochs": epochs, "seed": 0},
        "output": {"base_dir": base, "plots": False},
    })


def test_audio_cues_main_trains_and_resumes_exactly(cue_corpus, tmp_path):
    whole = pac_pipeline.main(_ac_cfg(cue_corpus, str(tmp_path / "whole")), device="cpu")
    hist = whole["history"]
    assert len(hist) == 2 and all(np.isfinite([h["train_loss"] for h in hist])) and "test_loss" in hist[0]
    ckpts = os.path.join(str(tmp_path / "whole"), "models_trained")
    assert sorted(os.listdir(ckpts)) == ["middle_fusion_mobile_best.pt", "middle_fusion_mobile_checkpoint.pt"]
    with open(os.path.join(str(tmp_path / "whole"), "metrics", "middle_fusion_mobile_training_log.txt")) as f:
        assert f.read().splitlines()[-1].startswith("Final Test Loss: ")
    torch.manual_seed(123)
    pac_pipeline.main(_ac_cfg(cue_corpus, str(tmp_path / "cut"), epochs=1), device="cpu")
    resumed = pac_pipeline.main(_ac_cfg(cue_corpus, str(tmp_path / "cut")), resume=True, device="cpu")
    keys = ("epoch", "train_loss", "train_acc", "val_loss", "val_acc", "test_loss", "test_acc", "lr")
    assert [[h[k] for k in keys] for h in resumed["history"]] == [[h[k] for k in keys] for h in hist[1:]]
    assert resumed["final_test_loss"] == whole["final_test_loss"]


def test_audio_cues_main_reads_both_schemas_and_warms_up(cue_corpus, tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(Trainer, "fit", lambda self, *a, **k: seen.append(self.config) or {"history": []})
    pac_pipeline.main(_ac_cfg(cue_corpus, str(tmp_path / "a")), device="cpu")
    cfg = Config.from_dict({**_ac_cfg(cue_corpus, str(tmp_path / "b")).config, "train": {},
                            "training": {"batch_size": 4, "learning_rate": 3e-4, "epochs": 7, "seed": 5,
                                         "warmup_epochs": 0}})
    pac_pipeline.main(cfg, device="cpu")
    (a, b) = seen
    assert (a.batch_size, a.learning_rate, a.epochs, a.seed, a.warmup_epochs) == (8, 1e-3, 2, 0, 2.0)
    assert (b.batch_size, b.learning_rate, b.epochs, b.seed, b.warmup_epochs) == (4, 3e-4, 7, 5, 0)
    assert (a.scheduler_mode, a.scheduler_factor, a.scheduler_patience) == ("min", 0.5, 3)
    assert a.test_every_epoch and a.rolling_checkpoint
    bad = _ac_cfg(cue_corpus, str(tmp_path / "c"))
    bad.set("dataset.num_classes", 5)
    with pytest.raises(ValueError, match="5 classes"):
        pac_pipeline.main(bad, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where there is no card")
def test_main_runs_on_the_card_unless_asked(cue_corpus, tmp_path):
    with pytest.raises((RuntimeError, AssertionError)):
        pcues_pipeline.main(_cues_cfg(cue_corpus, str(tmp_path / "a"), epochs=1))
    with pytest.raises((RuntimeError, AssertionError)):
        pac_pipeline.main(_ac_cfg(cue_corpus, str(tmp_path / "b"), epochs=1))


# --- serving -------------------------------------------------------------------


def _write_texts(folder, records):
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i, r in enumerate(records):
        paths.append(os.path.join(folder, f"cue_{i}.txt"))
        with open(paths[-1], "w") as f:
            f.write(r.description + "\n")
    return paths


def _served(pipeline, glips_root, tmp, name, inputs, data):
    """One set of weights for ``name``, saved as a JAX and a port checkpoint."""
    jconfig = JConfig.from_dict(data)
    jmodel = jserving.build_model(pipeline, jconfig)
    v = random_variables(jmodel, *inputs, seed=13)
    tree = {"epoch": 1, "val_acc": 0.5, "scheduler_lr": 1e-4,
            "state": {"params": v["params"], "batch_stats": v.get("batch_stats", {})}}
    jckpt = os.path.join(tmp, f"{name}_best.msgpack")
    jsave_checkpoint(jckpt, tree)
    cfg = Config.from_dict(data)
    pckpt = os.path.join(tmp, f"{name}_best.pt")
    save_checkpoint(pckpt, {**tree, "state": module_state(load_bridged(serving.build_model(pipeline, cfg), v))})
    return cfg, jconfig, pckpt, jckpt


@pytest.mark.parametrize("name", ["bert", "dense_nn", "minilm_cnn_lstm"])
def test_predict_clips_cues_matches_jax(glips_root, tmp_path, name):
    records = load_cue_records(glips_root, "emotion")[:6]
    texts = _write_texts(str(tmp_path / "texts"), records)
    kind = pcue_models.cue_embedding_kind(name)
    inputs = pcues_pipeline._featurize(records[:2], kind, None, bert_size="small")
    data = {"dataset": {"root_dir": glips_root, "num_classes": 4}, "model": {"name": name, "bert_size": "small"}}
    cfg, jcfg, pckpt, jckpt = _served("cues", glips_root, str(tmp_path), name, (inputs,), data)
    groups = [[t] for t in texts]
    want = jserving.predict_clips(jcfg, jckpt, "cues", groups, batch_size=4)
    got = serving.predict_clips(cfg, pckpt, "cues", groups, batch_size=4, device="cpu")
    assert [r["paths"] for r in got] == groups
    np.testing.assert_allclose([r["logits"] for r in got], [r["logits"] for r in want], rtol=TOL, atol=TOL)
    assert [r["word"] for r in got] == [r["word"] for r in want] and got[0]["word"] is not None


def test_predict_clips_audio_cues_and_the_cli_match_jax(glips_root, tmp_path, capsys):
    cue_map = {r.key: r for r in load_cue_records(glips_root, "emotion")}
    entries = [e for e in scan_glips(glips_root).by_split("test") if e.key in cue_map][:5]
    texts = _write_texts(str(tmp_path / "texts"), [cue_map[e.key] for e in entries])
    groups = [[e.path, t] for e, t in zip(entries, texts)]
    data = {"dataset": {"root_dir": glips_root, "num_classes": 4, "input_size": 117, "embed_model": "mpnet"},
            "model": {"name": "late_fusion_mobile"}}
    mel, cue = np.zeros((1, 80, 117), np.float32), np.zeros((1, 768), np.float32)
    cfg, jcfg, pckpt, jckpt = _served("audio_cues", glips_root, str(tmp_path), "late_fusion_mobile", (mel, cue), data)
    want = jserving.predict_clips(jcfg, jckpt, "audio_cues", groups, batch_size=4)
    got = serving.predict_clips(cfg, pckpt, "audio_cues", groups, batch_size=4, device="cpu")
    np.testing.assert_allclose([r["logits"] for r in got], [r["logits"] for r in want], rtol=TOL, atol=TOL)
    mels, cues = serving._featurize_modalities("audio_cues", cfg, groups, device="cpu")
    jmels, jcues = jserving._featurize_modalities("audio_cues", jcfg, groups)
    np.testing.assert_allclose(mels, jmels, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(cues, jcues)
    with pytest.raises(ValueError, match="2 files per clip"):
        serving._featurize_modalities("audio_cues", cfg, [[groups[0][0]]], device="cpu")
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg.config, f)
    serving.main(["--pipeline", "audio_cues", "--config", path, "--checkpoint", pckpt, "--batch-size", "2",
                  "--device", "cpu", *[",".join(g) for g in groups]])
    out = json.loads(capsys.readouterr().out)
    assert [r["prediction"] for r in out] == [r["prediction"] for r in want]


def test_serving_cli_cues(glips_root, tmp_path, capsys):
    records = load_cue_records(glips_root, "emotion")[:3]
    texts = _write_texts(str(tmp_path / "texts"), records)
    data = {"dataset": {"root_dir": glips_root, "num_classes": 4}, "model": {"name": "multi_attn"}}
    emb = pcues_pipeline._featurize(records[:1], "mpnet", None)
    cfg, jcfg, pckpt, jckpt = _served("cues", glips_root, str(tmp_path), "multi_attn", (emb,), data)
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg.config, f)
    serving.main(["--pipeline", "cues", "--config", path, "--checkpoint", pckpt, "--device", "cpu", *texts])
    out = json.loads(capsys.readouterr().out)
    want = jserving.predict_clips(jcfg, jckpt, "cues", [[t] for t in texts])
    np.testing.assert_allclose([r["logits"] for r in out], [r["logits"] for r in want], rtol=TOL, atol=TOL)


def test_serving_refuses_the_tfidf_model(glips_root, tmp_path):
    records = load_cue_records(glips_root, "emotion")[:2]
    texts = _write_texts(str(tmp_path / "texts"), records)
    cfg = Config.from_dict({"dataset": {"root_dir": glips_root}, "model": {"name": "linear"}})
    with pytest.raises(ValueError, match="TF-IDF"):
        serving._featurize_modalities("cues", cfg, [[t] for t in texts], device="cpu")
    assert serving.PIPELINES == ("audio", "video", "audio_video", "cues", "audio_cues", "cues_video",
                                 "audio_cues_video")
    with pytest.raises(ValueError, match="unknown pipeline"):
        serving.build_model("nope", cfg)
