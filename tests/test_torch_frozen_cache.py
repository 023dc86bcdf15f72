"""Frozen encoders in the port's trainer and the frozen-feature cache, on the
CPU at T=4 lip frames.

- ``frozen_param_prefixes`` against the JAX trainer: the same weights,
  dropout off on both sides, lr 1e-4 and weight decay 1e-3; 3 steps of cues_video's
  ``early_fusion_mobile`` (frozen MobileNetV2, its BatchNorms in train
  mode): the per-step losses at 1e-4 relative, every frozen parameter
  bit-equal to its start in both, the frozen running statistics as the JAX
  ``batch_stats`` at 1e-4, and no Adam moments for the frozen parameters;
- ``compute_frozen_features`` / ``cached_dataset`` against the JAX
  package's (a last batch padded and trimmed), for both pipelines' frozen
  models;
- the cached trajectory of the triple ``early_fusion_mobile`` against the
  uncached ``frozen_bn_eval`` one (2 epochs), whose frozen statistics never
  move;
- ``set_apply_kwargs`` after a step and a prefix that names no parameter
  raise.
"""

import jax
import numpy as np
import pytest
import torch

from torch_parity_utils import jax_dropout_off, no_dropout, one_torch_thread, random_variables  # noqa: F401

from multimodal_lipread_tpu.models import audio_cues_video as jacv
from multimodal_lipread_tpu.models import cues_video as jcv
from multimodal_lipread_tpu.train import frozen_cache as jfrozen_cache
from multimodal_lipread_tpu.train.trainer import ArrayDataset as JArrayDataset
from multimodal_lipread_tpu.train.trainer import Trainer as JTrainer
from multimodal_lipread_tpu.train.trainer import TrainerConfig as JTrainerConfig

from multimodal_lipread_torch.models import audio_cues_video as pacv
from multimodal_lipread_torch.models import cues_video as pcv
from multimodal_lipread_torch.nn import MLP
from multimodal_lipread_torch.train.checkpoint import load_checkpoint
from multimodal_lipread_torch.train.frozen_cache import cached_dataset, compute_frozen_features
from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig
from multimodal_lipread_torch.utils.jax_bridge import state_dict_from_jax

LOSS_RTOL = 1e-4
T = 4


def _cv_data(n, seed, size=44):
    rng = np.random.default_rng(seed)
    y = (np.arange(n) % 4).astype(np.int32)
    cue = (rng.standard_normal((n, 768)) * 0.05 + 0.02 * y[:, None]).astype(np.float32)
    lip = rng.integers(0, 255, (n, T, size, size, 3), dtype=np.uint8)
    return (cue, lip), y


def _triple_data(n, seed, size=44):
    rng = np.random.default_rng(seed)
    (cue, lip), y = _cv_data(n, seed, size)
    mel = (rng.standard_normal((n, 80, 40)) + 0.3 * y[:, None, None]).astype(np.float32)
    return (mel, cue, lip), y


def _jax_trainer(jmodel, v, tmp_path, prefixes, **cfg):
    """A JAX trainer holding ``v`` and a fresh optimizer state, set up as its
    ``init_state`` sets it up, without Flax's eager init of the model."""
    jt = JTrainer(jmodel, JTrainerConfig(model_name="j", num_classes=4, batch_size=8, epochs=1, seed=0,
                                         frozen_param_prefixes=prefixes, metrics_dir=str(tmp_path / "jm"),
                                         checkpoints_dir=str(tmp_path / "jc"), **cfg))
    jt._tx = jt._make_tx()
    jt.state = jt._place({"params": v["params"], "batch_stats": v.get("batch_stats", {}),
                          "opt_state": jt._tx.init(v["params"]), "step": np.zeros((), np.int32)})
    jt._current_lr = float(jt.config.learning_rate)
    return jt


def _port_trainer(model, v, tmp_path, prefixes, tag="p", **cfg):
    cfg = {"batch_size": 8, "epochs": 1, "seed": 0, **cfg}
    pt = Trainer(model, TrainerConfig(model_name=tag, num_classes=4, frozen_param_prefixes=prefixes,
                                      metrics_dir=str(tmp_path / f"{tag}m"), checkpoints_dir=str(tmp_path / f"{tag}c"),
                                      **cfg), device="cpu")
    pt.init_state()
    if v is not None:
        pt.model.load_state_dict(state_dict_from_jax(v["params"], v.get("batch_stats", {})), strict=True)
    return pt


def test_frozen_prefix_steps_match_the_jax_trainer(tmp_path, jax_dropout_off):
    x, y = _cv_data(20, 1, size=32)
    prefixes = jcv.FROZEN_PARAM_PREFIXES["early_fusion_mobile"]
    jmodel = jcv.get_cues_video_model("early_fusion_mobile", 4)
    v = random_variables(jmodel, *(a[:2] for a in x), seed=3)
    # lr 1e-4: at 1e-3 the two packages' float32 train-mode MobileNetV2
    # statistics (3.6e-6 apart at step 1) part by 3.4e-4 at step 3
    cfg = dict(learning_rate=1e-4, weight_decay=1e-3, scheduler_factor=1.0)
    jt = _jax_trainer(jmodel, v, tmp_path, prefixes, **cfg)
    pt = _port_trainer(no_dropout(pcv.get_cues_video_model("early_fusion_mobile", 4)), v, tmp_path, prefixes, **cfg)
    start = {k: t.clone() for k, t in pt.model.state_dict().items()}
    frozen = pt.frozen_names()
    assert frozen and all(k.startswith("video_encoder.cnn.") for k in frozen)
    assert len(frozen) == sum(1 for k in start if k.startswith("video_encoder.cnn.") and "running_" not in k)
    jt._build_steps()
    jlosses, plosses = [], []
    for (ji, jl, jw), (pi, pl, pw) in zip(jt._batches(JArrayDataset(x, y), True, np.random.default_rng(7)),
                                          pt.batches(ArrayDataset(x, y), True, np.random.default_rng(7))):
        jt.state, loss, _c, _n, w = jt._train_step(jt.state, ji, jl, jw, jt._dropout_rng(1))
        jlosses.append(float(loss) / float(w))
        loss_sum, _c, _n, wsum = pt.train_step(pi, pl, pw).tolist()
        plosses.append(loss_sum / wsum)
    assert len(plosses) == 3
    np.testing.assert_allclose(plosses, jlosses, rtol=LOSS_RTOL)

    end = pt.model.state_dict()
    for k in frozen:
        assert torch.equal(end[k], start[k]), k
    jparams = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jt.state["params"]))
    for k in frozen:  # the JAX trainer leaves them too: a literal zero update, decay included
        np.testing.assert_array_equal(jparams[k].numpy(), start[k].numpy())
    assert not torch.equal(end["cue_proj.weight"], start["cue_proj.weight"])
    jstats = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jt.state["params"]),
                                 jax.tree_util.tree_map(np.asarray, jt.state["batch_stats"]))
    running = [k for k in end if k.startswith("video_encoder.cnn.") and "running_" in k]
    assert running and all(not torch.equal(end[k], start[k]) for k in running)  # train-mode BatchNorm moved them
    for k in running:
        np.testing.assert_allclose(end[k].numpy(), jstats[k].numpy(), rtol=1e-4, atol=1e-4, err_msg=k)

    # Adam holds moments for the trainable parameters only, in its state and the checkpoint
    trainable = [p for n, p in pt.model.named_parameters() if n not in set(frozen)]
    assert len(pt.optimizer.state) == len(trainable) and all(p in pt.optimizer.state for p in trainable)
    assert all(not p.requires_grad for n, p in pt.model.named_parameters() if n in set(frozen))
    pt.fit(ArrayDataset(x, y), ArrayDataset(x, y), progress=None)
    ckpt = load_checkpoint(str(tmp_path / "pc" / "p_best.pt"))
    assert len(ckpt["state"]["opt_state"]["state"]) == len(trainable)


@pytest.mark.parametrize("pipeline", ["cues_video", "audio_cues_video"])
def test_cached_dataset_matches_jax(tmp_path, pipeline):
    if pipeline == "cues_video":
        x, y = _cv_data(6, 2, size=32)
        jmodel = jcv.get_cues_video_model("middle_fusion_mobile", 4, frozen_bn_eval=True)
        pmodel = pcv.get_cues_video_model("middle_fusion_mobile", 4, frozen_bn_eval=True)
        prefixes, assemble = jcv.FROZEN_PARAM_PREFIXES["middle_fusion_mobile"], lambda raw, f: (raw[0], f[0])
    else:
        x, y = _triple_data(6, 2, size=32)
        jmodel = jacv.get_triple_model("middle_fusion_resnet", 4, frozen_bn_eval=True)
        pmodel = pacv.get_triple_model("middle_fusion_resnet", 4, frozen_bn_eval=True)
        prefixes, assemble = jacv.FROZEN_PARAM_PREFIXES["middle_fusion_resnet"], lambda raw, f: (f[0], raw[1], f[1])
    v = random_variables(jmodel, *(a[:2] for a in x), seed=4)
    jt = _jax_trainer(jmodel, v, tmp_path, prefixes)
    pt = _port_trainer(pmodel, v, tmp_path, prefixes)
    want = jfrozen_cache.compute_frozen_features(jt, x, batch_size=4)  # batches of 4 and 2 padded to 4
    pt.model.train()
    got = compute_frozen_features(pt, x, batch_size=4)
    assert pt.model.training  # left in the mode it was in
    assert len(got) == len(want) == (1 if pipeline == "cues_video" else 2)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[0] == 6 and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)
    ds = cached_dataset(pt, ArrayDataset(x, y), assemble, batch_size=4)
    jds = jfrozen_cache.cached_dataset(jt, JArrayDataset(x, y), assemble, batch_size=4)
    np.testing.assert_array_equal(ds.labels, jds.labels)
    for g, w in zip(ds.inputs, jds.inputs):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)
    with torch.no_grad():  # the cached forward gives the uncached eval logits
        pt.model.eval()
        full = pt.model(*(pt._prepare(torch.from_numpy(a)) for a in x))
        cached = pt.model(*(torch.from_numpy(a) for a in ds.inputs), cached_features=True)
    torch.testing.assert_close(cached, full, rtol=1e-5, atol=1e-5)


def test_cached_trajectory_equals_the_uncached_frozen_bn_eval_one(tmp_path):
    train, val = _triple_data(16, 5), _triple_data(8, 6)
    prefixes = pacv.FROZEN_PARAM_PREFIXES["early_fusion_mobile"]

    def run(tag, cached):
        pt = _port_trainer(pacv.get_triple_model("early_fusion_mobile", 4, frozen_bn_eval=True), None, tmp_path,
                           prefixes, tag=tag, learning_rate=1e-3, weight_decay=1e-4, epochs=2, test_every_epoch=False)
        start = {k: t.clone() for k, t in pt.model.state_dict().items()}
        tr, va = ArrayDataset(*train), ArrayDataset(*val)
        if cached:
            tr, va = (cached_dataset(pt, d, lambda raw, f: (f[0], raw[1], f[1])) for d in (tr, va))
            assert tr.inputs[0].shape == (16, 512) and tr.inputs[2].shape == (16, T, 1280)
            pt.set_apply_kwargs(cached_features=True)
        hist = pt.fit(tr, va, None, progress=None)["history"]
        end = pt.model.state_dict()
        frozen = [k for k in end if k.startswith(("audio.resnet.", "video.cnn."))]
        assert frozen and all(torch.equal(end[k], start[k]) for k in frozen)  # weights and statistics
        return hist, end

    ref, ref_end = run("uncached", False)
    got, got_end = run("cached", True)
    for a, b in zip(ref, got):
        assert b["train_loss"] == pytest.approx(a["train_loss"], rel=1e-5)
        assert b["val_loss"] == pytest.approx(a["val_loss"], rel=1e-5)
        assert b["train_acc"] == a["train_acc"] and b["val_acc"] == a["val_acc"]
    for k in ref_end:
        torch.testing.assert_close(got_end[k], ref_end[k], rtol=1e-4, atol=1e-5)


def test_set_apply_kwargs_and_prefixes_that_name_nothing(tmp_path):
    pt = _port_trainer(MLP(6, (5,), 4, use_batchnorm=True), None, tmp_path, (("dense0",),))
    assert pt.frozen_names() == ["dense0.bias", "dense0.weight"]
    x = np.random.default_rng(0).standard_normal((8, 6)).astype(np.float32)
    y = np.arange(8, dtype=np.int32) % 4
    pt.set_apply_kwargs()  # nothing set before a step is fine
    pt.train_single_batch(ArrayDataset((x,), y))
    with pytest.raises(RuntimeError, match="after training steps"):
        pt.set_apply_kwargs(cached_features=True)
    with pytest.raises(ValueError, match="names no parameter"):
        _port_trainer(MLP(6, (5,), 4), None, tmp_path, (("video_encoder", "cnn"),), tag="q")


def test_apply_kwargs_reach_every_forward(tmp_path):
    seen = []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(3, 4)

        def forward(self, x, flag=False):
            seen.append(flag)
            return self.fc(x)

    pt = _port_trainer(Probe(), None, tmp_path, ())
    pt.set_apply_kwargs(flag=True)
    ds = ArrayDataset((np.ones((8, 3), np.float32),), np.zeros(8, np.int32))
    pt.fit(ds, ds, ds, progress=None)
    assert seen and all(seen)
