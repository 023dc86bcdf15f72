"""Tensor parallelism of the port's BERT on the CPU: two gloo ranks on a
``(data=1, model=2)`` mesh with ``BERT_TP_RULES``.

From the same weights (drawn for the JAX model, bridged into the port) and
with dropout off, held against tests/test_tensor_parallel.py's bounds:

- the rules resolve on the port's names as the JAX rules do on the JAX
  paths, and cut query/key/value and intermediate by rows, attention out
  and output by columns, Adam's moments with them; each rank runs half the
  heads;
- 3 steps of ``bert_tiny`` and an evaluation equal the port's one-rank
  (data-parallel) run and the JAX package's tensor-parallel run on the
  conftest mesh at rtol 2e-4;
- a data-parallel checkpoint resumes tensor-parallel (on the one-rank
  trajectory) and a tensor-parallel one resumes at one rank;
- ``pipelines.cues.main`` with ``training.tensor_parallel: 2`` trains, and
  its checkpoint loads into a standard ``BertClassifier``.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torch_dist_worker import NUM_CLASSES, bert_trainer, history, ids_dataset, run_ranks
from torch_parity_utils import one_torch_thread, random_variables  # noqa: F401

from multimodal_lipread_tpu.models import bert as jbert
from multimodal_lipread_tpu.parallel.mesh import get_mesh_2d as jget_mesh_2d
from multimodal_lipread_tpu.parallel.mesh import resolve_partition_spec as jresolve
from multimodal_lipread_tpu.train.trainer import ArrayDataset as JArrayDataset
from multimodal_lipread_tpu.train.trainer import Trainer as JTrainer
from multimodal_lipread_tpu.train.trainer import TrainerConfig as JTrainerConfig

from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
from multimodal_lipread_torch.models.bert import BERT_TP_RULES, BertClassifier, BertConfig, bert_tiny_config
from multimodal_lipread_torch.parallel.mesh import resolve_partition_spec
from multimodal_lipread_torch.train.checkpoint import load_checkpoint
from multimodal_lipread_torch.utils.jax_bridge import state_dict_from_jax

RTOL = 2e-4  # tests/test_tensor_parallel.py's bound


def _config() -> BertConfig:
    cfg = bert_tiny_config(vocab_size=64)
    cfg.dropout_rate = 0.0
    return cfg


def _data(n=16, seq=12, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 64, size=(n, seq)).astype(np.int32)
    ids[:, 0] = 1
    labels = rng.integers(0, NUM_CLASSES, size=n).astype(np.int32)
    return ids, labels


def _jax_tp_losses(tmp, variables, ids, labels):
    import dataclasses

    cfg = jbert.BertConfig(**dataclasses.asdict(_config()))
    trainer = JTrainer(jbert.BertClassifier(cfg, num_classes=NUM_CLASSES), JTrainerConfig(
        model_name="tp_jax", num_classes=NUM_CLASSES, batch_size=8, epochs=1, learning_rate=1e-3, weight_decay=0.0,
        test_every_epoch=False, metrics_dir=str(tmp / "jm"), checkpoints_dir=str(tmp / "jc"),
        param_partition_rules=jbert.BERT_TP_RULES), mesh=jget_mesh_2d(2))
    trainer.init_state((ids,))
    host = jax.tree_util.tree_map(np.asarray, trainer.state)
    trainer.state = trainer._place({**host, "params": variables["params"]})
    ds = JArrayDataset((ids,), labels)
    losses = [trainer.train_single_batch(ds, seed=s) for s in range(3)]
    ev = trainer.evaluate(ds)
    return losses, (ev.loss, ev.acc)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    ids, labels = _data()
    import dataclasses

    jmodel = jbert.BertClassifier(jbert.BertConfig(**dataclasses.asdict(_config())), num_classes=NUM_CLASSES)
    variables = random_variables(jmodel, ids[:2], seed=4)
    params = state_dict_from_jax(variables["params"])
    ds = ids_dataset(ids, labels)

    one = bert_trainer(str(tmp), "dp", BertClassifier(_config(), NUM_CLASSES))
    one.init_state()
    one.load_weights({"params": params, "batch_stats": {}})
    losses = [one.train_single_batch(ds, seed=s) for s in range(3)]
    ev = one.evaluate(ds)

    # the data-parallel checkpoint that the ranks resume (a copy stays here)
    bert_trainer(str(tmp / "dp_ckpt"), "elastic", BertClassifier(_config(), NUM_CLASSES),
                 rolling_checkpoint=True).fit(ds, ds, progress=None)
    shutil.copytree(tmp / "dp_ckpt", tmp / "dp_ckpt_copy")
    cue_root = make_synthetic_glips(str(tmp / "cues" / "GLips_4"), clips_per_split=4, seed=3, with_cues=True)
    two = run_ranks("tp", 2, str(tmp / "two"), {
        "bert_config": dataclasses.asdict(_config()), "ids": ids, "labels": labels, "params": params,
        "dp_dir": str(tmp / "dp_ckpt"), "tp_dir": str(tmp / "tp_ckpt"), "cue_root": cue_root})
    return {"two": two, "losses": losses, "eval": (ev.loss, ev.acc), "jax": _jax_tp_losses(tmp, variables, ids, labels),
            "tmp": tmp, "ds": ds}


@pytest.mark.parametrize("path", [
    "layer0.attention.query.weight", "layer0.attention.value.bias", "layer0.attention.out.weight",
    "layer1.intermediate.weight", "layer1.intermediate.bias", "layer1.output.weight",
    "layer0.output_norm.weight", "layer0.attention.out.bias", "layer1.output.bias",
    "embeddings.word_embeddings.weight", "pooler.weight", "classifier.weight",
])
def test_rules_resolve_as_the_jax_rules_on_the_port_layout(path):
    ours = resolve_partition_spec(BERT_TP_RULES, path)
    jax_path = "params/" + path.replace(".", "/").replace("/weight", "/kernel").replace("word_embeddings/kernel",
                                                                                        "word_embeddings/embedding")
    jax_path = jax_path.replace("output_norm/kernel", "output_norm/scale")
    theirs = tuple(jresolve(jbert.BERT_TP_RULES, jax_path))
    # the same parameters are cut, on the same logical axis: a Flax kernel's
    # output features (heads for q/k/v) are the rows of a torch weight
    assert ("model" in ours) == ("model" in theirs)
    if path.endswith(".weight") and "model" in ours:
        out_axis = "model" in theirs[1:]  # the Flax kernel cut after its input axis
        assert ours.index("model") == (0 if out_axis else 1)


def test_parameters_and_adam_moments_are_cut_by_the_rules(runs):
    cfg = _config()
    h, i = cfg.hidden_size, cfg.intermediate_size
    for r in runs["two"]:
        shapes = r["shapes"]
        assert r["heads"] == cfg.num_heads // 2
        for layer in range(cfg.num_layers):
            p = f"layer{layer}."
            for proj in ("query", "key", "value"):
                assert shapes[p + f"attention.{proj}.weight"] == (h // 2, h)
                assert shapes[p + f"attention.{proj}.bias"] == (h // 2,)
            assert shapes[p + "attention.out.weight"] == (h, h // 2)
            assert shapes[p + "attention.out.bias"] == (h,)
            assert shapes[p + "intermediate.weight"] == (i // 2, h)
            assert shapes[p + "output.weight"] == (h, i // 2)
            assert shapes[p + "output_norm.weight"] == (h,)
        assert shapes["embeddings.word_embeddings.weight"] == (cfg.vocab_size, h)
        for name, (mu, nu) in r["moments"].items():
            assert mu == nu == shapes[name], name


def test_tp_trajectory_equals_data_parallel_and_jax_tp(runs):
    jax_losses, jax_eval = runs["jax"]
    assert runs["losses"][0] != runs["losses"][2]
    np.testing.assert_allclose(runs["losses"], jax_losses, rtol=RTOL)
    for r in runs["two"]:
        np.testing.assert_allclose(r["losses"], runs["losses"], rtol=RTOL)
        np.testing.assert_allclose(r["losses"], jax_losses, rtol=RTOL)
        assert r["eval"][0] == pytest.approx(runs["eval"][0], rel=RTOL)
        assert r["eval"][1] == runs["eval"][1] == jax_eval[1]


def test_tp_checkpoint_restores_to_dp_and_back(runs):
    tmp, ds = runs["tmp"], runs["ds"]
    dp = bert_trainer(str(tmp / "dp_ckpt_copy"), "elastic", BertClassifier(_config(), NUM_CLASSES), epochs=2,
                      rolling_checkpoint=True)
    want = history(dp.fit(ds, ds, resume=True, progress=None))
    for r in runs["two"]:
        got = r["dp_to_tp"]
        assert got["query_shape"] == (_config().hidden_size // 2, _config().hidden_size)
        assert [h["epoch"] for h in got["history"]] == [2]
        assert got["history"][0]["train_loss"] == pytest.approx(want[0]["train_loss"], rel=RTOL)
    # the tensor-parallel run's checkpoint holds whole tensors and resumes at one rank
    state = load_checkpoint(os.path.join(tmp / "tp_ckpt", "elastic", "c", "m_elastic_checkpoint.pt"))["state"]
    assert tuple(state["params"]["layer0.attention.query.weight"].shape) == (_config().hidden_size,) * 2
    resumed = bert_trainer(str(tmp / "tp_ckpt"), "elastic", BertClassifier(_config(), NUM_CLASSES), epochs=2,
                           rolling_checkpoint=True).fit(ds, ds, resume=True, progress=None)
    assert [h["epoch"] for h in resumed["history"]] == [2]
    assert np.isfinite(resumed["history"][0]["train_loss"])


def test_cues_pipeline_trains_tensor_parallel(runs):
    for r in runs["two"]:
        hist = r["pipeline"]["history"]
        assert len(hist) == 1 and np.isfinite(hist[0]["train_loss"])
    state = load_checkpoint(runs["two"][0]["pipeline"]["best"])["state"]
    model = BertClassifier(bert_tiny_config(), len(load_checkpoint(runs["two"][0]["pipeline"]["best"])["classes"]))
    model.load_state_dict({**state["params"], **state["batch_stats"]}, strict=True)
    assert torch.isfinite(model.eval()(torch.ones(2, 8, dtype=torch.long))).all()
