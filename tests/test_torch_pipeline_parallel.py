"""GPipe pipeline parallelism of the port's BERT on the CPU: a
``(data=1, stage=S)`` mesh over gloo ranks, S = 2 for ``bert_tiny`` and
S = 4 for ``bert_small``, with ``BERT_PP_RULES``.

From the same weights (drawn for the JAX model, bridged into the port) and
with dropout off, held against tests/test_pipeline_parallel.py's bounds:

- ``stack_bert_layers`` / ``unstack_bert_layers`` round-trip and agree
  with the JAX functions through the bridge;
- the S-stage forward and gradients equal the sequential
  ``BertClassifier``'s at atol 1e-5, and the JAX ``PipelinedBertClassifier``'s
  parameters, carried through ``utils/jax_bridge.py``, give the JAX logits
  at atol 1e-5, at one stage and at four;
- 3 steps and an evaluation equal the sequential model's at rtol 2e-4,
  with the stacked encoder and its Adam moments cut by stage;
- a pipelined checkpoint loads as a standard ``BertClassifier``;
- the misconfigurations raise (stages that do not divide the world or the
  layers, microbatches that do not divide the rows, mixup, remat,
  BatchNorm models, a model other than BERT);
- ``pipelines.cues.main`` with ``training.pipeline_parallel: 2`` trains.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_dist_worker import NUM_CLASSES, bert_trainer, ids_dataset, run_ranks
from torch_parity_utils import one_torch_thread, random_variables  # noqa: F401

from multimodal_lipread_tpu.models import bert as jbert

from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
from multimodal_lipread_torch.models.bert import (
    BertClassifier,
    PipelinedBertClassifier,
    bert_small_config,
    bert_tiny_config,
    stack_bert_layers,
    unstack_bert_layers,
)
from multimodal_lipread_torch.models.cues import get_cue_model
from multimodal_lipread_torch.parallel.pipeline import get_mesh_pp
from multimodal_lipread_torch.train.checkpoint import load_checkpoint
from multimodal_lipread_torch.utils.jax_bridge import state_dict_from_jax

ATOL = 1e-5  # tests/test_pipeline_parallel.py's bounds
RTOL = 2e-4


def _config(small=False):
    cfg = (bert_small_config if small else bert_tiny_config)(vocab_size=64)
    cfg.dropout_rate = 0.0
    return cfg


def _ids(n=8, seq=12, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 64, size=(n, seq)).astype(np.int32)
    ids[:, 0] = 1
    ids[: n // 2, 9:] = 0  # padded keys in half the rows
    return ids, rng.integers(0, NUM_CLASSES, size=n).astype(np.int32)


def _jax_model(small=False, pipelined=False):
    cfg = jbert.BertConfig(**dataclasses.asdict(_config(small)))
    if pipelined:
        return jbert.PipelinedBertClassifier(cfg, NUM_CLASSES, num_stages=1)
    return jbert.BertClassifier(cfg, num_classes=NUM_CLASSES)


def _inputs(tmp, small, cue_root=None):
    ids, labels = _ids()
    variables = random_variables(_jax_model(small), ids[:2], seed=6)
    params = state_dict_from_jax(variables["params"])
    return variables, params, {
        "bert_config": dataclasses.asdict(_config(small)), "ids": ids, "labels": labels, "train_rows": 8,
        "stacked": stack_bert_layers(params, _config(small).num_layers), "cue_root": cue_root}


def _sequential(params, small=False):
    model = BertClassifier(_config(small), NUM_CLASSES)
    model.load_state_dict(params)
    return model.eval()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    cue_root = make_synthetic_glips(str(tmp / "cues" / "GLips_4"), clips_per_split=4, seed=3, with_cues=True)
    variables, params, inputs = _inputs(tmp, False, cue_root)
    two = run_ranks("pp", 2, str(tmp / "two"), inputs)
    _, params4, inputs4 = _inputs(tmp, True)
    jax_stacked = jbert.stack_bert_layers(jax.tree_util.tree_map(np.asarray, dict(_jax_vars(True)["params"])), 4)
    inputs4["stacked"] = state_dict_from_jax(jax_stacked)
    four = run_ranks("pp", 4, str(tmp / "four"), inputs4)
    return {"two": two, "four": four, "params": params, "params4": state_dict_from_jax(
        jbert.unstack_bert_layers(jax_stacked, 4)), "inputs": inputs, "inputs4": inputs4, "tmp": tmp}


def _jax_vars(small):
    ids, _ = _ids()
    return random_variables(_jax_model(small), ids[:2], seed=6)


def _full_grads(results, num_layers):
    """Each stage's gradients summed: a stage holds zeros for the layers of
    the others, and the replicated parameters' reduced sums."""
    grads = {}
    for name in results[0]["grads"]:
        if name.startswith("encoder."):
            grads[name] = sum(r["grads"][name] for r in results)
        else:
            grads[name] = results[0]["grads"][name]
    return unstack_bert_layers(grads, num_layers)


def test_stack_unstack_round_trips_and_matches_jax():
    ids, _ = _ids()
    variables = _jax_vars(False)
    params = state_dict_from_jax(variables["params"])
    stacked = stack_bert_layers(params, 2)
    assert all(not k.startswith("layer") for k in stacked)
    assert all(v.shape[0] == 2 for k, v in stacked.items() if k.startswith("encoder."))
    for k, v in unstack_bert_layers(stacked, 2).items():
        torch.testing.assert_close(v, params[k], rtol=0, atol=0)
    jstacked = jbert.stack_bert_layers(jax.tree_util.tree_map(np.asarray, dict(variables["params"])), 2)
    bridged = state_dict_from_jax(jstacked)
    assert set(bridged) == set(stacked)
    for k in stacked:
        torch.testing.assert_close(bridged[k], stacked[k], rtol=0, atol=0)


@pytest.mark.parametrize("world", ["two", "four"])
def test_pipelined_forward_and_gradients_equal_the_sequential_model(runs, world):
    small = world == "four"
    params = runs["params4"] if small else runs["params"]
    inputs = runs["inputs4"] if small else runs["inputs"]
    seq = _sequential(params, small)
    ids, labels = torch.from_numpy(inputs["ids"]), torch.from_numpy(inputs["labels"]).long()
    with torch.no_grad():
        want = seq(ids).numpy()
    for r in runs[world]:
        np.testing.assert_allclose(r["logits"], want, atol=ATOL, rtol=0)
    loss = F.cross_entropy(seq(ids), labels)
    loss.backward()
    got = _full_grads(runs[world], _config(small).num_layers)
    for name, p in seq.named_parameters():
        np.testing.assert_allclose(got[name].numpy(), p.grad.numpy(), atol=ATOL, rtol=0, err_msg=name)
    assert runs[world][0]["mean_ce"] == pytest.approx(float(loss.detach()), rel=1e-6)


def test_jax_pipelined_parameters_through_the_bridge_give_the_jax_logits(runs):
    ids, _ = _ids()
    jmodel = _jax_model(True, pipelined=True)
    jstacked = jbert.stack_bert_layers(jax.tree_util.tree_map(np.asarray, dict(_jax_vars(True)["params"])), 4)
    want = np.asarray(jmodel.apply({"params": jstacked}, ids, train=False))
    one = PipelinedBertClassifier(_config(True), NUM_CLASSES)
    one.load_state_dict(state_dict_from_jax(jstacked))
    with torch.no_grad():
        np.testing.assert_allclose(one.eval()(torch.from_numpy(ids)).numpy(), want, atol=ATOL, rtol=0)
    for r in runs["four"]:  # the same parameters over 4 stages
        np.testing.assert_allclose(r["logits"], want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("world", ["two", "four"])
def test_pp_trajectory_equals_sequential_with_stage_cut_state(runs, world):
    small = world == "four"
    cfg = _config(small)
    inputs = runs["inputs4"] if small else runs["inputs"]
    params = runs["params4"] if small else runs["params"]
    ds = ids_dataset(inputs["ids"], inputs["labels"])
    seq = bert_trainer(str(runs["tmp"] / f"seq_{world}"), "seq", BertClassifier(cfg, NUM_CLASSES))
    seq.init_state()
    seq.load_weights({"params": params, "batch_stats": {}})
    losses = [seq.train_single_batch(ds, seed=s) for s in range(3)]
    ev = seq.evaluate(ds)
    assert losses[0] != losses[2]
    stages = len(runs[world])
    for r in runs[world]:
        np.testing.assert_allclose(r["losses"], losses, rtol=RTOL)
        assert r["eval"][0] == pytest.approx(ev.loss, rel=RTOL) and r["eval"][1] == ev.acc
        for name, shape in r["shapes"].items():
            if name.startswith("encoder."):
                assert shape[0] == cfg.num_layers // stages, name
            assert r["moments"][name] == shape, name


def test_pp_checkpoint_loads_as_a_standard_bert(runs):
    for world, small in (("two", False), ("four", True)):
        r = runs[world][0]
        std = BertClassifier(_config(small), NUM_CLASSES)
        std.load_state_dict(unstack_bert_layers(r["exported"], _config(small).num_layers), strict=True)
        with torch.no_grad():
            got = std.eval()(torch.from_numpy(runs["inputs4" if small else "inputs"]["ids"])).numpy()
        np.testing.assert_allclose(got, r["trained_logits"], atol=ATOL, rtol=0)


def test_misconfigurations_raise(runs):
    with pytest.raises(ValueError, match="must divide"):
        get_mesh_pp(3)
    cfg3 = _config()
    cfg3.num_layers = 3
    with pytest.raises(ValueError, match="divisible"):
        PipelinedBertClassifier(cfg3, NUM_CLASSES, num_stages=2)
    with pytest.raises(ValueError, match="only supported for the BERT"):
        get_cue_model("dense_nn", NUM_CLASSES, pipeline_stages=2)
    with pytest.raises(ValueError, match="requires a"):
        PipelinedBertClassifier(_config(), NUM_CLASSES, num_stages=2)(torch.ones(2, 4, dtype=torch.long))
    for r in runs["two"]:
        refused = r["refused"]
        assert refused["microbatches"].startswith("ValueError") and "num_microbatches" in refused["microbatches"]
        assert refused["mixup"].startswith("NotImplementedError") and "mixup" in refused["mixup"]
        assert refused["remat"].startswith("NotImplementedError") and "remat" in refused["remat"]
        assert refused["batchnorm"].startswith("NotImplementedError") and "BatchNorm" in refused["batchnorm"]


def test_cues_pipeline_trains_pipeline_parallel(runs):
    assert isinstance(get_cue_model("bert", NUM_CLASSES, pipeline_stages=1), BertClassifier)
    for r in runs["two"]:
        hist = r["pipeline"]["history"]
        assert len(hist) == 1 and np.isfinite(hist[0]["train_loss"])
    tree = load_checkpoint(runs["two"][0]["pipeline"]["best"])
    std = BertClassifier(bert_tiny_config(), len(tree["classes"]))
    std.load_state_dict(unstack_bert_layers(tree["state"]["params"], 2), strict=True)
    assert torch.isfinite(std.eval()(torch.ones(2, 8, dtype=torch.long))).all()
