"""Data parallelism of the PyTorch port on the CPU: two gloo ranks give the
one-rank run's math.

The ranks run in processes of ``tests/torch_dist_worker.py`` (one spawn
for the trainer cases, one for the audio pipeline). Held, as
tests/test_mesh_invariance.py holds the JAX package's 1 against 8 devices:

- one step on each batch of n = 24 at batch 16 (the second batch carries 8
  weight-0 padding rows), at lr 0 so that both batches see the same
  weights: the loss, the summed gradients and the BatchNorm running
  statistics of two ranks equal one rank's at atol 1e-6 / rtol 1e-5;
- a 3-epoch fit from the same weights equals the JAX trainer's fit on the
  conftest's 8-device mesh at rtol 5e-3 for the losses, with equal
  accuracies (JAX's own bounds; dropout off on both sides);
- a streaming dataset of 65 records splits 33 / 32 over the ranks, both
  run ``global_batches`` steps an epoch and apply the same LR schedule;
- a preemption requested on one rank stops both, and ``--resume`` replays
  the uninterrupted run;
- a world-2 checkpoint resumes at world 1 on the uninterrupted trajectory;
- ``pipelines.audio.main`` at world 2 gives the world-1 history.
"""

import jax
import numpy as np
import pytest
from flax import linen as fnn

from torch_dist_worker import BnMlp, Tiny, mlp_data, one_step_records, run_ranks, tiny_data, trainer_config
from torch_parity_utils import one_torch_thread, random_variables  # noqa: F401

from multimodal_lipread_tpu.parallel.mesh import get_mesh
from multimodal_lipread_tpu.train.trainer import ArrayDataset as JArrayDataset
from multimodal_lipread_tpu.train.trainer import Trainer as JTrainer
from multimodal_lipread_tpu.train.trainer import TrainerConfig as JTrainerConfig

from multimodal_lipread_torch.train.trainer import Trainer
from multimodal_lipread_torch.utils.jax_bridge import state_dict_from_jax

STEP_ATOL, STEP_RTOL = 1e-6, 1e-5
FIT_RTOL = 5e-3


class _BnMlp(fnn.Module):
    """tests/test_mesh_invariance.py's model."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = fnn.Dense(32)(x)
        x = fnn.BatchNorm(use_running_average=not train)(x)
        x = fnn.relu(x)
        x = fnn.Dropout(0.2)(x, deterministic=not train)
        return fnn.Dense(4)(x)


def _jax_fit(tmp, variables):
    cfg = JTrainerConfig(model_name="mi_jax", num_classes=4, batch_size=16, epochs=3, learning_rate=1e-2,
                         weight_decay=1e-4, metrics_dir=str(tmp / "jax" / "m"), checkpoints_dir=str(tmp / "jax" / "c"),
                         test_every_epoch=False, seed=0)
    trainer = JTrainer(_BnMlp(), cfg, mesh=get_mesh(jax.devices()[:8]))
    train = mlp_data(40, 0)
    trainer.init_state(train.inputs)
    host = jax.tree_util.tree_map(np.asarray, trainer.state)
    trainer.state = trainer._place({**host, "params": variables["params"],
                                    "batch_stats": variables["batch_stats"]})
    val = mlp_data(24, 1)
    return trainer.fit(JArrayDataset(train.inputs, train.labels), JArrayDataset(val.inputs, val.labels), None,
                       progress=None)["history"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    variables = random_variables(_BnMlp(), mlp_data(2, 0).inputs[0], seed=3)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    names = {n for n, _ in BnMlp().named_parameters()}
    weights = {"params": {k: v for k, v in sd.items() if k in names},
               "batch_stats": {k: v for k, v in sd.items() if k not in names}}
    two = run_ranks("dp", 2, str(tmp / "two"), {"weights": weights, "elastic_dir": str(tmp / "elastic")})

    one = Trainer(BnMlp(), trainer_config(str(tmp / "one"), "step", learning_rate=0.0), device="cpu")
    one.init_state()
    one.load_weights(weights)
    step = one_step_records(one, mlp_data(24, 0))
    fit = Trainer(BnMlp(), trainer_config(str(tmp / "one"), "fit"), device="cpu")
    fit.init_state()
    fit.load_weights(weights)
    one_fit = fit.fit(mlp_data(40, 0), mlp_data(24, 1), None, progress=None)["history"]

    with pytest.MonkeyPatch.context() as patch:  # the JAX model's dropout off, as the port's
        patch.setattr(fnn.Dropout, "__call__", lambda self, x, *args, **kwargs: x)
        jax_fit = _jax_fit(tmp, variables)
    return {"two": two, "step": step, "fit": one_fit, "jax_fit": jax_fit, "tmp": tmp}


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def test_two_rank_step_equals_one_rank_with_padding_inside(runs):
    one = runs["step"]
    assert len(one["loss"]) == 2  # 16 rows, then 8 rows + 8 at weight 0
    for rank_result in runs["two"]:
        two = rank_result["step"]
        _close(two["loss"], one["loss"], atol=STEP_ATOL, rtol=0)
        for g2, g1 in zip(two["grads"], one["grads"]):
            assert set(g2) == set(g1)
            for name in g1:
                _close(g2[name], g1[name], atol=STEP_ATOL, rtol=STEP_RTOL, err_msg=name)
        for s2, s1 in zip(two["stats"], one["stats"]):
            for name in ("BatchNorm_0.running_mean", "BatchNorm_0.running_var"):
                _close(s2[name], s1[name], atol=STEP_ATOL, rtol=STEP_RTOL, err_msg=name)


def test_replicate_broadcasts_the_first_ranks_tensors(runs):
    for rank_result in runs["two"]:
        first, second = rank_result["replicated"]
        assert first.tolist() == [1.0] * 3 and second.tolist() == [0.0, 1.0, 2.0, 3.0]


def test_two_rank_fit_equals_the_jax_8_device_fit(runs):
    want = runs["jax_fit"]
    for rank_result in runs["two"]:
        assert rank_result["fit_batch_size"] == 16
        got = rank_result["fit"]
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a["train_loss"] == pytest.approx(b["train_loss"], rel=FIT_RTOL)
            assert a["val_loss"] == pytest.approx(b["val_loss"], rel=FIT_RTOL)
            assert a["train_acc"] == b["train_acc"]
            assert a["val_acc"] == b["val_acc"]
    for a, b in zip(runs["two"][0]["fit"], runs["fit"]):  # and the port's own world of one
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=FIT_RTOL)
        assert a["val_acc"] == b["val_acc"]


def test_uneven_streaming_shards_share_steps_and_lr_schedule(runs):
    r0, r1 = (r["stream"] for r in runs["two"])
    assert (r0["shard"], r1["shard"]) == ((0, 2), (1, 2))
    assert (r0["len"], r1["len"]) == (33, 32)
    assert r0["rows"] == r1["rows"] == 4  # batch 8 over 2 ranks
    assert r0["global_batches"] == r1["global_batches"] == 9  # ceil(33 / 4) on both
    assert len(r0["lrs"]) == 2 * 9 and r0["lrs"] == r1["lrs"]
    assert r0["history"] == r1["history"]
    assert len(r0["history"]) == 2 and np.isfinite([h["train_loss"] for h in r0["history"]]).all()


def test_preemption_on_one_rank_stops_every_rank_and_resume_replays(runs):
    for rank_result in runs["two"]:
        p = rank_result["preempt"]
        assert p["stopped"] and p["stopped_epochs"] == 1
        assert [h["epoch"] for h in p["resumed"]] == [2, 3, 4]
        for a, b in zip(p["resumed"], p["full"][1:]):
            for key in ("train_loss", "val_loss", "train_acc", "val_acc", "lr"):
                assert a[key] == pytest.approx(b[key], rel=1e-6), key


def test_world_2_checkpoint_resumes_at_world_1(runs):
    tmp = runs["tmp"]
    train, val = tiny_data(48, 0), tiny_data(16, 1)
    full = Trainer(Tiny(), trainer_config(str(tmp / "full"), "elastic", epochs=4, weight_decay=0.0,
                                          rolling_checkpoint=True), device="cpu").fit(train, val, progress=None)
    resumed = Trainer(Tiny(), trainer_config(str(tmp / "elastic"), "elastic", epochs=4, weight_decay=0.0,
                                             rolling_checkpoint=True), device="cpu").fit(
        train, val, resume=True, progress=None)
    assert [h["epoch"] for h in resumed["history"]] == [3, 4]
    by_epoch = {h["epoch"]: h for h in full["history"]}
    for h in resumed["history"]:
        assert h["train_loss"] == pytest.approx(by_epoch[h["epoch"]]["train_loss"], rel=FIT_RTOL)
        assert h["val_loss"] == pytest.approx(by_epoch[h["epoch"]]["val_loss"], rel=FIT_RTOL)


def test_audio_pipeline_at_world_2_gives_the_world_1_history(tmp_path):
    from multimodal_lipread_torch.config import Config
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
    from multimodal_lipread_torch.pipelines.audio import main

    root = make_synthetic_glips(str(tmp_path / "GLips_4"), clips_per_split=3, seed=1)
    config = {"dataset": {"root_dir": root, "num_classes": 4},
              "model": {"name": "vgg_lstm", "version": 11},
              "training": {"batch_size": 8, "epochs": 2, "learning_rate": 1e-4, "seed": 0}}
    two = run_ranks("audio", 2, str(tmp_path / "two"), {"config": config})
    one = main(Config.from_dict({**config, "output": {"base_dir": str(tmp_path / "one"), "plots": False}}),
               device="cpu")["history"]
    for rank_result in two:
        got = rank_result["history"]
        assert [h["epoch"] for h in got] == [1, 2]
        for a, b in zip(got, one):
            for key in ("train_loss", "val_loss"):
                assert a[key] == pytest.approx(b[key], rel=FIT_RTOL), key
            assert (a["train_acc"], a["val_acc"]) == (b["train_acc"], b["val_acc"])
