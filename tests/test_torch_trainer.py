"""The port's Trainer against the JAX package's Trainer, on the CPU.

Both trainers start from the same weights (drawn for the JAX model by
``torch_parity_utils.random_variables`` and bridged into the port), with
dropout off (the JAX trainer's ``rbg`` keys have no torch counterpart).
Each takes 3 optimizer steps on the same shuffled, padded batches (the
third batch holds 4 real rows and 4 pad rows at weight 0) and then a
2-epoch fit. Held: the per-step losses to 1e-4 relative, the parameters and
BatchNorm statistics after the steps, the epoch history, and the plateau's
LR sequence exactly. Also: the plateau copy, the metric logs byte for byte,
an exact resume, the Flax-style BatchNorm and initializers, bf16 compute
over float32 parameters, and the knobs that are not ported.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from torch_parity_utils import random_variables

from multimodal_lipread_tpu.models import audio as jaudio
from multimodal_lipread_tpu.nn import common as jcommon
from multimodal_lipread_tpu.train.schedule import ReduceLROnPlateau as JPlateau
from multimodal_lipread_tpu.train.trainer import ArrayDataset as JArrayDataset
from multimodal_lipread_tpu.train.trainer import Trainer as JTrainer
from multimodal_lipread_tpu.train.trainer import TrainerConfig as JTrainerConfig
from multimodal_lipread_tpu.utils.metrics_log import MetricLogger as JMetricLogger

from multimodal_lipread_torch.models import audio as paudio
from multimodal_lipread_torch.nn import MLP, BatchNorm, flax_init_
from multimodal_lipread_torch.train.checkpoint import load_checkpoint
from multimodal_lipread_torch.train.schedule import ReduceLROnPlateau
from multimodal_lipread_torch.train.trainer import (
    UNPORTED_KNOBS,
    ArrayDataset,
    Trainer,
    TrainerConfig,
)
from multimodal_lipread_torch.utils.jax_bridge import state_dict_from_jax
from multimodal_lipread_torch.utils.metrics_log import MetricLogger

LOSS_RTOL = 1e-4
# Adam's first steps move nearly every weight by ±lr whatever the size of
# its gradient (g / (sqrt(v) + eps) with v = g²), so a weight whose gradient
# is near zero steps the opposite way under two float32 implementations
# whose gradients differ by rounding. After 3 steps the parameters are held
# to: 99 % of each tensor's elements within 2 % of lr, every element within
# 6 lr (three opposite steps). A bias straight before a BatchNorm (dense{i},
# conv{k}, fc1 → bn) has an exactly zero gradient (training-mode BatchNorm
# subtracts it again), so all its steps follow rounding noise: only the
# 6 lr bound holds for it. Such weights change no output.
PARAM_P99_PER_LR = 0.02
PARAM_MAX_PER_LR = 6.0
# Batch statistics agree as the activations do.
STATS_TOL = 1e-4
# The epoch history comes after 3 to 9 steps. A float32 trajectory of this
# training departs from its own float64 trajectory at a rate that grows with
# every step and with lr (multimodal_lipread_torch/tools/train_drift.py
# measures it on the card), so the history's losses are held to 5e-3 and
# its accuracies and plateau LRs exactly.
HISTORY_RTOL = 5e-3
BATCH = 8
N_TRAIN = 20  # batches of 8, 8 and 4 (+ 4 rows at weight 0)
NUM_CLASSES = 4


def _data(n, shape, seed, offset=1.5):
    """Class-conditional inputs: class c raises the c-th quarter of the
    flattened features by ``offset``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, NUM_CLASSES, n).astype(np.int32)
    x = rng.standard_normal((n, *shape)).astype(np.float32)
    flat = x.reshape(n, -1)
    q = flat.shape[1] // NUM_CLASSES
    for i, c in enumerate(labels):
        flat[i, c * q : (c + 1) * q] += offset
    return x, labels


def _mlp_case():
    kwargs = dict(class_weights=np.asarray([1.0, 2.0, 0.5, 1.0], np.float32), warmup_epochs=0.5)
    return (jcommon.MLP((16, 12), NUM_CLASSES, 0.0, True), MLP(10, (16, 12), NUM_CLASSES, 0.0, True),
            (10,), 1.5, 1e-2, kwargs)


def _vgg_lstm_case():
    # lr 3e-5 and inputs without the class offset, because of two float32
    # effects: three Adam steps at a large lr leave any float32 run far from
    # the exact one (tools/train_drift.py), and on offset inputs the JAX
    # forward picks other max-pool maxima than float64 does
    # (test_vgg_lstm_gradient_matches_float64), so the two gradients differ
    # beyond rounding from the first step.
    jm = jaudio.VGGWithLSTMClassifier(NUM_CLASSES, version=11, lstm_hidden=16, dropout_rate=0.0)
    pm = paudio.VGGWithLSTMClassifier(NUM_CLASSES, version=11, lstm_hidden=16, dropout_rate=0.0)
    return jm, pm, (80, 32), 0.0, 3e-5, {}


CASES = {"mlp_bn": _mlp_case, "vgg_lstm": _vgg_lstm_case}


def _configs(tmp, lr, kwargs, side):
    common = dict(model_name="m", num_classes=NUM_CLASSES, batch_size=BATCH, epochs=2,
                  learning_rate=lr, weight_decay=1e-4, scheduler_patience=0, seed=0,
                  metrics_dir=str(tmp / side / "metrics"), checkpoints_dir=str(tmp / side / "ckpt"),
                  **kwargs)
    return JTrainerConfig(**common), TrainerConfig(**common)


def _jax_state_dict(trainer):
    state = jax.tree_util.tree_map(np.asarray, trainer.state)
    return state_dict_from_jax(state["params"], state["batch_stats"])


@pytest.fixture(scope="module", params=sorted(CASES))
def trained(request, tmp_path_factory):
    """Both trainers: 3 steps, then a 2-epoch fit, from bridged weights."""
    tmp = tmp_path_factory.mktemp(request.param)
    jmodel, pmodel, shape, off, lr, kwargs = CASES[request.param]()
    x, y = _data(N_TRAIN, shape, seed=1, offset=off)
    splits = {name: _data(12, shape, seed=s, offset=off) for name, s in (("val", 2), ("test", 3))}
    jcfg, pcfg = _configs(tmp, lr, kwargs, "jax"), _configs(tmp, lr, kwargs, "torch")

    jt = JTrainer(jmodel, jcfg[0])
    jt.init_state((x,))
    v = random_variables(jmodel, x[:2], seed=5)
    host = jax.tree_util.tree_map(np.asarray, jt.state)
    jt.state = jt._place({**host, "params": v["params"], "batch_stats": v.get("batch_stats", {})})
    pt = Trainer(pmodel, pcfg[1], device="cpu")
    pt.init_state()
    pt.model.load_state_dict(state_dict_from_jax(v["params"], v.get("batch_stats", {})), strict=True)

    # 3 steps: one shuffled epoch of 8 + 8 + (4 real + 4 pad) rows
    jt._build_steps()
    jds, pds = JArrayDataset((x,), y), ArrayDataset((x,), y)
    jlosses, plosses, jbatches, pbatches = [], [], [], []
    for (ji, jl, jw), (pi, pl, pw) in zip(jt._batches(jds, True, np.random.default_rng(7)),
                                          pt.batches(pds, True, np.random.default_rng(7))):
        jbatches.append((np.asarray(ji[0]), np.asarray(jl), np.asarray(jw)))
        pbatches.append((pi[0].numpy(), pl.numpy(), pw.numpy()))
        jt.state, l, _c, _n, w = jt._train_step(jt.state, ji, jl, jw, jt._dropout_rng(1))
        jlosses.append(float(l) / float(w))
        loss_sum, _c, _n, wsum = pt.train_step(pi, pl, pw).tolist()
        plosses.append(loss_sum / wsum)
    after_steps = (_jax_state_dict(jt), {k: v.clone() for k, v in pt.model.state_dict().items()})
    jt._global_step = 3  # what the JAX trainer's own loop counts; the port's is pt.step

    jfit = jt.fit(jds, JArrayDataset((splits["val"][0],), splits["val"][1]),
                  JArrayDataset((splits["test"][0],), splits["test"][1]), progress=None)
    pfit = pt.fit(pds, ArrayDataset((splits["val"][0],), splits["val"][1]),
                  ArrayDataset((splits["test"][0],), splits["test"][1]), progress=None)
    return dict(lr=lr, jlosses=jlosses, plosses=plosses, jbatches=jbatches, pbatches=pbatches,
                after_steps=after_steps, jfit=jfit, pfit=pfit, tmp=tmp)


def test_batches_are_the_jax_trainers(trained):
    assert len(trained["pbatches"]) == 3
    for (jx, jy, jw), (px, py, pw) in zip(trained["jbatches"], trained["pbatches"]):
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(py, jy)
        np.testing.assert_array_equal(pw, jw)
    assert trained["pbatches"][-1][2].tolist() == [1.0] * 4 + [0.0] * 4  # padded with real rows


def test_step_losses_match_jax(trained):
    np.testing.assert_allclose(trained["plosses"], trained["jlosses"], rtol=LOSS_RTOL)
    assert trained["plosses"][0] != trained["plosses"][1] != trained["plosses"][2]


def test_vgg_lstm_gradient_matches_float64():
    """One training-mode gradient of the port's vgg_lstm, in float32,
    against the same in float64, on class-offset inputs: within 1e-4 of
    each tensor's largest entry. (The JAX package's float32 gradient on
    XLA:CPU is not held to this here: its forward picks other max-pool
    maxima than float64 in some windows of these inputs, which routes
    those windows' gradient elsewhere.)"""
    x, y = _data(BATCH, (80, 32), seed=1)
    jm = jaudio.VGGWithLSTMClassifier(NUM_CLASSES, version=11, lstm_hidden=16, dropout_rate=0.0)
    v = random_variables(jm, x[:2], seed=5)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        pm = paudio.VGGWithLSTMClassifier(NUM_CLASSES, version=11, lstm_hidden=16, dropout_rate=0.0, dtype=dtype)
        pm.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]))
        pm.to(dtype).train()
        loss = torch.nn.functional.cross_entropy(pm(torch.from_numpy(x).to(dtype)), torch.from_numpy(y).long())
        loss.backward()
        grads[dtype] = {k: p.grad.double() for k, p in pm.named_parameters()}
    for name, exact in grads[torch.float64].items():
        if name.endswith(".bias") and ("conv" in name or "fc1" in name):
            continue  # feeds a BatchNorm: exactly zero, rounding noise in both
        err = float((grads[torch.float32][name] - exact).abs().max() / exact.abs().max().clamp_min(1e-30))
        assert err <= 1e-4, (name, err)


def test_parameters_and_running_stats_after_steps_match_jax(trained):
    want, got = trained["after_steps"]
    lr = trained["lr"]
    assert set(got) == set(want)
    for name in sorted(want):
        if "running_" in name:
            torch.testing.assert_close(got[name], want[name], rtol=STATS_TOL, atol=STATS_TOL, msg=name)
            continue
        diff = (got[name] - want[name]).abs().flatten()
        assert float(diff.max()) <= PARAM_MAX_PER_LR * lr, name
        bn_scale = name.replace("dense", "bn").replace("conv", "bn").replace("fc1", "bn")[: -len("bias")] + "weight"
        feeds_bn = name.endswith(".bias") and bn_scale in want and bn_scale != name[: -len("bias")] + "weight"
        if not feeds_bn:
            assert float(diff.quantile(0.99)) <= PARAM_P99_PER_LR * lr, name


def test_fit_history_and_plateau_lrs_match_jax(trained):
    jh, ph = trained["jfit"]["history"], trained["pfit"]["history"]
    assert [h["epoch"] for h in ph] == [h["epoch"] for h in jh] == [1, 2]
    assert [h["lr"] for h in ph] == pytest.approx([h["lr"] for h in jh], rel=1e-12)
    for key in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose([h[key] for h in ph], [h[key] for h in jh], rtol=HISTORY_RTOL, err_msg=key)
    for key in ("train_acc", "val_acc", "test_acc"):
        assert [h[key] for h in ph] == [h[key] for h in jh], key
    assert trained["pfit"]["best_val_acc"] == trained["jfit"]["best_val_acc"]
    np.testing.assert_allclose(trained["pfit"]["final_test_loss"], trained["jfit"]["final_test_loss"],
                               rtol=HISTORY_RTOL)


def test_fit_writes_the_jax_files(trained):
    tmp = trained["tmp"]
    assert sorted(os.listdir(tmp / "torch" / "ckpt")) == ["m_best.pt"]
    tree = load_checkpoint(str(tmp / "torch" / "ckpt" / "m_best.pt"))
    assert set(tree["state"]) == {"params", "batch_stats", "opt_state", "step"}
    for key in ("epoch", "val_acc", "scheduler_lr", "scheduler_best", "scheduler_has_best",
                "scheduler_bad_epochs", "best_val_acc"):
        assert key in tree
    for name in ("m_training_log.csv", "m_training_log.txt"):
        with open(tmp / "jax" / "metrics" / name) as f:
            want = f.read().splitlines()
        with open(tmp / "torch" / "metrics" / name) as f:
            got = f.read().splitlines()
        assert len(got) == len(want) and got[0] == want[0], name
    with open(tmp / "torch" / "metrics" / "m_training_log.txt") as f:
        assert f.read().splitlines()[-1].startswith("Final Test Loss: ")


@pytest.mark.parametrize("mode, series", [
    ("min", [1.0, 0.9, 0.9, 0.91, 0.8999, 0.95, 0.5, 0.6, 0.6, 0.6, 0.6]),
    ("max", [10.0, 5.0, 10.0005, 10.002, 9.0, 9.0, 12.0]),
])
@pytest.mark.parametrize("patience, min_lr", [(0, 0.0), (2, 0.3)])
def test_plateau_matches_jax(mode, series, patience, min_lr):
    ours = ReduceLROnPlateau(1.0, mode=mode, factor=0.5, patience=patience, min_lr=min_lr)
    theirs = JPlateau(1.0, mode=mode, factor=0.5, patience=patience, min_lr=min_lr)
    for metric in series:
        assert ours.step(metric) == theirs.step(metric)
        assert (ours.best, ours.num_bad_epochs) == (theirs.best, theirs.num_bad_epochs)


@pytest.mark.parametrize("columns, txt_header", [("full", False), ("full", True), ("train_val", False)])
def test_metric_logs_are_byte_identical(tmp_path, columns, txt_header):
    rows = [(1, 1.2345678, 40.0, 1.3, 37.5, 1.31, 33.333333333), (2, 0.5, 87.5, 0.61, 75.0, None, None)]
    loggers = [cls(str(tmp_path / side), "vgg_lstm", columns=columns, txt_header=txt_header)
               for cls, side in ((JMetricLogger, "jax"), (MetricLogger, "torch"))]
    for logger in loggers:
        for row in rows:
            logger.log_epoch(*row)
        logger.log_final(0.625, 81.25)
    for name in ("vgg_lstm_training_log.csv", "vgg_lstm_training_log.txt"):
        with open(tmp_path / "jax" / name, "rb") as f:
            want = f.read()
        with open(tmp_path / "torch" / name, "rb") as f:
            assert f.read() == want, name


def _mlp_trainer(tmp, epochs, **kwargs):
    cfg = TrainerConfig(model_name="m", num_classes=NUM_CLASSES, batch_size=BATCH, epochs=epochs,
                        learning_rate=1e-2, seed=3, rolling_checkpoint=True, scheduler_patience=0,
                        metrics_dir=str(tmp / "metrics"), checkpoints_dir=str(tmp / "ckpt"), **kwargs)
    return Trainer(MLP(10, (16,), NUM_CLASSES, 0.3, True), cfg, device="cpu")


@pytest.mark.parametrize("warmup_epochs", [0.0, 1.5])
def test_resume_is_exact(tmp_path, warmup_epochs):
    # dropout on: the resumed run must also restore the dropout generator
    splits = [ArrayDataset(*(lambda x, y: ((x,), y))(*_data(n, (10,), seed=s))) for n, s in ((21, 1), (9, 2), (9, 3))]
    whole = _mlp_trainer(tmp_path / "whole", 3, warmup_epochs=warmup_epochs).fit(*splits, progress=None)
    _mlp_trainer(tmp_path / "cut", 1, warmup_epochs=warmup_epochs).fit(*splits, progress=None)
    resumed = _mlp_trainer(tmp_path / "cut", 3, warmup_epochs=warmup_epochs).fit(*splits, resume=True, progress=None)
    keys = ("epoch", "train_loss", "train_acc", "val_loss", "val_acc", "test_loss", "test_acc", "lr")
    assert [[h[k] for k in keys] for h in resumed["history"]] == [[h[k] for k in keys] for h in whole["history"][1:]]
    assert resumed["final_test_loss"] == whole["final_test_loss"]


def test_train_single_batch_and_bf16_keep_float32_parameters(tmp_path):
    model = paudio.VGGWithLSTMClassifier(NUM_CLASSES, version=11, lstm_hidden=16, dtype=torch.bfloat16)
    cfg = TrainerConfig(model_name="m", num_classes=NUM_CLASSES, batch_size=BATCH,
                        metrics_dir=str(tmp_path / "m"), checkpoints_dir=str(tmp_path / "c"))
    trainer = Trainer(model, cfg, device="cpu")
    x, y = _data(N_TRAIN, (80, 32), seed=4)
    first = trainer.train_single_batch(ArrayDataset((x,), y))
    assert np.isfinite(first)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    assert all(p.grad is None or p.grad.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        assert model.eval()(torch.from_numpy(x[:2])).dtype == torch.bfloat16


@pytest.mark.parametrize("name", sorted(UNPORTED_KNOBS))
def test_unported_knob_raises(tmp_path, name):
    on = {"checkpoint_backend": "orbax"}
    cfg = TrainerConfig(model_name="m", num_classes=NUM_CLASSES, metrics_dir=str(tmp_path / "m"),
                        checkpoints_dir=str(tmp_path / "c"), **{name: on[name]})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Trainer(MLP(10, (4,), NUM_CLASSES), cfg, device="cpu")
    assert set(on) == set(UNPORTED_KNOBS)


def test_trainer_config_has_the_jax_fields_it_ports():
    ours = {f.name for f in dataclasses.fields(TrainerConfig)}
    theirs = {f.name for f in dataclasses.fields(JTrainerConfig)}
    assert theirs - ours == {"dropout_rng_impl"}  # a JAX PRNG name; torch has Philox


@pytest.mark.parametrize("shape", [(6, 5), (4, 5, 3, 7)])
def test_batchnorm_matches_flax_in_training(shape):
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(shape) * 3 + 2).astype(np.float32)
    c = shape[1]
    x_last = np.moveaxis(x, 1, -1)  # Flax normalizes the last axis
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), x_last)
    scale, bias = rng.standard_normal(c).astype(np.float32), rng.standard_normal(c).astype(np.float32)
    mean0, var0 = rng.standard_normal(c).astype(np.float32), rng.uniform(0.5, 2, c).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    want, mutated = bn.apply(variables, jnp.asarray(x_last), mutable=["batch_stats"])
    ours = BatchNorm(c).train()
    ours.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(mean0), "running_var": torch.from_numpy(var0)})
    got = ours(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.running_mean.numpy(), mutated["batch_stats"]["mean"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours.running_var.numpy(), mutated["batch_stats"]["var"], rtol=1e-6, atol=1e-6)


def test_flax_init_matches_the_jax_initializers():
    x = np.zeros((2, 80, 32), np.float32)
    jm = jaudio.VGGWithLSTMClassifier(NUM_CLASSES, version=11, lstm_hidden=16)
    v = jax.tree_util.tree_map(np.asarray, jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
                                                   x, train=False))
    want = state_dict_from_jax(v["params"], v["batch_stats"])
    pm = paudio.VGGWithLSTMClassifier(NUM_CLASSES, version=11, lstm_hidden=16)
    got = flax_init_(pm, torch.Generator().manual_seed(0)).state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if w.ndim > 1 and "lstm" not in name:  # lecun normal, truncated at 2 sigma
            fan_in = w[0].numel()
            assert abs(float(g.std()) * np.sqrt(fan_in) - 1.0) < 0.1 + 3 / np.sqrt(g.numel()), name
            assert float(g.abs().max()) <= 2.0 / 0.8796256610342398 / np.sqrt(fan_in) + 1e-6, name
        elif "lstm" in name:
            bound = 1.0 / np.sqrt(16)
            assert float(g.abs().max()) <= bound and float(w.abs().max()) <= bound, name
            assert float(g.std()) == pytest.approx(bound / np.sqrt(3), rel=0.15), name
        else:  # biases, BatchNorm scale/bias/statistics: constants
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
    again = flax_init_(paudio.VGGWithLSTMClassifier(NUM_CLASSES, version=11, lstm_hidden=16),
                       torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_model_precision_turns_tf32_off_for_float32_and_restores():
    from multimodal_lipread_torch.utils.precision import compute_dtype, model_precision

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        with model_precision(torch.float32):
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (False, False)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
        with model_precision(torch.bfloat16):
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    assert compute_dtype(paudio.VGGWithLSTMClassifier(4, version=11, dtype=torch.bfloat16)) == torch.bfloat16
    assert compute_dtype(MLP(3, (2,), 2)) == torch.float32


class _RecordsTF32(torch.nn.Module):
    dtype = torch.float32

    def forward(self, x):
        self.seen = torch.backends.cudnn.allow_tf32
        return x


def test_predictor_and_trainer_run_a_float32_model_without_tf32(tmp_path):
    from multimodal_lipread_torch.serving import Predictor

    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        model = _RecordsTF32()
        Predictor(model, batch_size=2, device="cpu").predict_logits(np.zeros((3, 4), np.float32))
        assert model.seen is False
        cfg = TrainerConfig(model_name="m", num_classes=4, metrics_dir=str(tmp_path / "m"),
                            checkpoints_dir=str(tmp_path / "c"))
        trainer = Trainer(model, cfg, device="cpu")
        model.seen = None
        trainer.eval_step((torch.zeros(2, 4),), torch.zeros(2, dtype=torch.long), torch.ones(2))
        assert model.seen is False and torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = saved
