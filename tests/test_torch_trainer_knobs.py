"""The port trainer's remaining knobs on the CPU: ``device_resident`` and
``steps_per_dispatch`` (exactly equal to per-step host batching, with the
JAX trainer's two fallback warnings), ``remat`` (equal to the plain step
with dropout and BatchNorm on, with mixup too, stepwise and in groups of
4), ``mixup_alpha`` (the mix at a fixed λ and
permutation against the JAX package's ``mixup``; only full batches mix),
``handle_preemption`` (a preemption mid-epoch 2 with dropout on resumes to
the uninterrupted run's parameters exactly; SIGTERM and the handlers'
restoration), ``profile_dir`` (a Chrome trace) and an optimizer state
written by a capturable Adam (the card's device-resident trainer) loading
into a CPU trainer. On the CPU the grouped dispatch runs eagerly; the card's
CUDA graphs are held to eager steps in tests/test_torch_cuda.py and
chip_smoke.py's [graphs]."""

import contextlib
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from torch_parity_utils import one_torch_thread  # noqa: F401 (autouse)

from multimodal_lipread_tpu.data.augment import mixup as jmixup

from multimodal_lipread_torch.data.augment import draw_mixup, mixup
from multimodal_lipread_torch.nn.common import MLP
from multimodal_lipread_torch.train.checkpoint import load_checkpoint, save_checkpoint
from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig

NUM_CLASSES = 4


def _dataset(n, seed=0, dim=12):
    rng = np.random.default_rng(seed)
    return ArrayDataset((rng.standard_normal((n, dim)).astype(np.float32),), rng.integers(0, NUM_CLASSES, n))


def _trainer(tmp_path, tag, dropout=0.3, model=None, **cfg):
    model = model or MLP(12, (16, 16), NUM_CLASSES, dropout_rate=dropout, use_batchnorm=True)
    cfg = {"epochs": 3, "test_every_epoch": False, **cfg}
    config = TrainerConfig(model_name="m", num_classes=NUM_CLASSES, batch_size=8, learning_rate=1e-2, seed=3,
                           host_prefetch=0, metrics_dir=str(tmp_path / tag / "metrics"),
                           checkpoints_dir=str(tmp_path / tag / "ckpt"), **cfg)
    return Trainer(model, config, device="cpu")


def _params(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def _assert_same_run(a, b, ta, tb):
    keys = ("train_loss", "train_acc", "val_loss", "val_acc")
    assert [[h[k] for k in keys] for h in a["history"]] == [[h[k] for k in keys] for h in b["history"]]
    pa, pb = _params(ta), _params(tb)
    assert pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k]) for k in pa)
    assert ta.step == tb.step


# --- device_resident and steps_per_dispatch ---------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 16])
def test_device_resident_and_grouped_dispatch_equal_host_batching(tmp_path, k):
    # 44 examples at batch 8: 5 full batches and a padded one, so K=4 leaves
    # a tail of 2 and K=16 runs everything as a tail
    train, val = _dataset(44), _dataset(12, seed=1)
    host = _trainer(tmp_path, "host")
    want = host.fit(train, val, progress=None)
    resident = _trainer(tmp_path, f"k{k}", device_resident=True, steps_per_dispatch=k)
    got = resident.fit(train, val, progress=None)
    _assert_same_run(want, got, host, resident)
    assert host.dropout_generator.get_state().equal(resident.dropout_generator.get_state())


def test_device_dataset_cache_holds_three_by_identity(tmp_path):
    t = _trainer(tmp_path, "cache", device_resident=True)
    sets = [_dataset(8, seed=s) for s in range(4)]
    placed = [t._device_dataset(ds) for ds in sets[:3]]
    assert t._device_dataset(sets[0])[0][0] is placed[0][0][0]
    t._device_dataset(sets[3])
    assert id(sets[0]) not in t._device_data and len(t._device_data) == 3


def test_grouped_dispatch_warns_where_it_falls_back(tmp_path):
    train, val = _dataset(16), _dataset(8, seed=1)
    with pytest.warns(UserWarning, match="device_resident ArrayDataset"):
        _trainer(tmp_path, "host", steps_per_dispatch=2, epochs=1).fit(train, val, progress=None)
    with pytest.warns(UserWarning, match="per-step LR schedule"):
        _trainer(tmp_path, "warm", steps_per_dispatch=2, device_resident=True, warmup_epochs=1.0,
                 epochs=1).fit(train, val, progress=None)


def test_per_step_lr_falls_back_to_the_same_trajectory(tmp_path):
    train, val = _dataset(40), _dataset(8, seed=1)
    runs = []
    for tag, extra in (("host", {}), ("grouped", {"device_resident": True, "steps_per_dispatch": 2})):
        t = _trainer(tmp_path, tag, lr_schedule="linear_warmup", **extra)
        with pytest.warns(UserWarning, match="per-step LR") if extra else contextlib.nullcontext():
            runs.append((t.fit(train, val, progress=None), t))
    _assert_same_run(runs[0][0], runs[1][0], runs[0][1], runs[1][1])


# --- remat ---------------------------------------------------------------------


def test_remat_equals_plain_with_dropout_on(tmp_path):
    ds = _dataset(24)
    losses, trainers = {}, {}
    for remat in (False, True):
        t = trainers[remat] = _trainer(tmp_path, f"remat{remat}", dropout=0.4, remat=remat)
        t.init_state()
        losses[remat] = []
        for inputs, labels, weights in t.batches(ds, True, np.random.default_rng(0)):
            loss_sum, _, _, wsum = t.train_step(inputs, labels, weights).tolist()
            losses[remat].append(loss_sum / wsum)
    assert len(losses[True]) == 3
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-6, atol=0)
    plain, remat = _params(trainers[False]), _params(trainers[True])
    for k in plain:  # parameters and the BatchNorm statistics (moved once per step)
        np.testing.assert_allclose(remat[k].numpy(), plain[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    assert trainers[True].dropout_generator.get_state().equal(trainers[False].dropout_generator.get_state())


@pytest.mark.parametrize("extra", [{}, {"device_resident": True, "steps_per_dispatch": 4}])
def test_remat_with_mixup_equals_plain_mixup_and_keeps_its_twin_in_step(tmp_path, extra):
    # mixup draws from the dropout generator before the forward: the twin
    # that the recompute draws from takes the same draw, or it would stand
    # one draw behind and the recompute would draw other masks
    train, val = _dataset(44), _dataset(12, seed=1)
    runs = {}
    for remat in (False, True):
        t = _trainer(tmp_path, f"remat{remat}", dropout=0.4, mixup_alpha=0.4, remat=remat, **extra)
        runs[remat] = (t.fit(train, val, progress=None), t)
    keys = ("train_loss", "train_acc", "val_loss", "val_acc")
    np.testing.assert_allclose([[h[k] for k in keys] for h in runs[True][0]["history"]],
                               [[h[k] for k in keys] for h in runs[False][0]["history"]], rtol=1e-6, atol=0)
    plain, remat = _params(runs[False][1]), _params(runs[True][1])
    for k in plain:
        np.testing.assert_allclose(remat[k].numpy(), plain[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    t = runs[True][1]
    assert t.dropout_generator.get_state().equal(runs[False][1].dropout_generator.get_state())
    assert t._twin_generator.get_state().equal(t.dropout_generator.get_state())


# --- mixup -----------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_mixup_matches_jax_at_a_fixed_lambda_and_permutation(alpha):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 3, 4)).astype(np.float32)
    z = rng.integers(0, 255, (6, 5)).astype(np.float32)
    onehot = np.eye(NUM_CLASSES, dtype=np.float32)[rng.integers(0, NUM_CLASSES, 6)]
    key = jax.random.PRNGKey(int(alpha * 10))
    (jx, jz), jy = jmixup(key, (x, z), onehot, alpha)
    k1, k2 = jax.random.split(key)  # what jmixup drew
    lam = torch.tensor(float(jax.random.beta(k1, alpha, alpha)))
    perm = torch.from_numpy(np.asarray(jax.random.permutation(k2, 6)).astype(np.int64))
    (px, pz), py = mixup((torch.from_numpy(x), torch.from_numpy(z)), torch.from_numpy(onehot), lam, perm)
    for got, want in ((px, jx), (pz, jz), (py, jy)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_mixup_draw_is_a_beta_and_a_permutation():
    gen = torch.Generator().manual_seed(0)
    lams = []
    for _ in range(400):
        lam, perm = draw_mixup(gen, 8, 0.4, torch.device("cpu"))
        assert sorted(perm.tolist()) == list(range(8))
        lams.append(float(lam))
    # Beta(0.4, 0.4): mean 1/2, variance 1/(4 (2α + 1)) = 0.1389
    assert abs(np.mean(lams) - 0.5) < 0.05 and abs(np.var(lams) - 0.1389) < 0.03


def test_mixup_trains_and_leaves_padded_batches_unmixed(tmp_path):
    train, val = _dataset(20), _dataset(8, seed=1)
    hist = _trainer(tmp_path, "mix", mixup_alpha=0.4).fit(train, val, progress=None)["history"]
    assert all(np.isfinite([h["train_loss"] for h in hist]))
    # a batch with a weight-0 row does not mix: the same step as without mixup
    inputs, labels = torch.from_numpy(train.inputs[0][:8]), torch.from_numpy(train.labels[:8])
    weights = torch.ones(8)
    weights[-1] = 0.0
    stats = []
    for tag, alpha in (("off", 0.0), ("on", 0.4)):
        t = _trainer(tmp_path, tag, dropout=0.0, mixup_alpha=alpha)
        t.init_state()
        stats.append((t.train_step((inputs,), labels, weights), _params(t)))
    assert torch.equal(stats[0][0], stats[1][0])
    assert all(torch.equal(stats[0][1][k], stats[1][1][k]) for k in stats[0][1])
    # and a full batch does
    t = _trainer(tmp_path, "full", dropout=0.0, mixup_alpha=0.4)
    t.init_state()
    mixed = t.train_step((inputs,), labels, torch.ones(8))
    t = _trainer(tmp_path, "plain", dropout=0.0)
    t.init_state()
    assert not torch.equal(mixed, t.train_step((inputs,), labels, torch.ones(8)))


# --- preemption ----------------------------------------------------------------


def _preempt_after(trainer, steps):
    """Request a preemption once ``trainer`` has taken ``steps`` steps."""
    step = trainer.train_step

    def counting(*args, **kwargs):
        out = step(*args, **kwargs)
        if trainer.step == steps:
            trainer.request_preemption()
        return out

    trainer.train_step = counting


@pytest.mark.parametrize("extra", [{}, {"device_resident": True, "steps_per_dispatch": 2}])
def test_preemption_mid_epoch_two_resumes_exactly(tmp_path, extra):
    train, val, test = _dataset(40), _dataset(12, seed=1), _dataset(12, seed=2)
    common = dict(dropout=0.4, epochs=3, handle_preemption=True, rolling_checkpoint=True, test_every_epoch=True,
                  **extra)
    whole_t = _trainer(tmp_path, "whole", **common)
    whole = whole_t.fit(train, val, test, progress=None)
    cut = _trainer(tmp_path, "cut", **common)
    _preempt_after(cut, 5 + 2)  # an epoch is 5 steps: 2 steps into epoch 2
    first = cut.fit(train, val, test, progress=None)
    assert first["preempted"] is True and [h["epoch"] for h in first["history"]] == [1]
    ckpt = load_checkpoint(str(tmp_path / "cut" / "ckpt" / "m_checkpoint.pt"))
    assert ckpt["epoch"] == 1 and ckpt["state"]["step"] == 5
    resumed_t = _trainer(tmp_path, "cut", **common)
    resumed = resumed_t.fit(train, val, test, resume=True, progress=None)
    keys = ("epoch", "train_loss", "train_acc", "val_loss", "val_acc", "test_loss", "test_acc")
    assert ([[h[k] for k in keys] for h in first["history"] + resumed["history"]]
            == [[h[k] for k in keys] for h in whole["history"]])
    pa, pb = _params(whole_t), _params(resumed_t)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert resumed["final_test_loss"] == whole["final_test_loss"]


def test_sigterm_preempts_and_the_handlers_are_restored(tmp_path):
    train, val = _dataset(40), _dataset(8, seed=1)
    before = signal.getsignal(signal.SIGTERM)
    t = _trainer(tmp_path, "sig", handle_preemption=True, rolling_checkpoint=True)
    step = t.train_step

    def kill_once(*args, **kwargs):
        if t.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*args, **kwargs)

    t.train_step = kill_once
    result = t.fit(train, val, progress=None)
    assert result["preempted"] is True and result["history"] == []
    assert signal.getsignal(signal.SIGTERM) is before
    assert load_checkpoint(str(tmp_path / "sig" / "ckpt" / "m_checkpoint.pt"))["epoch"] == 0


# --- profile_dir and checkpoints -----------------------------------------------


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    t = _trainer(tmp_path, "prof", epochs=2, profile_dir=str(tmp_path / "trace"))
    t.fit(_dataset(16), _dataset(8, seed=1), progress=None)
    assert os.listdir(tmp_path / "trace") == ["m_epoch1.trace.json"]
    with open(tmp_path / "trace" / "m_epoch1.trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("train_step" in str(e.get("name", "")) or "aten::" in str(e.get("name", "")) for e in events)


def test_a_capturable_optimizer_state_resumes_on_the_cpu(tmp_path):
    # what a device-resident trainer on the card writes: Adam's step counts
    # on the device and its LR a tensor; on the CPU it loads as a float LR
    train, val = _dataset(16), _dataset(8, seed=1)
    a = _trainer(tmp_path, "a", rolling_checkpoint=True, epochs=1)
    a.fit(train, val, progress=None)
    path = str(tmp_path / "a" / "ckpt" / "m_checkpoint.pt")
    ckpt = load_checkpoint(path)
    for group in ckpt["state"]["opt_state"]["param_groups"]:
        group["capturable"], group["lr"] = True, torch.tensor(group["lr"])
    save_checkpoint(str(tmp_path / "b" / "ckpt" / "m_checkpoint.pt"), ckpt)
    b = _trainer(tmp_path, "b", rolling_checkpoint=True, epochs=2)
    resumed = b.fit(train, val, resume=True, progress=None)
    assert [h["epoch"] for h in resumed["history"]] == [2] and b.step == 4
    assert all(g["capturable"] is False and isinstance(g["lr"], float) for g in b.optimizer.param_groups)
    whole = _trainer(tmp_path, "c", rolling_checkpoint=True, epochs=2)
    want = whole.fit(train, val, progress=None)
    assert resumed["history"][0]["train_loss"] == want["history"][1]["train_loss"]
