"""cuDNN's timed choice of convolution engines in the trainer, on the CPU
(``utils/precision.timed_conv_engines``): ``torch.backends.cudnn.benchmark``
is on inside the forward of every kind of step (``train_step``,
``train_step_idx``, ``eval_step``, grouped train and eval dispatches),
unless the caller set ``cudnn.deterministic`` and left it off, and the
caller's value comes back after each, after a failing step too;
``cudnn.deterministic`` and ``allow_tf32`` as the caller set them are left
alone (a float32 model still turns TF32 off inside); a ``Predictor``'s
forward sees the process's own value; and ``trainer.conv_tune_rounds``
counts one round a new input signature (kind, shapes, dtypes) under a
profiler session, inside the span ``trainer.conv_tune``, and nothing with
the profiler off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_parity_utils import one_torch_thread  # noqa: F401 (autouse)

from multimodal_lipread_torch import serving
from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig
from multimodal_lipread_torch.utils import trace

NUM_CLASSES = 4
FLAGS = ("benchmark", "deterministic", "allow_tf32")


class _Probe(torch.nn.Module):
    """A linear classifier that records cuDNN's flags at each forward, and
    raises there once ``fail`` is set."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc = torch.nn.Linear(12, NUM_CLASSES)
        self.seen = []
        self.fail = False

    def forward(self, x):
        self.seen.append(tuple(getattr(torch.backends.cudnn, f) for f in FLAGS))
        if self.fail:
            raise RuntimeError("probe failure")
        return self.fc(x.float())


def _dataset(n, seed=0):
    rng = np.random.default_rng(seed)
    return ArrayDataset((rng.standard_normal((n, 12)).astype(np.float32),), rng.integers(0, NUM_CLASSES, n))


def _trainer(tmp_path, model=None, **cfg):
    config = TrainerConfig(model_name="p", num_classes=NUM_CLASSES, batch_size=8, learning_rate=1e-2, seed=3,
                           host_prefetch=0, metrics_dir=str(tmp_path / "metrics"),
                           checkpoints_dir=str(tmp_path / "ckpt"), **cfg)
    t = Trainer(model if model is not None else _Probe(), config, device="cpu")
    t.ensure_initialized()
    return t


def _batch(n, seed=0):
    ds = _dataset(n, seed)
    return (torch.from_numpy(ds.inputs[0]),), torch.from_numpy(ds.labels.astype(np.int64)), torch.ones(n)


def _run(kind, trainer):
    """One ``kind`` of step (or grouped epoch) of ``trainer``."""
    inputs, labels, weights = _batch(8)
    if kind == "train_step":
        trainer.train_step(inputs, labels, weights)
    elif kind == "train_step_idx":
        trainer.train_step_idx(inputs, labels, torch.arange(8), weights)
    elif kind == "eval_step":
        trainer.eval_step(inputs, labels, weights)
    elif kind == "grouped_train":
        trainer.train_epoch(_dataset(40), np.random.default_rng(0))
    else:
        trainer.evaluate(_dataset(40, seed=1))


@pytest.fixture
def caller_flags():
    """Restores cuDNN's flags as the test found them."""
    cudnn = torch.backends.cudnn
    saved = tuple(getattr(cudnn, f) for f in FLAGS)
    yield
    for f, v in zip(FLAGS, saved):
        setattr(cudnn, f, v)


def _set(flags):
    for f, v in zip(FLAGS, flags):
        setattr(torch.backends.cudnn, f, v)


def _now():
    return tuple(getattr(torch.backends.cudnn, f) for f in FLAGS)


KINDS = ["train_step", "train_step_idx", "eval_step", "grouped_train", "grouped_eval"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("caller", [(False, False, True), (True, True, False), (False, True, True),
                                    (False, True, False)])
def test_engines_are_timed_inside_each_step_and_the_callers_flags_come_back(tmp_path, caller_flags, kind, caller):
    trainer = _trainer(tmp_path, device_resident=kind.startswith("grouped"), steps_per_dispatch=2)
    _set(caller)
    _run(kind, trainer)
    assert _now() == caller
    seen = trainer.model.seen
    timed = caller[0] or not caller[1]  # timed picks differ between processes: deterministic keeps the caller's
    assert seen and all(s == (timed, caller[1], False) for s in seen), seen  # float32: no TF32 inside


@pytest.mark.parametrize("kind", ["train_step", "eval_step"])
def test_a_bfloat16_model_is_timed_with_the_callers_tf32(tmp_path, caller_flags, kind):
    trainer = _trainer(tmp_path, model=_Probe(torch.bfloat16))
    _set((False, False, True))
    _run(kind, trainer)
    assert _now() == (False, False, True)
    assert set(trainer.model.seen) == {(True, False, True)}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("caller", [(False, False, True), (False, True, True)])
def test_the_callers_flags_come_back_after_a_failing_step(tmp_path, caller_flags, kind, caller):
    trainer = _trainer(tmp_path, device_resident=kind.startswith("grouped"), steps_per_dispatch=2)
    trainer.model.fail = True
    _set(caller)
    with pytest.raises(RuntimeError, match="probe failure"):
        _run(kind, trainer)
    assert _now() == caller
    assert trainer.model.seen == [(not caller[1], caller[1], False)]


@pytest.mark.parametrize("process", [False, True])
def test_a_predictor_forward_sees_the_process_flag(tmp_path, caller_flags, process):
    trainer = _trainer(tmp_path)
    _set((process, False, True))
    _run("train_step", trainer)
    probe = trainer.model
    probe.seen.clear()
    serving.Predictor(probe.eval(), batch_size=8, device="cpu").predict_logits(_dataset(5).inputs[0])
    assert [s[0] for s in probe.seen] == [process]


def _rounds(session):
    return session["counters"].get("trainer.conv_tune_rounds", 0)


def test_one_round_a_new_signature_under_a_profiler(tmp_path):
    trainer = _trainer(tmp_path)
    (x,), labels, weights = _batch(8)
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train_step((x,), labels, weights)  # new: train at (8, 12) float32
        trainer.train_step((x,), labels, weights)
        trainer.train_step((x[:4],), labels[:4], weights[:4])  # new: a short batch
        trainer.train_step((x.double(),), labels, weights)  # new: another dtype
        trainer.eval_step((x,), labels, weights)  # new: eval
        trainer.eval_step((x,), labels, weights)
    session = trace.last_session()
    assert _rounds(session) == 4
    tunes = [s for s in session["spans"] if s["name"] == "trainer.conv_tune"]
    assert [s["attrs"] for s in tunes] == [{"kind": "train"}] * 3 + [{"kind": "eval"}]
    steps = [s for s in session["spans"] if s["name"] == "trainer.step"]
    assert len(steps) == 4 and [s["parent"] for s in steps if s["parent"] is not None] == [
        t["id"] for t in tunes[:3]]  # each new train step runs inside its round


def test_a_grouped_epoch_tunes_once_in_its_first_group(tmp_path):
    trainer = _trainer(tmp_path, device_resident=True, steps_per_dispatch=2)
    with profile(activities=[ProfilerActivity.CPU]):
        for epoch in range(2):  # 5 steps an epoch: two groups of 2 and a padded tail
            trainer.train_epoch(_dataset(40), np.random.default_rng(epoch), epoch=epoch)
    session = trace.last_session()
    (tune,) = [s for s in session["spans"] if s["name"] == "trainer.conv_tune"]
    first_group = min((s for s in session["spans"] if s["name"] == "trainer.group"), key=lambda s: s["start_ns"])
    assert _rounds(session) == 1 and tune["parent"] == first_group["id"]


def test_no_round_is_counted_with_the_profiler_off(tmp_path):
    trainer = _trainer(tmp_path)
    inputs, labels, weights = _batch(8)
    kept = trace.last_session()
    trainer.train_step(inputs, labels, weights)
    trainer.eval_step(inputs, labels, weights)
    assert trace.last_session() == kept
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train_step(inputs, labels, weights)  # signatures met off the profiler are not new
        trainer.eval_step(inputs, labels, weights)
    session = trace.last_session()
    assert _rounds(session) == 0 and not [s for s in session["spans"] if s["name"] == "trainer.conv_tune"]
