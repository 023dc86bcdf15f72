"""A run whose timed path is broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU at a small size, with one fault planted in the program: a train
step that leaves its state unchanged, a train step over half of its batch
(the mean taken over the rest), a served answer altered where it is
produced, half of a served batch left out. The cells run on one card, so
no exchange between cards can be left out. The same run unbroken is the
comparison: the number the fault breaks stays under its limit there."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

TINY = {
    "audio_vgg_lstm.train": {"config": {"training": {"batch_size": 8}, "dataset": {"num_workers": 2}},
                             "mix": {"clips": 24}},
    "audio_vgg_lstm.serve": {"mix": {"pool": 12, "rate_per_s": 3.0, "clips_max": 4, "batch_size": 4,
                                     "check_requests": 4, "workers": 2}},
}
SEED = 2**31 + 101


def run(cell):
    return harness.run_cell(cell, SEED, 1.0, False, "cpu", overrides=TINY[cell])


def _value(result, name):
    return result["checks"][name]["value"], result["checks"][name]["limit"]


@pytest.fixture(scope="module")
def sound():
    return {cell: run(cell) for cell in TINY}


def _unchanged_state(monkeypatch):
    import torch

    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from multimodal_lipread_torch.train.trainer import Trainer

    step = Trainer.train_step

    def half(self, inputs, labels, weights):
        k = labels.shape[0] // 2
        return step(self, tuple(x[:k] for x in inputs), labels[:k], weights[:k])

    monkeypatch.setattr(Trainer, "train_step", half)


def _altered_answer(monkeypatch):
    from multimodal_lipread_torch import serving

    predict = serving.Predictor.predict_logits

    def altered(self, *inputs):
        out = predict(self, *inputs).copy()
        out[0, np.argmax(out[0])] += 1.0
        return out

    monkeypatch.setattr(serving.Predictor, "predict_logits", altered)


def _half_rows(monkeypatch):
    from multimodal_lipread_torch import serving

    predict = serving.Predictor.predict_logits

    def half(self, *inputs):
        k = max(1, inputs[0].shape[0] // 2)
        out = np.zeros((inputs[0].shape[0],) + predict(self, *(a[:1] for a in inputs)).shape[1:], np.float32)
        out[:k] = predict(self, *(a[:k] for a in inputs))
        return out

    monkeypatch.setattr(serving.Predictor, "predict_logits", half)


CASES = [
    ("audio_vgg_lstm.train", _unchanged_state, "delta_gap"),
    ("audio_vgg_lstm.train", _half_batch, "loss_gap"),
    ("audio_vgg_lstm.serve", _altered_answer, "logit_gap"),
    ("audio_vgg_lstm.serve", _half_rows, "logit_gap"),
]


@pytest.mark.parametrize("cell,fault,number", CASES, ids=[f"{c}-{f.__name__[1:]}" for c, f, _n in CASES])
def test_fault_comes_out_not_correct(sound, monkeypatch, cell, fault, number):
    value, limit = _value(sound[cell], number)
    assert value <= limit, f"the unbroken run already fails {number}: {value} > {limit}"
    fault(monkeypatch)
    broken = run(cell)
    assert broken["correct"] is False
    value, limit = _value(broken, number)
    assert value > limit
