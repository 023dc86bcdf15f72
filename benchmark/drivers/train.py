"""The train driver. Mix parameter: ``clips`` (the corpus; an epoch is
``clips / batch_size`` steps).

Set-up makes the corpus and the weights, builds the program's trainer and
the train split's dataset, and runs the first epoch of that dataset through
``Trainer.train_epoch``, the window's own call and feed: it warms every
shape and the loader's epoch start. The window hands the same trainer and
dataset on and loops ``train_epoch`` over epochs 1, 2, ... until
``--seconds`` have passed, when the trainer is asked to stop between steps
(``request_preemption``); it ends on a ``cuda.synchronize()``.
``train_clips_per_s`` is the clips of every step taken in the window over
its length.

Two runs of three steps are compared with the reference (``checks``): the
first three of set-up, from the seed's weights and a fresh Adam, and the
first three of the window, from the parameters, Adam's moments and step
count and the dropout generator's state as the window found them. There
the reference follows the program's own state; the first run checks the
start that state was reached from. The rows of both runs' batches, and
the first batch of every epoch the window begins, are checked against the
corpus."""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from benchmark import checks, tracing
from benchmark.reference.train import BETAS, train_steps

CHECKED_STEPS = 3


class CheckedRun:
    """The next three steps of a trainer: the state they start from, their
    batches and stats, the first step's gradient as Adam took it
    ((m₁ − β1·m₀) / (1 − β1) of its first moment), and each leaf's change
    over the three."""

    def __init__(self, trainer, params: list, names: list):
        state = trainer.optimizer.state
        self.fresh = not any("exp_avg" in state.get(p, {}) for p in params)
        self.start = [p.detach().clone() for p in params]
        self.m0 = [state[p]["exp_avg"].clone() if "exp_avg" in state.get(p, {}) else torch.zeros_like(p)
                   for p in params]
        self.adam = None if self.fresh else {
            "exp_avg": dict(zip(names, self.m0)),
            "exp_avg_sq": {n: state[p]["exp_avg_sq"].clone() for n, p in zip(names, params)},
            "step": int(float(state[params[0]]["step"]))}
        self.generator = trainer.dropout_generator.get_state()
        self.batches, self.stats = [], []
        self.grad_norms = self.delta_norms = None
        self.done = threading.Event()

    def record(self, inputs, labels, weights) -> None:
        self.batches.append((tuple(x.clone() for x in inputs), labels.clone(), weights.clone()))

    def after_step(self, trainer, params: list, stats) -> None:
        self.stats.append(stats.detach().clone())
        with torch.no_grad():
            if len(self.stats) == 1:
                state = trainer.optimizer.state
                self.grad_norms = torch.stack([
                    ((state[p]["exp_avg"] - BETAS[0] * m0) / (1 - BETAS[0])).norm() if "exp_avg" in state.get(p, {})
                    else p.new_zeros(()) for p, m0 in zip(params, self.m0)])
                self.m0 = None
            if len(self.stats) == CHECKED_STEPS:
                self.delta_norms = torch.stack([(p - s).norm() for p, s in zip(params, self.start)])
                self.done.set()

    def program(self) -> dict:
        stats = torch.stack(self.stats).double().cpu()
        return {"losses": (stats[:, 0] / stats[:, 3].clamp_min(1e-9)).tolist(),
                "grad_norms": self.grad_norms.tolist(), "delta_norms": self.delta_norms.tolist()}


class StepRecorder:
    """Stands in for ``trainer.train_step``: every step runs inside the span
    ``bench.train_step``; it feeds the checked runs, and keeps the batch of
    a step after ``keep_next`` is set (the first of an epoch)."""

    def __init__(self, trainer, names, prefix):
        self.trainer = trainer
        self.step_fn = trainer.train_step
        by_name = dict(trainer.model.named_parameters())
        self.names = names
        self.params = [by_name[prefix + n] for n in names]
        self.runs, self.kept = [], []
        self.keep_next = False
        trainer.train_step = self

    def check_next_steps(self) -> CheckedRun:
        self.runs.append(CheckedRun(self.trainer, self.params, self.names))
        return self.runs[-1]

    def __call__(self, inputs, labels, weights):
        run = self.runs[-1] if self.runs and len(self.runs[-1].batches) < CHECKED_STEPS else None
        if run is not None:
            run.record(inputs, labels, weights)
        if self.keep_next:
            self.kept.append((inputs[0].clone(), labels.clone()))
            self.keep_next = False
        with tracing.span("bench.train_step", logmel_clips=labels.shape[0]):
            stats = self.step_fn(inputs, labels, weights)
        if run is not None:
            run.after_step(self.trainer, self.params, stats)
        return stats


def _wait_spans(trainer):
    """``trainer.batches`` with each fetch inside the span ``bench.loader.wait``."""
    batches = trainer.batches

    def timed(*args, **kwargs):
        it = batches(*args, **kwargs)
        try:
            while True:
                with tracing.span("bench.loader.wait"):
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                yield item
        finally:
            it.close()

    trainer.batches = timed


def _rows_wrong(adapter, corpus, first_input, labels, seen=None) -> tuple:
    """(rows that are no clip whole, carry another label, or repeat a clip
    in ``seen``; the clip of each row, 0 where none)."""
    ids = adapter.batch_clips(corpus, (first_input,))
    bad = (ids < 0) | (corpus.labels[np.maximum(ids, 0)] != labels.cpu().numpy())
    if seen is not None:
        bad |= np.array([i >= 0 and i in seen for i in ids])
        seen.update(int(i) for i in ids)
    return int(bad.sum()), np.maximum(ids, 0)


def run(ctx) -> dict:
    adapter, cfg = ctx.adapter, ctx.config
    corpus = adapter.make_corpus(ctx, ctx.mix["clips"])
    ctx.phase("corpus")
    trainer, dataset = adapter.build_train(ctx, corpus)
    trainer.ensure_initialized()
    trainer.model.load_state_dict({adapter.PREFIX + n: t for n, t in ctx.weights.items()}, strict=True)
    ctx.phase("trainer and dataset")
    trainable = ctx.trainable_names()
    recorder = StepRecorder(trainer, trainable, adapter.PREFIX)
    if ctx.trace:
        _wait_spans(trainer)
    rng = np.random.default_rng(ctx.seed)
    recorder.check_next_steps()
    trainer.train_epoch(dataset, rng, epoch=0)
    ctx.sync()
    ctx.phase("first epoch")
    window_run = recorder.check_next_steps()
    batch = trainer.batch_size
    stop = threading.Event()

    def close():
        stop.set()
        window_run.done.wait(120.0)  # the window's checked steps are always in it
        trainer.request_preemption()

    steps_before = trainer.step
    timer = threading.Timer(ctx.seconds, close)
    timer.daemon = True
    with tracing.window(ctx.trace) as win:
        ctx.mark_setup_done()
        t0 = time.perf_counter()
        timer.start()
        epoch = 1
        while not stop.is_set():
            recorder.keep_next = True
            trainer.train_epoch(dataset, rng, epoch=epoch)
            epoch += 1
        ctx.sync()
        seconds = time.perf_counter() - t0
    timer.cancel()
    steps = trainer.step - steps_before
    ctx.read_memory_peak()
    runs, kept = recorder.runs, recorder.kept
    if hasattr(dataset, "close"):
        dataset.close()
    del trainer, recorder, dataset
    ctx.free()

    # the reference, from the benchmark's own files, and from the seed's
    # weights or the state the window found
    rows_wrong = sum(_rows_wrong(adapter, corpus, inputs, labels)[0] for inputs, labels in kept)
    lr, wd = adapter.optimizer(cfg)
    numbers, notes = {}, []
    for run_, prefix, label in zip(runs, ("", "window_"), ("start", "window")):
        seen, ref_batches = set(), []
        for inputs, labels, weights in run_.batches:
            wrong, ids = _rows_wrong(adapter, corpus, inputs[0], labels, seen)
            rows_wrong += wrong
            ref_batches.append((adapter.reference_inputs(corpus, ids, ctx.device),
                                torch.from_numpy(corpus.labels[ids]).to(ctx.device), weights.to(ctx.device)))
        params = ctx.weights if run_.fresh else {
            **ctx.weights, **{n: s for n, s in zip(trainable, run_.start)}}
        gen = torch.Generator(device=ctx.device)
        gen.set_state(run_.generator)  # the trainer's dropout generator
        with ctx.reference_precision():
            reference = train_steps(ctx.reference, cfg, params, trainable, ref_batches, lr, wd, gen, run_.adam)
        judged, printed = checks.train_numbers(run_.program(), reference, trainable, prefix)
        numbers.update(judged)
        notes.append(f"{label}: not judged: "
                     + ", ".join(f"{k} {printed[k]!r}" for k in ("loss_gap_steps_2_3", "delta_gap_worst"))
                     + f"; worst leaves of grad_gap: {printed['worst_leaves']}; left out: {printed['left_out']}")
        del reference, ref_batches
    for line in notes:
        ctx.note(line)
    clips = steps * batch
    return {
        "e2e": {"train_clips_per_s": clips / seconds},
        "attempted": clips, "failed": 0, "numbers": {"rows_wrong": float(rows_wrong), **numbers},
        "view": {"trace": win.trace, "steps": steps, "batch": batch, "window_s": seconds,
                 "flops_per_step": lambda: ctx.reference_flops(batch, train=True)},
    }
