"""The resident train driver (traffic kind ``train_resident``): the
program's device-resident path, where the whole train split lives on the
card and ``training.steps_per_dispatch`` K steps go as one CUDA graph
replay. Mix parameters: ``clips`` (the corpus; an epoch is ``clips /
batch_size`` steps, ``clips / (batch_size · K)`` dispatches), and those of
the pipeline's corpus (``frames`` a clip, ``frame_size``).

Set-up makes the weights and the corpus, builds the program's trainer and
the train split's resident dataset as the pipeline's entry point does, and
runs epoch 0 through ``Trainer.train_epoch``: the corpus placed on the
card, the first group of K steps run eagerly, its capture, and the other
groups replayed. The window hands the same trainer and dataset on and loops
``train_epoch`` over epochs 1, 2, ... until ``--seconds`` have passed, when
the trainer is asked to stop between dispatches (``request_preemption``);
it ends on a ``cuda.synchronize()``. ``train_clips_per_s`` is the clips of
every step dispatched in the window over its length.

The program's dispatch of a group, ``Trainer._run_group``, runs inside the
span ``bench.dispatch``; a replay calls no ``train_step``, so the group is
what is checked. ``correct`` compares with the reference (``checks``):

- the start: set-up's first three steps, run eagerly before the capture,
  from the seed's weights and a fresh Adam (``loss_gap``, ``grad_gap``,
  ``delta_gap`` as ``drivers/train.py`` reads them);
- the window: its first group, a replay, from the parameters, Adam's
  moments and step count and the dropout generator's state as the window
  found them: ``window_loss_gap``, |program − reference| / |reference| of
  the group's first loss, ``window_losses_gap``, the worst of its K losses
  (each from the group's (K, 4) stats), and ``window_delta_gap``, each
  leaf's change over the K steps by the median leaf;
- ``rows_wrong``: rows of the start's batches that are no clip of the
  corpus whole, carry another label or repeat a clip; indices of every
  group of the window outside the corpus or repeated within an epoch; rows
  of the window's first group whose frames, boxes or label in the program's
  dataset are not the clip's (limit 0).

Nothing is read or cloned inside the capture: the start's steps are the
first group's, run before it, and the window's state is taken before the
window opens."""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from benchmark import checks, crop_counts, tracing
from benchmark.drivers.train import CHECKED_STEPS, StepRecorder
from benchmark.reference.train import train_steps

VARIANTS = ("tf32", "shifted_box", "dropped_step")


class WindowCheck:
    """The window's first group: the state it starts from, its indices,
    weights and (K, 4) stats, and each leaf's change over its K steps."""

    def __init__(self, trainer, params: list, names: list):
        state = trainer.optimizer.state
        self.start = [p.detach().clone() for p in params]
        self.adam = {"exp_avg": {n: state[p]["exp_avg"].clone() for n, p in zip(names, params)},
                     "exp_avg_sq": {n: state[p]["exp_avg_sq"].clone() for n, p in zip(names, params)},
                     "step": int(float(state[params[0]]["step"]))}
        self.generator = trainer.dropout_generator.get_state()
        self.idxs = self.ws = self.stats = self.delta_norms = None
        self.done = threading.Event()

    def end(self, params: list, idxs: np.ndarray, ws: np.ndarray, stats: torch.Tensor) -> None:
        self.idxs, self.ws, self.stats = idxs.copy(), ws.copy(), stats.detach().clone()
        with torch.no_grad():
            self.delta_norms = torch.stack([(p - s).norm() for p, s in zip(params, self.start)])
        self.done.set()

    def program(self) -> dict:
        stats = self.stats.double().cpu()
        return {"losses": (stats[:, 0] / stats[:, 3].clamp_min(1e-9)).tolist(),
                "delta_norms": self.delta_norms.tolist()}


class GroupRecorder:
    """Stands in for ``trainer._run_group``: every train dispatch runs inside
    the span ``bench.dispatch``; the indices of each train group are kept by
    epoch (``new_epoch``), and the first group after ``check`` is set is
    checked."""

    def __init__(self, trainer, params: list):
        self.params = params
        self.run_group = trainer._run_group
        self.epochs: list = []
        self.check = None
        trainer._run_group = self

    def new_epoch(self) -> None:
        self.epochs.append([])

    def __call__(self, kind, ds, step, idxs, ws):
        if kind != "train":
            return self.run_group(kind, ds, step, idxs, ws)
        with tracing.span("bench.dispatch"):
            stats = self.run_group(kind, ds, step, idxs, ws)
        if self.epochs:
            self.epochs[-1].append((idxs, ws))
        check = self.check
        if check is not None and not check.done.is_set():
            check.end(self.params, idxs, ws, stats)
        return stats


def window_numbers(program: dict, reference: dict) -> dict:
    """The window's judged numbers (see the module's docstring)."""
    keep = checks.included(reference["raw_grad_norms"])
    losses = np.abs(np.asarray(program["losses"], np.float64) - reference["losses"]) / np.abs(reference["losses"])
    return {"window_loss_gap": float(losses[0]), "window_losses_gap": float(np.max(losses)),
            "window_delta_gap": checks.median_leaf_gap(program["delta_norms"], reference["delta_norms"], keep)}


def _start_rows_wrong(adapter, corpus, batches) -> tuple:
    """(rows of the start's batches that are no clip whole, carry another
    label or repeat a clip; the clip of each row of each batch)."""
    wrong, seen, all_ids = 0, set(), []
    for inputs, labels, _w in batches:
        ids = adapter.batch_clips(corpus, inputs)
        bad = (ids < 0) | (corpus.labels[np.maximum(ids, 0)] != labels.cpu().numpy())
        bad |= np.array([i >= 0 and i in seen for i in ids])
        seen.update(int(i) for i in ids)
        wrong += int(bad.sum())
        all_ids.append(np.maximum(ids, 0))
    return wrong, all_ids


def _window_rows_wrong(corpus, dataset, epochs, check) -> int:
    """Indices outside the corpus or repeated within an epoch, and rows of
    the checked group that the program's dataset holds otherwise than the
    corpus."""
    wrong = 0
    for groups in epochs:
        ids = np.concatenate([idxs[ws > 0] for idxs, ws in groups]) if groups else np.zeros(0, np.int64)
        outside = (ids < 0) | (ids >= len(corpus))
        wrong += int(outside.sum()) + len(ids[~outside]) - len(np.unique(ids[~outside]))
    frames, boxes = dataset.inputs
    for i in np.unique(check.idxs):
        same = (0 <= i < len(corpus) and dataset.labels[i] == corpus.labels[i]
                and np.array_equal(boxes[i], corpus.boxes[i])
                and torch.equal(torch.from_numpy(frames[i]).to(corpus.device), corpus.clip_frames(int(i))))
        wrong += 0 if same else int((check.idxs == i).sum())
    return wrong


def _reference(ctx, params: dict, batches: list, generator_state, adam) -> dict:
    lr, wd = ctx.adapter.optimizer(ctx.config)
    gen = torch.Generator(device=ctx.device)
    gen.set_state(generator_state)  # the trainer's dropout generator
    with ctx.reference_precision():
        return train_steps(ctx.reference, ctx.config, params, ctx.trainable_names(), batches, lr, wd, gen, adam)


def _batch(ctx, corpus, ids, weights) -> tuple:
    ids = np.asarray(ids)
    return (ctx.adapter.reference_inputs(corpus, ids, ctx.device),
            torch.from_numpy(corpus.labels[ids]).to(ctx.device), torch.as_tensor(weights, device=ctx.device))


def run(ctx) -> dict:
    adapter = ctx.adapter
    corpus = adapter.make_corpus(ctx, ctx.mix["clips"])
    trainer, dataset = adapter.build_train(ctx, corpus)
    trainer.ensure_initialized()
    trainer.model.load_state_dict({adapter.PREFIX + n: t for n, t in ctx.weights.items()}, strict=True)
    ctx.phase("trainer and dataset")
    trainable = ctx.trainable_names()
    steps_recorder = StepRecorder(trainer, trainable, adapter.PREFIX)
    groups = GroupRecorder(trainer, steps_recorder.params)
    rng = np.random.default_rng(ctx.seed)
    start_run = steps_recorder.check_next_steps()
    trainer.train_epoch(dataset, rng, epoch=0)
    ctx.sync()
    ctx.phase("first epoch: placing, the eager group, the capture and the replays")
    check = groups.check = WindowCheck(trainer, steps_recorder.params, trainable)
    batch = trainer.batch_size
    stop = threading.Event()

    def close():
        stop.set()
        check.done.wait(120.0)  # the window's checked group is always in it
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
            groups.new_epoch()
            trainer.train_epoch(dataset, rng, epoch=epoch)
            epoch += 1
        ctx.sync()
        seconds = time.perf_counter() - t0
    timer.cancel()
    steps = trainer.step - steps_before
    ctx.read_memory_peak()
    rows_wrong = _window_rows_wrong(corpus, dataset, groups.epochs, check)
    window_steps = [row for epoch_groups in groups.epochs for idxs, _ws in epoch_groups for row in idxs]
    frame_shape = (corpus.size, corpus.size)
    del trainer, steps_recorder, groups, dataset
    ctx.free()

    wrong, ids = _start_rows_wrong(adapter, corpus, start_run.batches)
    rows_wrong += wrong
    start_batches = [_batch(ctx, corpus, i, w) for i, (_x, _y, w) in zip(ids, start_run.batches)]
    reference = _reference(ctx, ctx.weights, start_batches, start_run.generator, None)
    numbers, printed = checks.train_numbers(start_run.program(), reference, trainable)
    ctx.note(f"start: not judged: loss_gap_steps_2_3 {printed['loss_gap_steps_2_3']!r}, delta_gap_worst "
             f"{printed['delta_gap_worst']!r}; worst leaves of grad_gap: {printed['worst_leaves']}; "
             f"left out: {printed['left_out']}")
    del reference, start_batches
    params = {**ctx.weights, **{n: s for n, s in zip(trainable, check.start)}}
    window_batches = [_batch(ctx, corpus, i, w) for i, w in zip(check.idxs, check.ws)]
    reference = _reference(ctx, params, window_batches, check.generator, check.adam)
    numbers.update(window_numbers(check.program(), reference))
    ctx.note(f"window: program losses {check.program()['losses']}, reference {reference['losses']}")
    del reference, window_batches

    clips = steps * batch
    source_bytes = crop_counts.frame_bytes(torch.from_numpy(corpus.boxes.reshape(-1, 4)), *frame_shape)
    clip_bytes = source_bytes.reshape(len(corpus), -1).sum(1).numpy()
    frames_a_launch = batch * corpus.frames

    def crop_bound_s(peaks) -> float:
        """Σ over the window's steps of its crop launch's bound (a launch
        crops every row of the step's batch, padding rows too)."""
        return sum(crop_counts.bound_s(crop_counts.launch_bytes(clip_bytes[row].sum(), frames_a_launch), peaks)
                   for row in window_steps)

    return {
        "e2e": {"train_clips_per_s": clips / seconds},
        "attempted": clips, "failed": 0, "numbers": {"rows_wrong": float(rows_wrong), **numbers},
        "view": {"trace": win.trace, "steps": steps, "batch": batch, "window_s": seconds,
                 "flops_per_step": lambda: ctx.reference_flops(batch, train=True), "crop_bound_s": crop_bound_s},
    }


def control(ctx, variant: str) -> dict:
    """The cell's numbers with the reference in the program's place, changed
    by ``variant``: ``tf32``, the reference computed with TF32 on (the
    precision below the configuration's float32); ``shifted_box``, every
    lip box 2 pixels to the right; ``dropped_step``, a group's last step
    left out (its loss the one before). The start's three steps run from
    the seed's weights on the seed's first epoch order, the window's group
    of K from the state the reference reaches after that epoch, on the next
    epoch's order."""
    if variant not in VARIANTS:
        raise ValueError(f"{variant!r} is not one of {VARIANTS}")
    cfg = ctx.config["training"]
    batch, k, clips = cfg["batch_size"], cfg["steps_per_dispatch"], ctx.mix["clips"]
    corpus = ctx.adapter.make_corpus(ctx, clips)
    rng = np.random.default_rng(ctx.seed)
    orders = [rng.permutation(clips), rng.permutation(clips)]
    ones = np.ones(batch, np.float32)

    def batches(order, count):
        return [_batch(ctx, corpus, order[i * batch:(i + 1) * batch], ones) for i in range(count)]

    class Epoch:  # the epoch's batches, made one at a time
        def __len__(self):
            return clips // batch

        def __iter__(self):
            return (_batch(ctx, corpus, orders[0][i * batch:(i + 1) * batch], ones) for i in range(len(self)))

    def compare(params, adam, use, gen_state):
        ctx.tf32 = False
        reference = _reference(ctx, params, use, gen_state, adam)
        if variant == "dropped_step":
            changed = _reference(ctx, params, use[:-1], gen_state, adam)
            changed["losses"] = changed["losses"] + changed["losses"][-1:]
        else:
            if variant == "shifted_box":
                shift = torch.tensor([2, 0, 2, 0], dtype=torch.int32, device=ctx.device)
                use = [((frames, (boxes + shift).clamp_max(corpus.size)), labels, w)
                       for (frames, boxes), labels, w in use]
            ctx.tf32 = variant == "tf32"
            changed = _reference(ctx, params, use, gen_state, adam)
        ctx.tf32 = False
        return changed, reference

    generator = torch.Generator(device=ctx.device)
    generator.manual_seed(ctx.seed + 1)
    changed, reference = compare(ctx.weights, None, batches(orders[0], CHECKED_STEPS), generator.get_state())
    numbers, _printed = checks.train_numbers(changed, reference)
    lr, wd = ctx.adapter.optimizer(ctx.config)
    with ctx.reference_precision():
        state = train_steps(ctx.reference, ctx.config, ctx.weights, ctx.trainable_names(), Epoch(), lr, wd,
                            generator)["state"]
    changed, reference = compare(state["params"], state["adam"], batches(orders[1], k), generator.get_state())
    numbers.update(window_numbers(changed, reference))
    return {"rows_wrong": 0.0, **numbers}


def main(argv=None) -> int:
    """``python3 -m benchmark.drivers.train_resident --workload <cell> --seeds
    11 12 [--variant tf32 ...]``, from the root of a checkout: one JSON line
    of :func:`control`'s numbers a seed and variant. The benchmark's own
    runs never run this."""
    import argparse
    import json

    from benchmark import harness

    parser = argparse.ArgumentParser(description=control.__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--variant", action="append", choices=VARIANTS)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        for variant in args.variant or VARIANTS:
            t0 = time.perf_counter()
            ctx = harness.Context(spec, cell, seed, spec["run_seconds"], False, torch.device(args.device), t0)
            try:
                numbers = control(ctx, variant)
            finally:
                ctx.close()
            print(json.dumps({"workload": args.workload, "seed": seed, "variant": variant, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
