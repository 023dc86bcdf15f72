"""The control of ``correct``, and the faults, read at a cell's own sizes:
the plain reference put in the program's place in a changed form, compared
by the same numbers as a run.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--variant tf32 ...]

Variants:

- ``tf32``: the reference computed with TF32 on, the precision below the
  configurations' float32 (every cell);
- ``half_batch``: each train step takes half of its batch, the mean over the
  rest (train cells);
- ``altered``: one served answer's largest logit raised by 1 (serve cells);
- ``half_rows``: the second half of each request's answers left at zero
  (serve cells).

A train cell's reference steps run on batches of distinct clips drawn from
the seed: the start's three, an epoch to reach the window's state, and the
window's three; a serve cell's on the requests a run of ``--seconds`` would
sample for its check. The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import checks, harness  # noqa: E402
from benchmark.drivers import serve as serve_driver  # noqa: E402
from benchmark.drivers.train import CHECKED_STEPS  # noqa: E402
from benchmark.reference.train import train_steps  # noqa: E402


def train_control(ctx, variant: str) -> dict:
    """A train cell's two checked runs, the reference against its variant:
    three steps from the seed's weights and a fresh Adam, and three from the
    state the reference itself reaches after the rest of an epoch of the
    mix (it stands in for the state the program's window starts from)."""
    batch = ctx.config["training"]["batch_size"]
    clips = ctx.mix["clips"]
    corpus = ctx.adapter.make_corpus(ctx, clips)
    rng = np.random.default_rng(ctx.seed)
    orders = [rng.permutation(clips), rng.permutation(clips)]

    def batches(order, first, last):
        out = []
        for step in range(first, last):
            ids = order[step * batch : (step + 1) * batch]
            out.append((ctx.adapter.reference_inputs(corpus, ids, ctx.device),
                        torch.from_numpy(corpus.labels[ids]).to(ctx.device), torch.ones(batch, device=ctx.device)))
        return out

    lr, wd = ctx.adapter.optimizer(ctx.config)
    trainable = ctx.trainable_names()
    generator = torch.Generator(device=ctx.device)
    generator.manual_seed(ctx.seed + 1)

    def steps(params, adam, use, tf32: bool, gen=None):
        if gen is None:
            gen = torch.Generator(device=ctx.device)
            gen.set_state(generator.get_state())
        ctx.tf32 = tf32
        with ctx.reference_precision():
            return train_steps(ctx.reference, ctx.config, params, trainable, use, lr, wd, gen, adam)

    def compare(params, adam, use, prefix):
        reference = steps(params, adam, use, False)
        if variant == "tf32":
            changed = steps(params, adam, use, True)
        elif variant == "half_batch":
            half = batch // 2
            changed = steps(params, adam, [(tuple(x[:half] for x in inputs), labels[:half], w[:half])
                                           for inputs, labels, w in use], False)
        else:
            raise ValueError(f"{variant} is not a train variant")
        judged, printed = checks.train_numbers(changed, reference, prefix=prefix)
        return {**judged, **{prefix + k: v for k, v in printed.items()}}

    numbers = {"rows_wrong": 0.0, **compare(ctx.weights, None, batches(orders[0], 0, CHECKED_STEPS), "")}
    state = steps(ctx.weights, None, batches(orders[0], 0, clips // batch), False, generator)["state"]
    numbers.update(compare(state["params"], state["adam"], batches(orders[1], 0, CHECKED_STEPS), "window_"))
    return numbers


def serve_control(ctx, variant: str) -> dict:
    mix = ctx.mix
    corpus = ctx.adapter.make_corpus(ctx, mix["pool"])
    due, ids = serve_driver.schedule(mix, ctx.seed, ctx.seconds)
    answered = list(range(len(due)))
    rng = np.random.default_rng(ctx.seed + 1)
    sample = set(rng.choice(answered, size=min(mix["check_requests"], len(answered)), replace=False).tolist())
    sample = sorted(sample | {max(answered, key=lambda i: len(ids[i]))})

    def forward(tf32: bool):
        ctx.tf32 = tf32
        out = []
        with ctx.reference_precision(), torch.no_grad():
            for i in sample:
                inputs = ctx.adapter.reference_inputs(corpus, ids[i], ctx.device)
                out.append(ctx.reference.forward(ctx.weights, ctx.config, inputs, False).float().cpu().numpy())
        return out

    reference = forward(False)
    if variant == "tf32":
        changed = forward(True)
    elif variant == "altered":
        changed = [r.copy() for r in reference]
        row = changed[0][0]
        row[np.argmax(row)] += 1.0
    elif variant == "half_rows":
        changed = [r.copy() for r in reference]
        for c in changed:
            c[len(c) // 2 :] = 0.0 if len(c) > 1 else c[len(c) // 2 :]
    else:
        raise ValueError(f"{variant} is not a serve variant")
    return checks.serve_numbers(changed, reference)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--variant", action="append")
    parser.add_argument("--seconds", type=float, default=None, help="the window a serve run samples from")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    spec = harness.load_spec(ROOT)
    cell = harness.find_cell(spec, args.workload)
    kind = harness.load_json("traffic", cell["traffic"])["kind"]
    variants = args.variant or (["tf32", "half_batch"] if kind == "train" else ["tf32", "altered", "half_rows"])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        for variant in variants:
            t0 = time.perf_counter()
            ctx = harness.Context(spec, cell, seed, args.seconds or spec["run_seconds"], False,
                                  torch.device(args.device), t0)
            try:
                numbers = train_control(ctx, variant) if kind == "train" else serve_control(ctx, variant)
            finally:
                ctx.close()
            print(json.dumps({"workload": args.workload, "seed": seed, "variant": variant, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
