"""How far float32 training trajectories of vgg_lstm part, on the card and
the CPU, against a float64 run of the same steps.

    python -m multimodal_lipread_torch.tools.train_drift [--lrs 5e-4 3e-5 1e-5] [--steps 3]
        [--seeds 0 ...] [--no-cpu]

For each of ``--seeds`` it writes the port's synthetic corpus (4 words, 68
clips per split, from the seed), featurizes the train split with the log-mel kernel, and from
one Flax-style initialization from the seed (dropout 0) takes the first ``--steps``
training steps of the full-width vgg_lstm (VGG16-BN, BiLSTM 2 x 128,
batch 32) on the same batches: in float64 on the card (the reference), in
float32 on the card (TF32 off, as the trainer runs a float32 model), and
in float32 on the CPU (left out with ``--no-cpu``). It prints each step's loss and the relative
distances. Adam's first steps move nearly every weight by ±lr whatever the
size of its gradient, so rounding differences between two float32 runs
grow in proportion to lr; ``chip_smoke.py`` holds the card to the CPU at an
lr where they stay small, and the card to float64 at the trained lr within
the spread this tool reads over seeds. Needs a card.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import List, Sequence

import numpy as np
import torch

from multimodal_lipread_torch.models.audio import VGGWithLSTMClassifier
from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig

NUM_CLASSES = 4


def first_steps(ds: ArrayDataset, device: str, dtype: torch.dtype, lr: float, steps: int,
                seed: int, workdir: str, batch_size: int = 32, version: int = 16) -> List[float]:
    """Losses of the first ``steps`` training steps of a full-width
    vgg_lstm from the trainer's initialization for ``seed``, dropout 0, in
    ``dtype`` on ``device``."""
    model = VGGWithLSTMClassifier(NUM_CLASSES, version=version, dropout_rate=0.0)
    trainer = Trainer(model, TrainerConfig(
        model_name="drift", num_classes=NUM_CLASSES, batch_size=batch_size, learning_rate=lr,
        weight_decay=1e-4, seed=seed, host_prefetch=0,
        metrics_dir=os.path.join(workdir, "metrics"), checkpoints_dir=os.path.join(workdir, "ckpt"),
    ), device=device)
    trainer.init_state()
    if dtype != torch.float32:  # the same initial weights, widened
        model.to(dtype)
        model.dtype = trainer.compute_dtype = dtype
        trainer.optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                             weight_decay=1e-4)
    losses: List[float] = []
    for inputs, labels, weights in trainer.batches(ds, True, np.random.default_rng(seed)):
        loss_sum, _, _, wsum = trainer.train_step(tuple(x.to(dtype) for x in inputs), labels, weights).tolist()
        losses.append(loss_sum / wsum)
        if len(losses) == steps:
            break
    return losses


def drift_table(ds: ArrayDataset, lrs: Sequence[float], steps: int, seed: int, workdir: str,
                cpu: bool = True) -> List[dict]:
    rows = []
    for lr in lrs:
        ref = np.asarray(first_steps(ds, "cuda", torch.float64, lr, steps, seed, workdir))
        card = np.asarray(first_steps(ds, "cuda", torch.float32, lr, steps, seed, workdir))
        row = {"lr": lr, "card_f64": ref, "card_f32": card, "card_vs_f64": np.abs(card / ref - 1)}
        if cpu:
            row["cpu_f32"] = np.asarray(first_steps(ds, "cpu", torch.float32, lr, steps, seed, workdir))
            row["cpu_vs_f64"] = np.abs(row["cpu_f32"] / ref - 1)
            row["card_vs_cpu"] = np.abs(card / row["cpu_f32"] - 1)
        rows.append(row)
    return rows


def main(argv=None) -> None:
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
    from multimodal_lipread_torch.pipelines.common import load_audio_datasets

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--lrs", type=float, nargs="+", default=[5e-4, 3e-5, 1e-5])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--no-cpu", action="store_true", help="card runs only (float32 against float64)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_drift needs a card (its reference runs in float64 on it)")
    fmt = lambda a: "[" + ", ".join(f"{v:.3e}" for v in a) + "]"  # noqa: E731
    tmp = tempfile.mkdtemp(prefix="mlt_train_drift_")
    try:
        for k, seed in enumerate(args.seeds):  # a seed given twice reads the card's run-to-run spread
            root = make_synthetic_glips(os.path.join(tmp, f"GLips_4_{k}"), clips_per_split=68, seed=seed)
            ds = load_audio_datasets(root, splits=("train",), device="cuda")[0]["train"]
            print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; seed {seed}; {len(ds)} clips, "
                  f"batch 32", flush=True)
            for r in drift_table(ds, args.lrs, args.steps, seed, tmp, cpu=not args.no_cpu):
                line = (f"lr {r['lr']:g}: card float64 losses {fmt(r['card_f64'])}; relative to it: card float32 "
                        f"{fmt(r['card_vs_f64'])}")
                if "cpu_f32" in r:
                    line += f", CPU float32 {fmt(r['cpu_vs_f64'])}; card vs CPU {fmt(r['card_vs_cpu'])}"
                print(line, flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
