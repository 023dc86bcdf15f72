"""Plots from the trainer's logs (counterpart of the JAX package's
``utils/visualize.py``): per-model loss and accuracy plots (``plot_logs``
and its CLI, ``python -m multimodal_lipread_torch.utils.visualize
--metrics-dir <dir>``), the cue classifiers' comparison bar chart
(``plot_cue_comparison``, and ``cues_compare_from_logs`` over the final
accuracies ``collect_final_accuracies`` reads from two metrics
directories), and a frame grid of a lip sequence
(``plot_lip_sequence_grid``).

matplotlib is imported inside the functions, so importing this module
needs it nowhere; ``pipelines.common.maybe_plot`` reports a missing
matplotlib as "plotting skipped" and the run goes on. The CSV logs are
read with ``csv``, not pandas.
"""

from __future__ import annotations

import csv
import math
import os
import re
from typing import Dict, List, Optional, Sequence


def _read_columns(path: str) -> dict:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    cols = {}
    for key in rows[0].keys() if rows else ():
        cols[key] = [float(r[key]) if r[key] != "" else math.nan for r in rows]
    return cols


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_logs(metrics_dir: str, plots_dir: Optional[str] = None) -> List[str]:
    """For every ``*_training_log.csv`` write ``<model>_loss.png`` and
    ``<model>_accuracy.png``. Returns the written paths."""
    plt = _pyplot()

    plots_dir = plots_dir or os.path.join(os.path.dirname(metrics_dir.rstrip("/")), "plots")
    os.makedirs(plots_dir, exist_ok=True)
    written = []
    for name in sorted(os.listdir(metrics_dir)):
        if not name.endswith("_training_log.csv"):
            continue
        model = name[: -len("_training_log.csv")]
        cols = _read_columns(os.path.join(metrics_dir, name))
        if not cols or not cols["epoch"]:
            continue
        for kind in ("loss", "acc"):
            fig, ax = plt.subplots(figsize=(8, 5))
            for split in ("train", "val", "test"):
                values = cols.get(f"{split}_{kind}")
                if values and not all(math.isnan(v) for v in values):
                    ax.plot(cols["epoch"], values, marker="o", label=split)
            ax.set_xlabel("Epoch")
            ax.set_ylabel("Loss" if kind == "loss" else "Accuracy (%)")
            ax.set_title(f"{model} {'Loss' if kind == 'loss' else 'Accuracy'}")
            ax.legend()
            ax.grid(True, alpha=0.3)
            out = os.path.join(plots_dir, f"{model}_{'loss' if kind == 'loss' else 'accuracy'}.png")
            fig.savefig(out, dpi=100, bbox_inches="tight")
            plt.close(fig)
            written.append(out)
    return written


def plot_cue_comparison(accuracies: Dict[str, Sequence[float]], out_path: str,
                        labels: Sequence[str] = ("Emotion", "Environment")) -> str:
    """Grouped bar chart of cue-classifier test accuracies (``accuracies``:
    model name → one accuracy per entry of ``labels``), written to
    ``out_path``, which is returned."""
    import numpy as np

    plt = _pyplot()
    models = list(accuracies)
    n_groups = len(labels)
    x = np.arange(len(models))
    width = 0.8 / n_groups
    fig, ax = plt.subplots(figsize=(10, 6))
    for g, label in enumerate(labels):
        ax.bar(x + g * width, [accuracies[m][g] for m in models], width, label=label)
    ax.set_xticks(x + width * (n_groups - 1) / 2)
    ax.set_xticklabels(models, rotation=20, ha="right")
    ax.set_ylabel("Test Accuracy (%)")
    ax.set_title("Cue classifier comparison")
    ax.legend()
    ax.grid(True, axis="y", alpha=0.3)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_path


def collect_final_accuracies(metrics_dir: str) -> Dict[str, float]:
    """model → final accuracy from a metrics directory: the last ``Final
    Test Acc`` of its ``<model>_training_log.txt``, else the last CSV row's
    val accuracy (the cue classifiers log train and val only)."""
    out: Dict[str, float] = {}
    for name in sorted(os.listdir(metrics_dir)):
        if not name.endswith("_training_log.txt"):
            continue
        model = name[: -len("_training_log.txt")]
        with open(os.path.join(metrics_dir, name)) as f:
            found = re.findall(r"Final Test Acc:\s*([\d.]+)%", f.read())
        if found:
            out[model] = float(found[-1])
            continue
        csv_path = os.path.join(metrics_dir, f"{model}_training_log.csv")
        if os.path.exists(csv_path):
            val_acc = _read_columns(csv_path).get("val_acc")
            if val_acc:
                out[model] = float(val_acc[-1])
    return out


def cues_compare_from_logs(emotion_metrics_dir: str, environment_metrics_dir: str, out_path: str) -> str:
    """The cue comparison chart from two metrics directories' final
    accuracies (emotion and environment cues; a model missing from one
    scores 0 there)."""
    emo = collect_final_accuracies(emotion_metrics_dir)
    env = collect_final_accuracies(environment_metrics_dir)
    models = sorted(set(emo) | set(env))
    return plot_cue_comparison({m: [emo.get(m, 0.0), env.get(m, 0.0)] for m in models}, out_path)


def plot_lip_sequence_grid(lip_sequence, out_path: str, rows: int = 3, cols: int = 10) -> str:
    """A rows × cols grid of the first frames of a (T, H, W, 3) lip
    sequence (uint8, or floats in [0, 1]) written as a PNG to ``out_path``,
    which is returned."""
    import numpy as np

    plt = _pyplot()
    seq = np.asarray(lip_sequence)
    n = min(rows * cols, seq.shape[0])
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 1.2, rows * 1.4))
    for i, ax in enumerate(np.asarray(axes).ravel()):
        ax.axis("off")
        if i < n:
            frame = seq[i]
            if frame.dtype != np.uint8:
                frame = (np.clip(frame, 0, 1) * 255).astype(np.uint8)
            ax.imshow(frame)
            ax.set_title(str(i), fontsize=6)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def main(argv=None) -> None:
    """``python -m multimodal_lipread_torch.utils.visualize --metrics-dir <dir> [--plots-dir <dir>]``."""
    import argparse

    parser = argparse.ArgumentParser(description="Plot training-log CSVs")
    parser.add_argument("--metrics-dir", required=True)
    parser.add_argument("--plots-dir")
    args = parser.parse_args(argv)
    written = plot_logs(args.metrics_dir, args.plots_dir)
    print(f"Wrote {len(written)} plots")


if __name__ == "__main__":
    main()
