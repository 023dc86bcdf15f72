"""Per-model loss and accuracy plots from the trainer's CSV logs
(counterpart of the JAX package's ``utils/visualize.py::plot_logs``).

matplotlib is imported inside :func:`plot_logs`, so importing this module
needs it nowhere; ``pipelines.common.maybe_plot`` reports a missing
matplotlib as "plotting skipped" and the run goes on.
"""

from __future__ import annotations

import csv
import math
import os
from typing import List, Optional


def _read_columns(path: str) -> dict:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    cols = {}
    for key in rows[0].keys() if rows else ():
        cols[key] = [float(r[key]) if r[key] != "" else math.nan for r in rows]
    return cols


def plot_logs(metrics_dir: str, plots_dir: Optional[str] = None) -> List[str]:
    """For every ``*_training_log.csv`` write ``<model>_loss.png`` and
    ``<model>_accuracy.png``. Returns the written paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

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
