"""Epoch metric logs in the reference's CSV and TXT formats (a copy of the
JAX package's ``utils/metrics_log.py``).

The 7-column CSV (``columns="full"``) or its train/val-only variant
(``columns="train_val"``), the human-readable TXT log with its
``Final Test`` footer, and optionally the "Training Log" banner.
"""

from __future__ import annotations

import csv
import os
from typing import Optional


class MetricLogger:
    """CSV + TXT epoch logger for one model run.

    Files are ``<metrics_dir>/<model_name>_training_log.{csv,txt}``.
    """

    FULL_HEADER = ["epoch", "train_loss", "train_acc", "val_loss", "val_acc", "test_loss", "test_acc"]
    TRAIN_VAL_HEADER = ["epoch", "train_loss", "train_acc", "val_loss", "val_acc"]

    def __init__(self, metrics_dir: str, model_name: str, columns: str = "full",
                 txt_header: bool = False):
        if columns not in ("full", "train_val"):
            raise ValueError(f"columns must be 'full' or 'train_val', not {columns!r}")
        self.columns = columns
        self.metrics_dir = metrics_dir
        self.model_name = model_name
        self.txt_header = txt_header
        os.makedirs(metrics_dir, exist_ok=True)
        self.csv_path = os.path.join(metrics_dir, f"{model_name}_training_log.csv")
        self.txt_path = os.path.join(metrics_dir, f"{model_name}_training_log.txt")
        self._init_files()

    def _init_files(self) -> None:
        if not os.path.exists(self.csv_path):
            with open(self.csv_path, "w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(self.FULL_HEADER if self.columns == "full" else self.TRAIN_VAL_HEADER)
        if self.txt_header and not os.path.exists(self.txt_path):
            with open(self.txt_path, "w") as f:
                f.write("Training Log\n\n")

    def log_epoch(
        self,
        epoch: int,
        train_loss: float,
        train_acc: float,
        val_loss: float,
        val_acc: float,
        test_loss: Optional[float] = None,
        test_acc: Optional[float] = None,
    ) -> None:
        with open(self.csv_path, "a", newline="") as f:
            writer = csv.writer(f)
            row = [epoch, train_loss, train_acc, val_loss, val_acc]
            if self.columns == "full":
                row += ["" if test_loss is None else test_loss, "" if test_acc is None else test_acc]
            writer.writerow(row)

        with open(self.txt_path, "a") as f:
            f.write(
                f"Epoch {epoch}\n"
                f"  Train Loss: {train_loss:.4f}, Train Acc: {train_acc:.2f}%\n"
                f"  Val Loss:   {val_loss:.4f}, Val Acc:   {val_acc:.2f}%\n"
            )
            if self.columns == "full" and test_loss is not None and test_acc is not None:
                f.write(f"  Test Loss:  {test_loss:.4f}, Test Acc:  {test_acc:.2f}%\n")
            f.write("\n")

    def log_final(self, test_loss: float, test_acc: float) -> None:
        with open(self.txt_path, "a") as f:
            f.write(f"Final Test Loss: {test_loss:.4f}, Final Test Acc: {test_acc:.2f}%\n")
