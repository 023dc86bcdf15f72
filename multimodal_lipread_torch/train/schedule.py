"""ReduceLROnPlateau with the JAX package's semantics (a copy of its
``train/schedule.py``).

Relative threshold 1e-4 (``threshold_mode='rel'``), ``num_bad_epochs``
reset on improvement, cooldown 0, optional ``min_lr``. It runs on the host
between epochs; the trainer writes the LR into the optimizer's
``param_groups``. ``torch.optim.lr_scheduler.ReduceLROnPlateau`` is not
used: it skips a reduction smaller than its ``eps``, and it owns the
optimizer's LR, where the warmup ramp multiplies on top of this one.
"""

from __future__ import annotations


class ReduceLROnPlateau:
    def __init__(
        self,
        initial_lr: float,
        mode: str = "min",
        factor: float = 0.5,
        patience: int = 5,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', not {mode!r}")
        self.lr = float(initial_lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best: float | None = None
        self.num_bad_epochs = 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        """Record one epoch's metric; returns the (possibly reduced) LR."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr
