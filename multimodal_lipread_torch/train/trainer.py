"""The trainer of the PyTorch port (counterpart of the JAX package's
``train/trainer.py``), with the JAX package's semantics kept exactly:

- Adam with coupled L2 weight decay on every parameter (the decay is added
  to the gradient before the moments: ``torch.optim.Adam(weight_decay=)``
  is optax's ``add_decayed_weights`` → ``scale_by_adam``);
- cross entropy on float32 logits, weighted per example by
  ``weights × class_weights[label]`` and divided by ``max(Σw, 1e-9)``;
  accuracy counts ``weights`` only;
- fixed-size batches: one permutation per epoch from a single
  ``np.random.default_rng(seed)`` for the whole fit, evaluation unshuffled,
  and a short last batch padded with real examples at weight 0 (BatchNorm
  sees them, loss and accuracy do not);
- exact per-example epoch means (Σ loss·w / Σ w, 100 · correct / Σ weights),
  accumulated on the device and fetched once per epoch;
- ReduceLROnPlateau on the val loss or accuracy, an optional per-step
  warmup ramp on top of it or ``lr_schedule: linear_warmup``; the LR is
  written into the optimizer's ``param_groups`` between steps;
- per-epoch CSV + TXT logs, best-val-accuracy checkpoint, optional rolling
  checkpoint and exact resume (state, plateau state, running best, the
  data RNG fast-forwarded one permutation per completed epoch, the dropout
  generator), and the final test on the reloaded best checkpoint.

``frozen_param_prefixes`` freezes parameter subtrees as the JAX trainer
does: a JAX path prefix such as ``("video_encoder", "cnn")`` names the
``state_dict`` prefix ``video_encoder.cnn.``; its parameters are left out of
Adam (a literal zero update, weight decay included, and no moments in the
optimizer's state or the checkpoint) and compute no gradient. BatchNorm
running statistics under it are buffers, not parameters: they still move
whenever the module runs in train mode, as the JAX ``batch_stats`` do.
``set_apply_kwargs`` adds keyword arguments to every forward (e.g.
``cached_features=True`` after ``train/frozen_cache.py``).

Parameters are redrawn with Flax's default initializers from ``seed``
(``nn.common.flax_init_``); dropout masks come from a ``torch.Generator``
seeded with ``seed + 1`` on the trainer's device (the JAX package's ``rbg``
keys have no torch counterpart, so trajectories match the JAX trainer's
only with dropout off). A float32 model trains without TF32
(``utils/precision.py``).

Not ported yet (ROADMAP.md, Queue 1 #5): the knobs in ``UNPORTED_KNOBS``
raise ``NotImplementedError`` when set; multi-host runs and preemption
handling. The trainer runs on ``device`` ("cuda" unless the caller asks for
the CPU).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_lipread_torch.nn.common import Dropout, flax_init_
from multimodal_lipread_torch.train.checkpoint import (
    load_checkpoint,
    load_module_state,
    module_state,
    save_checkpoint,
)
from multimodal_lipread_torch.train.schedule import ReduceLROnPlateau
from multimodal_lipread_torch.utils.metrics_log import MetricLogger
from multimodal_lipread_torch.utils.precision import compute_dtype, model_precision


@dataclasses.dataclass
class ArrayDataset:
    """A fully materialized dataset: a tuple of input arrays and integer
    labels, all with the examples on the leading axis."""

    inputs: Tuple[np.ndarray, ...]
    labels: np.ndarray

    def __post_init__(self):
        n = len(self.labels)
        for a in self.inputs:
            if a.shape[0] != n:
                raise ValueError(f"input leading dim {a.shape[0]} != {n}")

    def __len__(self) -> int:
        return len(self.labels)


@dataclasses.dataclass
class TrainerConfig:
    model_name: str
    num_classes: int
    batch_size: int = 32
    epochs: int = 10
    learning_rate: float = 5e-4
    weight_decay: float = 1e-4
    scheduler_mode: str = "min"  # 'min' → val loss, 'max' → val acc
    scheduler_factor: float = 0.5
    scheduler_patience: int = 5
    min_lr: float = 0.0
    # 'plateau' (ReduceLROnPlateau per epoch) or 'linear_warmup' (per step:
    # 0 → lr over warmup_proportion of all steps, then linearly to 0)
    lr_schedule: str = "plateau"
    warmup_proportion: float = 0.1
    # per-step ramp lr = plateau lr * min(1, (step + 1) / warmup_steps) over
    # the first warmup_epochs epochs; 0 disables; ignored by linear_warmup
    warmup_epochs: float = 0.0
    seed: int = 0
    metrics_dir: str = "metrics"
    checkpoints_dir: str = "models_trained"
    log_columns: str = "full"  # 'full' or 'train_val'
    log_txt_header: bool = False
    test_every_epoch: bool = True
    rolling_checkpoint: bool = False
    class_weights: Optional[np.ndarray] = None
    half_precision: bool = False  # cast float inputs to bf16 before the model
    # batches prepared (gathered, pinned) this many ahead in a side thread;
    # the batch order is unchanged. 0 prepares them inline.
    host_prefetch: int = 2
    # the single-file checkpoint ('msgpack' in the JAX package; torch.save
    # here). The orbax backends are not ported.
    checkpoint_backend: str = "msgpack"
    # parameter subtrees (JAX path prefixes) that get no update
    frozen_param_prefixes: Tuple[Tuple[str, ...], ...] = ()
    # not ported yet: each raises NotImplementedError when set (UNPORTED_KNOBS)
    profile_dir: Optional[str] = None
    mixup_alpha: float = 0.0
    remat: bool = False
    device_resident: bool = False
    steps_per_dispatch: int = 1
    handle_preemption: bool = False
    param_partition_rules: Tuple[Any, ...] = ()
    device_preproc: Optional[Callable[..., tuple]] = None


# TrainerConfig knobs of the JAX trainer that the port does not run yet,
# with the value that leaves them off
UNPORTED_KNOBS: Dict[str, Any] = {
    "profile_dir": None,
    "mixup_alpha": 0.0,
    "remat": False,
    "device_resident": False,
    "steps_per_dispatch": 1,
    "handle_preemption": False,
    "param_partition_rules": (),
    "device_preproc": None,
    "checkpoint_backend": "msgpack",
}


def check_ported(config: TrainerConfig) -> None:
    """Raise for every knob that is set but not ported."""
    for name, off in UNPORTED_KNOBS.items():
        value = getattr(config, name)
        if value is not off and value != off:
            raise NotImplementedError(
                f"TrainerConfig.{name}={value!r} is not ported to PyTorch yet "
                "(ROADMAP.md, Queue 1)"
            )


@dataclasses.dataclass
class EpochMetrics:
    loss: float
    acc: float  # percent, like the reference logs


class _Metrics:
    """Sums of (Σ loss·w, correct, Σ weights, Σ w) over an epoch's batches,
    kept on the device in float64 and read once."""

    def __init__(self, device: torch.device):
        self.sums = torch.zeros(4, dtype=torch.float64, device=device)

    def push(self, stats: torch.Tensor) -> None:
        self.sums += stats.double()

    def result(self) -> EpochMetrics:
        loss_sum, correct, count, wsum = self.sums.tolist()
        return EpochMetrics(loss=loss_sum / max(wsum, 1e-9), acc=100.0 * correct / max(count, 1))


def _host_prefetch_iter(it: Iterator, depth: int) -> Iterator:
    """Drain ``it`` from a daemon thread, ``depth`` items ahead, in order.

    Producer exceptions re-raise in the consumer; a consumer that stops
    early stops the producer."""
    if depth <= 0:
        yield from it
        return
    import queue as queue_mod
    import threading

    q: Any = queue_mod.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue_mod.Full:
                continue
        return False

    def _produce():
        try:
            for item in it:
                if not _put(item):
                    return
            tail: Any = end
        except BaseException as e:  # noqa: BLE001 — delivered to the consumer
            tail = e
        _put(tail)

    t = threading.Thread(target=_produce, name="mlt-host-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)


class Trainer:
    """Single-device trainer (``device`` "cuda" unless the caller asks for
    the CPU)."""

    def __init__(self, model: nn.Module, config: TrainerConfig, device: str = "cuda"):
        check_ported(config)
        self.config = config
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.batch_size = config.batch_size
        self.compute_dtype = compute_dtype(model)
        self.optimizer: Optional[torch.optim.Adam] = None
        self.step = 0  # optimizer steps taken
        self.scheduler = ReduceLROnPlateau(
            config.learning_rate,
            mode=config.scheduler_mode,
            factor=config.scheduler_factor,
            patience=config.scheduler_patience,
            min_lr=config.min_lr,
        )
        self.logger = MetricLogger(config.metrics_dir, config.model_name,
                                   columns=config.log_columns, txt_header=config.log_txt_header)
        cw = config.class_weights
        self._class_weights = (
            None if cw is None else torch.as_tensor(np.asarray(cw, np.float32), device=self.device)
        )
        self.dropout_generator = torch.Generator(device=self.device)
        self.dropout_generator.manual_seed(config.seed + 1)
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = self.dropout_generator
        # per-step LR function, built in fit() once the step count is known
        self._lr_step_fn: Optional[Callable[[int], float]] = None
        # keyword arguments every forward receives (set_apply_kwargs)
        self._apply_kwargs: Dict[str, Any] = {}

    # ------------------------------------------------------------ setup

    def frozen_names(self) -> List[str]:
        """The parameters under ``frozen_param_prefixes``, by ``state_dict``
        name; a prefix that names no parameter raises."""
        names = [n for n, _ in self.model.named_parameters()]
        frozen = []
        for path in self.config.frozen_param_prefixes:
            prefix = ".".join(path) + "."
            hit = [n for n in names if n.startswith(prefix)]
            if not hit:
                raise ValueError(f"frozen_param_prefixes entry {tuple(path)} names no parameter of the model")
            frozen += hit
        return sorted(set(frozen))

    def trainable_parameters(self) -> List[nn.Parameter]:
        """The parameters Adam updates (all but the frozen ones), in
        registration order; the frozen ones stop asking for gradients."""
        frozen = set(self.frozen_names())
        for name, p in self.model.named_parameters():
            if name in frozen:
                p.requires_grad_(False)
        return [p for n, p in self.model.named_parameters() if n not in frozen]

    def init_state(self) -> nn.Module:
        """Redraw the parameters with Flax's initializers from ``seed`` and
        start a fresh Adam; returns the model."""
        flax_init_(self.model, torch.Generator().manual_seed(self.config.seed))
        self.optimizer = torch.optim.Adam(
            self.trainable_parameters(), lr=self.config.learning_rate,
            betas=(0.9, 0.999), eps=1e-8, weight_decay=self.config.weight_decay,
        )
        self.step = 0
        return self.model

    def ensure_initialized(self) -> None:
        if self.optimizer is None:
            self.init_state()

    def set_apply_kwargs(self, **kwargs) -> None:
        """Keyword arguments every forward receives from now on, in training
        and evaluation (e.g. ``cached_features=True``). Set them before the
        first step: the JAX trainer raises once its steps are compiled, and
        so does this one once a step has run."""
        if self.step:
            raise RuntimeError("set_apply_kwargs after training steps ran: the change would apply midway")
        self._apply_kwargs.update(kwargs)

    def _set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)

    # ------------------------------------------------------------ steps

    def _prepare(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 inputs are scaled to [0, 1] and int16 waveforms cast on the
        device; ``half_precision`` casts float inputs to bf16."""
        dtype = torch.bfloat16 if self.config.half_precision else torch.float32
        if x.dtype == torch.uint8:
            return x.to(dtype) / 255.0
        if x.dtype == torch.int16 or (self.config.half_precision and x.is_floating_point()):
            return x.to(dtype)
        return x

    def _example_weights(self, labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        return weights if self._class_weights is None else weights * self._class_weights[labels]

    def train_step(self, inputs: Sequence[torch.Tensor], labels: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
        """One optimizer step on a device batch. Returns the device tensor
        (Σ loss·w, correct, Σ weights, Σ w); nothing is read back."""
        self.model.train()
        with model_precision(self.compute_dtype):
            logits = self.model(*(self._prepare(x) for x in inputs), **self._apply_kwargs).float()
            w = self._example_weights(labels, weights)
            wsum = w.sum()
            loss = (F.cross_entropy(logits, labels, reduction="none") * w).sum() / wsum.clamp_min(1e-9)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        self.optimizer.step()
        self.step += 1
        with torch.no_grad():
            correct = ((logits.argmax(-1) == labels).float() * weights).sum()
            return torch.stack([loss.detach() * wsum, correct, weights.sum(), wsum])

    @torch.no_grad()
    def eval_step(self, inputs: Sequence[torch.Tensor], labels: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
        """Forward in eval mode (running BatchNorm statistics); returns the
        device tensor (Σ loss·w, correct, Σ weights, Σ w)."""
        self.model.eval()
        with model_precision(self.compute_dtype):
            logits = self.model(*(self._prepare(x) for x in inputs), **self._apply_kwargs).float()
        w = self._example_weights(labels, weights)
        ce = F.cross_entropy(logits, labels, reduction="none")
        correct = ((logits.argmax(-1) == labels).float() * weights).sum()
        return torch.stack([(ce * w).sum(), correct, weights.sum(), w.sum()])

    # ------------------------------------------------------------ batching

    def host_batches(self, ds: ArrayDataset, shuffle: bool, rng: np.random.Generator):
        """Yield fixed-size numpy batches ``(inputs, labels, weights)``; a
        short last batch is padded with real examples at weight 0."""
        n = len(ds)
        order = rng.permutation(n) if shuffle else np.arange(n)
        bs = self.batch_size
        for start in range(0, n, bs):
            idx = order[start : start + bs]
            k = len(idx)
            weights = np.zeros((bs,), np.float32)
            weights[:k] = 1.0
            if k < bs:
                fill = order[: bs - k] if n >= bs else np.resize(order, bs - k)
                idx = np.concatenate([idx, fill.astype(idx.dtype)])
            yield tuple(a[idx] for a in ds.inputs), ds.labels[idx].astype(np.int64), weights

    def batches(self, ds: ArrayDataset, shuffle: bool, rng: np.random.Generator):
        """``host_batches`` on the device: gathered (and pinned, for a card)
        ``host_prefetch`` batches ahead, copied without blocking."""
        pin = self.device.type == "cuda"

        def host():
            for inputs, labels, weights in self.host_batches(ds, shuffle, rng):
                ts = [torch.from_numpy(a) for a in (*inputs, labels, weights)]
                yield [t.pin_memory() for t in ts] if pin else ts

        for ts in _host_prefetch_iter(host(), self.config.host_prefetch):
            ts = [t.to(self.device, non_blocking=True) for t in ts]
            yield tuple(ts[:-2]), ts[-2], ts[-1]

    # ------------------------------------------------------------ epochs

    def train_single_batch(self, ds: ArrayDataset, seed: int = 0) -> float:
        """One optimizer step on the first (unshuffled) batch of ``ds``;
        returns its loss."""
        self.ensure_initialized()
        self.dropout_generator.manual_seed(seed)
        inputs, labels, weights = next(self.batches(ds, False, np.random.default_rng(seed)))
        loss_sum, _correct, _n, wsum = self.train_step(inputs, labels, weights).tolist()
        return loss_sum / max(wsum, 1e-9)

    def train_epoch(self, ds: ArrayDataset, rng: np.random.Generator) -> EpochMetrics:
        acc = _Metrics(self.device)
        for inputs, labels, weights in self.batches(ds, True, rng):
            if self._lr_step_fn is not None:
                self._set_lr(self._lr_step_fn(self.step))
            acc.push(self.train_step(inputs, labels, weights))
        return acc.result()

    def evaluate(self, ds: ArrayDataset) -> EpochMetrics:
        acc = _Metrics(self.device)
        for inputs, labels, weights in self.batches(ds, False, np.random.default_rng(0)):
            acc.push(self.eval_step(inputs, labels, weights))
        return acc.result()

    # ------------------------------------------------------------ checkpoints

    def _ckpt_path(self, kind: str) -> str:
        os.makedirs(self.config.checkpoints_dir, exist_ok=True)
        return os.path.join(self.config.checkpoints_dir, f"{self.config.model_name}_{kind}.pt")

    def checkpoint_tree(self, epoch: int, val_acc: float, best_val_acc: float) -> Dict[str, Any]:
        s = self.scheduler
        return {
            "epoch": epoch,
            "state": {**module_state(self.model), "opt_state": self.optimizer.state_dict(),
                      "step": self.step},
            "val_acc": float(val_acc),
            "scheduler_lr": float(s.lr),
            "scheduler_best": float(s.best if s.best is not None else 0.0),
            "scheduler_has_best": s.best is not None,
            "scheduler_bad_epochs": int(s.num_bad_epochs),
            "best_val_acc": float(best_val_acc),
            "dropout_rng": self.dropout_generator.get_state(),
        }

    def restore_state(self, state: Dict[str, Any]) -> None:
        """Load ``{params, batch_stats, opt_state, step}`` into the model and
        the optimizer."""
        self.ensure_initialized()
        load_module_state(self.model, state)
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])

    @contextlib.contextmanager
    def _weights_of(self, state: Dict[str, Any]):
        """The model holds ``state``'s parameters and buffers inside the
        block and its own again after it."""
        own = {k: v.clone() for k, v in self.model.state_dict().items()}
        load_module_state(self.model, state)
        try:
            yield
        finally:
            self.model.load_state_dict(own)

    # ------------------------------------------------------------ fit

    def _build_lr_schedule(self, train_ds: ArrayDataset) -> None:
        cfg = self.config
        steps_per_epoch = max(1, -(-len(train_ds) // self.batch_size))
        if cfg.lr_schedule == "linear_warmup":
            # per step, after the step count: the first step trains at lr 0
            total = steps_per_epoch * cfg.epochs
            warmup = int(cfg.warmup_proportion * total)
            base_lr = cfg.learning_rate

            def lr_at(step, _w=warmup, _t=total, _lr=base_lr):
                if step < _w:
                    return _lr * step / max(1, _w)
                return _lr * max(0.0, (_t - step) / max(1, _t - _w))

            self._lr_step_fn = lr_at
        elif cfg.warmup_epochs > 0:
            # reads the live plateau LR, so reductions still apply
            warmup_steps = max(1, int(round(cfg.warmup_epochs * steps_per_epoch)))

            def plateau_warmup_lr(step, _w=warmup_steps):
                return self.scheduler.lr * min(1.0, (step + 1) / _w)

            self._lr_step_fn = plateau_warmup_lr
        else:
            self._lr_step_fn = None

    def fit(
        self,
        train_ds: ArrayDataset,
        val_ds: ArrayDataset,
        test_ds: Optional[ArrayDataset] = None,
        resume: bool = False,
        progress: Optional[Callable[[str], None]] = print,
    ) -> Dict[str, Any]:
        """Full training run; returns the history and the final
        (best-checkpoint) test metrics."""
        cfg = self.config
        self.ensure_initialized()
        self._build_lr_schedule(train_ds)
        self.dropout_generator.manual_seed(cfg.seed + 1)
        start_epoch = 1
        best_val_acc = -1.0
        rolling_path = self._ckpt_path("checkpoint")
        best_path = self._ckpt_path("best")
        if resume and os.path.exists(rolling_path):
            ckpt = load_checkpoint(rolling_path)
            self.restore_state(ckpt["state"])
            start_epoch = int(ckpt["epoch"]) + 1
            self.scheduler.lr = float(ckpt["scheduler_lr"])
            self.scheduler.best = (
                float(ckpt["scheduler_best"]) if bool(ckpt["scheduler_has_best"]) else None
            )
            self.scheduler.num_bad_epochs = int(ckpt["scheduler_bad_epochs"])
            # the rolling checkpoint's val_acc is the last epoch's, not the best
            best_val_acc = float(ckpt["best_val_acc"])
            self.dropout_generator.set_state(ckpt["dropout_rng"])
            self._set_lr(self.scheduler.lr)
            if progress:
                progress(f"Resumed from {rolling_path} at epoch {start_epoch}")

        data_rng = np.random.default_rng(cfg.seed)
        # each completed epoch drew one permutation: skip them on resume
        for _ in range(start_epoch - 1):
            data_rng.permutation(len(train_ds))
        history: List[Dict[str, float]] = []
        for epoch in range(start_epoch, cfg.epochs + 1):
            t0 = time.time()
            tr = self.train_epoch(train_ds, data_rng)
            va = self.evaluate(val_ds)
            if cfg.lr_schedule == "plateau":
                metric = va.loss if cfg.scheduler_mode == "min" else va.acc
                new_lr = self.scheduler.step(metric)
                if self._lr_step_fn is None:
                    self._set_lr(new_lr)
                else:  # the warmup ramp reads the new plateau LR next step
                    new_lr = self._lr_step_fn(self.step)
            else:
                new_lr = self._lr_step_fn(self.step)
            te = self.evaluate(test_ds) if (test_ds is not None and cfg.test_every_epoch) else None
            self.logger.log_epoch(
                epoch, tr.loss, tr.acc, va.loss, va.acc,
                te.loss if te else None, te.acc if te else None,
            )
            seconds = time.time() - t0
            history.append(
                {
                    "epoch": epoch, "train_loss": tr.loss, "train_acc": tr.acc,
                    "val_loss": va.loss, "val_acc": va.acc,
                    **({"test_loss": te.loss, "test_acc": te.acc} if te else {}),
                    "lr": new_lr, "seconds": seconds,
                    "clips_per_sec": len(train_ds) / max(seconds, 1e-9),
                }
            )
            if progress:
                msg = (
                    f"Epoch {epoch}/{cfg.epochs} "
                    f"train {tr.loss:.4f}/{tr.acc:.2f}% val {va.loss:.4f}/{va.acc:.2f}%"
                )
                if te:
                    msg += f" test {te.loss:.4f}/{te.acc:.2f}%"
                progress(msg + f" lr {new_lr:.2e} ({seconds:.1f}s)")

            is_best = va.acc > best_val_acc
            if is_best:
                best_val_acc = va.acc
            if is_best or cfg.rolling_checkpoint:
                # params + Adam moments, ~3x the model: written only when needed
                ckpt = self.checkpoint_tree(epoch, va.acc, best_val_acc)
                if is_best:
                    save_checkpoint(best_path, ckpt)
                if cfg.rolling_checkpoint:
                    save_checkpoint(rolling_path, ckpt)

        result: Dict[str, Any] = {"history": history, "best_val_acc": best_val_acc}
        if test_ds is not None and os.path.exists(best_path):
            with self._weights_of(load_checkpoint(best_path)["state"]):
                final = self.evaluate(test_ds)
            self.logger.log_final(final.loss, final.acc)
            result["final_test_loss"] = final.loss
            result["final_test_acc"] = final.acc
            result["best_checkpoint"] = best_path
            if progress:
                progress(f"Final Test Loss: {final.loss:.4f}, Final Test Acc: {final.acc:.2f}%")
        return result
