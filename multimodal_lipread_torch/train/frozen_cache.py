"""Frozen-encoder features computed once per run (counterpart of the JAX
package's ``train/frozen_cache.py``).

The early and middle fusion variants of the cues_video and
audio_cues_video pipelines freeze their CNN encoders yet pay their forward
every step. Under ``frozen_bn_eval`` the frozen encoders are per-sample
deterministic (eval-mode BatchNorm on fixed weights), so their outputs can
be computed once and the trainer then runs only the trainable tail
(``Trainer.set_apply_kwargs(cached_features=True)``): the same trajectory
as the uncached ``frozen_bn_eval`` run, without the frozen forward.

Opt-in with ``training.cache_frozen_features: true`` in those two
pipelines.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from multimodal_lipread_torch.train.trainer import ArrayDataset
from multimodal_lipread_torch.utils.precision import model_precision


def compute_frozen_features(trainer, inputs: Sequence[np.ndarray], batch_size: int = 64) -> Tuple[np.ndarray, ...]:
    """The model's ``return_frozen_features=True`` forward over ``inputs``
    in eval mode without gradients, on the trainer's device, in batches of
    ``batch_size`` (the last one padded with its first row and trimmed),
    with the inputs prepared as the trainer's steps prepare them (uint8
    scaled to [0, 1], bf16 under ``half_precision``). Returns host numpy
    arrays, as a tuple even when the model returns one array."""
    model = trainer.model
    was_training = model.training
    model.eval()
    chunks = None
    try:
        with torch.no_grad(), model_precision(trainer.compute_dtype):
            for start in range(0, inputs[0].shape[0], batch_size):
                rows = [a[start : start + batch_size] for a in inputs]
                k = rows[0].shape[0]
                if k < batch_size:  # one batch shape, as the JAX extractor compiles one
                    rows = [np.concatenate([a, np.repeat(a[:1], batch_size - k, axis=0)]) for a in rows]
                xs = [trainer._prepare(torch.from_numpy(np.ascontiguousarray(a)).to(trainer.device)) for a in rows]
                out = model(*xs, return_frozen_features=True)
                feats = [f[:k].float().cpu().numpy() for f in (out if isinstance(out, tuple) else (out,))]
                if chunks is None:
                    chunks = [[] for _ in feats]
                for acc, f in zip(chunks, feats):
                    acc.append(f)
    finally:
        model.train(was_training)
    return tuple(np.concatenate(acc, axis=0) for acc in chunks)


def cached_dataset(
    trainer,
    ds: ArrayDataset,
    assemble: Callable[[Tuple[np.ndarray, ...], Tuple[np.ndarray, ...]], Tuple[np.ndarray, ...]],
    batch_size: int = 64,
) -> ArrayDataset:
    """``ds`` with the frozen encoders' inputs replaced by their features:
    ``assemble(raw_inputs, frozen_features)`` gives the inputs of the
    model's ``cached_features=True`` forward."""
    feats = compute_frozen_features(trainer, ds.inputs, batch_size)
    return ArrayDataset(inputs=tuple(assemble(ds.inputs, feats)), labels=ds.labels)
