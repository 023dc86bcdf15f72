"""Batch mixup (counterpart of the JAX package's ``data/augment.py``).

The reference defines a mixup transform but never wires it into training;
here, as in the JAX package, it runs inside the train step when
``training.mixup_alpha > 0`` and is off by default. The draw and the mix
are apart: :func:`draw_mixup` takes λ ~ Beta(α, α) and one permutation of
the batch from a ``torch.Generator`` on the batch's device, with no read
back to the host (so a CUDA graph can capture it); :func:`mixup` is the
pure function of the JAX package's ``mixup`` at a given λ and permutation.
Under data parallelism the batch is the global one: every rank draws the
same λ and permutation of the global rows and mixes its own rows with the
global rows the permutation points to (``pool``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def draw_mixup(generator: torch.Generator, batch: int, alpha: float,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """λ ~ Beta(α, α) as a 0-d float32 device tensor (the first share of a
    Dirichlet(α, α) draw) and a permutation of ``batch`` rows (the order of
    uniform keys), both from ``generator``."""
    concentration = torch.full((2,), float(alpha), dtype=torch.float32, device=device)
    lam = torch._sample_dirichlet(concentration, generator=generator)[0]
    perm = torch.argsort(torch.rand(batch, generator=generator, device=device))
    return lam, perm


def mixup(inputs: Sequence[torch.Tensor], labels_onehot: torch.Tensor, lam: torch.Tensor, perm: torch.Tensor,
          pool: Optional[Tuple[Sequence[torch.Tensor], torch.Tensor]] = None
          ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """The convex combination of a batch with the rows ``perm`` of ``pool``
    (``(inputs, labels_onehot)`` of the batch to draw partners from; the
    batch itself by default): every input ``x·λ + p[perm]·(1 − λ)`` (λ cast
    to the input's dtype) and the (B, C) soft labels ``y·λ + q[perm]·(1 −
    λ)``. ``perm`` holds one partner row per row of the batch."""
    pool_inputs, pool_onehot = pool if pool is not None else (inputs, labels_onehot)

    def mix(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        lam_x = lam.to(x.dtype)
        return x * lam_x + p[perm] * (1.0 - lam_x)

    return (tuple(mix(x, p) for x, p in zip(inputs, pool_inputs)),
            labels_onehot * lam + pool_onehot[perm] * (1.0 - lam))
