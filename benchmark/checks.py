"""The numbers that decide ``correct``, each beside its limit.

Training compares two runs of three steps with the reference: the first
three of set-up, which drives the trainer from the seed's weights and a
fresh Adam through the window's own call and feed (``loss_gap``,
``grad_gap``, ``delta_gap``), and the first three of the window, from the
parameters, Adam's moments and step count and the dropout generator as the
window found them (``window_loss_gap``, ``window_grad_gap``,
``window_delta_gap``):

- ``rows_wrong``: rows of the checked batches, and of the first batch of
  every epoch the window begins, that are no clip of the corpus whole, whose
  label is not the clip's, or that repeat a clip within a checked run
  (limit 0);
- ``loss_gap``: |program − reference| / |reference| of the run's first loss;
- ``grad_gap``: the first step's gradient as Adam took it (from its first
  moment before and after the step), by the worst leaf: |‖g‖ − ‖g_ref‖| /
  max(‖g_ref‖, the median leaf's ‖g_ref‖);
- ``delta_gap``: each leaf's change over the three steps, |‖Δ‖ − ‖Δ_ref‖|
  / ‖Δ_ref‖, by the median leaf.

A run's second and third steps are compared through the change alone, and
by its median leaf: float32 Adam from these weights is chaotic. Its first
step moves every element by about ±lr whatever the gradient's size, so the
elements whose gradient round-off can flip send the trajectories apart: a
change of the weights by 1e-7 of themselves moves step 3's loss by 0.7 %
and the worst leaf's change by 4 to 6 % in the reference alone. Those two
are printed (``loss_gap_steps_2_3``, ``delta_gap_worst``) and not judged.

Leaves whose loss gradient in the reference is under a thousandth of the
median leaf's (a bias before a BatchNorm, which the normalization cancels)
have a gradient of round-off alone and move under Adam by it: they are
left out of both gaps.

Serving: ``logit_gap``, the largest |program − reference| logit of a
sample of the answered requests over the root mean square of the
reference's logits, and ``answers_wrong``, sampled answers of the wrong
shape or not finite (limit 0)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

EXCLUDE_BELOW = 1e-3


def leaf_gaps(program: Sequence[float], reference: Sequence[float], include: Sequence[bool]) -> np.ndarray:
    """Per leaf |‖p‖ − ‖r‖| / max(‖r‖, the median leaf's ‖r‖); NaN where left out."""
    keep = np.asarray(include)
    prog, ref = np.asarray(program, np.float64), np.asarray(reference, np.float64)
    floor = np.maximum(ref, np.median(ref[keep]) if keep.any() else 0.0)
    gaps = np.abs(prog - ref) / np.where(floor > 0, floor, 1.0)
    return np.where(keep, gaps, np.nan)


def leaf_gap(program: Sequence[float], reference: Sequence[float], include: Sequence[bool]) -> float:
    gaps = leaf_gaps(program, reference, include)
    return float(np.nanmax(gaps)) if np.isfinite(gaps).any() else float("inf")


def included(raw_reference_grads: Sequence[float]) -> List[bool]:
    raw = np.asarray(raw_reference_grads, np.float64)
    return list(raw >= EXCLUDE_BELOW * np.median(raw))


def median_leaf_gap(program: Sequence[float], reference: Sequence[float], include: Sequence[bool]) -> float:
    prog = np.asarray(program, np.float64)[np.asarray(include)]
    ref = np.asarray(reference, np.float64)[np.asarray(include)]
    if not ref.size or np.any(ref <= 0):
        return float("inf")
    return float(np.median(np.abs(prog - ref) / ref))


def train_numbers(program: dict, reference: dict, names: Sequence[str] = (), prefix: str = "") -> tuple:
    """(judged numbers, printed-only numbers) of one run of steps, each name
    after ``prefix``; ``names`` label the leaves."""
    keep = included(reference["raw_grad_norms"])
    losses = np.abs(np.asarray(program["losses"], np.float64) - reference["losses"]) / np.abs(reference["losses"])
    judged = {
        prefix + "loss_gap": float(losses[0]),
        prefix + "grad_gap": leaf_gap(program["grad_norms"], reference["grad_norms"], keep),
        prefix + "delta_gap": median_leaf_gap(program["delta_norms"], reference["delta_norms"], keep),
    }
    printed = {"loss_gap_steps_2_3": float(np.max(losses[1:])) if len(losses) > 1 else 0.0,
               "delta_gap_worst": leaf_gap(program["delta_norms"], reference["delta_norms"], keep)}
    if names:
        grads = np.nan_to_num(leaf_gaps(program["grad_norms"], reference["grad_norms"], keep), nan=-1.0)
        printed["worst_leaves"] = [(names[i], float(grads[i])) for i in np.argsort(-grads)[:3]]
        printed["left_out"] = [n for n, k in zip(names, keep) if not k]
    return judged, printed


def serve_numbers(program: List[np.ndarray], reference: List[np.ndarray]) -> Dict[str, float]:
    wrong = sum(1 for p, r in zip(program, reference)
                if p is None or p.shape != r.shape or not np.all(np.isfinite(p)))
    good = [(p, r) for p, r in zip(program, reference) if p is not None and p.shape == r.shape]
    ref = np.concatenate([r for _p, r in good]).astype(np.float64) if good else np.zeros(1)
    diff = max((float(np.max(np.abs(p.astype(np.float64) - r))) for p, r in good), default=float("inf"))
    rms = float(np.sqrt(np.mean(ref ** 2)))
    return {"answers_wrong": float(wrong), "logit_gap": diff / rms if rms > 0 else float("inf")}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number with no limit, or one that is not finite, fails."""
    rows, ok = [], True
    for name, value in numbers.items():
        limit = limits.get(name)
        passed = limit is not None and np.isfinite(value) and value <= limit
        ok = ok and passed
        rows.append((name, value, limit))
    return ok, rows
