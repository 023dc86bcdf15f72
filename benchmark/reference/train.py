"""Plain training steps: the weighted cross entropy
Σ(ce · w) / max(Σw, 1e-9), the gradient by autograd, and Adam (β 0.9,
0.999, ε 1e-8) with coupled L2 (``wd · p`` added to the gradient before the
moments), on a parameter dict. BatchNorm statistics are not parameters and
get no update here (training normalizes with the batch's own)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

BETAS = (0.9, 0.999)
EPS = 1e-8


def train_steps(module, cfg: dict, params: Dict[str, torch.Tensor], trainable: Sequence[str],
                batches: List[tuple], lr: float, weight_decay: float, generator,
                adam: Optional[dict] = None) -> dict:
    """Run ``len(batches)`` steps from ``params`` (left untouched); each
    batch is ``(inputs, labels, weights)``. ``adam`` (``exp_avg`` and
    ``exp_avg_sq`` per trainable leaf, and the ``step`` count) continues an
    Adam that has taken steps; without it Adam starts fresh. Returns each
    step's loss, per trainable leaf the norm of the first step's gradient
    as Adam takes it (with the decay) and of the loss gradient alone, the
    norm of each leaf's change over all the steps, and the ``state`` the
    steps end in (``params`` and ``adam``)."""
    p = {n: t.detach().clone() for n, t in params.items()}
    for n in trainable:
        p[n].requires_grad_(True)
    m = {n: adam["exp_avg"][n].clone() if adam else torch.zeros_like(p[n]) for n in trainable}
    v = {n: adam["exp_avg_sq"][n].clone() if adam else torch.zeros_like(p[n]) for n in trainable}
    first = (adam["step"] if adam else 0) + 1
    losses, grad_norms, raw_norms = [], None, None
    b1, b2 = BETAS
    for step, (inputs, labels, weights) in enumerate(batches, start=first):
        logits = module.forward(p, cfg, inputs, True, generator).float()
        ce = F.cross_entropy(logits, labels, reduction="none")
        loss = (ce * weights).sum() / weights.sum().clamp_min(1e-9)
        grads = torch.autograd.grad(loss, [p[n] for n in trainable])
        losses.append(loss.detach())
        with torch.no_grad():
            full = [g + weight_decay * p[n] for n, g in zip(trainable, grads)]
            if step == first:
                grad_norms = torch.stack([g.norm() for g in full])
                raw_norms = torch.stack([g.norm() for g in grads])
            for n, g in zip(trainable, full):
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[n] / (1 - b1 ** step)
                v_hat = v[n] / (1 - b2 ** step)
                p[n].sub_(lr * m_hat / (v_hat.sqrt() + EPS))
    with torch.no_grad():
        deltas = torch.stack([(p[n] - params[n]).norm() for n in trainable])
    state = {"params": {n: t.detach() for n, t in p.items()},
             "adam": {"exp_avg": m, "exp_avg_sq": v, "step": first - 1 + len(batches)}}
    return {"losses": torch.stack(losses).tolist(), "grad_norms": grad_norms.tolist(),
            "raw_grad_norms": raw_norms.tolist(), "delta_norms": deltas.tolist(), "state": state}
