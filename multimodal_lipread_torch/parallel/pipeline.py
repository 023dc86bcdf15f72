"""GPipe pipeline parallelism over a ``(data, stage)`` mesh (counterpart of
the JAX package's ``parallel/pipeline.py``), for the BERT cue model's
``PipelinedBertClassifier``.

Each rank is one stage of one data-parallel row. Stage s holds encoder
layers [s·L/S, (s+1)·L/S) (the stacked ``encoder`` cut by
``BERT_PP_RULES``, Adam's moments with it); embeddings, pooler and head are
held whole on every stage, as the JAX mesh replicates them, and used on
stage 0 and on the last stage. A batch shard is cut into M microbatches
(M = S unless set; M must divide the shard's rows), and the schedule is
GPipe's: M forwards, stage s running microbatch m at tick m + s (M + S − 1
ticks of fill and drain), then the M backwards in reverse order.
Activations hop to the next stage and their gradients back with
point-to-point ``send``/``recv``: gloo runs these on the CPU only, so on
the card S ≥ 2 needs one card a stage over NCCL.

The loss is Σ over microbatches of Σ(ce·w) divided by the global Σw (all
data rows), as the JAX step's. The gradients are reduced after the
schedule, explicitly and in one order on every rank (``reduce_grads``):
the stage-held encoder over the ``data`` group, then every replicated
parameter over the whole mesh, a stage that did not use one adding zeros,
as the JAX step's gated loss makes one ``psum`` over ('data', 'stage')
right for them. The step's statistics and the eval logits are broadcast
from the last stage to the others of its row.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from multimodal_lipread_torch.parallel.distributed import world_size
from multimodal_lipread_torch.parallel.mesh import (
    DATA_AXIS,
    all_reduce_flat,
    axis_group,
    axis_index,
    axis_size,
    get_mesh_2d,
)

STAGE_AXIS = "stage"


def get_mesh_pp(num_stages: int):
    """2-D ``(data, stage)`` mesh, ``stage`` innermost (``None`` in a single
    process without a group, where ``num_stages`` must be 1)."""
    n = world_size()
    if num_stages < 1 or n % num_stages:
        raise ValueError(f"num_stages={num_stages} must divide the {n} ranks")
    return get_mesh_2d(num_stages, STAGE_AXIS)


class _Stage:
    """This rank's place in its pipeline row."""

    def __init__(self, mesh):
        self.index = axis_index(mesh, STAGE_AXIS)
        self.count = axis_size(mesh, STAGE_AXIS)
        self.group = axis_group(mesh, STAGE_AXIS)
        self.first = self.index == 0
        self.last = self.index == self.count - 1

    def peer(self, offset: int) -> int:
        return dist.get_global_rank(self.group, self.index + offset)

    def from_last(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the last stage holds it, on every stage of the row."""
        if self.count > 1:
            dist.broadcast(t, src=self.peer(self.count - 1 - self.index), group=self.group)
        return t


def _microbatch_rows(n: int, num_microbatches: int) -> int:
    if num_microbatches < 1 or n % num_microbatches:
        raise ValueError(f"per-shard batch {n} not divisible by num_microbatches={num_microbatches}")
    return n // num_microbatches


def _activation(model: nn.Module, rows: int, seq: int, device: torch.device) -> torch.Tensor:
    return torch.empty((rows, seq, model.config.hidden_size), dtype=model.dtype, device=device)


def gpipe_forward(model: nn.Module, input_ids: torch.Tensor, mask: torch.Tensor, mesh,
                  num_microbatches: int) -> torch.Tensor:
    """The pipelined forward of ``model`` (a ``PipelinedBertClassifier``) on
    this row's batch shard: the logits, on every stage. Activations cross
    stages detached: training goes through :func:`gpipe_train_step`."""
    st = _Stage(mesh)
    n, seq = input_ids.shape
    rows = _microbatch_rows(n, num_microbatches)
    outs: List[torch.Tensor] = []
    for m in range(num_microbatches):
        sl = slice(m * rows, (m + 1) * rows)
        if st.first:
            h = model.embed(input_ids[sl])
        else:
            h = _activation(model, rows, seq, input_ids.device)
            dist.recv(h, src=st.peer(-1))
        h = model.run_layers(h, mask[sl], st.index)
        if st.last:
            outs.append(model.head(h))
        else:
            dist.send(h.detach().contiguous(), dst=st.peer(1))
    if st.last:
        logits = torch.cat(outs).detach()
    else:
        logits = torch.empty((n, model.classifier.out_features), dtype=model.dtype, device=input_ids.device)
    return st.from_last(logits.contiguous())


def gpipe_train_step(model: nn.Module, input_ids: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
                     w: torch.Tensor, global_wsum: torch.Tensor, mesh, num_microbatches: int) -> torch.Tensor:
    """One GPipe forward and backward of this row's batch shard; the
    gradients are left in the parameters, unreduced (:func:`reduce_grads`).

    ``weights`` count accuracy, ``w`` (weights × class weights) weighs the
    cross entropy, and ``global_wsum`` is Σw over every data row. Returns
    (Σ ce·w, correct, Σ weights, Σ w) of the shard, on every stage."""
    st = _Stage(mesh)
    mask = model.key_mask(input_ids)
    n, seq = input_ids.shape
    rows = _microbatch_rows(n, num_microbatches)
    denom = global_wsum.clamp_min(1e-9)
    saved = []
    stats = torch.zeros(4, dtype=torch.float32, device=input_ids.device)
    for m in range(num_microbatches):
        sl = slice(m * rows, (m + 1) * rows)
        if st.first:
            h_in = model.embed(input_ids[sl])
        else:
            h_in = _activation(model, rows, seq, input_ids.device)
            dist.recv(h_in, src=st.peer(-1))
            h_in.requires_grad_(True)
        h_out = model.run_layers(h_in, mask[sl], st.index)
        if st.last:
            logits = model.head(h_out).float()
            ce_w = (F.cross_entropy(logits, labels[sl], reduction="none") * w[sl]).sum()
            with torch.no_grad():
                correct = ((logits.argmax(-1) == labels[sl]).float() * weights[sl]).sum()
                stats += torch.stack([ce_w.detach(), correct, weights[sl].sum(), w[sl].sum()])
            saved.append((h_in, ce_w / denom))
        else:
            dist.send(h_out.detach().contiguous(), dst=st.peer(1))
            saved.append((h_in, h_out))
    for h_in, out in reversed(saved):
        if st.last:
            out.backward()
        else:
            grad = torch.empty_like(out)
            dist.recv(grad, src=st.peer(1))
            out.backward(grad)
        if not st.first:
            dist.send(h_in.grad.contiguous(), dst=st.peer(-1))
    return st.from_last(stats)


def reduce_grads(model: nn.Module, mesh) -> None:
    """Sum the gradients after :func:`gpipe_train_step`: the encoder's (held
    per stage) over the ``data`` group, then the replicated parameters'
    (zeros where a stage did not use them) over the whole mesh."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    for _, p in named:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    staged = [p.grad for n, p in named if n.startswith("encoder.")]
    replicated = [p.grad for n, p in named if not n.startswith("encoder.")]
    all_reduce_flat(staged, axis_group(mesh, DATA_AXIS))
    all_reduce_flat(replicated, dist.group.WORLD if world_size() > 1 else None)
