"""Checkpoints (counterpart of the JAX package's ``train/checkpoint.py``).

Same layout as the JAX package's: ``{epoch, state: {params, batch_stats},
val_acc, scheduler_lr}``. Here ``params`` holds a module's parameters and
``batch_stats`` its buffers (BatchNorm running statistics), each a flat
``{state_dict name: tensor}`` mapping. Written with ``torch.save`` and read
with ``torch.load(weights_only=True)``, so loading runs no pickled code.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch
from torch import nn


def module_state(model: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{params, batch_stats}`` of ``model``, copied to the CPU."""
    return {
        "params": {k: v.detach().cpu().clone() for k, v in model.named_parameters()},
        "batch_stats": {k: v.detach().cpu().clone() for k, v in model.named_buffers()},
    }


def load_module_state(model: nn.Module, state: Dict[str, Dict[str, torch.Tensor]]) -> None:
    """Load ``{params, batch_stats}`` into ``model``; every name must match."""
    model.load_state_dict({**state["params"], **state["batch_stats"]}, strict=True)


def save_checkpoint(path: str, tree: Dict[str, Any]) -> None:
    """Write a checkpoint tree to ``path`` (atomic rename)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint tree onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
