"""Process-group start-up (counterpart of the JAX package's
``parallel/distributed.py``).

One process per rank, as ``torch.distributed.run`` (``torchrun``) starts
them: ``maybe_initialize_distributed(device)`` reads only the environment
that launcher sets (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``), or takes an explicit ``init_method``
(``file://...`` or ``tcp://host:port``), and joins the default process
group: NCCL for a ``cuda`` device, after ``torch.cuda.set_device(LOCAL_RANK)``
so that each rank drives its own card, gloo for the CPU. Without that
environment it does nothing, so every entry point calls it unconditionally.

The JAX module also detects TPU pods from their metadata
(``TPU_WORKER_HOSTNAMES``, ``MEGASCALE_COORDINATOR_ADDRESS``); a GPU host
has no such metadata, and the launcher's environment takes its place.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def maybe_initialize_distributed(device: str = "cuda", init_method: Optional[str] = None,
                                 backend: Optional[str] = None) -> bool:
    """Join the default process group when the environment (or
    ``init_method``) describes one; returns whether distributed mode is on.

    A group that is already initialized is kept (a second call returns
    True). ``WORLD_SIZE`` (default 1) and ``RANK`` (default 0) give the
    world and this rank; the rendezvous is ``init_method`` where given,
    else ``env://`` (``MASTER_ADDR``/``MASTER_PORT``). ``backend``
    overrides the device's: ``"gloo"`` with ``cuda`` lets ranks share one
    card (NCCL refuses two ranks on one device; gloo runs ``broadcast`` and
    ``all_reduce`` on CUDA tensors, not ``send``/``recv`` or
    ``all_gather``)."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and not ("WORLD_SIZE" in env and "MASTER_ADDR" in env):
        return False
    world = int(env.get("WORLD_SIZE", "1"))
    rank_ = int(env.get("RANK", "0"))
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    bound = None
    if cuda:
        bound = torch.device("cuda", int(env.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(bound)
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world, rank=rank_,
                            device_id=bound if backend == "nccl" else None)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The default group's size (1 without one)."""
    return dist.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    return rank() == 0
