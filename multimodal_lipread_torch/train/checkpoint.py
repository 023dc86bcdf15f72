"""Checkpoints (counterpart of the JAX package's ``train/checkpoint.py``).

Same layout as the JAX package's. A trainer writes the whole tree:

    {epoch, state: {params, batch_stats, opt_state, step}, val_acc,
     scheduler_lr, scheduler_best, scheduler_has_best, scheduler_bad_epochs,
     best_val_acc, dropout_rng, classes}

``params`` holds a module's parameters and ``batch_stats`` its buffers
(BatchNorm running statistics), each a flat ``{state_dict name: tensor}``
mapping; ``opt_state`` is the optimizer's ``state_dict()`` (Adam's moments
and step counts, and the LR in its ``param_groups``); ``dropout_rng`` the
dropout generator's state. Serving reads only ``state.params``,
``state.batch_stats`` and ``classes``, so a trained checkpoint serves as it
is.

Two formats, as the JAX package's ``checkpoint_backend`` has:

- ``msgpack``: one file, ``<model>_{best,checkpoint}.pt``, written with
  ``torch.save`` and read with ``torch.load(weights_only=True)``, so
  loading runs no pickled code.
- ``orbax`` and ``orbax_async``: a ``torch.distributed.checkpoint`` (dcp)
  directory, ``<model>_{best,checkpoint}.orbax``, holding the same tree
  (:func:`save_checkpoint_orbax`). Its values other than tensors are read
  with ``weights_only=True`` too.
"""

from __future__ import annotations

import os
import shutil
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

CHECKPOINT_BACKENDS = ("msgpack", "orbax", "orbax_async")
ORBAX_BACKENDS = ("orbax", "orbax_async")
ORBAX_SUFFIX = ".orbax"
# the keys serving reads: the weights and the label space, not Adam
SERVING_KEYS = ("state.params", "state.batch_stats", "classes")
# dcp keeps no empty mapping (a model without BatchNorm has no
# batch_stats); their paths are written under this key and put back on read
_EMPTY_KEY = "_empty_dicts"


def module_state(model: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{params, batch_stats}`` of ``model``, copied to the CPU: its
    ``state_dict``, parameters apart from buffers. Non-persistent buffers
    (constants such as the positional-encoding table) are left out."""
    params = {k for k, _ in model.named_parameters()}
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    return {
        "params": {k: v for k, v in state.items() if k in params},
        "batch_stats": {k: v for k, v in state.items() if k not in params},
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


def host_copy(tree: Any) -> Any:
    """A copy of a nest of dicts, lists and tuples with every tensor copied
    to the host (CPU tensors too: the caller may change them in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


def is_orbax_path(path: str) -> bool:
    """Whether ``path`` names a dcp checkpoint directory (``*.orbax``)."""
    return os.fspath(path).rstrip(os.sep).endswith(ORBAX_SUFFIX)


# ---------------------------------------------------------------- orbax (dcp)

# saves queued on the writer thread: futures that end once the directory is
# swapped in (or the write failed)
_pending: List[Future] = []
_writer: Optional[ThreadPoolExecutor] = None
# (default group, the group dcp saves over) for the current default group
_save_groups: Optional[Tuple[Any, Any]] = None


def _quiet_single_process() -> None:
    """dcp warns at every save and load without a process group; a single
    process is the intended case here."""
    warnings.filterwarnings("ignore", message="torch.distributed is disabled, unavailable or uninitialized",
                            category=UserWarning)


def _save_group():
    """The group dcp coordinates a save over: ``None`` without a process
    group (a single process); else a gloo group over the default group's
    ranks, made once (collectively: every rank saves) and used by the
    writer thread only. dcp's object collectives run on the CPU, and a
    group of their own keeps the writer's collectives apart from the
    training step's (DDP's all-reduce over the default group would
    interleave with them)."""
    global _save_groups
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.group.WORLD
    if _save_groups is None or _save_groups[0] is not world:
        _save_groups = (world, dist.new_group(backend="gloo"))
    return _save_groups[1]


def _empty_dict_paths(tree: Any, path: Tuple = ()) -> List[List[Any]]:
    out: List[List[Any]] = []
    if isinstance(tree, dict):
        if not tree and path:
            out.append(list(path))
        for k, v in tree.items():
            out += _empty_dict_paths(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out += _empty_dict_paths(v, path + (i,))
    return out


def _swap_in(staging: str, path: str) -> None:
    """``staging`` becomes ``path``; the previous ``path`` stays whole until
    the first rename and is removed after the second."""
    old = path + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(path):
        os.replace(path, old)
    os.replace(staging, path)
    shutil.rmtree(old, ignore_errors=True)


def _write(path: str, tree: Dict[str, Any], group: Any) -> None:
    """One save on the writer thread: the ranks check that they name one
    directory, rank 0 clears ``<path>.staging``, every rank writes its
    share there (dcp), and rank 0 swaps it in; the ranks meet after it,
    so that each sees the new directory when its save ends."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemWriter

    primary = group is None or dist.get_rank() == 0
    staging = path + ".staging"
    if group is not None:
        paths: List[Optional[str]] = [None] * dist.get_world_size(group)
        dist.all_gather_object(paths, path, group=group)
        if len(set(paths)) != 1:
            raise ValueError(f"an orbax checkpoint is written by every rank to one directory; the ranks name {paths}")
    if primary:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if os.path.exists(staging):
            shutil.rmtree(staging)
    if group is not None:
        dist.barrier(group=group)
    try:
        dcp.save(tree, storage_writer=FileSystemWriter(staging), process_group=group, no_dist=group is None)
        if primary:
            _swap_in(staging, path)
    except BaseException:
        if primary:
            shutil.rmtree(staging, ignore_errors=True)
        raise
    finally:
        if group is not None:
            dist.barrier(group=group)


def wait_for_async_saves() -> None:
    """Block until every save queued by this process has been written and
    swapped in. A failed background write is re-raised here."""
    global _pending
    pending, _pending = _pending, []
    errors = []
    for fut in pending:
        try:
            fut.result()
        except BaseException as e:  # noqa: BLE001 - re-raised below, once every save has ended
            errors.append(e)
    if errors:
        raise errors[0]


def save_checkpoint_orbax(directory: str, tree: Dict[str, Any], async_save: bool = False) -> None:
    """Write ``tree`` as a dcp directory at ``directory``.

    - Atomic: the save goes to ``<directory>.staging``, and rank 0 renames
      it into place once every rank's write has committed (dcp writes
      ``.metadata`` after every rank's data); until then the previous
      checkpoint stays whole under ``directory``. A failed save removes
      its staging directory and leaves ``directory`` as it was.
    - Collective under a process group: every rank passes the whole tree
      (full tensors) and names the same directory; dcp writes each tensor
      once, from one rank (its planner de-duplicates replicated items).
    - Saves run in order on one writer thread, so that a save to a path
      follows the previous one to it, and two saves in flight never run
      their collectives at once. ``async_save`` returns once every tensor
      of ``tree`` is copied to the host, so the caller may change the live
      state at once (the next optimizer step, a CUDA graph's replay); the
      write and the swap follow in the background, overlapping training,
      and :func:`wait_for_async_saves` waits for them and re-raises a
      failure. Without it the call returns when the directory is in place.
    """
    global _writer
    _quiet_single_process()
    path = os.path.abspath(directory)
    group = _save_group()
    empties = _empty_dict_paths(tree)
    tree = {**tree, _EMPTY_KEY: empties} if empties else dict(tree)
    if async_save:
        tree = host_copy(tree)
    if _writer is None:
        _writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="orbax-writer")
    done = _writer.submit(_write, path, tree, group)
    if async_save:
        _pending.append(done)
        return
    done.result()


def _selected(path: Sequence[Any], keys: Optional[Iterable[str]]) -> bool:
    """Whether the tree path ``path`` lies under one of the dotted ``keys``."""
    if keys is None:
        return True
    dotted = [".".join(map(str, path[: i + 1])) for i in range(len(path))]
    return any(d in keys for d in dotted)


def _set(tree: Dict[str, Any], path: Sequence[Any], value: Any) -> None:
    """``tree[path[0]][path[1]]... = value``, making dicts and lists on the
    way (an integer step is a list index)."""
    node: Any = tree
    for key, nxt in zip(path[:-1], path[1:]):
        fresh: Any = [] if isinstance(nxt, int) else {}
        if isinstance(node, list):
            while len(node) <= key:
                node.append(None)
            if node[key] is None:
                node[key] = fresh
            node = node[key]
        else:
            node = node.setdefault(key, fresh)
    last = path[-1]
    if isinstance(node, list):
        while len(node) <= last:
            node.append(None)
    node[last] = value


def load_checkpoint_orbax(directory: str, keys: Optional[Iterable[str]] = None) -> Dict[str, Any]:
    """Read a directory written by :func:`save_checkpoint_orbax` onto the
    CPU, raw: the tree is rebuilt from the directory's own metadata, with no
    template from the caller. ``keys`` (dotted paths, e.g.
    :data:`SERVING_KEYS`) reads only what lies under them. Every rank
    reads the whole of what it asks for itself (no collective). Adam's
    per-parameter state gets its integer keys back."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.default_planner import DefaultLoadPlanner
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    class RawLoadPlanner(DefaultLoadPlanner):
        """Loads the flat ``{fqn: value}`` as it is, values other than
        tensors with ``weights_only=True``."""

        def __init__(self):
            super().__init__(flatten_state_dict=False, flatten_sharded_tensors=False)

        def load_bytes(self, read_item, value) -> None:
            self.state_dict[read_item.dest_index.fqn] = torch.load(value, weights_only=True)

    _quiet_single_process()
    wait_for_async_saves()
    path = os.path.abspath(directory)
    keys = None if keys is None else set(keys) | {_EMPTY_KEY}
    reader = FileSystemReader(path)
    metadata = reader.read_metadata()
    paths = metadata.planner_data
    flat = {}
    for fqn, md in metadata.state_dict_metadata.items():
        if _selected(paths[fqn], keys):
            flat[fqn] = torch.empty(md.size, dtype=md.properties.dtype) if isinstance(md, TensorStorageMetadata) else None
    dcp.load(flat, storage_reader=reader, planner=RawLoadPlanner(), no_dist=True)
    tree: Dict[str, Any] = {}
    for fqn, value in flat.items():
        _set(tree, paths[fqn], value)
    for empty in tree.pop(_EMPTY_KEY, []):
        if _selected(empty, keys):
            _set(tree, empty, {})
    opt = tree.get("state", {}).get("opt_state")
    if isinstance(opt, dict) and isinstance(opt.get("state"), dict):
        opt["state"] = {int(k): v for k, v in opt["state"].items()}
    return tree
