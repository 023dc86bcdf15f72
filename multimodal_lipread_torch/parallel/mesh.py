"""Device meshes and partition rules for data-, tensor- and
pipeline-parallel training (counterpart of the JAX package's
``parallel/mesh.py``).

One process per rank (``parallel/distributed.py``). A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default group's
ranks: ``get_mesh()`` is 1-D ``("data",)``, ``get_mesh_2d(k)`` is
``("data", "model")`` with ``model`` innermost, so that the ranks of one
tensor-parallel group are adjacent (one host's cards). Without a process
group the world is one process and both return ``None``, which every user
of a mesh reads as a world of one.

Partition rules are the JAX package's, translated to the port's names and
layouts: ``(regex, spec)`` pairs matched with ``re.search`` against a
``state_dict`` name, first match wins, no match replicates; a spec names a
mesh axis (or ``None``) per dimension of the torch tensor, whose layout is
not Flax's (``nn.Linear.weight`` is (out, in) where a Flax kernel is
(in, out)); a trailing ``"..."`` replicates the remaining dimensions
whatever the rank. ``place_state`` cuts this rank's shard out of each full
tensor, ``gather_state`` puts the full tensors back together.

Where the JAX package lets GSPMD insert the collectives, the port writes
them: ``all_reduce_sum`` (autograd-aware), and Megatron's pair for a
column-parallel layer followed by a row-parallel one, ``copy_to_group``
(identity forward, gradient all-reduced) and ``reduce_from_group`` (output
all-reduced, gradient passed through). Every collective here is a
``broadcast`` or an ``all_reduce``, the two that gloo also runs on CUDA
tensors, so that two ranks can share one card.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from multimodal_lipread_torch.parallel.distributed import is_initialized, world_size

DATA_AXIS = "data"
MODEL_AXIS = "model"

PartitionRules = Sequence[Tuple[str, Tuple[Optional[str], ...]]]
# a DeviceMesh, or {axis name: (size, this rank's coordinate)}
MeshLike = Union[Any, Mapping[str, Tuple[int, int]], None]


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _grid(axes: Tuple[str, ...], shape: Tuple[int, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_mesh_device_type(), shape, mesh_dim_names=axes)


def get_mesh(axis_name: str = DATA_AXIS):
    """1-D data-parallel mesh over the world (``None`` in a single process
    without a group)."""
    if not is_initialized():
        return None
    return _grid((axis_name,), (world_size(),))


def get_mesh_2d(model_parallel: int, inner_axis: str = MODEL_AXIS):
    """2-D ``(data, inner_axis)`` mesh: batch over 'data', weights (or
    stages) over the inner axis, which is the faster-varying rank."""
    n = world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide the {n} ranks")
    if not is_initialized():
        return None
    return _grid((DATA_AXIS, inner_axis), (n // model_parallel, model_parallel))


def axis_names(mesh: MeshLike) -> Tuple[str, ...]:
    if mesh is None:
        return ()
    if isinstance(mesh, Mapping):
        return tuple(mesh)
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh: MeshLike, axis: str) -> int:
    """The size of ``axis`` (1 where the mesh has no such axis)."""
    if axis not in axis_names(mesh):
        return 1
    if isinstance(mesh, Mapping):
        return int(mesh[axis][0])
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_index(mesh: MeshLike, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 where the mesh has none)."""
    if axis not in axis_names(mesh):
        return 0
    if isinstance(mesh, Mapping):
        return int(mesh[axis][1])
    return int(mesh.get_local_rank(axis))


def axis_group(mesh: MeshLike, axis: str):
    """The process group along ``axis`` through this rank (``None`` where
    the axis has one rank: nothing to reduce)."""
    if axis_size(mesh, axis) <= 1 or isinstance(mesh, Mapping):
        return None
    return mesh.get_group(axis)


def resolve_partition_spec(rules: PartitionRules, name: str) -> Tuple[Optional[str], ...]:
    """First-match-wins spec for a ``state_dict`` name; ``()`` replicates."""
    for pattern, spec in rules:
        if re.search(pattern, name):
            return tuple(spec)
    return ()


def _checked_spec(mesh: MeshLike, name: str, shape: Tuple[int, ...], rules: PartitionRules):
    """The rule's spec for ``name``, expanded over a trailing ``"..."``,
    with the JAX package's three errors: a rank mismatch, an axis the mesh
    lacks, a dimension the axis does not divide."""
    spec = resolve_partition_spec(rules, name)
    if spec and spec[-1] == "...":
        head = spec[:-1]
        if len(head) > len(shape):
            raise ValueError(f"partition rule for '{name}' names {len(head)} leading dims "
                             f"but the tensor has shape {tuple(shape)}")
        spec = head + (None,) * (len(shape) - len(head))
    if not spec:
        return spec
    if len(spec) != len(shape):
        raise ValueError(f"partition rule for '{name}' has rank {len(spec)} but the tensor has shape {tuple(shape)}")
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if axis not in axis_names(mesh):
            raise ValueError(f"partition rule for '{name}' names axis '{axis}' not in mesh axes {axis_names(mesh)}")
        size = axis_size(mesh, axis)
        if shape[dim] % size:
            raise ValueError(f"'{name}' dim {dim} (size {shape[dim]}) not divisible by mesh axis '{axis}' "
                             f"(size {size})")
    return spec


def place_state(mesh: MeshLike, state: Mapping[str, torch.Tensor], rules: PartitionRules) -> Dict[str, torch.Tensor]:
    """This rank's shard of every tensor of ``state`` (a ``state_dict``-like
    mapping of full tensors), by ``rules``: a sharded dimension keeps the
    contiguous chunk at this rank's coordinate on its axis. Replicated
    tensors come back as they are. Adam's moments shard the same way when
    passed under their parameter's name."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        spec = _checked_spec(mesh, name, tuple(t.shape), rules)
        for dim, axis in enumerate(spec):
            if axis is not None:
                t = t.chunk(axis_size(mesh, axis), dim)[axis_index(mesh, axis)]
        out[name] = t.contiguous() if spec else t
    return out


def gather_state(mesh: MeshLike, state: Mapping[str, torch.Tensor], rules: PartitionRules,
                 full_shapes: Mapping[str, Tuple[int, ...]]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`place_state` on every rank: each sharded tensor
    is written at its offset into zeros of its full shape and summed over its
    axis group with ``all_reduce`` (adding zeros is exact), so it needs no
    ``all_gather``, which gloo does not run on CUDA tensors."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        spec = _checked_spec(mesh, name, tuple(full_shapes[name]), rules)
        if not any(spec):
            out[name] = t
            continue
        full = t.new_zeros(full_shapes[name])
        view = full
        for dim, axis in enumerate(spec):
            if axis is not None:
                view = view.narrow(dim, axis_index(mesh, axis) * t.shape[dim], t.shape[dim])
        view.copy_(t)
        for axis in dict.fromkeys(a for a in spec if a is not None):
            group = axis_group(mesh, axis)
            if group is not None:
                dist.all_reduce(full, group=group)
        out[name] = full
    return out


def pad_to_multiple(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Zero-pad the leading axis up to the next multiple (for even sharding)."""
    rem = (-arr.shape[0]) % multiple
    if rem == 0:
        return arr
    return np.pad(arr, [(0, rem)] + [(0, 0)] * (arr.ndim - 1))


def shard_batch(mesh: MeshLike, arr: Any, axis: str = DATA_AXIS) -> Any:
    """This rank's contiguous slice of a global batch's leading axis (the
    whole batch on a mesh of one); the axis size must divide it."""
    size, index = axis_size(mesh, axis), axis_index(mesh, axis)
    n = arr.shape[0]
    if n % size:
        raise ValueError(f"batch of {n} rows does not split over the {size} ranks of axis '{axis}'")
    step = n // size
    return arr[index * step : (index + 1) * step]


def replicate(mesh: MeshLike, tensors: Sequence[torch.Tensor], axis: Optional[str] = None) -> None:
    """Broadcast ``tensors`` in place from the first rank of ``axis`` (of
    the whole mesh where ``axis`` is None) to the others."""
    if mesh is None or isinstance(mesh, Mapping):
        return
    groups = [mesh.get_group(a) for a in ((axis,) if axis else mesh.mesh_dim_names) if axis_size(mesh, a) > 1]
    for group in groups:
        src = dist.get_global_rank(group, 0)
        for t in tensors:
            dist.broadcast(t.data, src=src, group=group)


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum over ``group``; backward: the sum of the gradients
    (every rank's copy of the sum feeds its own loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduced gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: all-reduced forward, gradient passed through."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group`` (``x`` itself where it is None)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def all_reduce_flat(tensors: Sequence[torch.Tensor], group, op=dist.ReduceOp.SUM) -> None:
    """All-reduce ``tensors`` in place as one flat buffer per dtype (one
    collective per dtype, in a fixed order on every rank)."""
    if group is None or not tensors:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_tensors in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group_tensors])
        dist.all_reduce(flat, op=op, group=group)
        pos = 0
        for t in group_tensors:
            t.copy_(flat[pos : pos + t.numel()].view_as(t))
            pos += t.numel()
