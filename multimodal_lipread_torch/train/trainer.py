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
only with dropout off). A float32 model trains without TF32, and cuDNN
picks the engines of the forward's and backward's convolutions by timing
them on the step's own shapes, unless the caller set
``cudnn.deterministic`` (``utils/precision.py``). The first step of a kind
(train or eval) on inputs of new shapes or dtypes runs in the span
``trainer.conv_tune`` with 1 added to the counter
``trainer.conv_tune_rounds``: it marks where cuDNN may meet new
convolution shapes, and counts such steps whether or not the model has
convolutions or the process met the shapes before. A graphed group's
first run is eager, so a capture meets only shapes timed before it.

Data: an ``ArrayDataset`` (the whole corpus in host memory), or a
``data.grain_loader.StreamingDataset`` read one epoch at a time, whose
short last batch is padded with its own rows (``np.resize``) at weight 0;
either way host batches are gathered and pinned ``host_prefetch`` ahead in
a side thread. ``device_preproc`` runs on the device batch before the uint8
/255 cast (e.g. ``ops/crop_resize_cuda.device_crop`` on full frames and lip
boxes).

``device_resident`` keeps an ``ArrayDataset`` on the device (a cache of
three, held by identity); only int64 indices and float32 weights cross per
batch. ``steps_per_dispatch`` K > 1 groups K such batches: on the card a
``torch.cuda.CUDAGraph`` holds K train steps (and one an eval group), each
gathering its batch from static (K, batch) index and weight buffers, with
the dropout generator registered so that every replay draws the masks K
eager steps would; the first group runs eagerly and counts, then the graph
is captured; a tail shorter than K runs step by step. On the CPU the groups
run eagerly. A device-resident trainer on the card keeps Adam
``capturable`` (step counts and the LR on the device), eager or graphed, so
both take the same arithmetic. A per-step LR, or a dataset that is not a
device-resident ``ArrayDataset``, falls back to per-step dispatch with the
JAX trainer's warnings.

``remat`` recomputes the forward in the backward
(``torch.utils.checkpoint``). The recompute draws its dropout masks from a
twin of the dropout generator that takes every draw the dropout generator
takes, one forward behind, so it draws the forward's masks and leaves the
dropout generator where the forward left it; it keeps the BatchNorm
statistics as the forward left them. Nothing is read or set on the host,
so a CUDA graph of K steps captures it, and eager and graphed steps, on the
card and on the CPU, take the same code. ``mixup_alpha`` mixes full
batches after the cast (``data/augment.py``), with soft-label cross
entropy; with several data-parallel ranks the batch is the global one (one
λ and one permutation of every rank's rows). ``profile_dir`` writes a
``torch.profiler`` Chrome trace of the first epoch, with the spans of
``utils/trace.py``: ``trainer.step`` and its ``trainer.forward`` (with
``trainer.preproc`` around ``device_preproc``), ``trainer.backward`` and
``trainer.optimizer``, ``trainer.group`` around a grouped dispatch (with the
counters ``trainer.eager_steps`` and ``trainer.replays``),
``data.resident_place`` around placing a dataset on the device (the counter
``data.resident_bytes``), and ``loader.wait`` around each wait for a host
batch (with the counters ``loader.batches`` and ``loader.batches_waited``).
``handle_preemption`` turns SIGTERM/SIGINT into ``request_preemption``: the step in flight
finishes, the rolling checkpoint is written from a host snapshot of the
epoch's start (the dropout generator's state included) labelled
``epoch - 1``, and ``fit`` returns ``preempted=True``; ``--resume`` replays
that epoch exactly.

Multi-GPU (one process per rank, ``parallel/``), with the JAX trainer's
semantics on a mesh, so that W ranks give the one-rank run's math:

- data parallelism over the mesh's ``data`` axis (``get_mesh()`` over the
  world by default): the batch size is padded to a multiple of the world,
  every rank draws the same global permutation from the one
  ``default_rng(seed)`` and takes its contiguous slice of each global batch
  (padding rows at weight 0); the loss is Σ(ce·w) over the slice divided by
  the global ``max(Σw, 1e-9)`` (all-reduced before the backward), and the
  gradients are summed, not averaged (DDP with a comm hook that sums;
  tensor and pipeline parallelism reduce explicitly); BatchNorm takes its
  statistics over the global batch (``nn.common.BatchNorm.group``); the
  epoch metrics and evaluations are all-reduced sums. A streaming dataset
  loads ``batch_size / world`` rows a step from its own shard, and the LR
  schedule counts ``global_batches``. A preemption on any rank stops every
  rank at the end of the epoch (all-reduce max), and the ranks agree that
  the best checkpoint exists (all-reduce min) before the final test.
- ``param_partition_rules`` (``parallel/mesh.place_state``) cut parameters,
  and Adam's moments with them, over a ``(data, model)`` mesh (tensor
  parallelism: modules with ``set_tensor_parallel`` run their
  collectives) or a ``(data, stage)`` mesh (GPipe,
  ``parallel/pipeline.py``; mixup, BatchNorm models, remat and
  ``device_preproc`` are refused there, as in the JAX trainer).
- Checkpoints hold full tensors whatever the world (cut tensors are put
  together with ``all_reduce``), and every rank writes them as the JAX
  trainer's processes do: with ``checkpoint_backend: msgpack`` a ``.pt``
  file through pid-unique staging files, with ``orbax`` / ``orbax_async``
  one shared ``.orbax`` directory written collectively
  (``torch.distributed.checkpoint``, each tensor once; ``orbax_async``
  writes in the background, and ``fit`` waits for it before the
  best-checkpoint gate and before it returns). A checkpoint written at one
  world size resumes at another. Every rank prints and logs, as the JAX
  processes do.

On the card, K > 1 graphed ``steps_per_dispatch`` captures DDP's step with
its NCCL all-reduce and mixup's exchange (DDP built on a side stream, its
first 11 steps run eagerly, the capture thread-local because NCCL's
watchdog queries events); over gloo it raises ``NotImplementedError``
(ROADMAP.md, Queue 3 #16). The
trainer runs on ``device`` ("cuda" unless the caller asks for the CPU).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from multimodal_lipread_torch.data.augment import draw_mixup, mixup
from multimodal_lipread_torch.nn.common import BatchNorm, Dropout, flax_init_
from multimodal_lipread_torch.parallel import mesh as pmesh
from multimodal_lipread_torch.parallel.distributed import is_initialized, world_size
from multimodal_lipread_torch.train.checkpoint import (
    CHECKPOINT_BACKENDS,
    ORBAX_BACKENDS,
    host_copy,
    load_checkpoint,
    load_checkpoint_orbax,
    load_module_state,
    module_state,
    save_checkpoint,
    save_checkpoint_orbax,
    wait_for_async_saves,
)
from multimodal_lipread_torch.train.schedule import ReduceLROnPlateau
from multimodal_lipread_torch.utils import trace
from multimodal_lipread_torch.utils.metrics_log import MetricLogger
from multimodal_lipread_torch.utils.precision import compute_dtype, model_precision, timed_conv_engines


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
    # 'msgpack': one torch.save file (<model>_*.pt); 'orbax' / 'orbax_async':
    # a torch.distributed.checkpoint directory (<model>_*.orbax), written in
    # the background by 'orbax_async' (train/checkpoint.py)
    checkpoint_backend: str = "msgpack"
    # parameter subtrees (JAX path prefixes) that get no update
    frozen_param_prefixes: Tuple[Tuple[str, ...], ...] = ()
    # a torch.profiler Chrome trace of the first epoch goes here
    profile_dir: Optional[str] = None
    # > 0: mixup of full batches with λ ~ Beta(α, α) (data/augment.py)
    mixup_alpha: float = 0.0
    # recompute the forward in the backward (torch.utils.checkpoint)
    remat: bool = False
    # keep ArrayDatasets on the device and gather each batch there by index
    device_resident: bool = False
    # K > 1: K device-resident steps per dispatch (a CUDA graph on the card)
    steps_per_dispatch: int = 1
    # SIGTERM/SIGINT: finish the step, checkpoint the epoch's start, return
    handle_preemption: bool = False
    # (regex, spec) rules that cut parameters over the mesh (parallel/mesh.py)
    param_partition_rules: Tuple[Any, ...] = ()
    # ``(*inputs) -> tuple(inputs)`` on the device batch before the cast
    device_preproc: Optional[Callable[..., tuple]] = None
    # the words of the label space, by index: written into every checkpoint
    # as ``classes``, where serving reads them
    class_names: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass
class EpochMetrics:
    loss: float
    acc: float  # percent, like the reference logs


class _Metrics:
    """Sums of (Σ loss·w, correct, Σ weights, Σ w) over an epoch's batches,
    kept on the device in float64 and read once (all-reduced over
    ``group``, the data-parallel ranks, where there are several)."""

    def __init__(self, device: torch.device, group=None):
        self.sums = torch.zeros(4, dtype=torch.float64, device=device)
        self.group = group

    def push(self, stats: torch.Tensor) -> None:
        """Add one step's stats, or a (K, 4) group's rows in order (a
        running sum, so a group adds up as K pushes would)."""
        if stats.ndim == 1:
            self.sums += stats.double()
        else:
            self.sums = torch.cat([self.sums[None], stats.double()]).cumsum(0)[-1]

    def result(self) -> EpochMetrics:
        if self.group is not None:
            dist.all_reduce(self.sums, group=self.group)
        loss_sum, correct, count, wsum = self.sums.tolist()
        return EpochMetrics(loss=loss_sum / max(wsum, 1e-9), acc=100.0 * correct / max(count, 1))


def _host_prefetch_iter(it: Iterator, depth: int) -> Iterator:
    """Drain ``it`` from a daemon thread, ``depth`` items ahead, in order.

    Producer exceptions re-raise in the consumer; a consumer that stops
    early stops the producer. Each wait for an item is the span
    ``loader.wait`` (the last one finds the end); ``loader.batches`` counts
    the items and ``loader.batches_waited`` those the queue did not hold
    when asked for (every item where ``depth`` is 0: it is made inline)."""
    if depth <= 0:
        end = object()
        try:
            while True:
                with trace.span("loader.wait"):
                    item = next(it, end)
                if item is end:
                    return
                trace.count("loader.batches")
                trace.count("loader.batches_waited")
                yield item
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
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
            waited = q.empty()
            with trace.span("loader.wait"):
                item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            trace.count("loader.batches")
            if waited:
                trace.count("loader.batches_waited")
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)


class _StepGroupGraph:
    """K calls of ``step(idx, weights)`` captured as one CUDA graph.

    The static (K, batch) index and weight buffers feed the calls; the graph
    returns the sum of their (Σ loss·w, correct, Σ weights, Σ w). Building
    it runs the first group for real, eagerly, on the capture stream (so
    that lazily made state, Adam's moments, cuBLAS workspaces, the
    log-mel kernel's scratch and cuDNN's timed engine choices, exists before
    capture; a capture never times an engine), and then captures the
    same K calls, which run no work. ``generators`` (the dropout generator
    and, under remat, its twin) are registered with the graph: each replay
    draws from where the last draw left them, as eager steps do. Both
    return the (K, 4) stats of the K calls."""

    def __init__(self, step: Callable, idxs: np.ndarray, ws: np.ndarray, device: torch.device,
                 generators: Sequence[torch.Generator] = ()):
        self.idx = torch.from_numpy(idxs).to(device)
        self.w = torch.from_numpy(ws).to(device)
        k = self.idx.shape[0]
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            self.first = torch.stack([step(self.idx[i], self.w[i]) for i in range(k)])
        self.graph = torch.cuda.CUDAGraph()
        for generator in generators:
            self.graph.register_generator_state(generator)
        # thread-local under a process group: NCCL's watchdog thread queries
        # its events while this thread captures
        mode = "thread_local" if dist.is_initialized() else "global"
        with torch.cuda.graph(self.graph, stream=stream, capture_error_mode=mode):
            self.out = torch.stack([step(self.idx[i], self.w[i]) for i in range(k)])
        torch.cuda.current_stream(device).wait_stream(stream)

    def replay(self, idxs: np.ndarray, ws: np.ndarray) -> torch.Tensor:
        """Run the K steps on these batches; the result is overwritten by the
        next replay, so read it (or add it up) on the stream before that."""
        self.idx.copy_(torch.from_numpy(idxs))
        self.w.copy_(torch.from_numpy(ws))
        self.graph.replay()
        return self.out


def _sum_hook(group, bucket):
    """DDP comm hook: the bucket's gradients summed over ``group`` (DDP's
    own hook averages them, which the global-Σw loss must not)."""
    fut = dist.all_reduce(bucket.buffer(), group=group, async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


class Trainer:
    """The trainer of one rank (``device`` "cuda" unless the caller asks for
    the CPU) on ``mesh`` (``parallel/mesh.py``; by default the 1-D data
    mesh over the world, ``None`` without a process group)."""

    def __init__(self, model: nn.Module, config: TrainerConfig, device: str = "cuda", mesh: Any = None):
        if config.checkpoint_backend not in CHECKPOINT_BACKENDS:
            raise ValueError(f"TrainerConfig.checkpoint_backend={config.checkpoint_backend!r}: one of "
                             f"{', '.join(CHECKPOINT_BACKENDS)}")
        self.config = config
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.mesh = mesh if mesh is not None else pmesh.get_mesh()
        self.world = world_size() if self.mesh is not None else 1
        self._data_size = pmesh.axis_size(self.mesh, pmesh.DATA_AXIS)
        self._data_index = pmesh.axis_index(self.mesh, pmesh.DATA_AXIS)
        self._data_group = pmesh.axis_group(self.mesh, pmesh.DATA_AXIS)
        self._pp = pmesh.axis_size(self.mesh, "stage") > 1
        self._rules = tuple(config.param_partition_rules)
        # pad the global batch so that it splits evenly over the ranks
        self.batch_size = -(-config.batch_size // self.world) * self.world
        self._check_parallel()
        for m in self.model.modules():
            if isinstance(m, BatchNorm):
                m.group = self._data_group
        self._ddp: Optional[nn.Module] = None
        self._ddp_steps = 0  # steps taken through DDP (it times its first 10 with CUDA events)
        self._full_shapes: Dict[str, Tuple[int, ...]] = {}
        self._opt_names: List[str] = []
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
        # under remat, the recompute's generator: it takes every draw the
        # dropout generator takes (the recompute mirrors the forward, and
        # mixup's draw is made on both), so it stands where the dropout
        # generator stood when the forward began (_remat_contexts)
        self._twin_generator = torch.Generator(device=self.device) if config.remat else None
        self._dropouts = [m for m in self.model.modules() if isinstance(m, Dropout)]
        for m in self._dropouts:
            m.generator = self.dropout_generator
            m.data_shard = (self._data_index, self._data_size)
        self.dropout_generator.manual_seed(config.seed + 1)
        self._sync_twin()
        # per-step LR function, built in fit() once the step count is known
        self._lr_step_fn: Optional[Callable[[int], float]] = None
        # keyword arguments every forward receives (set_apply_kwargs)
        self._apply_kwargs: Dict[str, Any] = {}
        # Adam keeps its step counts and LR on the card where graphs may run
        self._capturable = self.device.type == "cuda" and config.device_resident
        self._device_data: Dict[int, Tuple[Any, Tuple[Tuple[torch.Tensor, ...], torch.Tensor]]] = {}
        self._graphs: Dict[Tuple[str, int], _StepGroupGraph] = {}
        # (kind, shapes and dtypes of the inputs) of every step taken (_conv_tune)
        self._stepped: set = set()
        self._preempted = False
        self.exchange_bytes = 0  # bytes mixup's last exchange all-reduced (_global_rows)

    # ------------------------------------------------------------ parallel

    def _check_parallel(self) -> None:
        """The JAX trainer's refusals under pipeline parallelism."""
        cfg = self.config
        if not self._pp:
            return
        if not self._rules:
            raise ValueError("pipeline parallelism needs param_partition_rules that cut the stacked layers "
                             "over 'stage' (models/bert.BERT_PP_RULES)")
        if cfg.mixup_alpha > 0:
            raise NotImplementedError("mixup is not supported with pipeline parallelism")
        if cfg.remat:
            raise NotImplementedError("remat is not supported with pipeline parallelism")
        if cfg.device_preproc is not None:
            raise NotImplementedError("device_preproc is not supported with pipeline parallelism")
        if any(isinstance(m, BatchNorm) for m in self.model.modules()):
            raise NotImplementedError("BatchNorm models are not supported with pipeline parallelism")

    def _shard_model(self) -> None:
        """Cut the parameters by ``param_partition_rules`` and turn on the
        tensor-parallel modules' collectives (outermost modules only)."""
        if not self._rules:
            return
        params = dict(self.model.named_parameters())
        if not self._full_shapes:
            self._full_shapes = {n: tuple(p.shape) for n, p in params.items()}
        local = pmesh.place_state(self.mesh, {n: p.detach() for n, p in params.items()}, self._rules)
        for name, p in params.items():
            if local[name].shape != p.shape:
                p.data = local[name].clone()
        size = pmesh.axis_size(self.mesh, pmesh.MODEL_AXIS)
        if size > 1:
            group = pmesh.axis_group(self.mesh, pmesh.MODEL_AXIS)
            done: set = set()
            for m in self.model.modules():
                if id(m) not in done and hasattr(m, "set_tensor_parallel"):
                    m.set_tensor_parallel(group, size)
                    done.update(id(c) for c in m.modules())

    def _unshard_model(self) -> None:
        """Give every cut parameter its full shape again (values undefined),
        before a fresh initialization."""
        for name, p in self.model.named_parameters():
            full = self._full_shapes.get(name)
            if full is not None and tuple(p.shape) != full:
                p.data = torch.empty(full, dtype=p.dtype, device=p.device)

    def _train_module(self) -> nn.Module:
        """The module the train forward calls: under a process group, DDP
        over the data axis for plain data parallelism (a world of one
        included: its reduction is then the identity), built at the first
        step, after the parameters and their ``requires_grad`` are final;
        else the model. Buffers are not broadcast: BatchNorm's global
        statistics keep them equal on every rank."""
        if self.mesh is None or self._rules:
            return self.model
        if self._ddp is None:
            from torch.nn.parallel import DistributedDataParallel

            group = self.mesh.get_group(pmesh.DATA_AXIS)
            cuda = self.device.type == "cuda"
            # built on a side stream, as CUDA graphs of DDP steps need
            with torch.cuda.stream(torch.cuda.Stream(self.device)) if cuda else contextlib.nullcontext():
                self._ddp = DistributedDataParallel(
                    self.model, device_ids=[self.device.index if self.device.index is not None
                                            else torch.cuda.current_device()] if cuda else None,
                    process_group=group, broadcast_buffers=False)
            self._ddp.register_comm_hook(group, _sum_hook)
            # no runtime statistics after the first 10 steps: their CUDA
            # timing events cannot be recorded inside a graph capture
            self._ddp._set_ddp_runtime_logging_sample_rate(2**31 - 1)
        self._ddp_steps += 1
        return self._ddp

    def _global_sums(self, *sums: torch.Tensor) -> torch.Tensor:
        """The 0-d ``sums`` of this rank's slice, stacked and added over
        every data-parallel rank's slice in one all-reduce."""
        total = torch.stack([v.detach() for v in sums])
        if self._data_group is not None:
            dist.all_reduce(total, group=self._data_group)
        return total

    def _global_rows(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every data-parallel rank's rows of ``tensors`` joined in rank
        order (the global batch): each rank writes its rows at its offset
        in a zeroed buffer (one a dtype, the tensors' rows flattened side by
        side) and one all-reduce sum a buffer puts them together. Adding
        zeros is exact, and gloo runs ``all_reduce`` on CUDA tensors where
        it runs no ``all_gather``. ``exchange_bytes`` counts the buffers."""
        rows, ranks = tensors[0].shape[0], self._data_size
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        self.exchange_bytes = 0
        for dtype, members in by_dtype.items():
            widths = [tensors[i][0].numel() for i in members]
            buf = torch.zeros((ranks * rows, sum(widths)), dtype=dtype, device=tensors[0].device)
            buf[self._data_index * rows:(self._data_index + 1) * rows] = torch.cat(
                [tensors[i].reshape(rows, -1) for i in members], dim=1)
            dist.all_reduce(buf, group=self._data_group)
            self.exchange_bytes += buf.numel() * buf.element_size()
            for i, part in zip(members, buf.split(widths, dim=1)):
                out[i] = part.reshape(ranks * rows, *tensors[i].shape[1:])
        return out

    def _shard_rows(self, idx: np.ndarray, weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """This rank's contiguous slice of a global batch."""
        step = len(idx) // self._data_size
        sl = slice(self._data_index * step, (self._data_index + 1) * step)
        return idx[sl], weights[sl]

    def _any_rank(self, flag: bool, op=None) -> bool:
        """``flag`` agreed over every rank: the max (any), or the min with
        ``op=MIN`` (all)."""
        if self.world <= 1:
            return flag
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        dist.all_reduce(t, op=op or dist.ReduceOp.MAX)
        return bool(t.item())

    def _export_state(self, opt_to_cpu: bool = False) -> Dict[str, Any]:
        """``{params, batch_stats, opt_state, step}`` with full tensors (cut
        ones put together on every rank), as a checkpoint holds them."""
        state = module_state(self.model)
        opt = self.optimizer.state_dict()
        if self._rules:
            state["params"] = pmesh.gather_state(self.mesh, {k: v.to(self.device) for k, v in state["params"].items()},
                                                 self._rules, self._full_shapes)
            state["params"] = {k: v.cpu() for k, v in state["params"].items()}
            opt = {**opt, "state": {i: self._map_moments(i, s, gather=True) for i, s in opt["state"].items()}}
        if opt_to_cpu or self._rules:
            opt = host_copy(opt)
        return {**state, "opt_state": opt, "step": self.step}

    def _map_moments(self, index: int, entry: Dict[str, Any], gather: bool) -> Dict[str, Any]:
        """Adam's moments of parameter ``index`` cut (or put together) as
        its parameter is."""
        name = self._opt_names[index]
        out = dict(entry)
        for key in ("exp_avg", "exp_avg_sq"):
            if key in entry:
                t = entry[key].to(self.device)
                if gather:
                    out[key] = pmesh.gather_state(self.mesh, {name: t}, self._rules, self._full_shapes)[name]
                else:
                    out[key] = pmesh.place_state(self.mesh, {name: t}, self._rules)[name].clone()
        return out

    def load_weights(self, state: Dict[str, Any]) -> None:
        """Full ``{params, batch_stats}`` (``state_dict`` names) into the
        model, cut by the partition rules where it is."""
        params = state["params"]
        if self._rules:
            params = pmesh.place_state(self.mesh, params, self._rules)
        load_module_state(self.model, {"params": params, "batch_stats": state["batch_stats"]})

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
        """Redraw the parameters with Flax's initializers from ``seed`` (the
        whole model on every rank, then cut by the partition rules) and
        start a fresh Adam; returns the model."""
        self._unshard_model()
        flax_init_(self.model, torch.Generator().manual_seed(self.config.seed))
        self._shard_model()
        lr = self.config.learning_rate
        trainable = self.trainable_parameters()
        names = {id(p): n for n, p in self.model.named_parameters()}
        self._opt_names = [names[id(p)] for p in trainable]
        self.optimizer = torch.optim.Adam(
            trainable,
            lr=torch.tensor(lr, dtype=torch.float32, device=self.device) if self._capturable else lr,
            betas=(0.9, 0.999), eps=1e-8, weight_decay=self.config.weight_decay, capturable=self._capturable,
        )
        self.step = 0
        self._graphs.clear()
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
        """Write ``lr`` into Adam: into its LR tensor where it is capturable
        (a graph reads that tensor), else as the group's float."""
        for group in self.optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(float(lr))
            else:
                group["lr"] = float(lr)

    def _conform_optimizer(self) -> None:
        """After loading an optimizer state written with or without
        ``capturable``: this trainer's flag, its LR as a device tensor or a
        float, and the step counts on the device or the CPU."""
        for group in self.optimizer.param_groups:
            lr = float(group["lr"])
            group["capturable"] = self._capturable
            group["lr"] = torch.tensor(lr, dtype=torch.float32, device=self.device) if self._capturable else lr
        for state in self.optimizer.state.values():
            if "step" in state:
                state["step"] = state["step"].to(device=self.device if self._capturable else "cpu",
                                                 dtype=torch.float32)

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

    def _prepare_inputs(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """``device_preproc`` (e.g. the crop of full frames to lips), then
        the cast of :meth:`_prepare`."""
        if self.config.device_preproc is not None:
            with trace.span("trainer.preproc"):
                inputs = tuple(self.config.device_preproc(*inputs))
        return tuple(self._prepare(x) for x in inputs)

    def _example_weights(self, labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        return weights if self._class_weights is None else weights * self._class_weights[labels]

    def _sync_twin(self) -> None:
        """Put the twin generator where the dropout generator stands; every
        seeding or restore of the dropout generator on the host ends here."""
        if self._twin_generator is not None:
            self._twin_generator.set_state(self.dropout_generator.get_state())

    def _remat_contexts(self):
        """``torch.utils.checkpoint``'s (forward, recompute) contexts: the
        recompute's dropout modules draw from the twin generator, which
        stands where the dropout generator stood when the forward began, and
        the BatchNorm statistics are kept as the forward left them, so it
        draws the forward's masks, leaves the dropout generator where the
        forward left it and moves no statistic twice. No state is read or
        set on the host: a CUDA graph captures it."""
        buffers = list(self.model.buffers())

        @contextlib.contextmanager
        def recompute():
            kept = [b.clone() for b in buffers]
            for m in self._dropouts:
                m.generator = self._twin_generator
            try:
                yield
            finally:
                for m in self._dropouts:
                    m.generator = self.dropout_generator
                with torch.no_grad():
                    for b, k in zip(buffers, kept):
                        b.copy_(k)

        return contextlib.nullcontext(), recompute()

    def _train_forward(self, inputs: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        module = self._train_module()

        def forward(*xs):
            return module(*xs, **self._apply_kwargs)

        if not self.config.remat:
            return forward(*inputs)
        from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

        # preserve_rng_state=False: stashing torch's default generators reads
        # their state on the host, which a capture cannot record, and nothing
        # on the path draws from them (dropout draws from the trainer's
        # generator). No early stop: the recompute draws every mask the
        # forward drew, so that the twin generator keeps in step.
        with set_checkpoint_early_stop(False):
            return checkpoint(forward, *inputs, use_reentrant=False, preserve_rng_state=False,
                              context_fn=self._remat_contexts)

    def _mixup(self, xs: Tuple[torch.Tensor, ...], labels: torch.Tensor,
               global_count: torch.Tensor) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        """The JAX step's mixup over the global batch of every data-parallel
        rank's rows: one λ and one permutation of the global rows (drawn
        alike on every rank, whose dropout generators stay in step), this
        rank's inputs and one-hot labels mixed with the global rows the
        permutation points to (``_global_rows``: the inputs and the labels,
        not their one-hot rows); unmixed unless every global row has weight
        1 (``global_count``: a weight-0 padding row would leak in)."""
        rows, cfg = labels.shape[0], self.config
        ranks = self._data_size if self._data_group is not None else 1
        lam, perm = draw_mixup(self.dropout_generator, ranks * rows, cfg.mixup_alpha, self.device)
        if self._twin_generator is not None:
            draw_mixup(self._twin_generator, ranks * rows, cfg.mixup_alpha, self.device)
        onehot = F.one_hot(labels, cfg.num_classes).to(torch.float32)
        pool = None
        if ranks > 1:
            *pool_xs, pool_labels = self._global_rows([*xs, labels.to(torch.float32)])
            pool = (pool_xs, F.one_hot(pool_labels.long(), cfg.num_classes).to(torch.float32))
            perm = perm.narrow(0, self._data_index * rows, rows)
        mixed, mixed_onehot = mixup(xs, onehot, lam, perm, pool)
        full = global_count == ranks * rows
        return tuple(torch.where(full, m, x) for m, x in zip(mixed, xs)), torch.where(full, mixed_onehot, onehot)

    def _conv_tune(self, kind: str, inputs: Sequence[torch.Tensor]):
        """Around the first step of ``kind`` ("train" or "eval") on inputs
        of a new signature, their shapes and dtypes (which fix those of the
        prepared inputs), the span ``trainer.conv_tune``, and 1 on the
        counter ``trainer.conv_tune_rounds``: the first step of a kind on
        new input shapes, where cuDNN times the engines of any convolution
        shape the process has not met (``timed_conv_engines``). Nothing
        around the steps after it. The set is this trainer's: cuDNN's own
        choices are the process's."""
        signature = (kind, *((tuple(x.shape), x.dtype) for x in inputs))
        if signature in self._stepped:
            return contextlib.nullcontext()
        self._stepped.add(signature)
        trace.count("trainer.conv_tune_rounds")
        return trace.span("trainer.conv_tune", kind=kind)

    def train_step(self, inputs: Sequence[torch.Tensor], labels: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
        """One optimizer step on this rank's slice of a batch. Returns the
        device tensor (Σ loss·w, correct, Σ weights, Σ w) of the slice;
        nothing is read back. The span ``trainer.step`` holds
        ``trainer.forward`` (inputs through the weighted loss),
        ``trainer.backward`` (and the flat all-reduce under partition rules)
        and ``trainer.optimizer``; a first step on new shapes lies in
        ``trainer.conv_tune`` (:meth:`_conv_tune`)."""
        with self._conv_tune("train", inputs), trace.span("trainer.step"):
            self.model.train()
            if self._pp:
                return self._pp_train_step(inputs, labels, weights)
            with model_precision(self.compute_dtype), timed_conv_engines():
                with trace.span("trainer.forward"):
                    xs = self._prepare_inputs(inputs)
                    w = self._example_weights(labels, weights)
                    wsum = w.sum()
                    # one all-reduce: Σw, and the weights' count that says
                    # whether the global batch is full (mixup)
                    global_wsum, global_count = self._global_sums(wsum, weights.sum())
                    target = labels
                    if self.config.mixup_alpha > 0:
                        xs, target = self._mixup(xs, labels, global_count)
                    logits = self._train_forward(xs).float()
                    ce_w = (F.cross_entropy(logits, target, reduction="none") * w).sum()
                with trace.span("trainer.backward"):
                    self.optimizer.zero_grad(set_to_none=True)
                    (ce_w / global_wsum.clamp_min(1e-9)).backward()
                    if self._rules and self._data_group is not None:
                        pmesh.all_reduce_flat([p.grad for p in self._grads()], self._data_group)
            with trace.span("trainer.optimizer"):
                self.optimizer.step()
            self.step += 1
            with torch.no_grad():
                correct = ((logits.argmax(-1) == labels).float() * weights).sum()
                return torch.stack([ce_w.detach(), correct, weights.sum(), wsum])

    def _grads(self) -> List[nn.Parameter]:
        """Adam's parameters, a zero gradient given to any that got none."""
        params = [p for group in self.optimizer.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return params

    def _pp_train_step(self, inputs: Sequence[torch.Tensor], labels: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
        """The GPipe step (``parallel/pipeline.py``) and Adam."""
        from multimodal_lipread_torch.parallel.pipeline import gpipe_train_step, reduce_grads

        with model_precision(self.compute_dtype), timed_conv_engines():
            (ids,) = self._prepare_inputs(inputs)
            w = self._example_weights(labels, weights)
            self.optimizer.zero_grad(set_to_none=True)
            stats = gpipe_train_step(self.model, ids, labels, weights, w, self._global_sums(w.sum())[0], self.mesh,
                                     self.model.num_microbatches)
            reduce_grads(self.model, self.mesh)
        with trace.span("trainer.optimizer"):
            self.optimizer.step()
        self.step += 1
        return stats

    @torch.no_grad()
    def eval_step(self, inputs: Sequence[torch.Tensor], labels: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
        """Forward in eval mode (running BatchNorm statistics); returns the
        device tensor (Σ loss·w, correct, Σ weights, Σ w)."""
        self.model.eval()
        with self._conv_tune("eval", inputs), model_precision(self.compute_dtype), timed_conv_engines():
            logits = self.model(*self._prepare_inputs(inputs), **self._apply_kwargs).float()
        w = self._example_weights(labels, weights)
        ce = F.cross_entropy(logits, labels, reduction="none")
        correct = ((logits.argmax(-1) == labels).float() * weights).sum()
        return torch.stack([(ce * w).sum(), correct, weights.sum(), w.sum()])

    def train_step_idx(self, data: Tuple[torch.Tensor, ...], labels_all: torch.Tensor, idx: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
        """:meth:`train_step` on the rows ``idx`` of a device-resident dataset."""
        return self.train_step(tuple(d[idx] for d in data), labels_all[idx], weights)

    def eval_step_idx(self, data: Tuple[torch.Tensor, ...], labels_all: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
        return self.eval_step(tuple(d[idx] for d in data), labels_all[idx], weights)

    # ------------------------------------------------------------ batching

    def _index_batches_host(self, n: int, shuffle: bool, rng: np.random.Generator):
        """Yield (int64 indices, float32 weights) of fixed-size batches over
        ``n`` examples; a short last batch is padded with real examples at
        weight 0. Every rank draws the same global batch and keeps its
        slice."""
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
            yield self._shard_rows(idx.astype(np.int64), weights)

    def host_batches(self, ds: ArrayDataset, shuffle: bool, rng: np.random.Generator):
        """Yield fixed-size numpy batches ``(inputs, labels, weights)``; a
        short last batch is padded with real examples at weight 0."""
        for idx, weights in self._index_batches_host(len(ds), shuffle, rng):
            yield tuple(a[idx] for a in ds.inputs), ds.labels[idx].astype(np.int64), weights

    def stream_batch_rows(self) -> int:
        """Rows a rank loads per step from its own shard of a streaming
        dataset: ``batch_size / world``."""
        if self.batch_size % self.world:
            raise ValueError(f"batch_size {self.batch_size} must be divisible by the world size {self.world} "
                             "for streaming (each rank loads batch_size/world records per step)")
        if self._data_size != self.world:
            raise NotImplementedError("streaming feeds data parallelism only, not tensor or pipeline parallelism")
        return self.batch_size // self.world

    def stream_batches(self, ds: Any, epoch: int, shuffle: bool):
        """Yield fixed-size numpy batches of a ``StreamingDataset``'s epoch
        (this rank's shard, ``stream_batch_rows`` a step): a short loader
        batch is padded by repeating its own rows (``np.resize``) at weight
        0, and a shard with fewer batches than the largest emits
        all-weight-0 batches up to ``global_batches``."""
        bs = self.stream_batch_rows()
        emitted, last = 0, None
        for inputs, labels in ds.epoch_batches(epoch, shuffle, bs):
            k = len(labels)
            weights = np.zeros((bs,), np.float32)
            weights[:k] = 1.0
            if k < bs:
                fill = np.resize(np.arange(k), bs - k)
                inputs = tuple(np.concatenate([a, a[fill]], axis=0) for a in inputs)
                labels = np.concatenate([labels, labels[fill]], axis=0)
            emitted += 1
            last = (inputs, labels.astype(np.int64))
            yield inputs, last[1], weights
        while emitted < ds.global_batches(bs):
            if last is None:
                last = (tuple(ds.example_inputs(bs)), np.zeros((bs,), np.int64))
            emitted += 1
            yield last[0], last[1], np.zeros((bs,), np.float32)

    def batches(self, ds: Any, shuffle: bool, rng: np.random.Generator, epoch: int = 0):
        """``host_batches`` (an ``ArrayDataset``) or ``stream_batches`` (a
        ``StreamingDataset``) on the device: gathered (and pinned, for a
        card) ``host_prefetch`` batches ahead, copied without blocking."""
        pin = self.device.type == "cuda"
        source = (self.host_batches(ds, shuffle, rng) if isinstance(ds, ArrayDataset)
                  else self.stream_batches(ds, epoch, shuffle))

        def host():
            for inputs, labels, weights in source:
                ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in (*inputs, labels, weights)]
                yield [t.pin_memory() for t in ts] if pin else ts

        for ts in _host_prefetch_iter(host(), self.config.host_prefetch):
            ts = [t.to(self.device, non_blocking=True) for t in ts]
            yield tuple(ts[:-2]), ts[-2], ts[-1]

    def _device_dataset(self, ds: ArrayDataset) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        """``ds`` on the device, placed once: a cache of three (the run's
        train, val and test), held by identity (an ``id`` alone can be
        reused once its dataset is gone); the oldest goes first, with its
        graphs. Placing is the span ``data.resident_place``, its bytes the
        counter ``data.resident_bytes``."""
        entry = self._device_data.get(id(ds))
        if entry is None or entry[0] is not ds:
            self._drop_graphs(id(ds))
            with trace.span("data.resident_place"):
                data = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in ds.inputs)
                labels = torch.from_numpy(ds.labels.astype(np.int64)).to(self.device)
            trace.count("data.resident_bytes", sum(t.numel() * t.element_size() for t in (*data, labels)))
            entry = self._device_data[id(ds)] = (ds, (data, labels))
            while len(self._device_data) > 3:
                oldest = next(iter(self._device_data))
                del self._device_data[oldest]
                self._drop_graphs(oldest)
        return entry[1]

    def _drop_graphs(self, ds_id: int) -> None:
        for key in [k for k in self._graphs if k[1] == ds_id]:
            del self._graphs[key]

    def _index_groups(self, n: int, shuffle: bool, rng: np.random.Generator):
        """``_index_batches_host`` in groups of K = ``steps_per_dispatch``:
        ``("group", (idxs (K, bs), weights (K, bs)))``, and a last group of
        fewer than K as ``("tail", [(idx, weights), ...])``, which runs step
        by step (padding it with weight-0 batches would still move Adam's
        moments and the weight decay)."""
        k = self.config.steps_per_dispatch
        buf: list = []
        for pair in self._index_batches_host(n, shuffle, rng):
            buf.append(pair)
            if len(buf) == k:
                yield "group", (np.stack([b[0] for b in buf]), np.stack([b[1] for b in buf]))
                buf = []
        if buf:
            yield "tail", buf

    def _to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        return [torch.from_numpy(a).to(self.device, non_blocking=True) for a in arrays]

    def _run_group(self, kind: str, ds: ArrayDataset, step: Callable, idxs: np.ndarray,
                   ws: np.ndarray) -> torch.Tensor:
        """K steps of ``step`` on one group, in the span ``trainer.group``:
        eagerly on the CPU; on the card through the dataset's graph, captured
        after running the first group for real (a replay runs no span).
        Returns the group's (K, 4) stats. Of train groups, the counter
        ``trainer.eager_steps`` counts the steps of those run eagerly (the
        first, and every one on the CPU) and ``trainer.replays`` the
        replays."""
        with trace.span("trainer.group", kind=kind, steps=len(idxs)):
            train = kind == "train"
            if self.device.type != "cuda" or (train and self._ddp_warming()):
                if train:
                    trace.count("trainer.eager_steps", len(idxs))
                return torch.stack([step(*self._to_device(i, w)) for i, w in zip(idxs, ws)])
            key = (kind, id(ds))
            graph = self._graphs.get(key)
            if graph is None:
                generators = [g for g in (self.dropout_generator, self._twin_generator) if g is not None]
                steps_before = self.step
                graph = _StepGroupGraph(step, idxs, ws, self.device, generators if train else ())
                self.step = steps_before + (len(idxs) if train else 0)  # capture ran no step
                self._graphs[key] = graph
                if train:
                    trace.count("trainer.eager_steps", len(idxs))
                return graph.first
            if train:
                self.step += len(idxs)
                trace.count("trainer.replays")
            return graph.replay(idxs, ws)

    def _ddp_warming(self) -> bool:
        """Whether the train steps go through DDP and it has taken fewer
        than 11: DDP times its first 10 steps with CUDA events, which a
        graph capture cannot record, so groups run eagerly until then."""
        return self.mesh is not None and not self._rules and self._ddp_steps < 11

    def _graphed(self, ds: Any) -> bool:
        """Whether training on ``ds`` dispatches K steps at a time."""
        cfg = self.config
        return (isinstance(ds, ArrayDataset) and cfg.device_resident and cfg.steps_per_dispatch > 1
                and self._lr_step_fn is None)

    # ------------------------------------------------------------ epochs

    def train_single_batch(self, ds: ArrayDataset, seed: int = 0) -> float:
        """One optimizer step on the first (unshuffled) batch of ``ds``;
        returns its loss (over every rank's slice)."""
        self.ensure_initialized()
        self.dropout_generator.manual_seed(seed)
        self._sync_twin()
        inputs, labels, weights = next(self.batches(ds, False, np.random.default_rng(seed)))
        stats = self.train_step(inputs, labels, weights).double()
        if self._data_group is not None:
            dist.all_reduce(stats, group=self._data_group)
        loss_sum, _correct, _n, wsum = stats.tolist()
        return loss_sum / max(wsum, 1e-9)

    def train_epoch(self, ds: Any, rng: np.random.Generator, epoch: int = 0) -> EpochMetrics:
        """One epoch of ``ds``; stops between dispatches once a preemption
        is requested (in a world of one: several ranks finish the epoch and
        agree in ``fit``)."""
        acc = _Metrics(self.device, self._data_group)
        if isinstance(ds, ArrayDataset) and self.config.device_resident:
            data, labels_all = self._device_dataset(ds)

            def step(idx, weights):
                return self.train_step_idx(data, labels_all, idx, weights)

            if self._graphed(ds):
                for kind, payload in self._index_groups(len(ds), True, rng):
                    if self._preempted and self.world == 1:
                        break
                    if kind == "group":
                        acc.push(self._run_group("train", ds, step, *payload))
                        continue
                    for idx, weights in payload:
                        if self._preempted and self.world == 1:
                            break
                        acc.push(step(*self._to_device(idx, weights)))
                return acc.result()
            for idx, weights in self._index_batches_host(len(ds), True, rng):
                if self._preempted and self.world == 1:
                    break
                if self._lr_step_fn is not None:
                    self._set_lr(self._lr_step_fn(self.step))
                acc.push(step(*self._to_device(idx, weights)))
            return acc.result()
        for inputs, labels, weights in self.batches(ds, True, rng, epoch):
            if self._preempted and self.world == 1:
                break
            if self._lr_step_fn is not None:
                self._set_lr(self._lr_step_fn(self.step))
            acc.push(self.train_step(inputs, labels, weights))
        return acc.result()

    def evaluate(self, ds: Any) -> EpochMetrics:
        acc = _Metrics(self.device, self._data_group)
        rng = np.random.default_rng(0)
        if isinstance(ds, ArrayDataset) and self.config.device_resident:
            data, labels_all = self._device_dataset(ds)

            def step(idx, weights):
                return self.eval_step_idx(data, labels_all, idx, weights)

            if self.config.steps_per_dispatch > 1:
                for kind, payload in self._index_groups(len(ds), False, rng):
                    if kind == "group":
                        acc.push(self._run_group("eval", ds, step, *payload))
                    else:
                        for idx, weights in payload:
                            acc.push(step(*self._to_device(idx, weights)))
                return acc.result()
            for idx, weights in self._index_batches_host(len(ds), False, rng):
                acc.push(step(*self._to_device(idx, weights)))
            return acc.result()
        for inputs, labels, weights in self.batches(ds, False, rng):
            acc.push(self.eval_step(inputs, labels, weights))
        return acc.result()

    # ------------------------------------------------------------ checkpoints

    def _ckpt_path(self, kind: str) -> str:
        os.makedirs(self.config.checkpoints_dir, exist_ok=True)
        suffix = "orbax" if self.config.checkpoint_backend in ORBAX_BACKENDS else "pt"
        return os.path.join(self.config.checkpoints_dir, f"{self.config.model_name}_{kind}.{suffix}")

    def _save_ckpt(self, path: str, tree: Dict[str, Any]) -> None:
        backend = self.config.checkpoint_backend
        if backend in ORBAX_BACKENDS:
            save_checkpoint_orbax(path, tree, async_save=backend == "orbax_async")
        else:
            save_checkpoint(path, tree)

    def _load_ckpt(self, path: str, keys: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        """The checkpoint at ``path``; the ``.orbax`` read takes only
        ``keys`` where given (the ``.pt`` file is read whole)."""
        if self.config.checkpoint_backend in ORBAX_BACKENDS:
            return load_checkpoint_orbax(path, keys)
        return load_checkpoint(path)

    def _scheduler_fields(self) -> Dict[str, Any]:
        s = self.scheduler
        return {
            "scheduler_lr": float(s.lr),
            "scheduler_best": float(s.best if s.best is not None else 0.0),
            "scheduler_has_best": s.best is not None,
            "scheduler_bad_epochs": int(s.num_bad_epochs),
        }

    def checkpoint_tree(self, epoch: int, val_acc: float, best_val_acc: float) -> Dict[str, Any]:
        return {
            "epoch": epoch,
            "state": self._export_state(),
            "val_acc": float(val_acc),
            **self._scheduler_fields(),
            "best_val_acc": float(best_val_acc),
            "dropout_rng": self.dropout_generator.get_state(),
            **self._classes_field(),
        }

    def _classes_field(self) -> Dict[str, Any]:
        names = self.config.class_names
        return {} if names is None else {"classes": list(names)}

    def _host_snapshot(self) -> Dict[str, Any]:
        """The trainer's state on the host: ``state`` as a checkpoint holds
        it (parameters, statistics, Adam, step count) and the dropout
        generator's state."""
        return {"state": self._export_state(opt_to_cpu=True), "dropout_rng": self.dropout_generator.get_state()}

    def restore_state(self, state: Dict[str, Any]) -> None:
        """Load ``{params, batch_stats, opt_state, step}`` into the model and
        the optimizer (a state written with or without ``capturable``, at
        any world size: full tensors, cut here by the partition rules)."""
        self.ensure_initialized()
        self.load_weights(state)
        opt = state["opt_state"]
        if self._rules:
            opt = {**opt, "state": {i: self._map_moments(int(i), s, gather=False) for i, s in opt["state"].items()}}
        self.optimizer.load_state_dict(opt)
        self._conform_optimizer()
        self.step = int(state["step"])
        self._graphs.clear()  # they hold the replaced optimizer state

    @contextlib.contextmanager
    def _weights_of(self, state: Dict[str, Any]):
        """The model holds ``state``'s parameters and buffers inside the
        block and its own again after it (copied in place, so graphs stay
        valid)."""
        own = {k: v.clone() for k, v in self.model.state_dict().items()}
        self.load_weights(state)
        try:
            yield
        finally:
            self.model.load_state_dict(own)

    # ------------------------------------------------------------ preemption

    def request_preemption(self) -> None:
        """Ask a running ``fit`` to stop: the step in flight finishes, the
        checkpoint is written, and ``fit`` returns with ``preempted=True``.
        Safe to call from a signal handler or another thread."""
        self._preempted = True

    def _install_preemption_handlers(self) -> Callable[[], None]:
        """SIGTERM and SIGINT → ``request_preemption``; returns the undo.
        Nothing is installed outside the main thread (signal's rule)."""
        import signal
        import threading

        if threading.current_thread() is not threading.main_thread():
            return lambda: None
        previous = {sig: signal.signal(sig, lambda _signum, _frame: self.request_preemption())
                    for sig in (signal.SIGTERM, signal.SIGINT)}

        def restore():
            for sig, old in previous.items():
                signal.signal(sig, old)

        return restore

    # ------------------------------------------------------------ fit

    def _build_lr_schedule(self, train_ds: Any) -> None:
        cfg = self.config
        if isinstance(train_ds, ArrayDataset):
            steps_per_epoch = max(1, -(-len(train_ds) // self.batch_size))
        else:
            # every rank's schedule: the collective step count, not its
            # own shard's length (ceil-split shards differ by a record)
            steps_per_epoch = max(1, int(train_ds.global_batches(self.stream_batch_rows())))
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
        train_ds: Any,
        val_ds: Any,
        test_ds: Optional[Any] = None,
        resume: bool = False,
        progress: Optional[Callable[[str], None]] = print,
    ) -> Dict[str, Any]:
        """Full training run on ``ArrayDataset``s or ``StreamingDataset``s;
        returns the history and the final (best-checkpoint) test metrics,
        or ``preempted=True`` when a preemption stopped it."""
        cfg = self.config
        self.ensure_initialized()
        self._build_lr_schedule(train_ds)
        if cfg.steps_per_dispatch > 1 and not (cfg.device_resident and isinstance(train_ds, ArrayDataset)):
            warnings.warn(
                "training.steps_per_dispatch > 1 has no effect here: the grouped dispatch path needs a "
                "device_resident ArrayDataset — training falls back to per-step dispatch",
                stacklevel=2,
            )
        if self._lr_step_fn is not None and cfg.steps_per_dispatch > 1:
            warnings.warn(
                "training.steps_per_dispatch > 1 is ignored with a per-step LR schedule (linear_warmup / "
                "warmup_epochs): the LR cannot change inside a grouped dispatch — training falls back to "
                "per-step dispatch",
                stacklevel=2,
            )
        if (self.mesh is not None and self.device.type == "cuda" and self._graphed(train_ds)
                and dist.get_backend() != "nccl"):
            raise NotImplementedError(
                f"training.steps_per_dispatch > 1 over {dist.get_backend()} on the card: its collectives run on "
                "the host and cannot be captured in a CUDA graph (ROADMAP.md, Queue 3 #16)"
            )
        self._preempted = False
        restore_signals = self._install_preemption_handlers() if cfg.handle_preemption else (lambda: None)
        try:
            return self._fit_loop(train_ds, val_ds, test_ds, resume, progress)
        finally:
            restore_signals()
            if cfg.checkpoint_backend == "orbax_async":
                wait_for_async_saves()  # a returned run is on disk

    def _train_epoch_traced(self, train_ds: Any, rng: np.random.Generator, epoch: int) -> EpochMetrics:
        """``train_epoch`` under ``torch.profiler`` (CPU, and CUDA on a card),
        its Chrome trace written into ``profile_dir``."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        with profile(activities=activities) as prof:
            metrics = self.train_epoch(train_ds, rng, epoch)
        os.makedirs(self.config.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.config.profile_dir,
                                              f"{self.config.model_name}_epoch{epoch}.trace.json"))
        return metrics

    def _fit_loop(self, train_ds, val_ds, test_ds, resume, progress) -> Dict[str, Any]:
        cfg = self.config
        self.dropout_generator.manual_seed(cfg.seed + 1)
        self._sync_twin()
        self._graphs.clear()  # captured against another run's generator state
        start_epoch = 1
        best_val_acc = -1.0
        rolling_path = self._ckpt_path("checkpoint")
        best_path = self._ckpt_path("best")
        if resume and os.path.exists(rolling_path):
            ckpt = self._load_ckpt(rolling_path)
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
            self._sync_twin()
            self._set_lr(self.scheduler.lr)
            if progress:
                progress(f"Resumed from {rolling_path} at epoch {start_epoch}")

        data_rng = np.random.default_rng(cfg.seed)
        # each completed epoch drew one permutation: skip them on resume (a
        # streaming dataset seeds its own epochs)
        if isinstance(train_ds, ArrayDataset):
            for _ in range(start_epoch - 1):
                data_rng.permutation(len(train_ds))
        history: List[Dict[str, float]] = []
        for epoch in range(start_epoch, cfg.epochs + 1):
            t0 = time.time()
            # the epoch's start on the host: a preemption saves it, labelled
            # epoch - 1, and --resume replays this epoch from it exactly
            boundary = self._host_snapshot() if cfg.handle_preemption else None
            if cfg.profile_dir is not None and epoch == start_epoch:
                tr = self._train_epoch_traced(train_ds, data_rng, epoch)
            else:
                tr = self.train_epoch(train_ds, data_rng, epoch)
            if cfg.handle_preemption and self.world > 1:
                # every rank must stop, or the others hang in the next
                # collective: any rank's preemption preempts them all
                self._preempted = self._any_rank(self._preempted)
            if self._preempted:
                # without handle_preemption there is no snapshot: the current
                # state is saved (a valid checkpoint, an approximate replay)
                snap = boundary if boundary is not None else self._host_snapshot()
                self._save_ckpt(rolling_path, {
                    "epoch": epoch - 1, "state": snap["state"], "val_acc": float(best_val_acc),
                    **self._scheduler_fields(), "best_val_acc": float(best_val_acc),
                    "dropout_rng": snap["dropout_rng"], **self._classes_field(),
                })
                if progress:
                    progress(f"Preempted during epoch {epoch}; checkpoint saved to {rolling_path} "
                             f"(resume replays epoch {epoch})")
                return {"history": history, "best_val_acc": best_val_acc, "preempted": True}
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
                    self._save_ckpt(best_path, ckpt)
                if cfg.rolling_checkpoint:
                    self._save_ckpt(rolling_path, ckpt)

        result: Dict[str, Any] = {"history": history, "best_val_acc": best_val_acc}
        if cfg.checkpoint_backend == "orbax_async":
            wait_for_async_saves()  # the best checkpoint may still be writing
        # evaluate() is collective: every rank takes the same branch
        have_best = self._any_rank(os.path.exists(best_path), op=dist.ReduceOp.MIN)
        if test_ds is not None and have_best:
            with self._weights_of(self._load_ckpt(best_path, ("state.params", "state.batch_stats"))["state"]):
                final = self.evaluate(test_ds)
            self.logger.log_final(final.loss, final.acc)
            result["final_test_loss"] = final.loss
            result["final_test_acc"] = final.acc
            result["best_checkpoint"] = best_path
            if progress:
                progress(f"Final Test Loss: {final.loss:.4f}, Final Test Acc: {final.acc:.2f}%")
        return result
