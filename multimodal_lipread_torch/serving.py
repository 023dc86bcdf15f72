"""Inference / serving of the seven pipelines: audio, video, audio_video,
cues, audio_cues, cues_video and audio_cues_video (counterpart of the JAX
package's ``serving.py``).

- ``Predictor``: a trained model from a checkpoint, in eval mode on one
  device; serves any number of inputs in fixed-size batches, padding the
  last one; uint8 inputs cross to the device as they are and are scaled
  to [0, 1] there.
- ``predict_audio_clips``: WAV files → host decode (the threaded native
  decoder) → log-mel on the device (the CUDA kernel of
  ``ops/logmel_cuda.py``) → classifier.
- ``predict_clips``: any ported pipeline, per-clip groups of files →
  featurize (``_featurize_modalities``) → classify; for ``video`` the
  lip-region ``.npy`` files, kept uint8 up to the device; for
  ``audio_video`` a WAV and a ``.npy`` per clip, the WAV through the host
  decode and the log-mel kernel on the predictor's device; for ``cues`` a
  text file per clip, featurized as the model's training pipeline does
  (token ids for BERT, cached sentence or token embeddings otherwise; the
  TF-IDF ``linear`` model fits its vocabulary on the training corpus and
  is refused, as in the JAX package); for ``audio_cues`` a WAV and a text
  file per clip (log-mel kernel and ``dataset.embed_model`` embeddings);
  for ``cues_video`` a text file and a ``.npy`` per clip, for
  ``audio_cues_video`` a WAV, a text file and a ``.npy`` (the JAX order of
  ``_PIPELINE_INPUTS``).
- a CLI: ``python -m multimodal_lipread_torch.serving --pipeline
  <pipeline> --config <yaml> --checkpoint <path> [--export PATH.pt2]
  <clips...>`` → JSON predictions (WAV files for audio, lip-region ``.npy`` files for video,
  ``clip.wav,clip.npy`` groups for audio_video, cue ``.txt`` files for
  cues, ``clip.wav,cue.txt`` groups for audio_cues, ``cue.txt,lips.npy``
  groups for cues_video, ``clip.wav,cue.txt,lips.npy`` groups for
  audio_cues_video).

The audio features are taken at the time steps the pipeline's training
reads: ``dataset.audio_input_size`` for audio_video (the JAX package's
serving reads ``dataset.input_size`` there; ROADMAP.md Queue 3 notes it),
``dataset.input_size`` for audio_cues and audio_cues_video.

``Predictor(device_preproc=...)`` runs a function on the device batch
before the cast, as the trainer's ``device_preproc`` does: with
``ops/crop_resize_cuda.device_crop`` a video predictor serves full decoded
frames and lip boxes, the crop kernel cutting the lips on the card.

A ``.pt`` checkpoint is read memory-mapped and only its ``state`` is
touched (Adam's moments stay on disk); of a ``.orbax`` directory (the
``orbax`` / ``orbax_async`` checkpoint backends) only the weights and
``classes`` are read. The model is built on the ``meta`` device and
takes the checkpoint's tensors as they are (``load_state_dict(assign=True)``),
then moves to the card from pinned memory. A checkpoint that names its
label space (``classes``, written by the port's trainer) sizes the head and
names the served words; an older one falls back to ``dataset.num_classes``
and the words under ``dataset.root_dir``. Request lips load through the
threaded native ``.npy`` loader.

- ``load_test``: p50/p90/p99 request latency and clips/s of a resident
  ``Predictor`` under concurrent client threads.
- ``export_pipeline`` (CLI ``--export PATH.pt2``): the inference graph of a
  checkpoint through ``torch.export``, saved with ``torch.export.save`` (the
  counterpart of the JAX package's StableHLO export).
- data-parallel serving (the JAX ``Predictor.mesh``, CLI
  ``--data-parallel``): ``Predictor(..., devices=[...])`` holds one replica
  of the model per device in one process and splits every fixed batch
  evenly over them (a batch size the replica count does not divide
  raises); the logits are put back together in order and equal
  single-device serving. ``replica_devices`` lists every local card.

On a card a ``Predictor`` serves each fixed batch of a signature (the
shapes and dtypes of the inputs) after its first request as one CUDA
graph replay per replica. The first request runs eagerly, as on the CPU,
so a predictor built for one call (the ``predict_*`` paths) never
captures. At the first batch of a later request each replica, with the
predictor's other batches held back, runs the forward eagerly on a stream
of its own (so cuDNN's and cuBLAS's workspaces, the LSTM's flat weights
and the log-mel kernel's scratch of that stream exist) and captures it
there, thread-locally, under the request's precision: the cast, the
``device_preproc`` and the model. Later batches copy their rows into
pinned host tensors (padding rows zeroed in place), and under the
replica's lock copy them in, replay the graph and copy the logits back
into a pinned tensor, all on the replica's stream; the wait for the copy
back comes after the lock is released and every replica has been
launched. Each replica keeps its stream, its lock and, per signature of
its share, the device inputs, the graph and its output, in one memory
pool a replica. A forward that cannot be captured (one that waits for the
card) stays eager at that signature, with one warning. The spans
(``utils/trace.py``) of a replayed batch: ``serve.pad`` the zero fill,
``serve.h2d`` the rows, the wait for the lock and the copy in,
``serve.forward`` the replay, ``serve.d2h`` the copy back and the wait
for it; the counter ``serve.replays`` counts the replicas' batches that a
replay served.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import itertools
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_lipread_torch.train.checkpoint import SERVING_KEYS, is_orbax_path, load_checkpoint_orbax
from multimodal_lipread_torch.utils import trace
from multimodal_lipread_torch.utils.precision import compute_dtype, model_precision


def read_checkpoint(ckpt_path: str) -> Tuple[Dict[str, Dict[str, torch.Tensor]], Optional[List[str]]]:
    """A checkpoint's ``state`` (``{params, batch_stats, ...}``) and its
    ``classes`` (``None`` where it names none). A ``.pt`` file is read
    memory-mapped (only the tensors a caller touches are read from disk);
    of a ``.orbax`` directory only ``state.params``, ``state.batch_stats``
    and ``classes`` are read (``train/checkpoint.SERVING_KEYS``)."""
    if is_orbax_path(ckpt_path):
        tree = load_checkpoint_orbax(ckpt_path, SERVING_KEYS)
    else:
        tree = torch.load(ckpt_path, map_location="cpu", weights_only=True, mmap=True)
    return tree["state"], tree.get("classes")


def assign_state(model: nn.Module, state: Dict[str, Dict[str, torch.Tensor]], device: str) -> nn.Module:
    """``{params, batch_stats}`` into ``model`` (built on any device, the
    ``meta`` device included): the module takes the state's tensors as they
    are (``assign=True``; each parameter keeps its ``requires_grad``), every
    name must match, and the model moves to ``device``, on a card from
    pinned memory."""
    tensors = {**state["params"], **state["batch_stats"]}
    if torch.device(device).type == "cuda":
        tensors = {k: v.pin_memory() for k, v in tensors.items()}
    model.load_state_dict(tensors, strict=True, assign=True)
    left = [n for n, t in itertools.chain(model.named_parameters(), model.named_buffers()) if t.is_meta]
    if left:
        raise ValueError(f"the checkpoint leaves {len(left)} tensors of the model unset, e.g. {left[0]}")
    model.to(device, non_blocking=True)
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(torch.device(device)).synchronize()
    return model


def load_model(build: Callable[[Optional[int]], nn.Module], ckpt_path: str,
               device: str) -> Tuple[nn.Module, Optional[List[str]]]:
    """``build(num_classes)`` on the ``meta`` device, at the checkpoint's
    class count where it names its classes (``None`` otherwise), with the
    checkpoint's state on ``device`` (:func:`assign_state`); returns the
    model and the checkpoint's classes."""
    state, classes = read_checkpoint(ckpt_path)
    with torch.device("meta"):
        model = build(len(classes) if classes else None)
    return assign_state(model, state, device), classes


def _cast(t: torch.Tensor) -> torch.Tensor:
    """uint8 inputs (lip tensors) are scaled to [0, 1] on the device, int16
    waveforms cast to float32 there; int32 token ids stay as they are."""
    if t.dtype == torch.uint8:
        return t.to(torch.float32) / 255.0
    if t.dtype == torch.int16:
        return t.to(torch.float32)
    return t


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → device tensor, cast there (:func:`_cast`): uint8 crosses
    at 1/4 of the float bytes, int16 at 1/2."""
    return _cast(torch.from_numpy(np.ascontiguousarray(x)).to(device))


def replica_devices(device: str = "cuda") -> List[str]:
    """The devices of data-parallel serving: every local card, or the one
    CPU for ``device`` "cpu"."""
    if torch.device(device).type != "cuda":
        return ["cpu"]
    if not torch.cuda.device_count():
        raise ValueError("data-parallel serving on the card: no card visible")
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


@dataclasses.dataclass
class _Fixed:
    """A card replica's buffers for one signature of its share of a fixed
    batch: the device inputs that the copies in fill and, once captured,
    the CUDA graph of the forward on them and its output; ``eager`` once
    the capture failed."""

    inputs: Tuple[torch.Tensor, ...]
    graph: Optional[torch.cuda.CUDAGraph] = None
    out: Optional[torch.Tensor] = None
    eager: bool = False


class _Gate:
    """Batches in flight together, or one alone: :meth:`alone` waits for the
    batches in flight to end and holds new ones back."""

    def __init__(self):
        self.cond = threading.Condition()
        self.among_n = 0  # batches in flight
        self.held = False  # a batch alone
        self.asking = 0  # batches waiting to run alone

    @contextlib.contextmanager
    def among(self):
        with self.cond:
            self.cond.wait_for(lambda: not self.held and not self.asking)
            self.among_n += 1
        try:
            yield
        finally:
            with self.cond:
                self.among_n -= 1
                self.cond.notify_all()

    @contextlib.contextmanager
    def alone(self):
        with self.cond:
            self.asking += 1
            self.cond.wait_for(lambda: not self.held and not self.among_n)
            self.asking -= 1
            self.held = True
        try:
            yield
        finally:
            with self.cond:
                self.held = False
                self.cond.notify_all()


class _Replica:
    """One copy of the model on one device, with the predictor's
    ``preproc``. On a card it serves its share of a graphed batch on a
    stream of its own (made at its first such batch), one batch at a time
    under its lock, from a :class:`_Fixed` per signature (the shapes and
    dtypes of the share); its CUDA graphs share one memory pool."""

    def __init__(self, model: nn.Module, device: torch.device, preproc: Optional[Callable[..., tuple]]):
        self.model, self.device, self.preproc = model, device, preproc
        self.stream = None
        self.lock = threading.Lock()
        self.fixed: Dict[tuple, _Fixed] = {}
        self.pool: Optional[tuple] = None

    def forward(self, *xs: torch.Tensor) -> torch.Tensor:
        """Float32 logits of a device batch: the preproc, the cast, the model."""
        if self.preproc is not None:  # zero boxes pad to blank frames
            xs = tuple(self.preproc(*xs))
        return self.model(*(_cast(x) for x in xs)).float()

    def ready(self, key: tuple) -> bool:
        """Whether a share of signature ``key`` would neither capture nor try to."""
        fixed = self.fixed.get(key)
        return fixed is not None and (fixed.graph is not None or fixed.eager)

    def launch(self, hosts: Tuple[torch.Tensor, ...],
               rows: Tuple[np.ndarray, ...]) -> Tuple[torch.Tensor, torch.cuda.Event]:
        """Enqueue the share on the card: ``rows`` into the pinned ``hosts``
        (whose other rows are zero), the copy in, the forward (at the
        signature's first share here eager, then captured; replayed from
        then on; eager for good where it could not be captured) and the
        copy back into a pinned tensor; returns that tensor and the event
        that marks it written. Spans: ``serve.h2d`` (the rows, the wait for
        the lock, the copy in), ``serve.forward`` (the replay, or the eager
        launches and the capture) and ``serve.d2h`` (the copy back's
        launch)."""
        with contextlib.ExitStack() as held:
            with trace.span("serve.h2d"):
                for h, a in zip(hosts, rows):
                    h.numpy()[: a.shape[0]] = a
                held.enter_context(self.lock)
                if self.stream is None:
                    self.stream = torch.cuda.Stream(self.device)
                    self.stream.wait_stream(torch.cuda.current_stream(self.device))
                held.enter_context(torch.cuda.stream(self.stream))
                key = tuple((tuple(h.shape), h.dtype) for h in hosts)
                fixed = self.fixed.get(key)
                first = fixed is None
                if first:
                    fixed = self.fixed[key] = _Fixed(tuple(torch.empty_like(h, device=self.device) for h in hosts))
                for x, h in zip(fixed.inputs, hosts):
                    x.copy_(h, non_blocking=True)
            with trace.span("serve.forward"):
                if fixed.graph is not None:
                    fixed.graph.replay()
                    trace.count("serve.replays")
                    out = fixed.out
                else:
                    out = self.forward(*fixed.inputs)
                    if first:
                        self._capture(fixed)
            with trace.span("serve.d2h"):
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.stream)
        return host, done

    def _capture(self, fixed: _Fixed) -> None:
        """Capture the forward on ``fixed.inputs`` as a CUDA graph on this
        replica's stream, after an eager forward there has made its lazily
        built state (cuDNN and cuBLAS workspaces, the LSTM's flat weights,
        the log-mel kernel's scratch of this stream). The capture is
        thread-local, so other predictors' threads may use the card
        meanwhile. A forward that cannot be captured (one that waits for the
        card) stays eager at this signature, with one warning."""
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream, capture_error_mode="thread_local"):
                out = self.forward(*fixed.inputs)
        except RuntimeError as e:  # a CUDA error of the capture (torch.AcceleratorError) among them
            warnings.warn(f"serving on {self.device}: the forward on inputs of shapes "
                          f"{[tuple(x.shape) for x in fixed.inputs]} runs eagerly, its capture as a CUDA graph "
                          f"failed: {e!r}", RuntimeWarning)
            fixed.eager = True
            return
        self.pool = self.pool or graph.pool()
        fixed.graph, fixed.out = graph, out


@dataclasses.dataclass
class Predictor:
    """Fixed-batch classifier around a model in eval mode on ``device``,
    run at its compute dtype's precision (``utils/precision.py``: no TF32
    for a float32 model). With ``devices``, one replica per device (the
    first takes the model itself) serves an equal share of every batch.
    On a card, from a signature's second request on, each replica replays
    a CUDA graph of its forward (:class:`_Replica`); a signature's first
    request, and every request on the CPU, runs the forward eagerly."""

    model: nn.Module
    batch_size: int = 32
    device: str = "cuda"
    # ``(*inputs) -> tuple(inputs)`` on the device batch before the cast,
    # e.g. ops/crop_resize_cuda.device_crop: (frames, boxes) → (lips,)
    device_preproc: Optional[Callable[..., tuple]] = None
    devices: Optional[Sequence[str]] = None

    def __post_init__(self):
        if self.devices:
            if self.batch_size % len(self.devices):
                raise ValueError(
                    f"serving batch_size={self.batch_size} must be a multiple of the {len(self.devices)} "
                    "replicas so that every device gets an equal share of the batch")
            self.device = self.devices[0]
        self.model = self.model.to(self.device).eval()
        models = [(self.model, self.device)] + [
            (copy.deepcopy(self.model).to(d).eval(), d) for d in (self.devices or [])[1:]]
        self.replicas = [_Replica(m, torch.device(d), self.device_preproc) for m, d in models]
        self.on_card = all(r.device.type == "cuda" for r in self.replicas)
        self.served: set = set()  # the input signatures of the requests served
        self.gate = _Gate()

    @classmethod
    def from_checkpoint(
        cls, model: nn.Module, ckpt_path: str, batch_size: int = 32, device: str = "cuda",
        device_preproc: Optional[Callable[..., tuple]] = None, devices: Optional[Sequence[str]] = None,
    ) -> "Predictor":
        """Restore a checkpoint (``{epoch, state, val_acc, ...}``) into
        ``model``, which may be built on the ``meta`` device
        (:func:`assign_state`)."""
        device = devices[0] if devices else device
        return cls(model=assign_state(model, read_checkpoint(ckpt_path)[0], device), batch_size=batch_size,
                   device=device, device_preproc=device_preproc, devices=devices)

    def _eager_batch(self, chunk: Tuple[np.ndarray, ...]) -> torch.Tensor:
        """One fixed batch, eagerly: ``serve.pad`` (a short batch padded
        with zero rows), then each replica on its equal share, ``serve.h2d``
        (the copy in) and ``serve.forward`` (the preproc and the model), and
        ``serve.d2h``, the copies back, which wait for the card."""
        k = chunk[0].shape[0]
        if k < self.batch_size:
            with trace.span("serve.pad"):
                chunk = tuple(np.pad(a, [(0, self.batch_size - k)] + [(0, 0)] * (a.ndim - 1)) for a in chunk)
        share = self.batch_size // len(self.replicas)
        outs = []
        for i, replica in enumerate(self.replicas):
            with trace.span("serve.h2d"):
                xs = tuple(torch.from_numpy(np.ascontiguousarray(a[i * share : (i + 1) * share])).to(replica.device)
                           for a in chunk)
            with trace.span("serve.forward"):
                outs.append(replica.forward(*xs))
        with trace.span("serve.d2h"):
            return torch.cat([o.cpu() for o in outs])

    def _graphed_batch(self, chunk: Tuple[np.ndarray, ...]) -> torch.Tensor:
        """One fixed batch on the card replicas, each launched
        (:meth:`_Replica.launch`) before any result is read, from pinned
        host tensors of ``batch_size`` rows whose padding rows are zeroed in
        place (the span ``serve.pad``); ``serve.d2h`` holds the wait for the
        copies back. The pinned tensors are freed when this returns."""
        k = chunk[0].shape[0]
        hosts = [torch.empty((self.batch_size, *a.shape[1:]), dtype=_torch_dtype(a.dtype), pin_memory=True)
                 for a in chunk]
        if k < self.batch_size:
            with trace.span("serve.pad"):
                for h in hosts:
                    h[k:].zero_()
        share = self.batch_size // len(self.replicas)
        launched = [replica.launch(tuple(h[i * share : (i + 1) * share] for h in hosts),
                                   tuple(a[i * share : (i + 1) * share] for a in chunk))
                    for i, replica in enumerate(self.replicas)]
        with trace.span("serve.d2h"):
            for _, done in launched:
                done.synchronize()
        return torch.cat([host for host, _ in launched])

    def _batch(self, chunk: Tuple[np.ndarray, ...], graphed: bool) -> torch.Tensor:
        """One fixed batch, eager or graphed, in flight together with the
        predictor's other batches, or alone where a replica will capture:
        another thread's pinned allocation, or its free of a pinned tensor
        copied on the capturing stream (which records an event there),
        would break the capture."""
        if not graphed:
            with self.gate.among():
                return self._eager_batch(chunk)
        share = self.batch_size // len(self.replicas)
        key = tuple(((share, *a.shape[1:]), _torch_dtype(a.dtype)) for a in chunk)
        with self.gate.among() if all(r.ready(key) for r in self.replicas) else self.gate.alone():
            return self._graphed_batch(chunk)

    def predict_logits(self, *inputs: np.ndarray) -> np.ndarray:
        """Any-N inputs → (N, num_classes) float32 logits via fixed-size
        batches. A call is the span ``serve.request`` (a request of its own,
        ``utils/trace.py``), holding ``serve.pad`` for a short batch,
        ``serve.h2d`` and ``serve.forward`` for each replica, and
        ``serve.d2h``, the copy back that waits for the card
        (:meth:`_eager_batch`; on a card from the signature's second
        request on, :meth:`_graphed_batch`); ``serve.rows`` and
        ``serve.rows_padded`` count the real and the padding rows sent to
        the card, and ``serve.replays`` the replicas' batches that a CUDA
        graph's replay served."""
        n = inputs[0].shape[0]
        out: List[np.ndarray] = []
        signature = tuple((a.shape[1:], a.dtype) for a in inputs)
        graphed = self.on_card and signature in self.served
        with trace.span("serve.request", new_request=True, rows=n), torch.inference_mode(), \
                model_precision(compute_dtype(self.model)):
            for start in range(0, n, self.batch_size):
                chunk = tuple(a[start : start + self.batch_size] for a in inputs)
                k = chunk[0].shape[0]
                trace.count("serve.rows", k)
                if k < self.batch_size:
                    trace.count("serve.rows_padded", self.batch_size - k)
                out.append(self._batch(chunk, graphed)[:k].numpy())
        self.served.add(signature)
        return np.concatenate(out, axis=0) if out else np.zeros((0, 0), np.float32)

    def predict(self, *inputs: np.ndarray) -> np.ndarray:
        return np.argmax(self.predict_logits(*inputs), axis=-1)


def load_test(
    predictor: Predictor,
    inputs: Sequence[np.ndarray],
    num_threads: int = 4,
    requests_per_thread: int = 25,
) -> Dict[str, Any]:
    """Concurrent requests to one resident ``Predictor`` on one card.

    ``num_threads`` client threads each send ``requests_per_thread``
    requests of ``inputs`` back to back. A request is a whole
    ``predict_logits`` call: padding, the host-to-device copy, the
    predictor's ``device_preproc``, the forward and the logits copied back
    to the host, which synchronizes it; so its latency includes queueing
    behind the other clients on the card. One request warms up before the
    clock starts. Returns the latency percentiles (ms; the p-th is
    ``sorted[min(n - 1, round(p / 100 * (n - 1)))]``), the largest, and the
    clips per second over the wall time."""
    latencies: List[List[float]] = [[] for _ in range(num_threads)]
    barrier = threading.Barrier(num_threads + 1)

    def client(tid: int) -> None:
        barrier.wait()
        for _ in range(requests_per_thread):
            t0 = time.perf_counter()
            predictor.predict_logits(*inputs)
            latencies[tid].append(time.perf_counter() - t0)

    # the precision is set once here for every thread: a per-request
    # model_precision on several threads would restore the process setting
    # under another thread's forward
    with model_precision(compute_dtype(predictor.model)):
        predictor.predict_logits(*inputs)
        threads = [threading.Thread(target=client, args=(i,)) for i in range(num_threads)]
        for t in threads:
            t.start()
        barrier.wait()
        t_start = time.perf_counter()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t_start
    return latency_summary(np.concatenate([np.asarray(lat) for lat in latencies]), int(inputs[0].shape[0]),
                           num_threads, wall)


def latency_summary(latencies_s: np.ndarray, batch: int, num_threads: int, wall_s: float) -> Dict[str, Any]:
    """``load_test``'s result from the request latencies (seconds)."""
    lats = np.sort(np.asarray(latencies_s, np.float64))
    n = len(lats)

    def pct(p: float) -> float:
        return float(lats[min(n - 1, int(round(p / 100 * (n - 1))))])

    return {
        "num_threads": num_threads,
        "requests": n,
        "batch": batch,
        "throughput_clips_per_s": batch * n / wall_s,
        "p50_ms": pct(50) * 1e3,
        "p90_ms": pct(90) * 1e3,
        "p99_ms": pct(99) * 1e3,
        "max_ms": float(lats[-1]) * 1e3,
        "wall_s": wall_s,
    }


def build_audio_model(config: Any, num_classes: Optional[int] = None) -> nn.Module:
    """The audio model exactly as its training pipeline builds it, wrapped
    in ``WaveToLogMel`` when ``dataset.streaming`` is set (the model then
    takes raw waveforms and its parameters nest under ``model.``); the head
    has ``num_classes`` outputs, ``dataset.num_classes`` where not given."""
    from multimodal_lipread_torch.models.audio import get_audio_model
    from multimodal_lipread_torch.pipelines.common import model_dtype

    input_size = config.get("dataset.input_size", 117)
    model = get_audio_model(
        config.get("model.name", "resnet"), num_classes or config.get("dataset.num_classes", 4),
        input_size=input_size,
        version=config.get("model.version", 16),
        use_batchnorm=config.get("model.use_batchnorm", True),
        dtype=model_dtype(config),
        d_model=config.get("model.d_model"),
    )
    if bool(config.get("dataset.streaming", False)):
        from multimodal_lipread_torch.models.frontend import WaveToLogMel

        model = WaveToLogMel(model, input_size=input_size)
    return model


def predict_audio_clips(
    config: Any, ckpt_path: str, clip_paths: Sequence[str], batch_size: int = 32,
    device: str = "cuda", devices: Optional[Sequence[str]] = None,
) -> List[Dict[str, Any]]:
    """End-to-end audio inference: files → decode → log-mel → classify.

    With ``dataset.streaming`` the log-mel runs inside the model's forward
    (``WaveToLogMel``), on every replica of ``devices`` where given;
    otherwise the features are computed first (``compute_logmel_features``,
    on the first device). Both run the log-mel kernel on a card.
    """
    device = devices[0] if devices else device
    from multimodal_lipread_torch.pipelines.common import compute_logmel_features, decode_waveforms

    waves = decode_waveforms(list(clip_paths))
    if bool(config.get("dataset.streaming", False)):
        inputs = waves
    else:
        inputs = compute_logmel_features(
            waves, input_size=config.get("dataset.input_size", 117), device=device
        )
    model, classes = load_model(functools.partial(build_audio_model, config), ckpt_path, device)
    classes = classes or _class_names(config)
    logits = Predictor(model=model, batch_size=batch_size, device=device, devices=devices).predict_logits(inputs)
    preds = np.argmax(logits, axis=-1)
    return [
        {
            "path": path,
            "prediction": int(p),
            "word": classes[int(p)] if classes and int(p) < len(classes) else None,
            "logits": [float(x) for x in row],
        }
        for path, p, row in zip(clip_paths, preds, logits)
    ]


PIPELINES = ("audio", "video", "audio_video", "cues", "audio_cues", "cues_video", "audio_cues_video")
# per-pipeline input modalities, in the model's order: 'a' = audio clip
# path, 'v' = lip-region .npy path, 'c' = cue text file (the JAX package's)
_PIPELINE_INPUTS = {
    "audio": "a",
    "video": "v",
    "audio_video": "av",
    "cues": "c",
    "audio_cues": "ac",
    "cues_video": "cv",
    "audio_cues_video": "acv",
}


def build_model(pipeline: str, config: Any, num_classes: Optional[int] = None) -> nn.Module:
    """The model exactly as the pipeline's training entry builds it (a
    different knob gives other parameter names, and the checkpoint does
    not load), with ``num_classes`` outputs: a checkpoint's class count
    where it names its classes, else ``dataset.num_classes``."""
    from multimodal_lipread_torch.pipelines.common import model_dtype

    num_classes = num_classes or config.get("dataset.num_classes", 4)
    if pipeline == "audio":
        raise ValueError("audio uses predict_audio_clips (streaming-aware)")
    if pipeline == "video":
        from multimodal_lipread_torch.models.video import get_video_model

        return get_video_model(
            config.get("model.name", "resnet_lstm"), num_classes,
            dtype=model_dtype(config),
            resnet_version=config.get("model.resnet_version", 18),
            shufflenet_version=config.get("model.shufflenet_version", "0.5x"),
            feature_dim=config.get("model.feature_dim"),
            dropout=config.get("model.dropout"),
        )
    if pipeline == "audio_video":
        from multimodal_lipread_torch.models.audio_video import get_av_model

        return get_av_model(
            config.get("model.name", "middle_fusion_mobilenet"), num_classes,
            input_size=config.get("dataset.audio_input_size", 117), dtype=model_dtype(config),
        )
    if pipeline == "cues":
        from multimodal_lipread_torch.models.cues import get_cue_model

        return get_cue_model(config.get("model.name", "dense_nn"), num_classes,
                             dtype=model_dtype(config), bert_size=config.get("model.bert_size", "tiny"))
    if pipeline == "audio_cues":
        from multimodal_lipread_torch.models.audio_cues import get_audio_cues_model

        return get_audio_cues_model(config.get("model.name", "middle_fusion_mobile"),
                                    num_classes, dtype=model_dtype(config))
    if pipeline == "cues_video":
        from multimodal_lipread_torch.models.cues_video import get_cues_video_model

        name = config.get("train.model_name") or config.get("model.name") or "middle_fusion_mobile"
        return get_cues_video_model(name, num_classes, dtype=model_dtype(config))
    if pipeline == "audio_cues_video":
        from multimodal_lipread_torch.models.audio_cues_video import get_triple_model

        name = config.get("train.model_name") or config.get("model.name") or "late_fusion_mobile"
        return get_triple_model(name, num_classes, dtype=model_dtype(config))
    raise ValueError(f"unknown pipeline '{pipeline}' (one of {PIPELINES})")


# the key of the log-mel width that each pipeline's training reads
_AUDIO_INPUT_KEY = {"audio_video": "dataset.audio_input_size", "audio_cues": "dataset.input_size",
                    "audio_cues_video": "dataset.input_size"}


def _cue_features(pipeline: str, config: Any, paths: Sequence[str]) -> np.ndarray:
    """Cue text files → the model's cue input: for ``cues`` the featurization
    of the model's embedding kind (token ids for BERT, embeddings through
    the cache otherwise; TF-IDF is refused), for the fusion pipelines the
    ``dataset.embed_model`` sentence embedding."""
    from multimodal_lipread_torch.data.cues import CueRecord, embed_cached

    texts = []
    for p in paths:
        with open(p, "r", encoding="utf-8") as f:
            texts.append(f.read().strip())
    if pipeline != "cues":
        return embed_cached(texts, model=config.get("dataset.embed_model", "mpnet"),
                            cache_dir=config.get("dataset.cache_dir"))
    from multimodal_lipread_torch.models.cues import cue_embedding_kind
    from multimodal_lipread_torch.pipelines.cues import _featurize

    kind = cue_embedding_kind(config.get("model.name", "dense_nn"))
    if kind == "tfidf":
        raise ValueError(
            "the 'linear' (TF-IDF) cue model fits its vectorizer on the training corpus and cannot be "
            "served from a checkpoint alone — use an embedding-based cue model"
        )
    records = [CueRecord(word="", split="", sequence_id="", description=t) for t in texts]
    return np.asarray(_featurize(records, kind, config.get("dataset.cache_dir"),
                                 bert_size=config.get("model.bert_size", "tiny")))


def _featurize_modalities(pipeline: str, config: Any, groups: Sequence[Sequence[str]],
                          device: str = "cuda") -> tuple:
    """Per-clip file groups (one path per modality, in the order of
    ``_PIPELINE_INPUTS``) → the model's input arrays, as the training
    pipeline featurizes them. Audio is decoded on the host and featurized
    by the log-mel kernel on ``device`` at the width of
    ``_AUDIO_INPUT_KEY``; lips are loaded as uint8 (a float file in [0, 1]
    is scaled to uint8) and scaled to [0, 1] on the device by the
    predictor; cue text files go through ``_cue_features``. The audio
    pipeline goes through ``predict_audio_clips``."""
    if pipeline == "audio":
        raise ValueError("audio uses predict_audio_clips (streaming-aware)")
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline '{pipeline}' (one of {PIPELINES})")
    codes = _PIPELINE_INPUTS[pipeline]
    for g in groups:
        if len(g) != len(codes):
            raise ValueError(
                f"pipeline '{pipeline}' needs {len(codes)} files per clip "
                f"({','.join(codes)}: a=audio, v=lips .npy, c=cue text); got {g}"
            )
    inputs: List[np.ndarray] = []
    for i, code in enumerate(codes):
        paths = [g[i] for g in groups]
        if code == "a":
            from multimodal_lipread_torch.pipelines.common import compute_logmel_features, decode_waveforms

            inputs.append(compute_logmel_features(
                decode_waveforms(paths), input_size=config.get(_AUDIO_INPUT_KEY[pipeline], 117), device=device))
        elif code == "c":
            inputs.append(_cue_features(pipeline, config, paths))
        else:
            inputs.append(load_lips(paths))
    return tuple(inputs)


def load_lips(paths: Sequence[str]) -> np.ndarray:
    """Lip-region ``.npy`` files → one uint8 array (N, *shape), through the
    threaded native loader (``data/native_io.load_npy_u8_batch``); where it
    refuses a file (not uint8, or another shape than the first file's) the
    files are loaded with ``np.load`` and a float file in [0, 1] is scaled
    to uint8."""
    from multimodal_lipread_torch.data.native_io import load_npy_u8_batch

    shape = np.load(paths[0], mmap_mode="r").shape
    lips, failed = load_npy_u8_batch(paths, shape, scale=1.0)
    if failed < 0:
        return lips.astype(np.uint8)
    lips = np.stack([np.load(p) for p in paths])
    if lips.dtype != np.uint8:
        lips = np.clip(lips * 255.0 if lips.max() <= 1.0 else lips, 0, 255).astype(np.uint8)
    return lips


def _class_names(config: Any) -> Optional[List[str]]:
    """For a checkpoint that names no classes: the sorted word list under
    ``dataset.root_dir``, from its audio clips or ``.npy`` files, where
    there are any (the label space of a pipeline whose words are all the
    corpus's)."""
    from multimodal_lipread_torch.data.glips import AUDIO_EXTS, scan_glips

    root = config.get("dataset.root_dir")
    if not root:
        return None
    for exts in (AUDIO_EXTS, (".npy",)):
        try:
            classes = scan_glips(root, exts=exts).classes
        except FileNotFoundError:
            continue
        if classes:
            return classes
    return None


def predict_clips(
    config: Any, ckpt_path: str, pipeline: str, groups: Sequence[Sequence[str]],
    batch_size: int = 32, device: str = "cuda", data_parallel: bool = False,
    devices: Optional[Sequence[str]] = None,
) -> List[Dict[str, Any]]:
    """End-to-end inference for a ported pipeline: per-clip file groups →
    featurize → classify (see ``_featurize_modalities`` for the groups).
    ``data_parallel`` serves with a replica on every local card
    (``replica_devices``), ``devices`` on the devices given."""
    if data_parallel and not devices:
        devices = replica_devices(device)
    if pipeline == "audio":
        return predict_audio_clips(config, ckpt_path, [g[0] for g in groups], batch_size, device=device,
                                   devices=devices)
    device = devices[0] if devices else device
    inputs = _featurize_modalities(pipeline, config, groups, device=device)
    model, classes = load_model(functools.partial(build_model, pipeline, config), ckpt_path, device)
    logits = Predictor(model=model, batch_size=batch_size, device=device, devices=devices).predict_logits(*inputs)
    preds = np.argmax(logits, axis=-1)
    classes = classes or _class_names(config)
    return [
        {
            "paths": list(g),
            "prediction": int(p),
            "word": classes[int(p)] if classes and int(p) < len(classes) else None,
            "logits": [float(x) for x in row],
        }
        for g, p, row in zip(groups, preds, logits)
    ]


def export_program(model: nn.Module, example_inputs: Sequence[np.ndarray]) -> "torch.export.ExportedProgram":
    """``model``'s eval-mode forward traced by ``torch.export`` at the
    example inputs' shapes and dtypes, on the model's device. A
    ``WaveToLogMel`` frontend stays in the graph as the log-mel kernel's
    operator ``torch.ops.mlt.log_mel`` (``ops/logmel_cuda.py``), so the
    exported program launches the kernel on a card."""
    device = next(model.parameters()).device
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in example_inputs)
    return torch.export.export(model.eval(), args)


def export_pipeline(
    config: Any, ckpt_path: str, pipeline: str, out_path: str, batch_size: int = 32, device: str = "cuda",
) -> "torch.export.ExportedProgram":
    """A checkpoint's fixed-batch inference graph (:func:`export_program`)
    saved to ``out_path`` with ``torch.export.save``; returns the program.

    As the JAX package's StableHLO export: a ``dataset.streaming`` audio
    checkpoint exports ``WaveToLogMel`` over raw (B, 20000) waveforms, any
    other audio one over (B, 80, input_size) log-mels; lip inputs are
    float32 in [0, 1] (the caller divides uint8 lips by 255); the TF-IDF
    cue model is refused. The parameters stay on ``device``.

    Load it with ``torch.export.load(out_path).module()`` in a process that
    has imported ``multimodal_lipread_torch.ops.logmel_cuda`` (which
    registers the log-mel operator), and call it under
    ``utils.precision.model_precision`` for the model's own precision."""
    from multimodal_lipread_torch.data.audio_io import TARGET_SAMPLES

    if pipeline == "audio":
        if bool(config.get("dataset.streaming", False)):
            example: tuple = (np.zeros((batch_size, TARGET_SAMPLES), np.float32),)
        else:
            example = (np.zeros((batch_size, 80, config.get("dataset.input_size", 117)), np.float32),)
        build = functools.partial(build_audio_model, config)
    else:
        example = _example_inputs(pipeline, config, batch_size)
        build = functools.partial(build_model, pipeline, config)
    example = tuple(a.astype(np.float32) / 255.0 if a.dtype == np.uint8 else a for a in example)
    program = export_program(load_model(build, ckpt_path, device)[0], example)
    torch.export.save(program, out_path)
    return program


def _example_inputs(pipeline: str, config: Any, batch: int) -> tuple:
    """Zeros in the model's input shapes and dtypes (uint8 lips)."""
    from multimodal_lipread_torch.data.cues import EMBED_DIMS, canonical_embed_model

    mel = np.zeros((batch, 80, config.get(_AUDIO_INPUT_KEY.get(pipeline, "dataset.input_size"), 117)), np.float32)
    lips = np.zeros((batch, config.get("dataset.sequence_length", 29), 44, 44, 3), np.uint8)
    if pipeline == "cues":
        from multimodal_lipread_torch.models.cues import cue_embedding_kind

        kind = cue_embedding_kind(config.get("model.name", "dense_nn"))
        if kind == "tfidf":
            raise ValueError(
                "the 'linear' (TF-IDF) cue model fits its vectorizer on the training corpus and cannot be "
                "exported from a checkpoint alone — use an embedding-based cue model"
            )
        if kind == "bert_tok":
            cue = np.zeros((batch, 32), np.int32)
        elif kind.endswith("_tok"):
            cue = np.zeros((batch, 32, EMBED_DIMS[kind[:-4]]), np.float32)
        else:
            cue = np.zeros((batch, EMBED_DIMS[kind]), np.float32)
    else:
        cue = np.zeros((batch, EMBED_DIMS[canonical_embed_model(config.get("dataset.embed_model", "mpnet"))]),
                       np.float32)
    return {
        "video": (lips,),
        "audio_video": (mel, lips),
        "cues": (cue,),
        "audio_cues": (mel, cue),
        "cues_video": (cue, lips),
        "audio_cues_video": (mel, cue, lips),
    }[pipeline]


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    import json

    from multimodal_lipread_torch.config import load_config

    parser = argparse.ArgumentParser(
        description="Serve a checkpoint of the PyTorch port (any of its seven pipelines): classify clips",
    )
    parser.add_argument("--pipeline", default="audio", choices=PIPELINES)
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True,
                        help="a trainer's <model>_best.pt file or <model>_best.orbax directory")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    parser.add_argument("--data-parallel", action="store_true",
                        help="one model replica per local card, each serving an equal share of every batch "
                             "(logits equal single-device serving)")
    parser.add_argument("--export", metavar="PATH.pt2",
                        help="instead of classifying, save the inference graph (torch.export) to PATH")
    parser.add_argument("clips", nargs="*",
                        help="files to classify: WAV clips (audio), lip-region .npy files (video), "
                             "comma-separated 'clip.wav,clip.npy' groups (audio_video), cue .txt files (cues), "
                             "'clip.wav,cue.txt' groups (audio_cues), 'cue.txt,lips.npy' groups (cues_video) "
                             "or 'clip.wav,cue.txt,lips.npy' groups (audio_cues_video)")
    args = parser.parse_args(argv)
    config = load_config(args.config)
    if args.export:
        export_pipeline(config, args.checkpoint, args.pipeline, args.export, args.batch_size, device=args.device)
        print(json.dumps({"exported": args.export, "pipeline": args.pipeline}))
        return
    if not args.clips:
        parser.error("no clips given (and no --export)")
    results = predict_clips(config, args.checkpoint, args.pipeline, [c.split(",") for c in args.clips],
                            args.batch_size, device=args.device, data_parallel=args.data_parallel)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
