"""Streaming datasets for corpora too large to hold in memory (counterpart
of the JAX package's ``data/grain_loader.py``, which stands on grain; this
module keeps its name so that a reader finds the counterpart, and stands on
``torch.utils.data.DataLoader`` instead).

Random-access sources decode on the host and yield fixed-shape numpy
records, as dicts:

- ``AudioClipSource``: GLips audio → ``{waveform, label}``;
- ``LipClipSource``: lip-region ``.npy`` → ``{lip_regions, label}``, uint8;
- ``FullFrameClipSource``: raw ``.mp4`` → ``{frames, boxes, label}``: 29
  full frames and their margin-expanded lip boxes, the host half of the
  device crop (``dataset.device_crop``; the crop runs in the train step,
  ``ops/crop_resize_cuda.py``);
- ``HostCropClipSource``: raw ``.mp4`` → ``{lip_regions, label}``, decoded,
  detected and cropped on the host (``dataset.host_crop_streaming``, the
  reference's layout).

The video sources build their lip detector lazily, once per process, and
leave it out of their pickled state, so a loader worker process builds its
own. ``StreamingDataset`` reads one epoch at a time through a
``DataLoader`` (``num_workers`` worker processes, started with ``spawn``),
for ``Trainer.fit``. ``NativeStreamingDataset`` does the same on the C++
prefetcher of ``native/mlt_io.cpp`` (``dataset.loader_backend: native``):
in-process threads, no per-record Python, one modality (WAV waveforms or
uint8 ``.npy`` lips).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from multimodal_lipread_torch.data.audio_io import load_waveform
from multimodal_lipread_torch.data.glips import ClipEntry


@dataclasses.dataclass
class AudioClipSource:
    """GLips audio entries → ``{waveform (20000,) float32, label}``."""

    entries: Sequence[ClipEntry]
    class_to_idx: Dict[str, int]

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int):
        e = self.entries[int(idx)]
        return {"waveform": load_waveform(e.path), "label": np.int32(self.class_to_idx[e.word])}


@dataclasses.dataclass
class LipClipSource:
    """Lip-region ``.npy`` entries → ``{lip_regions (29, 44, 44, 3) uint8,
    label}``; the trainer scales them to [0, 1] on the device."""

    entries: Sequence[ClipEntry]
    class_to_idx: Dict[str, int]

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int):
        e = self.entries[int(idx)]
        return {"lip_regions": np.load(e.path), "label": np.int32(self.class_to_idx[e.word])}


class _VideoSource:
    """A lip detector built on first use in each process and never pickled."""

    backend: str

    @property
    def _ex(self):
        ex = getattr(self, "_extractor", None)
        if ex is None:
            from multimodal_lipread_torch.data.lip_extraction import LipRegionExtractor

            ex = self._extractor = LipRegionExtractor(backend=self.backend)
        return ex

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if k != "_extractor"}


@dataclasses.dataclass
class FullFrameClipSource(_VideoSource):
    """Raw ``.mp4`` entries → ``{frames (29, H, W, 3) uint8, boxes (29, 4)
    int32, label}``: decode and lip detection only. Frames in one batch
    must share (H, W), as GLips's 256 × 256 clips do; ``frame_shape`` (H, W)
    makes a clip of another size raise."""

    entries: Sequence[ClipEntry]
    class_to_idx: Dict[str, int]
    backend: str = "auto"
    frame_shape: Optional[tuple] = None

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int):
        e = self.entries[int(idx)]
        frames, boxes = self._ex.extract_full_frame_sequence(e.path)
        if self.frame_shape is not None and frames.shape[1:3] != tuple(self.frame_shape):
            raise ValueError(f"{e.path}: frame size {frames.shape[1:3]} != required {tuple(self.frame_shape)}: "
                             "device-crop batches need one frame size")
        return {"frames": frames, "boxes": boxes, "label": np.int32(self.class_to_idx[e.word])}


@dataclasses.dataclass
class HostCropClipSource(_VideoSource):
    """Raw ``.mp4`` entries → ``{lip_regions (29, 44, 44, 3) uint8, label}``,
    decoded, detected and cropped on the host (the reference's online
    layout, the counterpart of :class:`FullFrameClipSource` + the device
    crop)."""

    entries: Sequence[ClipEntry]
    class_to_idx: Dict[str, int]
    backend: str = "auto"

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int):
        e = self.entries[int(idx)]
        return {"lip_regions": self._ex.extract_lip_sequence(e.path), "label": np.int32(self.class_to_idx[e.word])}


def _stack_records(records):
    """A loader batch: the records' fields stacked into numpy arrays."""
    return {k: np.stack([np.asarray(r[k]) for r in records]) for k in records[0]}


def _default_shard(index: Optional[int], count: Optional[int]) -> Tuple[int, int]:
    """The shard a dataset reads: as given, else this process's rank and the
    world size (0 / 1 without a process group)."""
    from multimodal_lipread_torch.parallel.distributed import rank, world_size

    return (rank() if index is None else index), (world_size() if count is None else count)


class StreamingDataset:
    """One epoch at a time of a random-access source, for ``Trainer.fit``.

    - ``input_keys`` order the record fields into the model's inputs;
      ``label_key`` names the integer label;
    - an epoch's order is ``np.random.default_rng(seed + epoch)
      .permutation`` when shuffled, the index order otherwise: every record
      once, the same for a given (seed, epoch) (grain's ``IndexSampler``
      permutation is not reproduced);
    - ``shard_index`` / ``shard_count`` (by default this process's rank and
      the world size where a process group is initialized, else 0 / 1)
      take every ``shard_count``-th record of that order from
      ``shard_index`` on, a ceil split: ``len`` is this shard's count,
      ``global_batches`` the largest shard's batch count;
    - ``worker_count`` is the ``DataLoader``'s ``num_workers`` (0 loads in
      the calling thread)."""

    def __init__(self, source, input_keys: Sequence[str], label_key: str = "label", seed: int = 0,
                 worker_count: int = 0, shard_index: Optional[int] = None, shard_count: Optional[int] = None):
        shard_index, shard_count = _default_shard(shard_index, shard_count)
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard_index {shard_index} outside [0, {shard_count})")
        self.source = source
        self.input_keys = tuple(input_keys)
        self.label_key = label_key
        self.seed = seed
        self.worker_count = worker_count
        self.shard_index = shard_index
        self.shard_count = shard_count

    def __len__(self) -> int:
        n, c, i = len(self.source), self.shard_count, self.shard_index
        return (n - i + c - 1) // c

    def global_batches(self, per_host: int) -> int:
        """The batch count of the largest shard: the steps every shard runs."""
        largest_shard = -(-len(self.source) // self.shard_count)
        return max(1, -(-largest_shard // max(1, per_host)))

    def example_inputs(self, n: int) -> tuple:
        """The first record tiled ``n`` times: a shape and dtype template."""
        rec = self.source[0]
        return tuple(np.broadcast_to(np.asarray(rec[k])[None], (n,) + np.asarray(rec[k]).shape).copy()
                     for k in self.input_keys)

    def epoch_order(self, epoch: int, shuffle: bool) -> np.ndarray:
        n = len(self.source)
        order = np.random.default_rng(self.seed + epoch).permutation(n) if shuffle else np.arange(n)
        return order[self.shard_index :: self.shard_count]

    def epoch_batches(self, epoch: int, shuffle: bool, batch_size: int):
        """Yield ``(inputs, labels)`` numpy batches of one epoch, the last
        one short where the shard does not fill it."""
        from torch.utils.data import DataLoader

        loader = DataLoader(
            self.source, batch_size=batch_size, sampler=self.epoch_order(epoch, shuffle).tolist(),
            num_workers=self.worker_count, collate_fn=_stack_records,
            multiprocessing_context="spawn" if self.worker_count > 0 else None,
        )
        for batch in loader:
            yield (tuple(batch[k] for k in self.input_keys), batch[self.label_key].astype(np.int32))


class NativeStreamingDataset:
    """:class:`StreamingDataset`'s interface (``__len__``,
    ``global_batches``, ``example_inputs``, ``epoch_batches``, ``close``)
    on the native prefetcher (``data/native_io.NativePrefetcher``): its
    thread pool reads the records of an epoch, in order, into a bounded
    ring while the card trains on the previous batches.

    - ``kind='wav'``: PCM16 WAVs → float32 waveforms of ``record_shape``
      ``(20000,)`` at ``sample_rate``; every entry must be a ``.wav``
      (``tools/transcode.ensure_wav_mirror`` makes a mirror of others);
    - ``kind='npy_u8'``: uint8 lip ``.npy`` records of ``record_shape``;
    - an epoch's order is ``np.random.default_rng(seed + epoch)
      .permutation`` when shuffled, the index order otherwise, sharded
      ``[shard_index::shard_count]`` (rank / world under a process group,
      else 0 / 1, by default), as :class:`StreamingDataset`'s;
    - a file the prefetcher could not read raises, naming the file;
    - ``wire_dtype='int16'`` (``kind='wav'`` only) ships the waveforms as
      int16, half the bytes to the card, where the trainer casts them back
      to float32. The cast is exact for mono PCM16; a batch holding a
      sample that is not integral (a stereo source's channel mean, a
      32-bit source) raises, naming the clip, instead of truncating it."""

    def __init__(
        self,
        entries: Sequence[ClipEntry],
        class_to_idx: Dict[str, int],
        kind: str,
        record_shape: Sequence[int],
        sample_rate: int = 16000,
        seed: int = 0,
        n_threads: Optional[int] = None,
        capacity: int = 256,
        shard_index: Optional[int] = None,
        shard_count: Optional[int] = None,
        wire_dtype: Optional[str] = None,
    ):
        from multimodal_lipread_torch.data.native_io import DEFAULT_THREADS, NativePrefetcher

        shard_index, shard_count = _default_shard(shard_index, shard_count)
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard_index {shard_index} outside [0, {shard_count})")
        self.entries = list(entries)
        if kind == "wav":
            bad = [e.path for e in self.entries if not e.path.lower().endswith(".wav")]
            if bad:
                raise ValueError(
                    f"loader_backend 'native' decodes PCM16 WAV only; found {len(bad)} non-WAV clips "
                    f"(e.g. {bad[0]}): transcode them (tools/transcode.py) or use the grain backend"
                )
        if wire_dtype not in (None, "int16"):
            raise ValueError(f"unsupported wire_dtype {wire_dtype!r}")
        if wire_dtype == "int16" and kind != "wav":
            raise ValueError("wire_dtype='int16' only applies to kind='wav'")
        self.labels = np.asarray([class_to_idx[e.word] for e in self.entries], np.int32)
        self.seed = seed
        self.wire_dtype = wire_dtype
        self.shard_index = shard_index
        self.shard_count = shard_count
        self._prefetcher = NativePrefetcher(
            [e.path for e in self.entries], kind, record_shape, sample_rate=sample_rate, capacity=capacity,
            n_threads=n_threads or DEFAULT_THREADS,
        )

    def __len__(self) -> int:
        n, c, i = len(self.entries), self.shard_count, self.shard_index
        return (n - i + c - 1) // c

    def global_batches(self, per_host: int) -> int:
        """The batch count of the largest shard: the steps every shard runs."""
        largest_shard = -(-len(self.entries) // self.shard_count)
        return max(1, -(-largest_shard // max(1, per_host)))

    def example_inputs(self, n: int) -> tuple:
        """Zeros of ``n`` records in the wire's dtype: a shape and dtype template."""
        dtype = np.int16 if self.wire_dtype == "int16" else self._prefetcher.dtype
        return (np.zeros((n,) + self._prefetcher.record_shape, dtype),)

    def epoch_order(self, epoch: int, shuffle: bool) -> np.ndarray:
        n = len(self.entries)
        order = np.random.default_rng(self.seed + epoch).permutation(n) if shuffle else np.arange(n)
        return order[self.shard_index :: self.shard_count]

    def epoch_batches(self, epoch: int, shuffle: bool, batch_size: int):
        """Yield ``(inputs, labels)`` numpy batches of one epoch, the last
        one short where the shard does not fill it."""
        order = self.epoch_order(epoch, shuffle).astype(np.int64)
        self._prefetcher.start_epoch(order)
        consumed = 0
        while True:
            batch = self._prefetcher.next_batch(batch_size)
            if batch is None:
                break
            err = self._prefetcher.first_error
            if err >= 0:
                raise RuntimeError(f"the native prefetcher could not read {self.entries[err].path} "
                                   "(corrupt file, wrong shape, or unsupported format)")
            idx = order[consumed : consumed + len(batch)]
            consumed += len(batch)
            if self.wire_dtype == "int16":
                wire = batch.astype(np.int16)
                inexact = np.flatnonzero((wire != batch).any(axis=1))
                if inexact.size:
                    raise ValueError(
                        f"wire_dtype int16: {self.entries[idx[inexact[0]]].path} has samples that are not "
                        "integral (a stereo or 32-bit source): transcode it to mono PCM16, or leave "
                        "dataset.wire_dtype unset"
                    )
                batch = wire
            yield (batch,), self.labels[idx]

    def close(self) -> None:
        self._prefetcher.close()
