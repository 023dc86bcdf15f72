"""The lip-crop CUDA kernel's wrapper: the port's crop entry (counterpart of
the JAX package's ``ops/crop_resize.py`` entry points).

:func:`crop_resize_pad` and :func:`crop_resize_pad_normalize` launch
``csrc/crop_resize.cu`` (built with plain ``nvcc``, see ``_build.py``) for
frames on a CUDA card, and raise if the build or the launch fails; for
frames on the CPU they run the plain version
(``ops.crop_resize.crop_resize_pad_reference``). There is no fallback from
one to the other. ``launch_count`` counts the kernel's launches, so a run
can show that it went through the kernel. The kernel launches on the
current stream, so a CUDA graph can capture it.

:func:`crop` takes the launch's knobs (blocks a cluster, threads a block,
the cap on a block's staging bytes); :func:`staging_plan` reckons on the
host the rounds in which the kernel stages a band's source rows (the CPU
tests hold it to the plain version's source coordinates);
:func:`launch_config` and :func:`phase_times` describe a launch on the card.

``Trainer(device_preproc=...)`` and ``Predictor(device_preproc=...)`` take
:func:`device_crop` (full frames + boxes → the uint8 lips the model's input
contract expects; the trainer scales them to [0, 1] after it).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from multimodal_lipread_torch.ops import _build
from multimodal_lipread_torch.ops.crop_resize import (
    TARGET_SIZE,
    crop_resize_pad_normalize_reference,
    crop_resize_pad_reference,
    letterbox,
    source_coords,
)

# mlt_crop_resize_pad_launch_config's fields, in order
LAUNCH_CONFIG_FIELDS = ("threads", "cluster", "stage_bytes", "dynamic_smem_bytes", "static_smem_bytes", "registers",
                        "local_bytes", "blocks_per_sm", "max_active_clusters")
# the launch: blocks per frame (a cluster), threads per block, and the most
# shared memory a block stages source rows in (chip_smoke.py's [crop-kernel]
# times the choices)
CLUSTER, THREADS, STAGE_CAP = 2, 128, 20 * 1024
_MAX_CHANNELS = 4
_MAX_CANVAS_BYTES = 48 * 1024
_MAX_CLUSTER, _MAX_THREADS = 8, 256
_GROUP, _CHUNK_ROWS = 64, 32  # csrc/crop_resize.cu's kGroup and kChunkRows
# a block's phases, between the kernel's timestamps (its kPhases)
PHASES = ("box", "rows", "stage", "blend", "exchange", "store")

# launches of the kernel in this process; a caller may set it to 0
launch_count = 0
_count_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("crop_resize")
    fn = lib.mlt_crop_resize_pad
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    cfg = lib.mlt_crop_resize_pad_launch_config
    cfg.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
    cfg.restype = ctypes.c_int
    return lib


def span_stride(span: int) -> int:
    """Shared-memory bytes of a staged row whose needed bytes are ``span``
    long: widened to 16-byte alignment at both ends, whatever the row's
    alignment."""
    return (span + 30) // 16 * 16


def stage_bytes(H: int, W: int, C: int, target_size: Tuple[int, int] = TARGET_SIZE, cluster: int = CLUSTER,
                cap: int = STAGE_CAP) -> int:
    """The shared-memory bytes a block stages source rows in: its band's
    largest window (two source rows an output row, at most ``_CHUNK_ROWS``
    output rows a round and H rows, each a whole frame row wide), or
    ``cap`` where that is less (a larger window is staged in chunks); at
    least 64, a multiple of 16."""
    rows = min(2 * min(-(-target_size[0] // cluster), _CHUNK_ROWS), H)
    return max(64, min(rows * span_stride(W * C), cap) // 16 * 16)


def staging_plan(boxes: torch.Tensor, H: int, W: int, C: int, target_size: Tuple[int, int] = TARGET_SIZE,
                 cluster: int = CLUSTER, stage: int | None = None) -> list:
    """The kernel's staging rounds, reckoned on the host as
    ``csrc/crop_resize.cu`` makes them: per frame, a list of rounds, each a
    dict of the cluster block (``band``), the canvas rows and columns it
    blends (``rows``, ``cols``: half-open), its distinct source rows
    (``src_rows``, ascending), the bytes ``[xa, xb)`` of a source row it
    needs (``span``), the shared memory a staged row takes (``stride``) and
    all of them (``bytes``). A degenerate box has no round. ``stage``
    defaults to :func:`stage_bytes`."""
    th, _tw = target_size
    stage = stage_bytes(H, W, C, target_size, cluster) if stage is None else stage
    boxes = boxes.reshape(-1, 4).to(torch.int32).cpu()
    y0, y1, _wy, x0, x1, _wx, _in = source_coords(boxes, H, W, target_size)
    new_h, new_w, ph, pw = letterbox(boxes, target_size)
    valid = ((boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])).tolist()
    band = -(-th // cluster)
    max_stride = stage // min(2, H) // 16 * 16
    plan = []
    for f in range(boxes.shape[0]):
        rows0, rows1, cols0, cols1 = y0[f, :, 0].tolist(), y1[f, :, 0].tolist(), x0[f, 0].tolist(), x1[f, 0].tolist()
        top, left, bottom, right = int(ph[f]), int(pw[f]), int(ph[f] + new_h[f]), int(pw[f] + new_w[f])
        rounds = []
        for b in range(cluster if valid[f] else 0):
            lo, hi = max(min(b * band, th), top), min(min(b * band + band, th), bottom)
            j0 = left
            while lo < hi and j0 < right:
                xa, g = cols0[j0] * C, 0
                while g < min(_GROUP, right - j0) and span_stride(cols1[j0 + g] * C + C - xa) <= max_stride:
                    g += 1
                xb = cols1[j0 + g - 1] * C + C
                stride = span_stride(xb - xa)
                i0 = lo
                while i0 < hi:
                    src, m = [], 0
                    while m < min(_CHUNK_ROWS, hi - i0):
                        new = [y for y in sorted({rows0[i0 + m], rows1[i0 + m]}) if not src or y > src[-1]]
                        if len(src) + len(new) > stage // stride:
                            break
                        src, m = src + new, m + 1
                    rounds.append({"band": b, "rows": (i0, i0 + m), "cols": (j0, j0 + g), "src_rows": src,
                                   "span": (xa, xb), "stride": stride, "bytes": len(src) * stride})
                    i0 += m
                j0 += g
        plan.append(rounds)
    return plan


def launch_config(frame_size: Tuple[int, int] = (256, 256), channels: int = 3,
                  target_size: Tuple[int, int] = TARGET_SIZE, normalize: bool = False, cluster: int = CLUSTER,
                  threads: int = THREADS, stage_cap: int = STAGE_CAP, device: torch.device | str = "cuda") -> dict:
    """How the kernel launches on frames of ``frame_size`` x ``channels``:
    threads per block, blocks per cluster (one cluster per frame), stage and
    shared memory bytes, registers, spill bytes, blocks per SM and clusters
    resident at once."""
    H, W = frame_size
    info = (ctypes.c_int * len(LAUNCH_CONFIG_FIELDS))()
    stage = stage_bytes(H, W, channels, target_size, cluster, stage_cap)
    with torch.cuda.device(torch.device(device)):
        rc = _library().mlt_crop_resize_pad_launch_config(H, W, channels, target_size[0], target_size[1],
                                                          int(bool(normalize)), cluster, threads, stage, info)
    if rc != 0:
        raise RuntimeError(f"reading the crop kernel's launch configuration failed with CUDA error {rc}")
    return dict(zip(LAUNCH_CONFIG_FIELDS, info))


def crop(frames: torch.Tensor, boxes: torch.Tensor, target_size: Tuple[int, int] = TARGET_SIZE,
         normalize: bool = False, cluster: int = CLUSTER, threads: int = THREADS, stage_cap: int = STAGE_CAP,
         stamps: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`crop_resize_pad` (or, with ``normalize``,
    :func:`crop_resize_pad_normalize`) with the launch's knobs; ``stamps``
    (int64, frames x ``cluster`` x ``len(PHASES) + 1`` on the card, or
    None) takes each block's phase timestamps (:func:`phase_times`)."""
    global launch_count
    if frames.ndim < 3 or frames.dtype != torch.uint8:
        raise TypeError(f"crop_resize_pad takes uint8 frames (..., H, W, C), got {frames.dtype} "
                        f"{tuple(frames.shape)}")
    lead = frames.shape[:-3]
    if tuple(boxes.shape) != tuple(lead) + (4,):
        raise ValueError(f"boxes of shape {tuple(boxes.shape)} do not match frames {tuple(frames.shape)}")
    if frames.device.type == "cpu":
        plain = crop_resize_pad_normalize_reference if normalize else crop_resize_pad_reference
        return plain(frames, boxes, target_size)
    if frames.device.type != "cuda" or boxes.device != frames.device:
        raise ValueError(f"crop_resize_pad runs on a CUDA card or the CPU, with frames and boxes on one device; "
                         f"got {frames.device} and {boxes.device}")
    if boxes.dtype != torch.int32:
        raise TypeError(f"the crop kernel takes int32 boxes, got {boxes.dtype}")
    H, W, C = frames.shape[-3:]
    th, tw = target_size
    if not 0 < C <= _MAX_CHANNELS or th * tw * C > _MAX_CANVAS_BYTES:
        raise ValueError(f"the crop kernel takes 1 to {_MAX_CHANNELS} channels and a canvas of at most "
                         f"{_MAX_CANVAS_BYTES} bytes, got C={C}, target {target_size}")
    if not (1 <= cluster <= _MAX_CLUSTER and 32 <= threads <= _MAX_THREADS and threads % 32 == 0):
        raise ValueError(f"the crop kernel takes 1 to {_MAX_CLUSTER} blocks a cluster and 32 to {_MAX_THREADS} "
                         f"threads a block (a multiple of 32), got {cluster} and {threads}")
    n = frames.numel() // (H * W * C) if frames.numel() else 0
    out = torch.empty(tuple(lead) + (th, tw, C), dtype=torch.float32 if normalize else torch.uint8,
                      device=frames.device)
    if n == 0:
        return out
    frames, boxes = frames.contiguous(), boxes.contiguous()
    stage = stage_bytes(H, W, C, target_size, cluster, stage_cap)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = _library().mlt_crop_resize_pad(frames.data_ptr(), boxes.data_ptr(), out.data_ptr(), n, H, W, C,
                                            th, tw, int(bool(normalize)), cluster, threads, stage,
                                            0 if stamps is None else stamps.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"crop kernel launch failed with CUDA error {rc}")
    with _count_lock:  # clients on several threads launch (serving.load_test)
        launch_count += 1
    return out


def crop_resize_pad(frames: torch.Tensor, boxes: torch.Tensor,
                    target_size: Tuple[int, int] = TARGET_SIZE) -> torch.Tensor:
    """uint8 frames (..., H, W, C) + int32 boxes (..., 4), margin-expanded
    (``ops.crop_resize.expand_boxes``) → uint8 lips (..., th, tw, C);
    degenerate boxes give blank frames."""
    return crop(frames, boxes, target_size)


def crop_resize_pad_normalize(frames: torch.Tensor, boxes: torch.Tensor,
                              target_size: Tuple[int, int] = TARGET_SIZE) -> torch.Tensor:
    """:func:`crop_resize_pad` and /255 in the same pass → float32."""
    return crop(frames, boxes, target_size, normalize=True)


def phase_times(frames: torch.Tensor, boxes: torch.Tensor, normalize: bool = False, cluster: int = CLUSTER,
                threads: int = THREADS, stage_cap: int = STAGE_CAP) -> dict:
    """Run the kernel once on CUDA frames with its phase timestamps on and
    return microseconds: per phase of :data:`PHASES` (the box read and the
    letterbox; the first round's rows numbered; the first round staged;
    every round blended; the pad colour exchanged through the cluster; the
    band stored) the mean and the largest over the blocks that ran it, the
    mean block from start to end, the last block's start after the first
    one's, and the whole launch, first start to last end. The timestamps
    cost one global store per block and phase."""
    if frames.device.type != "cuda":
        raise ValueError("phase_times measures the kernel on a CUDA card")
    n = frames.numel() // (frames.shape[-3] * frames.shape[-2] * frames.shape[-1])
    stamps = torch.zeros((n * cluster, len(PHASES) + 1), dtype=torch.int64, device=frames.device)
    crop(frames, boxes, normalize=normalize, cluster=cluster, threads=threads, stage_cap=stage_cap, stamps=stamps)
    raw = stamps.cpu()
    t = (raw - raw[:, 0].min()).double() / 1e3  # offsets first: ns stamps exceed a double's 53 bits
    ran = (raw > 0).all(1)  # the blocks that staged a round (not blank frames, not pad-only bands)
    steps = t[ran].diff(dim=1)
    out = {name: (float(steps[:, i].mean()), float(steps[:, i].max())) if bool(ran.any()) else (0.0, 0.0)
           for i, name in enumerate(PHASES)}
    out["block"] = float((t[:, -1] - t[:, 0]).mean())
    out["last_start"] = float(t[:, 0].max())
    out["launch"] = float(t[:, -1].max())
    return out


def device_crop(frames: torch.Tensor, boxes: torch.Tensor) -> tuple:
    """The ``device_preproc`` of ``dataset.device_crop``: (frames, boxes) →
    (uint8 lips,), which the trainer or the predictor scales to [0, 1]."""
    return (crop_resize_pad(frames, boxes),)
