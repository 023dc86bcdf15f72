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
)

# mlt_crop_resize_pad_launch_config's fields, in order
LAUNCH_CONFIG_FIELDS = ("threads", "dynamic_smem_bytes", "static_smem_bytes", "registers", "local_bytes",
                        "blocks_per_sm")
_MAX_CHANNELS = 4
_MAX_CANVAS_BYTES = 48 * 1024

# launches of the kernel in this process; a caller may set it to 0
launch_count = 0
_count_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("crop_resize")
    fn = lib.mlt_crop_resize_pad
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cfg = lib.mlt_crop_resize_pad_launch_config
    cfg.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    cfg.restype = ctypes.c_int
    return lib


def launch_config(target_size: Tuple[int, int] = TARGET_SIZE, channels: int = 3, normalize: bool = False,
                  device: torch.device | str = "cuda") -> dict:
    """How the kernel launches: threads per block (one block per frame),
    shared memory, registers, spill bytes and blocks per SM."""
    info = (ctypes.c_int * len(LAUNCH_CONFIG_FIELDS))()
    with torch.cuda.device(torch.device(device)):
        rc = _library().mlt_crop_resize_pad_launch_config(target_size[0], target_size[1], channels,
                                                          int(bool(normalize)), info)
    if rc != 0:
        raise RuntimeError(f"reading the crop kernel's launch configuration failed with CUDA error {rc}")
    return dict(zip(LAUNCH_CONFIG_FIELDS, info))


def _crop(frames: torch.Tensor, boxes: torch.Tensor, target_size: Tuple[int, int], normalize: bool) -> torch.Tensor:
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
    n = frames.numel() // (H * W * C) if frames.numel() else 0
    out = torch.empty(tuple(lead) + (th, tw, C), dtype=torch.float32 if normalize else torch.uint8,
                      device=frames.device)
    if n == 0:
        return out
    frames, boxes = frames.contiguous(), boxes.contiguous()
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = _library().mlt_crop_resize_pad(frames.data_ptr(), boxes.data_ptr(), out.data_ptr(), n, H, W, C,
                                            th, tw, int(bool(normalize)), stream)
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
    return _crop(frames, boxes, target_size, False)


def crop_resize_pad_normalize(frames: torch.Tensor, boxes: torch.Tensor,
                              target_size: Tuple[int, int] = TARGET_SIZE) -> torch.Tensor:
    """:func:`crop_resize_pad` and /255 in the same pass → float32."""
    return _crop(frames, boxes, target_size, True)


def device_crop(frames: torch.Tensor, boxes: torch.Tensor) -> tuple:
    """The ``device_preproc`` of ``dataset.device_crop``: (frames, boxes) →
    (uint8 lips,), which the trainer or the predictor scales to [0, 1]."""
    return (crop_resize_pad(frames, boxes),)
