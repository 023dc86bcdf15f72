"""Lip crop on the device: box crop + aspect-preserving resize + average
colour pad, batched over frames: the plain PyTorch version (counterpart of
the JAX package's ``ops/crop_resize.py``).

The host decodes full frames and ships them as uint8 with int32 lip boxes;
the crop, the resize, the pad and the /255 normalize run on the device.
Per frame of (H, W, C) and box (x_min, y_min, x_max, y_max), as the
reference's host cv2 path does it (``data/lip_extraction.resize_and_pad``):

- the letterbox size in integer arithmetic: wide ⟺ ``cw·th > ch·tw``,
  then ``(tw, (tw·ch)//cw)`` or ``((th·cw)//ch, th)``, centred;
- every output pixel's source coordinate is cv2 INTER_LINEAR's
  ``(dst + 0.5)·scale − 0.5``, clamped to the crop, then to the frame; the
  bilinear neighbours clamp at the crop's last row and column;
- the bilinear blend ``p00·(1−wy)·(1−wx) + p01·(1−wy)·wx + p10·wy·(1−wx) +
  p11·wy·wx`` in float32, left to right, rounded half to even
  (``jnp.round`` and ``torch.round`` both do) and clipped to [0, 255];
- the pad colour is ``floor(Σ rounded / count)`` over the letterboxed
  region, per channel, in float32 (the sums are integers below 2^24, so
  exact in any order);
- a degenerate box (width or height ≤ 0) gives a blank frame.

Gather indices are clamped into the frame, as XLA's gather clamps them, so
a box outside the frame reads edge pixels in both packages.

:func:`crop_resize_pad_reference` is the plain version that the CPU tests
hold to the JAX op and the card holds the CUDA kernel
(``ops/crop_resize_cuda.py``) to. The public entries, which pick the kernel
for a CUDA tensor, are :func:`crop_resize_pad` and
:func:`crop_resize_pad_normalize` there.
"""

from __future__ import annotations

from typing import Tuple

import torch

TARGET_SIZE = (44, 44)
MARGIN = 0.4


def expand_boxes(boxes: torch.Tensor, frame_h: int, frame_w: int, margin: float = MARGIN) -> torch.Tensor:
    """40 % margin around lip boxes, clipped to the frame: int32 (..., 4)
    (x_min, y_min, x_max, y_max) in, the same out; the margins truncate as
    ``int()`` does (``data/lip_extraction._expand_box`` on the host)."""
    x_min, y_min, x_max, y_max = boxes.to(torch.int32).unbind(-1)
    mh = ((y_max - y_min).to(torch.float32) * margin).to(torch.int32)
    mw = ((x_max - x_min).to(torch.float32) * margin).to(torch.int32)
    return torch.stack([
        (x_min - mw).clamp_min(0), (y_min - mh).clamp_min(0),
        (x_max + mw).clamp_max(frame_w), (y_max + mh).clamp_max(frame_h),
    ], dim=-1).to(torch.int32)


def letterbox(boxes: torch.Tensor, target_size: Tuple[int, int] = TARGET_SIZE) -> Tuple[torch.Tensor, ...]:
    """Per box of int32 (N, 4): ``(new_h, new_w, ph, pw)``, the letterboxed
    size and its top-left offset on the (th, tw) canvas, in exact integer
    arithmetic (the host's float ``int(tw / aspect)`` is one ULP unstable at
    exact ratios)."""
    th, tw = target_size
    cwi = (boxes[:, 2] - boxes[:, 0]).clamp_min(1)
    chi = (boxes[:, 3] - boxes[:, 1]).clamp_min(1)
    wide = cwi * th > chi * tw
    new_w = torch.where(wide, torch.full_like(cwi, tw), (th * cwi) // chi).clamp_min(1)
    new_h = torch.where(wide, (tw * chi) // cwi, torch.full_like(chi, th)).clamp_min(1)
    return new_h, new_w, (th - new_h) // 2, (tw - new_w) // 2


def source_coords(boxes: torch.Tensor, frame_h: int, frame_w: int,
                  target_size: Tuple[int, int] = TARGET_SIZE) -> Tuple[torch.Tensor, ...]:
    """Where each output pixel of N frames samples its frame:
    ``(y0, y1, wy)`` (N, th, 1), ``(x0, x1, wx)`` (N, 1, tw) and the
    letterboxed region ``in_region`` (N, th, tw). Rows y0, y1 and columns
    x0, x1 are int64 and lie inside the frame; wy, wx are float32."""
    th, tw = target_size
    boxes = boxes.to(torch.int32)
    device = boxes.device
    x_min, y_min, x_max, y_max = (boxes[:, i].to(torch.float32) for i in range(4))
    cw_s = (x_max - x_min).clamp_min(1.0)
    ch_s = (y_max - y_min).clamp_min(1.0)
    new_h, new_w, ph, pw = letterbox(boxes, target_size)

    ri = torch.arange(th, dtype=torch.float32, device=device)[None, :] - ph.to(torch.float32)[:, None]  # (N, th)
    rj = torch.arange(tw, dtype=torch.float32, device=device)[None, :] - pw.to(torch.float32)[:, None]  # (N, tw)
    in_rows = (ri >= 0) & (ri < new_h.to(torch.float32)[:, None])
    in_cols = (rj >= 0) & (rj < new_w.to(torch.float32)[:, None])
    scale_y = (ch_s / new_h.to(torch.float32))[:, None]
    scale_x = (cw_s / new_w.to(torch.float32))[:, None]
    src_y = torch.minimum(torch.maximum((ri + 0.5) * scale_y - 0.5, torch.zeros_like(ri)),
                          (ch_s - 1.0)[:, None]) + y_min[:, None]
    src_x = torch.minimum(torch.maximum((rj + 0.5) * scale_x - 0.5, torch.zeros_like(rj)),
                          (cw_s - 1.0)[:, None]) + x_min[:, None]
    src_y = src_y.clamp(0.0, frame_h - 1.0)
    src_x = src_x.clamp(0.0, frame_w - 1.0)
    y0 = torch.floor(src_y).to(torch.int32)
    x0 = torch.floor(src_x).to(torch.int32)
    # the neighbours clamp at the crop's last row/col (cv2 sees only the crop)
    y_last = torch.clamp_max((y_min + ch_s).to(torch.int32) - 1, frame_h - 1)[:, None]
    x_last = torch.clamp_max((x_min + cw_s).to(torch.int32) - 1, frame_w - 1)[:, None]
    y1 = torch.minimum(y0 + 1, y_last)
    x1 = torch.minimum(x0 + 1, x_last)
    wy = src_y - y0.to(torch.float32)
    wx = src_x - x0.to(torch.float32)

    def inside(i, n):  # XLA's gather clamps its indices into the operand
        return i.clamp(0, n - 1).to(torch.int64)

    return (inside(y0, frame_h)[..., None], inside(y1, frame_h)[..., None], wy[..., None],
            inside(x0, frame_w)[:, None, :], inside(x1, frame_w)[:, None, :], wx[:, None, :],
            in_rows[:, :, None] & in_cols[:, None, :])


def crop_resize_pad_reference(frames: torch.Tensor, boxes: torch.Tensor,
                              target_size: Tuple[int, int] = TARGET_SIZE) -> torch.Tensor:
    """uint8 frames (..., H, W, C) + int32 boxes (..., 4) → uint8
    (..., th, tw, C), any number of leading axes (e.g. (B, T) video).
    Boxes are already margin-expanded (:func:`expand_boxes`)."""
    if frames.dtype != torch.uint8:
        raise TypeError(f"crop_resize_pad takes uint8 frames, got {frames.dtype}")
    th, tw = target_size
    lead = frames.shape[:-3]
    H, W, C = frames.shape[-3:]
    if boxes.shape != lead + (4,):
        raise ValueError(f"boxes of shape {tuple(boxes.shape)} do not match frames {tuple(frames.shape)}")
    fl = frames.reshape((-1, H, W, C))
    bl = boxes.reshape(-1, 4).to(torch.int32)
    n = fl.shape[0]
    if n == 0:
        return frames.new_zeros(lead + (th, tw, C))
    y0, y1, wy, x0, x1, wx, in_region = source_coords(bl, H, W, target_size)
    frame_idx = torch.arange(n, device=fl.device)[:, None, None]

    def px(y, x):  # (N, th, tw, C) float32
        return fl[frame_idx, y, x].to(torch.float32)

    wy, wx = wy[..., None], wx[..., None]
    sampled = (px(y0, x0) * (1 - wy) * (1 - wx) + px(y0, x1) * (1 - wy) * wx
               + px(y1, x0) * wy * (1 - wx) + px(y1, x1) * wy * wx)
    resized = torch.round(sampled).clamp(0.0, 255.0)
    m = in_region[..., None].to(torch.float32)
    count = m.sum(dim=(1, 2)).clamp_min(1.0)  # (N, 1)
    avg = torch.floor((resized * m).sum(dim=(1, 2)) / count)  # (N, C)
    canvas = torch.where(in_region[..., None], resized, avg[:, None, None, :])
    valid = (bl[:, 2] > bl[:, 0]) & (bl[:, 3] > bl[:, 1])
    canvas = torch.where(valid[:, None, None, None], canvas, torch.zeros_like(canvas))
    return canvas.to(torch.uint8).reshape(lead + (th, tw, C))


def crop_resize_pad_normalize_reference(frames: torch.Tensor, boxes: torch.Tensor,
                                        target_size: Tuple[int, int] = TARGET_SIZE) -> torch.Tensor:
    """:func:`crop_resize_pad_reference`, then /255 in float32."""
    return crop_resize_pad_reference(frames, boxes, target_size).to(torch.float32) / 255.0
