"""The crop kernel's bytes for a launch, by the frames and boxes it crops:
the least time the card could take for it is those bytes at the memory
bandwidth (its operations, some 30 float32 operations a sampled byte, take
a hundredth of that at the float32 peak). The count is ``chip_smoke.py``'s
``crop_bound`` on the reference's own sampling (``reference/resnet_trans``):
the output written once, the boxes read once and, per frame with a box of
some width and height, every distinct 32-byte sector of the source rows
that its bilinear gather reads (the rows it reads times the sectors that
hold the columns it reads; a GLips row of 256 × 3 bytes starts on a
sector's boundary)."""

from __future__ import annotations

import torch

from benchmark.reference.resnet_trans import TARGET, sample_points

SECTOR = 32


def frame_bytes(boxes: torch.Tensor, h: int, w: int, c: int = 3) -> torch.Tensor:
    """(N,) int64: the source bytes the gather reads of each of N frames
    of (h, w, c) with int32 boxes (N, 4)."""
    y0, y1, _wy, in_y, x0, x1, _wx, in_x = sample_points(boxes, h, w)
    n = boxes.shape[0]
    valid = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    rows = torch.zeros((n, h), dtype=torch.int32, device=boxes.device)
    for y in (y0, y1):
        rows.scatter_add_(1, y, in_y.int())
    sectors = torch.zeros((n, -(-w * c // SECTOR)), dtype=torch.int32, device=boxes.device)
    for x in (x0, x1):
        for byte in (0, c - 1):
            sectors.scatter_add_(1, (x * c + byte) // SECTOR, in_x.int())
    return (rows > 0).sum(1).long() * (sectors > 0).sum(1).long() * valid.long() * SECTOR


def launch_bytes(source_bytes: int, frames: int, c: int = 3) -> int:
    """All the bytes of one launch over ``frames`` frames whose gathers read
    ``source_bytes``: those, the uint8 lips written and the boxes read."""
    return int(source_bytes) + frames * TARGET * TARGET * c + frames * 4 * 4


def bound_s(nbytes: int, peaks: dict) -> float:
    return nbytes / peaks["bytes_per_s"]
