"""Published peaks of the cards the benchmark knows (NVIDIA's data sheet,
SXM part, dense rates), at the card's full power limit."""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "H100": {"fp32_flops": 67e12, "tf32_flops": 495e12, "bf16_flops": 989e12, "bytes_per_s": 3.35e12},
}


def for_device(name: str) -> Optional[dict]:
    """The peaks of the card named ``name`` (``torch.cuda.get_device_name``),
    or None for a card the table does not hold."""
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    return None
