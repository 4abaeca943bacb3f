"""End-to-end drift correction (host, float64 for reference parity).

The reference (image_stitching_harris.py:502-520) accumulates the pairwise
shifts, computes ``average_drift = total_dy / (N - 1)`` with ``N = number
of pano.txt entries`` (including unreadable images!), and subtracts it from
every pairwise dy.  dx is untouched; dy becomes float.  This is pure
scalar math over at most a few dozen values — it stays on the host in
Python floats, which *is* the reference semantics.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def correct_drift(
    shifts: Sequence[Tuple[float, float]], n_images: int
) -> List[Tuple[float, float]]:
    """Subtract the average per-step dy drift from every shift."""
    acc_x, acc_y = 0.0, 0.0
    for dx, dy in shifts:
        acc_x += dx
        acc_y += dy
    average_drift = acc_y / (n_images - 1) if n_images > 1 else 0.0
    return [(dx, dy - average_drift) for dx, dy in shifts]
