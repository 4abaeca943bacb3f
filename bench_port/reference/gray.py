"""BGR to gray as OpenCV 5's ``cvtColor(COLOR_BGR2GRAY)`` computes it on
uint8: ``(3735 B + 19235 G + 9798 R + 2^14) >> 15``.

Spelt out rather than called, so that the reference computes the same
gray image whatever OpenCV is installed (4.x rounds 14-bit weights,
which moves some pixels by one level).
"""

from __future__ import annotations

import numpy as np


def gray_u8(bgr: np.ndarray) -> np.ndarray:
    """(H, W) uint8 gray of an (H, W, 3) uint8 BGR image."""
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    return ((3735 * b + 19235 * g + 9798 * r + (1 << 14)) >> 15).astype(np.uint8)
