"""Parity metrics: alignment-tolerant RMSE against golden panoramas.

Vote ties in the translation RANSAC can legitimately resolve differently
under float32 (several hypotheses with identical vote counts — observed
on parrington pair 13), shifting a panorama by a pixel or two.  Direct
pixel-wise RMSE is then undefined (shapes differ); ``aligned_rmse``
searches a small integer offset window and reports the best-overlap RMSE,
which is the faithful "blend tolerance" comparison.

A copy of the JAX package's ``utils/metrics.py`` (numpy only).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def aligned_rmse(
    ours: np.ndarray, golden: np.ndarray, max_offset: int = 8
) -> Tuple[float, Tuple[int, int]]:
    """Best RMSE over integer alignments within ±max_offset.

    Images may differ in shape by up to 2*max_offset; comparison runs on
    the overlapping region at each candidate offset.
    """
    a = ours.astype(np.float64)
    b = golden.astype(np.float64)
    best = (float("inf"), (0, 0))
    for dy in range(-max_offset, max_offset + 1):
        for dx in range(-max_offset, max_offset + 1):
            ay0, by0 = max(0, dy), max(0, -dy)
            ax0, bx0 = max(0, dx), max(0, -dx)
            h = min(a.shape[0] - ay0, b.shape[0] - by0)
            w = min(a.shape[1] - ax0, b.shape[1] - bx0)
            if h <= 0 or w <= 0:
                continue
            if h * w < 0.5 * min(a.shape[0] * a.shape[1],
                                 b.shape[0] * b.shape[1]):
                continue
            d = a[ay0 : ay0 + h, ax0 : ax0 + w] - b[by0 : by0 + h, bx0 : bx0 + w]
            rmse = float(np.sqrt((d * d).mean()))
            if rmse < best[0]:
                best = (rmse, (dy, dx))
    return best
