"""Forward-rounded cylindrical projection (the reference's
``cylindrical_projection``).

Every source pixel ``(y, x)`` goes to

    x' = round(f * atan((x - cx) / f)) + cx
    y' = round(f * (y - cy) / sqrt((x - cx)^2 + f^2)) + cy

with ``(cx, cy) = (w // 2, h // 2)``, rounding half to even as Python's
``round`` does; a pixel mapped outside the image is dropped, an output
pixel nothing maps to stays black, and where two source pixels land on
one output pixel the later one in row-major order wins, as the
reference's loop writes them.
"""

from __future__ import annotations

import numpy as np


def project(img: np.ndarray, focal: float) -> np.ndarray:
    """The (h, w, 3) uint8 image projected at ``focal``."""
    h, w = img.shape[:2]
    f = float(focal)
    cx, cy = w // 2, h // 2
    ys, xs = np.mgrid[0:h, 0:w]
    x_dist = (xs - cx).astype(np.float64)
    y_dist = (ys - cy).astype(np.float64)
    xm = np.round(f * np.arctan(x_dist / f)).astype(np.int64) + cx
    ym = np.round(f * (y_dist / np.sqrt(x_dist ** 2 + f * f))).astype(np.int64) + cy
    ok = (xm >= 0) & (xm < w) & (ym >= 0) & (ym < h)
    out = np.zeros_like(img)
    # one assignment in row-major source order: a repeated target keeps
    # the last source written to it
    out[ym[ok], xm[ok]] = img[ys[ok], xs[ok]]
    return out
