"""Rectangling crop (image_stitching_harris.py:381-420), host side.

Gray > black_threshold defines content; the bounding box is shrunk by
``extra_margin`` in y only (the reference's x-shrink is commented out); a
degenerate box or an all-black image returns the input unchanged.  The
bounds come from :func:`compose.host.content_bounds_host`.
"""

from __future__ import annotations

import numpy as np

from vfx_image_stitching_tpu_torch.compose.host import content_bounds_host


def apply_crop(
    img: np.ndarray, bounds, extra_margin: int
) -> np.ndarray:
    """Host-side slice with the reference margin semantics."""
    y_min, y_max, x_min, x_max, any_content = bounds
    h = img.shape[0]
    if not bool(any_content):
        return img
    y_min = max(0, int(y_min) + extra_margin)
    y_max = min(h - 1, int(y_max) - extra_margin)
    if y_min > y_max or int(x_min) > int(x_max):
        return img
    return img[y_min : y_max + 1, int(x_min) : int(x_max) + 1]


def rectangle_crop(
    img: np.ndarray, black_threshold: int, extra_margin: int, bounds=None
) -> np.ndarray:
    """Crop to the content bounding box, shrunk by extra_margin in y."""
    if bounds is None:
        bounds = content_bounds_host(img, black_threshold)
    return apply_crop(img, bounds, extra_margin)
