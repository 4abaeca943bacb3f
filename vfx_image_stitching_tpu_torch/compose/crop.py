"""Rectangling crop (image_stitching_harris.py:381-420).

Gray > black_threshold defines content; the bounding box is shrunk by
``extra_margin`` in y only (the reference's x-shrink is commented out); a
degenerate box or an all-black image returns the input unchanged.  The
bounds come from :func:`compose.host.content_bounds_host` for a host
mosaic, or from :func:`crop_bounds` / :func:`mosaic_with_bounds` for a
mosaic on a device (mask reductions there, the slice on the host).
"""

from __future__ import annotations

import numpy as np
import torch

from vfx_image_stitching_tpu_torch.compose.host import content_bounds_host
from vfx_image_stitching_tpu_torch.ops.color import bgr_to_gray_u8
from vfx_image_stitching_tpu_torch.utils.profiling import count_d2h


def _content_bounds(img: torch.Tensor, black_threshold: int) -> torch.Tensor:
    """``(y_min, y_max, x_min, x_max, any)`` of an (H, W, 3) uint8 mosaic
    as one (5,) int64 tensor on its device; an all-black mosaic gives
    ``(0, H-1, 0, W-1, 0)``, as :func:`compose.host.content_bounds_host`."""
    mask = bgr_to_gray_u8(img) > black_threshold
    rows = mask.any(dim=1).to(torch.int32)
    cols = mask.any(dim=0).to(torch.int32)
    h, w = mask.shape
    # argmax returns the first maximal index
    y_min = torch.argmax(rows)
    y_max = h - 1 - torch.argmax(rows.flip(0))
    x_min = torch.argmax(cols)
    x_max = w - 1 - torch.argmax(cols.flip(0))
    return torch.stack([y_min, y_max, x_min, x_max,
                        rows.amax().to(torch.int64)])


def _bounds_tuple(bounds) -> tuple:
    y0, y1, x0, x1, anyc = (int(v) for v in bounds.tolist())
    return y0, y1, x0, x1, bool(anyc)


def crop_bounds(img_device: torch.Tensor, black_threshold: int) -> tuple:
    """Bounds of a mosaic on a device, pulled to the host."""
    bounds = _content_bounds(img_device, black_threshold)
    count_d2h(bounds.nbytes)
    return _bounds_tuple(bounds.cpu())


def mosaic_with_bounds(img: torch.Tensor, black_threshold: int):
    """``(mosaic, bounds)`` on the host: the mosaic pulled as it is, and
    its bounds computed on its device and pulled as their own (5,)
    tensor (both pulls counted in the current request)."""
    bounds = _content_bounds(img, black_threshold)
    count_d2h(img.nbytes)
    count_d2h(bounds.nbytes)
    return img.cpu().numpy(), _bounds_tuple(bounds.cpu())


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
