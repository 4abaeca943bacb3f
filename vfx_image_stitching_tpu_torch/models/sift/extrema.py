"""Scale-space extrema detection (sift_impl.py:117-163 parity).

One 3x3x3 window comparison over the whole (5, H, W) DoG stack plus a
fixed-capacity row-major candidate extraction.

Parity notes: threshold is ``floor(0.5*contrast/intervals*255)`` with the
*strict* magnitude test ``|val| > thresh``; neighbor comparisons are
non-strict (>= / <=), which is exactly ``val == max(3x3x3 cube)`` /
``val == min(cube)``; candidates are visited in (layer, y, x) row-major
order.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def extrema_threshold(contrast_threshold: float, num_intervals: int) -> float:
    return float(math.floor(0.5 * contrast_threshold / num_intervals * 255))


def _sep3(dog: torch.Tensor, op) -> torch.Tensor:
    """Separable 3x3x3 window reduction (VALID), one axis per pass."""
    r = op(op(dog[..., :-2], dog[..., 1:-1]), dog[..., 2:])
    r = op(op(r[..., :-2, :], r[..., 1:-1, :]), r[..., 2:, :])
    return op(op(r[:-2], r[1:-1]), r[2:])


def extrema_mask(
    dog: torch.Tensor, border: int, threshold: float
) -> torch.Tensor:
    """(3, H, W) bool: is (layer=i+1, y, x) a 26-neighbor extremum."""
    h, w = dog.shape[-2:]
    win_max = _sep3(dog, torch.maximum)
    win_min = _sep3(dog, torch.minimum)
    center = dog[1:4, 1 : h - 1, 1 : w - 1]
    pos = (center > threshold) & (center == win_max)
    neg = (center < -threshold) & (center == win_min)
    mask = torch.zeros((3, h, w), dtype=torch.bool, device=dog.device)
    mask[:, 1 : h - 1, 1 : w - 1] = pos | neg
    inb = torch.zeros((h, w), dtype=torch.bool, device=dog.device)
    if h > 2 * border and w > 2 * border:
        inb[border : h - border, border : w - border] = True
    return mask & inb[None, :, :]


def extract_candidates(
    dog: torch.Tensor, border: int, threshold: float, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """First ``capacity`` extrema in (layer, y, x) row-major order.

    Position of the t-th set bit by a binary search of the running count
    (the JAX package's flat path; its two-level search selects the same
    bits).  Returns (layer, y, x, valid), each (capacity,); unfilled slots
    carry index 0.
    """
    h, w = dog.shape[-2:]
    mask = extrema_mask(dog, border, threshold).reshape(-1)
    csum = torch.cumsum(mask.to(torch.int32), 0).to(torch.int32)
    targets = torch.arange(1, capacity + 1, dtype=torch.int32, device=dog.device)
    sel = torch.searchsorted(csum, targets, side="left").to(torch.int32)
    valid = targets <= csum[-1]
    sel = torch.where(valid, sel, torch.zeros_like(sel))
    i = torch.div(sel, h * w, rounding_mode="floor")
    rem = sel - i * (h * w)
    y = torch.div(rem, w, rounding_mode="floor")
    return (i + 1).to(torch.int32), y.to(torch.int32), (rem - y * w).to(torch.int32), valid
