"""Forward-rounded cylindrical projection.

The reference projects with a per-pixel Python loop: for every source
pixel,

    x' = round(f * atan((x-cx)/f)) + cx
    y' = round(f * (y-cy) / sqrt((x-cx)^2 + f^2)) + cy

scattering source -> dest, dropping out-of-bounds, leaving unmapped pixels
black, with *last-writer-wins in row-major source order* on collisions.

The mapping depends only on (h, w, focal), so the *index map* (winning
source pixel per output pixel, or -1) is computed once per focal on the
host in float64 — a copy of the JAX package's map, bit-identical to the
reference's Python-float math including banker's rounding — and the
per-image work is one flat gather, batched over the dataset, on whatever
device the images live on.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def cylindrical_index_map(h: int, w: int, focal: float) -> np.ndarray:
    """(h*w,) int32: winning flat source index per output pixel, -1 if none."""
    f = float(focal)
    yy, xx = np.mgrid[0:h, 0:w]
    cx = w // 2
    cy = h // 2
    x_dist = (xx - cx).astype(np.float64)
    y_dist = (yy - cy).astype(np.float64)
    # np.round == Python round on float64 (banker's / half-to-even).
    x_mapped = np.round(f * np.arctan(x_dist / f)).astype(np.int64) + cx
    denom = np.sqrt(x_dist**2 + f * f)
    y_mapped = np.round(f * (y_dist / denom)).astype(np.int64) + cy
    valid = (x_mapped >= 0) & (x_mapped < w) & (y_mapped >= 0) & (y_mapped < h)

    dest = (y_mapped * w + x_mapped).ravel()
    src = np.arange(h * w, dtype=np.int64)
    ok = valid.ravel()
    winner = np.full(h * w, -1, dtype=np.int64)
    # Fancy assignment applies indices in order -> the last (row-major
    # largest) source index wins, matching the reference's loop order.
    winner[dest[ok]] = src[ok]
    return winner.astype(np.int32)


def _gather_project(images: torch.Tensor, winners: torch.Tensor) -> torch.Tensor:
    """(N, H, W, ...) images gathered through (N, H*W) winner maps."""
    n, h, w = images.shape[:3]
    flat = images.reshape(n, h * w, -1)
    idx = winners.clamp(0, h * w - 1).to(torch.int64)
    picked = torch.gather(flat, 1, idx[:, :, None].expand(-1, -1, flat.shape[-1]))
    out = torch.where((winners >= 0)[:, :, None], picked, torch.zeros_like(picked))
    return out.reshape(images.shape)


def cylindrical_project(img_bgr: torch.Tensor, focal: float) -> torch.Tensor:
    """Project one (H, W[, C]) image; unmapped pixels are black."""
    return cylindrical_project_batch(img_bgr[None], (focal,))[0]


def cylindrical_project_batch(
    batch_bgr: torch.Tensor, focals: Sequence[float]
) -> torch.Tensor:
    """Project an (N, H, W[, C]) batch with per-image focals, on the
    batch's device."""
    n, h, w = batch_bgr.shape[:3]
    winners = np.stack([cylindrical_index_map(h, w, float(f)) for f in focals])
    return _gather_project(
        batch_bgr, torch.as_tensor(winners, device=batch_bgr.device)
    )
