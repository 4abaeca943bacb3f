"""Harris corners and their patch descriptors, in float64 as the
reference (``image_stitching_harris.py``: ``HarrisCorner``,
``calc_orientation``, ``gen_descriptor``) computes them.

* gray (:mod:`.gray`) -> signed 3x3 gradients ``Ix = I(x-1) - I(x+1)``, ``Iy =
  I(y-1) - I(y+1)`` on the edge-padded image;
* ``Ix^2``, ``Iy^2``, ``IxIy`` blurred by ``cv2.GaussianBlur`` (21x21,
  sigma 2), ``R = det - k tr^2``;
* a corner is an interior pixel with ``R > 0.02 max(R)`` equal to the
  maximum of its 3x3 patch; the 200 strongest are kept (ties in
  row-major order), then those within 8 px of the border dropped;
* each descriptor: the 16x16 patch of gradient magnitude and angle whose
  top left pixel is the corner (fields edge-padded past the border), the magnitude patch blurred 9x9 with
  sigma 4.5, the main orientation ``(argmax + 0.5) * 45`` of a global
  8-bin histogram, then 4x4 cells of 8 bins of the angle less the main
  orientation, normalized, clipped at 0.2, normalized again.

``lowp`` is the control: every float field stored in bfloat16.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from bench_port.reference.gray import gray_u8
from bench_port.reference.lowp import store

DEFAULTS = dict(max_points=200, k=0.05, block_size=21, gauss_sigma=2.0,
                thresh_ratio=0.02, border_margin=8, patch_size=16,
                desc_blur_ksize=9, desc_blur_sigma=4.5, desc_bins=8,
                desc_cells=4, desc_clip=0.2)


def _gradients(gray: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    p = np.pad(gray, 1, mode="edge")
    ix = p[1:-1, :-2] - p[1:-1, 2:]
    iy = p[:-2, 1:-1] - p[2:, 1:-1]
    return ix, iy


def corners(gray: np.ndarray, prm: dict, lowp: bool = False):
    """``(ys, xs, ix, iy)``: the kept corners' rows and columns, strongest
    first, and the gradient fields."""
    import cv2

    h, w = gray.shape
    ix, iy = (store(g, lowp) for g in _gradients(gray))
    ks = (prm["block_size"], prm["block_size"])
    s = prm["gauss_sigma"]
    ix2 = store(cv2.GaussianBlur(ix * ix, ks, s), lowp)
    iy2 = store(cv2.GaussianBlur(iy * iy, ks, s), lowp)
    ixy = store(cv2.GaussianBlur(ix * iy, ks, s), lowp)
    r = store(ix2 * iy2 - ixy * ixy - prm["k"] * (ix2 + iy2) ** 2, lowp)
    threshold = r.max() * prm["thresh_ratio"]
    c = r[1:-1, 1:-1]
    patch_max = np.max(np.stack([r[1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]
                                 for dy in (-1, 0, 1) for dx in (-1, 0, 1)]),
                       axis=0)
    ys, xs = np.nonzero((c > threshold) & (c == patch_max))
    ys, xs = ys + 1, xs + 1
    order = np.argsort(-r[ys, xs], kind="stable")[:prm["max_points"]]
    ys, xs = ys[order], xs[order]
    m = prm["border_margin"]
    keep = (ys >= m) & (ys < h - m) & (xs >= m) & (xs < w - m)
    return ys[keep], xs[keep], ix, iy


def _bins(theta: np.ndarray, bins: int) -> np.ndarray:
    return np.floor(theta * (bins / 360.0)).astype(np.int64) % bins


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / (np.sqrt(np.sum(v * v)) + 1e-7)


def descriptor(mag_pad: np.ndarray, ang_pad: np.ndarray, y: int, x: int,
               prm: dict) -> np.ndarray:
    """The 128-d descriptor of the corner at ``(y, x)`` from fields
    edge-padded by half a patch: rows ``y .. y + 15`` and columns ``x ..
    x + 15`` of the field."""
    import cv2

    size, bins, cells = prm["patch_size"], prm["desc_bins"], prm["desc_cells"]
    pad = size // 2
    pm = np.ascontiguousarray(mag_pad[y + pad:y + pad + size, x + pad:x + pad + size])
    pt = ang_pad[y + pad:y + pad + size, x + pad:x + pad + size]
    k = prm["desc_blur_ksize"]
    s = prm["desc_blur_sigma"]
    pm = cv2.GaussianBlur(pm, (k, k), s)
    hist = np.bincount(_bins(pt % 360.0, bins).ravel(), pm.ravel(), bins)
    main = (np.argmax(hist) + 0.5) * (360.0 / bins)
    shifted = (pt - main + 360.0) % 360.0
    cell = size // cells
    b = _bins(shifted % 360.0, bins)
    desc = np.zeros((cells, cells, bins))
    for by in range(cells):
        for bx in range(cells):
            sl = (slice(by * cell, (by + 1) * cell), slice(bx * cell, (bx + 1) * cell))
            desc[by, bx] = np.bincount(b[sl].ravel(), pm[sl].ravel(), bins)
    desc = _normalize(desc.ravel())
    return _normalize(np.clip(desc, 0.0, prm["desc_clip"]))


def features(bgr: np.ndarray, prm: dict, lowp: bool = False):
    """``(xy, descriptors)`` of one BGR uint8 image: (K, 2) float64 (x, y)
    and (K, 128) float64, in the order the matcher visits them."""
    gray = gray_u8(bgr).astype(np.float64)
    ys, xs, ix, iy = corners(gray, prm, lowp)
    mag = store(np.sqrt(ix * ix + iy * iy), lowp)
    ang = store(np.degrees(np.arctan2(iy, ix)) % 360.0, lowp)
    pad = prm["patch_size"] // 2
    mag_pad = np.pad(mag, pad, mode="edge")
    ang_pad = np.pad(ang, pad, mode="edge")
    desc = np.array([descriptor(mag_pad, ang_pad, int(y), int(x), prm)
                     for y, x in zip(ys, xs)]).reshape(-1, 128)
    xy = np.stack([xs, ys], axis=-1).astype(np.float64)
    return xy, desc
