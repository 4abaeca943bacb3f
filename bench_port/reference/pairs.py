"""The pair step and drift correction, as the reference computes them.

* matching: for every keypoint of image A, in order, the first keypoint
  of image B at the least squared L2 distance of their descriptors; the
  match is kept if that distance is under the absolute threshold (1.0
  for Harris, 25000 for SIFT);
* the translation vote: every kept match's move ``(xA - xB, yA - yB)``
  is a hypothesis; its votes are the moves within squared distance
  ``ransac_thresh`` of it; the first hypothesis with the most votes wins
  and gives the pair's shift and its seam pair; no match gives ``(0, 0)``
  and no pair;
* drift: ``total_dy / (N - 1)`` subtracted from every pairwise dy.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

THRESHOLDS = {"harris": dict(desc_thresh=1.0, ransac_thresh=3.0),
              "sift": dict(desc_thresh=25000.0, ransac_thresh=3.0)}


def match(desc_a: np.ndarray, desc_b: np.ndarray, desc_thresh: float):
    """``(rows of A, their nearest rows of B)`` of the kept matches."""
    if len(desc_a) == 0 or len(desc_b) == 0:
        e = np.zeros(0, np.int64)
        return e, e
    a = desc_a.astype(np.float64)
    b = desc_b.astype(np.float64)
    best = np.zeros(len(a), np.int64)
    dist = np.zeros(len(a))
    for lo in range(0, len(a), 256):
        d = a[lo:lo + 256, None, :] - b[None, :, :]
        d = np.einsum("ijk,ijk->ij", d, d)
        best[lo:lo + 256] = np.argmin(d, axis=1)
        dist[lo:lo + 256] = d[np.arange(len(d)), best[lo:lo + 256]]
    rows = np.nonzero(dist < desc_thresh)[0]
    return rows, best[rows]


def vote(moves: np.ndarray, thresh: float) -> int:
    """Index of the first move with the most votes (``-1`` for none)."""
    if len(moves) == 0:
        return -1
    diff = moves[:, None, :] - moves[None, :, :]
    votes = ((diff * diff).sum(-1) < thresh).sum(1)
    return int(np.argmax(votes))


def pair_shift(xy_a, desc_a, xy_b, desc_b, desc_thresh: float,
               ransac_thresh: float):
    """``(shift, seam pair or None)`` of one adjacent pair."""
    rows, cols = match(desc_a, desc_b, desc_thresh)
    pa = xy_a[rows].astype(np.float64)
    pb = xy_b[cols].astype(np.float64)
    win = vote(pa - pb, ransac_thresh)
    if win < 0:
        return (0.0, 0.0), None
    a = (float(pa[win, 0]), float(pa[win, 1]))
    b = (float(pb[win, 0]), float(pb[win, 1]))
    return (a[0] - b[0], a[1] - b[1]), (a, b)


def correct_drift(shifts: Sequence[Tuple[float, float]],
                  n_images: int) -> List[Tuple[float, float]]:
    """Every shift with the mean vertical drift taken out of its dy."""
    total_dy = 0.0
    for _dx, dy in shifts:
        total_dy += dy
    drift = total_dy / (n_images - 1) if n_images > 1 else 0.0
    return [(dx, dy - drift) for dx, dy in shifts]


def shifts_and_pairs(features, thresholds: dict):
    """Every adjacent pair's ``(shift, pair)`` from per-image
    ``(xy, descriptors)`` (``None`` for an unreadable image: shift ``(0,
    0)``, the placeholder pair ``((0, 0), (0, 0))``)."""
    shifts: List[Tuple[float, float]] = []
    pairs: List[Optional[tuple]] = []
    for fa, fb in zip(features, features[1:]):
        if fa is None or fb is None:
            shifts.append((0.0, 0.0))
            pairs.append(((0.0, 0.0), (0.0, 0.0)))
            continue
        s, p = pair_shift(fa[0], fa[1], fb[0], fb[1], **thresholds)
        shifts.append(s)
        pairs.append(p)
    return shifts, pairs
