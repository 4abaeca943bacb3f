"""Brute-force nearest-neighbor matching as one batched matmul.

The reference does an O(N_A * N_B * 128) pure-Python loop: nearest
neighbor in squared L2, kept iff the best distance beats an *absolute*
threshold (1.0 for unit-norm Harris descriptors, 25000 for 0..255-scaled
SIFT descriptors; no Lowe ratio, no cross-check).

``|a|^2 + |b|^2 - 2 a.b`` via a matmul, then (``refine > 1``) an exact
re-check of the top candidates per row.  For SIFT's integer-valued
descriptors the matmul is already exact: every partial sum is an integer
below 2^24, exact in f32 — provided the matmul runs in full f32, which
is why the stitch entry point turns TF32 off.

Every function takes leading batch dimensions (the pipeline matches all
adjacent pairs at once).  Ties keep the *first* index, as the reference's
strict ``<`` scan does.
"""

from __future__ import annotations

from typing import Tuple

import torch

_BIG = 3.0e38


def pairwise_sqdist(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(..., K_A, K_B) squared L2 distances via matmul (f32 accumulate)."""
    a = desc_a.to(torch.float32)
    b = desc_b.to(torch.float32)
    ab = torch.matmul(a, b.transpose(-1, -2))
    na = torch.sum(a * a, dim=-1, keepdim=True)
    nb = torch.sum(b * b, dim=-1, keepdim=True)
    return na + nb.transpose(-1, -2) - 2.0 * ab


def _first_min(d2: torch.Tensor):
    return torch.amin(d2, dim=-1), torch.argmin(d2, dim=-1).to(torch.int32)


def match_descriptors(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    desc_thresh: float,
    refine: int = 8,
    return_dist: bool = False,
    margin: float = 0.0,
) -> Tuple[torch.Tensor, ...]:
    """Per-A-row nearest neighbor in B under an absolute threshold.

    Returns ``(best_idx, matched)`` (the Lowe-ratio option of the JAX
    package's matcher serves its UI surface and is not ported yet).  With
    ``return_dist=True`` also
    returns ``(best_dist, second_dist, cand_idx (..., K, 4), cand_dist
    (..., K, 4), n_inmargin)`` — the top-4 candidate set by exact
    distance used by the knife-edge escalation, and per A row the count
    of ALL candidates within ``margin`` of the row's best.
    """
    d2 = pairwise_sqdist(desc_a, desc_b)
    big = torch.full((), _BIG, dtype=torch.float32, device=d2.device)
    d2 = torch.where(valid_b[..., None, :], d2, big)
    n_b = d2.shape[-1]

    if refine <= 1:
        # integer-descriptor path (SIFT): the matmul distances are exact
        best_dist, best_idx = _first_min(d2)
        matched = valid_a & (best_dist < desc_thresh) & (best_dist < _BIG)
        if not return_dist:
            return best_idx, matched
        cols = torch.arange(n_b, dtype=torch.int32, device=d2.device)
        n_cand = min(4, n_b)
        # iterative first-min + mask: the (value, first-index) order of a
        # stable top-4
        d2m = d2
        idxs, dists = [best_idx], [best_dist]
        for _ in range(n_cand - 1):
            d2m = torch.where(cols == idxs[-1][..., None], big, d2m)
            dist, idx = _first_min(d2m)
            dists.append(dist)
            idxs.append(idx)
        cand_idx = torch.stack(idxs, dim=-1)
        cand_dist = torch.stack(dists, dim=-1)
        second = cand_dist[..., 1] if n_cand > 1 else best_dist
        n_inmargin = torch.sum(
            (d2 < best_dist[..., None] + margin) & (d2 < _BIG), dim=-1
        ).to(torch.int32)
        return (best_idx, matched, best_dist, second, cand_idx, cand_dist,
                n_inmargin)

    refine = min(refine, n_b)
    # top `refine` candidates per row by approximate distance; a stable
    # sort keeps the lower index first among equal distances (lax.top_k)
    order = torch.sort(d2, dim=-1, stable=True)
    approx = order.values[..., :refine]
    cand_idx = order.indices[..., :refine]
    cand_desc = torch.gather(
        desc_b[..., None, :, :].expand(*d2.shape[:-1], n_b, desc_b.shape[-1]),
        -2, cand_idx[..., None].expand(*cand_idx.shape, desc_b.shape[-1]),
    )
    diff = desc_a[..., None, :].to(torch.float32) - cand_desc.to(torch.float32)
    exact = torch.sum(diff * diff, dim=-1)
    exact = torch.where(approx >= _BIG, big, exact)
    best_dist = torch.amin(exact, dim=-1)
    int_max = torch.iinfo(torch.int32).max
    best_idx = torch.amin(
        torch.where(exact == best_dist[..., None], cand_idx,
                    torch.full_like(cand_idx, int_max)),
        dim=-1,
    ).to(torch.int32)

    matched = valid_a & (best_dist < desc_thresh) & (best_dist < _BIG)
    if not return_dist:
        return best_idx, matched
    n_cand = min(4, refine)
    by_exact = torch.sort(exact, dim=-1, stable=True)
    out_dist = by_exact.values[..., :n_cand]
    out_idx = torch.gather(cand_idx, -1, by_exact.indices[..., :n_cand]).to(
        torch.int32
    )
    second = out_dist[..., min(1, n_cand - 1)] if n_cand > 1 else best_dist
    n_inmargin = torch.sum(
        (d2 < best_dist[..., None] + margin) & (d2 < _BIG), dim=-1
    ).to(torch.int32)
    return best_idx, matched, best_dist, second, out_idx, out_dist, n_inmargin
