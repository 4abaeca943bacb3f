"""Batched-hypothesis translation "RANSAC" (exhaustive voting).

The reference is deterministic exhaustive voting, not sampling: every
match's ``(dx, dy) = (xA - xB, yA - yB)`` is a hypothesis; its score is
the number of matches whose move differs by squared distance < 3; the
first argmax wins and the winning *seed match pair* is returned alongside
the move.  Empty match set -> ((0,0), None).

The O(M^2) loop becomes an M x M pairwise squared-distance computation +
row-wise masked count + first argmax, with a validity mask.  Every
function takes a leading batch dimension (one row per image pair).
"""

from __future__ import annotations

from typing import Optional

import torch


def _adjacency(m: torch.Tensor, dist_sq_thresh: float) -> torch.Tensor:
    diff = m[:, :, None, :] - m[:, None, :, :]
    return torch.sum(diff * diff, dim=-1) < dist_sq_thresh


def translation_ransac(
    moves: torch.Tensor, valid: torch.Tensor, dist_sq_thresh: float = 3.0
):
    """Vote over translation hypotheses.

    ``moves`` (B, M, 2) f32 candidate moves, ``valid`` (B, M) bool.
    Returns ``(best_index, best_votes, any_valid)``, each (B,): the first
    row achieving the maximal vote count among valid rows.
    """
    adj = _adjacency(moves.to(torch.float32), dist_sq_thresh)
    votes = torch.sum(adj & valid[:, None, :], dim=-1).to(torch.int32)
    votes = torch.where(valid, votes, torch.full_like(votes, -1))
    best = torch.argmax(votes, dim=-1)
    return (best.to(torch.int32), votes.gather(1, best[:, None])[:, 0],
            valid.any(dim=-1))


def translation_ransac_material(
    moves: torch.Tensor,
    matched: torch.Tensor,
    border_flip: torch.Tensor,
    border_swap: torch.Tensor,
    alt_moves: Optional[torch.Tensor] = None,
    alt_valid: Optional[torch.Tensor] = None,
    dist_sq_thresh: float = 3.0,
    swap_cap: int = 64,
):
    """Vote + per-row decision materiality, in one O(K^2) pass.

    Borderline rows are knife edges the f32 descriptor path cannot decide
    (see models/sift/strict.py): a ``border_flip`` row's threshold
    decision may flip; a ``border_swap`` row's argmin may swap to one of
    its in-margin runner-up candidates, moving the row's hypothesis to a
    known alternative ``alt_moves[b, j, c]`` (valid where
    ``alt_valid[b, j, c]``).  A row is *material* when one of its possible
    single-row changes alters the winning hypothesis (or ``any_match``,
    or makes the row itself win a swap scenario).  Swap scenarios run on
    the first ``swap_cap`` swap rows; any further swap rows are
    conservatively material.

    Shapes: (B, K, 2) moves, (B, K) masks, (B, K, C, 2) / (B, K, C)
    alternatives.  Returns ``(best_index, best_votes, any_match,
    material, n_material)``.
    """
    bsz, k = matched.shape
    dev = moves.device
    if alt_moves is None:  # swap rows are then material only via flip
        alt_moves = torch.zeros((bsz, k, 0, 2), dtype=torch.float32, device=dev)
        alt_valid = torch.zeros((bsz, k, 0), dtype=torch.bool, device=dev)
    m = moves.to(torch.float32)
    adj = _adjacency(m, dist_sq_thresh)                       # (B, K, K)
    votes = torch.sum(adj & matched[:, None, :], dim=-1).to(torch.int32)
    neg1 = torch.full_like(votes, -1)
    votes_masked = torch.where(matched, votes, neg1)
    best = torch.argmax(votes_masked, dim=-1)                 # (B,)
    best_votes = votes_masked.gather(1, best[:, None])[:, 0]
    any_now = matched.any(dim=-1)

    # flip scenario per row j: counts under j's flip (remove if matched
    # else add); candidate hypothesis rows after the flip
    sign = torch.where(matched, -1, 1).to(torch.int32)
    counts = votes[:, None, :] + sign[:, :, None] * adj.to(torch.int32)
    eye = torch.eye(k, dtype=torch.bool, device=dev)
    cand = (matched[:, None, :] & ~(matched[:, :, None] & eye)) | (
        (~matched)[:, :, None] & eye
    )
    winner_j = torch.argmax(
        torch.where(cand, counts, torch.full_like(counts, -1)), dim=-1
    )
    scen_any = cand.any(dim=-1)
    flip_changes = (scen_any != any_now[:, None]) | (
        scen_any & any_now[:, None] & (winner_j != best[:, None])
    )

    # exact swap scenarios over the compacted swap rows
    s = min(swap_cap, k)
    order = torch.argsort((~border_swap).to(torch.int8), dim=-1, stable=True)
    rows = order[:, :s]                                       # (B, S)
    slot_swap = border_swap.gather(1, rows)
    bidx = torch.arange(bsz, device=dev)[:, None]
    r_alt = alt_moves[bidx, rows].to(torch.float32)           # (B, S, C, 2)
    r_valid = alt_valid[bidx, rows] & slot_swap[:, :, None]   # (B, S, C)
    ad = r_alt[:, :, :, None, :] - m[:, None, None, :, :]
    alt_adj = torch.sum(ad * ad, dim=-1) < dist_sq_thresh     # (B, S, C, K)
    # rival i's count: loses j's departing vote, gains the re-landed one
    # if the alternative lands in its cluster
    m_rows = matched.gather(1, rows)                          # (B, S)
    dep = (adj[bidx, rows] & m_rows[:, :, None]).to(torch.int32)  # (B, S, K)
    cnt = votes[:, None, None, :] - dep[:, :, None, :] + alt_adj.to(torch.int32)
    # j's own count at the alternative: matched neighbors of the new
    # position (minus j's old vote if it was adjacent) + its own vote
    n_alt = alt_adj.shape[2]
    self_adj = torch.gather(
        alt_adj, 3, rows[:, :, None, None].expand(bsz, s, n_alt, 1)
    )[..., 0]                                                 # (B, S, C)
    nbr = torch.sum(alt_adj & matched[:, None, None, :], dim=-1).to(torch.int32)
    cnt_j = nbr - (self_adj & m_rows[:, :, None]).to(torch.int32) + 1
    is_j = (torch.arange(k, device=dev)[None, None, None, :]
            == rows[:, :, None, None])                        # (B, S, 1, K)
    counts_sc = torch.where(is_j, cnt_j[..., None], cnt)      # (B, S, C, K)
    cand_sc = matched[:, None, None, :] | is_j
    winner_sc = torch.argmax(
        torch.where(cand_sc, counts_sc, torch.full_like(counts_sc, -1)), dim=-1
    )                                                         # (B, S, C)
    changed = (
        (winner_sc != best[:, None, None]) | (winner_sc == rows[:, :, None])
        | ~any_now[:, None, None]
    )
    mat_slot = torch.any(r_valid & changed, dim=-1)           # (B, S)
    zeros = torch.zeros_like(matched)
    material_swap = zeros.scatter(1, rows, mat_slot & slot_swap)
    selected = zeros.scatter(1, rows, slot_swap)
    material_swap = material_swap | (border_swap & ~selected)  # overflow

    material = (border_flip & flip_changes) | (
        border_swap & flip_changes
    ) | material_swap
    return (best.to(torch.int32), best_votes, any_now, material,
            torch.sum(material, dim=-1).to(torch.int32))
