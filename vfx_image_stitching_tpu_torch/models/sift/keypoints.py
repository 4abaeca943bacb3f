"""Keypoint struct-of-arrays and set-level operations.

Fixed-capacity masked arrays in place of the reference's lists of
``cv2.KeyPoint``; the packed-octave encoding is kept bit-compatible so
``unpack_octave`` round-trips with the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

_INT_MAX = torch.iinfo(torch.int32).max


class Keypoints(NamedTuple):
    """Fixed-capacity masked keypoint set (all fields shape (K,))."""

    x: torch.Tensor          # f32 pt[0]
    y: torch.Tensor          # f32 pt[1]
    size: torch.Tensor       # f32
    angle: torch.Tensor      # f32 degrees
    response: torch.Tensor   # f32
    octave: torch.Tensor     # i32 packed: octave + layer<<8 + offset_byte<<16
    valid: torch.Tensor      # bool
    # Newton-fit cells (octave-local ints) for the strict host path:
    # (ix, iy) is the final (post-move) cell, (jx, jy, jl) the
    # last-COMPUTE cell.
    ix: torch.Tensor
    iy: torch.Tensor
    jx: torch.Tensor
    jy: torch.Tensor
    jl: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid, dim=-1)


def concatenate(sets: Tuple[Keypoints, ...]) -> Keypoints:
    return Keypoints(*[torch.cat(f, dim=-1) for f in zip(*sets)])


def take(kps: Keypoints, idx: torch.Tensor, idx_valid: torch.Tensor) -> Keypoints:
    out = Keypoints(*[f[idx] for f in kps])
    return out._replace(valid=out.valid & idx_valid)


def unpack_octave(octave_packed: torch.Tensor):
    """(octave, layer, scale) from the packed int (sift_impl.py:349-358):
    sign-extends the low byte; ``scale = 2^-octave``."""
    octave = octave_packed & 255
    layer = (octave_packed >> 8) & 255
    octave = torch.where(octave >= 128, octave | ~255, octave)
    scale = torch.exp2(-octave.to(torch.float32))
    return octave, layer, scale


def convert_keypoints_to_input_image_size(kps: Keypoints) -> Keypoints:
    """Halve pt/size, decrement packed octave (sift_impl.py:333-343)."""
    new_octave = (kps.octave & ~255) | ((kps.octave - 1) & 255)
    return kps._replace(
        x=kps.x * 0.5, y=kps.y * 0.5, size=kps.size * 0.5, octave=new_octave
    )


def _stable_lexsort(keys) -> torch.Tensor:
    """Permutation sorting by ``keys`` (last key primary), ties kept in
    index order: stable sorts chained from the least significant key."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in keys:
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def sort_and_dedup(
    kps: Keypoints, descriptors: torch.Tensor, out_capacity: int
) -> Tuple[Keypoints, torch.Tensor]:
    """Canonical sort + duplicate removal + compaction.

    Reference semantics (sift_impl.py:299-327): sort by (x asc, y asc,
    size desc, angle asc, response desc, class_id) — class_id is -1 for
    every keypoint and Python's sort is stable, so the final tiebreak is
    the original emission order; then drop any keypoint whose (pt, size,
    angle) equals its predecessor's.  Invalid slots sort to the end; the
    first ``out_capacity`` rows survive compaction.
    """
    big = torch.full_like(kps.x, 3.0e38)
    x = torch.where(kps.valid, kps.x, big)
    y = torch.where(kps.valid, kps.y, big)
    order = _stable_lexsort((-kps.response, kps.angle, -kps.size, y, x))
    s = Keypoints(*[f[order] for f in kps])
    desc_s = descriptors[order]

    same_as_prev = (
        (s.x == torch.roll(s.x, 1))
        & (s.y == torch.roll(s.y, 1))
        & (s.size == torch.roll(s.size, 1))
        & (s.angle == torch.roll(s.angle, 1))
    )
    same_as_prev[0] = False
    keep = s.valid & ~same_as_prev
    comp_order = _compact_order(keep)[:out_capacity]
    out = Keypoints(*[f[comp_order] for f in s])
    return out._replace(valid=keep[comp_order]), desc_s[comp_order]


def _compact_order(valid: torch.Tensor) -> torch.Tensor:
    """Stable permutation putting valid rows first, both sides in order."""
    ar = torch.arange(valid.shape[0], dtype=torch.int32, device=valid.device)
    rank = torch.where(valid, ar, torch.full_like(ar, _INT_MAX))
    return torch.argsort(rank, stable=True)


def compact(kps: Keypoints, out_capacity: int) -> Keypoints:
    """Keep valid rows (original order) in the first ``out_capacity`` slots."""
    order = _compact_order(kps.valid)[:out_capacity]
    return Keypoints(*[f[order] for f in kps])
