"""Host-side compositing planner.

The reference's pass 2 (image_stitching_harris.py:523-534) folds images
into a growing mosaic: each ``blend_two_images`` call
(image_stitching_harris.py:327-376) *translates the existing mosaic* and
the incoming image by pads derived from the winning match pair, grows the
canvas to the union, and alpha-blends per column.  Canvas shapes change
every step — anathema to XLA.

TPU design: all blend geometry is a function of the (already computed)
shifts and match pairs, so the entire shape schedule is planned here on the
host with reference-parity rounding, producing
  * the final canvas size (H_f, W_f),
  * for every step, the *absolute* placement of the incoming image on the
    final canvas, the swap flag, and the alpha denominator.

Derivation: let F_j be the local canvas frame after step j (F_0 = image 0
frame).  ``pad_image(A, -padA_x, -dy)`` moves mosaic content by
``a = (max(round(-padA_x),0), max(round(-dy),0))`` (F_{j-1} -> F_j) and
``pad_image(B, padB_x, dy)`` places the image at
``b = (max(round(padB_x),0), max(round(dy),0))`` in F_j
(image_stitching_harris.py:311-325,341-345).  Composing translations, the
offset of frame F_j inside the final frame F_{N-1} is
``T_j = sum_{t>j} a_t``; every image's absolute placement is ``b_j + T_j``
(plus the pass-2 height-equalization top pad, image_stitching_harris.py:
527-529).  The per-column alpha ramp and occupancy tests are invariant
under this pure translation, so the device can keep the mosaic static in
final coordinates and ``dynamic_update_slice`` each image once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _round_int(v: float) -> int:
    """int(round(v)) — Python/NumPy banker's rounding."""
    return int(np.round(v))


@dataclasses.dataclass
class StepPlan:
    img_index: int          # which image is folded in at this step
    swapped: bool           # dx<0 swap: the image plays the "A" role
    img_off_y: int          # absolute placement of the image content
    img_off_x: int          # (top-pad diff_y already folded in)
    overlap_range: float    # alpha denominator (0 -> alpha stays 0)
    # local-frame bookkeeping (for per-step golden extraction/testing):
    frame_off_y: int = 0    # T_j: offset of this step's local frame F_j
    frame_off_x: int = 0    # inside the final canvas
    local_h: int = 0        # HH_j, WW_j: this step's local canvas size
    local_w: int = 0


@dataclasses.dataclass
class ComposePlan:
    height: int
    width: int
    mosaic0_off_y: int      # absolute placement of image 0
    mosaic0_off_x: int
    steps: List[StepPlan]


def plan_compose(
    img_h: int,
    img_w: int,
    n_images: int,
    valid: Sequence[bool],
    shifts: Sequence[Tuple[float, float]],
    pairs: Sequence[Optional[Tuple[Tuple[float, float], Tuple[float, float]]]],
) -> ComposePlan:
    """Plan the full compositing schedule.

    Args:
      img_h, img_w: the (common) cylindrical image shape.
      valid: per-image readability mask (invalid images are skipped as in
        image_stitching_harris.py:525-526).
      shifts: drift-corrected (dx, dy) per adjacent pair.
      pairs: winning match pair ((xA, yA), (xB, yB)) per adjacent pair; a
        ``None`` pair (no matches) is treated as ((0,0),(0,0)), matching
        the degraded-mode dummy (image_stitching_harris.py:481).
    """
    if not valid[0]:
        raise ValueError("first image unreadable: reference would abort")

    # mosaic dims in local frame; per-step local records
    mh, mw = img_h, img_w
    raw_steps = []  # (img_index, swapped, a=(ay,ax), b_img=(by,bx), overlap)
    for i in range(1, n_images):
        if not valid[i]:
            continue
        diff_y = mh - img_h  # pass-2 height equalization (always >= 0)
        b_h, b_w = img_h + diff_y, img_w

        dx, dy = shifts[i - 1]
        pair = pairs[i - 1] or ((0.0, 0.0), (0.0, 0.0))
        a_dims = (mh, mw)      # current mosaic ("A" pre-swap)
        b_dims = (b_h, b_w)    # height-padded image
        if dx < 0:
            dx, dy = -dx, -dy
            pair = (pair[1], pair[0])
            a_dims, b_dims = b_dims, a_dims
            swapped = True
        else:
            swapped = False
        (xa, _ya), (xb, _yb) = pair
        pad_a_x = b_dims[1] - a_dims[1] + xa - xb
        pad_b_x = xa - xb
        overlap_range = xb - xa + a_dims[1]

        # pad_image(A, -pad_a_x, -dy) / pad_image(B, pad_b_x, dy)
        amx, amy = _round_int(-pad_a_x), _round_int(-dy)
        bmx, bmy = _round_int(pad_b_x), _round_int(dy)
        a_off = (max(amy, 0), max(amx, 0))
        b_off = (max(bmy, 0), max(bmx, 0))
        hh = max(a_dims[0] + abs(amy), b_dims[0] + abs(bmy))
        ww = max(a_dims[1] + abs(amx), b_dims[1] + abs(bmx))

        if swapped:
            mosaic_move = b_off
            img_off = (a_off[0] + diff_y, a_off[1])
        else:
            mosaic_move = a_off
            img_off = (b_off[0] + diff_y, b_off[1])
        raw_steps.append(
            (i, swapped, mosaic_move, img_off, float(overlap_range), hh, ww)
        )
        mh, mw = hh, ww

    # absolute frame = final frame: T_j = sum of mosaic moves of steps AFTER j
    steps: List[StepPlan] = []
    t_y = t_x = 0
    for (i, swapped, _mv, img_off, ovr, hh, ww) in reversed(raw_steps):
        steps.append(
            StepPlan(
                img_index=i,
                swapped=swapped,
                img_off_y=img_off[0] + t_y,
                img_off_x=img_off[1] + t_x,
                overlap_range=ovr,
                frame_off_y=t_y,
                frame_off_x=t_x,
                local_h=hh,
                local_w=ww,
            )
        )
        t_y += _mv[0]
        t_x += _mv[1]
    steps.reverse()
    if mh * mw > 500_000_000:
        raise ValueError(
            f"compositing plan produced an implausible {mh}x{mw} canvas — "
            "pairwise shifts are likely garbage (no real matches?)"
        )
    return ComposePlan(
        height=mh, width=mw, mosaic0_off_y=t_y, mosaic0_off_x=t_x, steps=steps
    )
