"""Host-side (NumPy) compositor: the port's compose path.

A copy of the JAX package's ``compose/host.py``.  The blend is tiny (~5 MP
of elementwise f32 for 18 images), so it folds the plan on host from the
cylindrical RGB projections.

Semantics are the REFERENCE's exactly (image_stitching_harris.py:
327-376): float32 canvases, a Python-float (f64) alpha that NumPy's
value-based casting rounds to f32 at multiply time, separate mul/add
roundings (no FMA), and a truncating uint8 cast per step — byte-identical
to the sequential reference fold.  Out-of-range blends (degenerate inputs
only) clip instead of wrapping mod 256.  Each step only ever changes the
incoming image's column band [x0, x0+w) — outside it the select tree
reduces to "keep the mosaic" — so the fold is band-limited for speed.
The JAX package's prefix/resume helpers for its speculative compose (a
latency trick for its TPU link) are left out.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from vfx_image_stitching_tpu_torch.compose.plan import ComposePlan


def _clamped(off: int, extent: int, limit: int) -> int:
    """dynamic_update_slice start clamping (plan guarantees fit anyway)."""
    return min(max(int(off), 0), limit - extent)


def _init_canvas(images, plan: ComposePlan):
    """Place image 0 on a fresh canvas; returns (canvas, col_occ)."""
    hgt, wid = plan.height, plan.width
    img0 = np.asarray(images[0])
    canvas = np.zeros((hgt, wid, 3), np.uint8)
    oy = _clamped(plan.mosaic0_off_y, img0.shape[0], hgt)
    ox = _clamped(plan.mosaic0_off_x, img0.shape[1], wid)
    canvas[oy : oy + img0.shape[0], ox : ox + img0.shape[1]] = img0

    # per-column occupancy of the growing mosaic, maintained incrementally
    col_occ = np.zeros(wid, bool)
    col_occ[ox : ox + img0.shape[1]] = _col_occupancy(img0)
    return canvas, col_occ


def _fold_step(canvas, col_occ, img, s) -> None:
    """Fold one plan step into (canvas, col_occ) in place."""
    hgt, wid = canvas.shape[:2]
    ih, iw = img.shape[:2]
    oy = _clamped(s.img_off_y, ih, hgt)
    x0 = _clamped(s.img_off_x, iw, wid)

    # The per-column select tree collapses to three cases: columns
    # where only the mosaic has content keep their bytes (a u8 ->
    # f32 -> u8 round trip is the identity, so no write is needed);
    # image-only columns are a pure paste (the mosaic bytes there
    # are all zero by the occupancy definition); and only the
    # overlap columns — the shift-narrowed seam, a small fraction
    # of the band — pay the f32 blend.
    img_occ = _col_occupancy(img)  # (iw,)
    mos_occ = col_occ[x0 : x0 + iw]
    ovl = img_occ & mos_occ
    img_only = img_occ & ~mos_occ

    def sel(idx):
        # contiguous column runs (the common case) as slices: NumPy
        # fancy indexing gathers per element, ~10x a strided copy
        if idx.size and int(idx[-1]) - int(idx[0]) + 1 == idx.size:
            return slice(int(idx[0]), int(idx[-1]) + 1)
        return idx

    cols = np.nonzero(img_only)[0]
    if cols.size:
        canvas[oy : oy + ih, sel(cols + x0)] = img[:, sel(cols)]
        col_occ[sel(cols + x0)] = True

    ocols = np.nonzero(ovl)[0]
    if ocols.size:
        # exclusive-cumsum alpha counter: overlap columns exist
        # only inside the band, so the band-local counter equals
        # the full-width one.  Alpha follows the reference
        # bit-for-bit: an f64 counter/overlap_range division whose
        # (1 - alpha) / alpha weights round to f32 only at the
        # multiply; the select-free weighted sum is exact for the
        # copy cases it replaces (w in {0, 1}, operands >= 0).
        ovf = ovl.astype(np.float64)
        counter = (np.cumsum(ovf) - ovf)[ocols]
        if s.overlap_range != 0.0:
            alpha64 = counter / float(s.overlap_range)
        else:
            alpha64 = np.zeros_like(counter)
        w_b = alpha64.astype(np.float32)
        w_a = (1.0 - alpha64).astype(np.float32)
        img_part = np.zeros((hgt, ocols.size, 3), np.float32)
        img_part[oy : oy + ih] = img[:, sel(ocols)]
        mos_part = canvas[:, sel(ocols + x0)].astype(np.float32)
        if s.swapped:  # the image plays the "A" role
            w_img, w_mos = w_a, w_b
        else:
            w_mos, w_img = w_a, w_b
        blended = (
            w_mos[None, :, None] * mos_part
            + w_img[None, :, None] * img_part
        )
        band_u8 = np.clip(blended, 0.0, 255.0).astype(np.uint8)
        canvas[:, sel(ocols + x0)] = band_u8
        # the truncating cast can zero out a whole column (the
        # reference's "no data" artifact) — recompute, don't assume
        col_occ[sel(ocols + x0)] = _col_occupancy(band_u8)


def compose_mosaic_host(
    images: Mapping[int, np.ndarray] | Sequence[np.ndarray],
    plan: ComposePlan,
) -> np.ndarray:
    """Fold cylindrical images into the final mosaic on host.

    Args:
      images: per-index (H, W, 3) uint8 cylindrical images; only image 0
        and every ``plan.steps[k].img_index`` are accessed, so a dict of
        just the valid images works.
      plan: host compositing plan.

    Returns the (height, width, 3) uint8 mosaic, byte-identical to the
    reference fold on the same inputs.
    """
    canvas, col_occ = _init_canvas(images, plan)
    for s in plan.steps:
        _fold_step(canvas, col_occ, np.asarray(images[s.img_index]), s)
    return canvas


def _col_occupancy(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) u8 -> (W,) bool any-nonzero per column.

    An axis-0 max over the contiguous (H, W*3) view is a SIMD
    column-reduction (~5x faster than ``np.any(img != 0, axis=(0, 2))``,
    which materializes a bool temp and reduces non-adjacent axes).
    """
    h, w = img.shape[:2]
    m = img.reshape(h, -1).max(axis=0).reshape(w, -1).max(axis=1)
    return m != 0


def content_bounds_host(mosaic: np.ndarray, black_threshold: int):
    """``(y_min, y_max, x_min, x_max, any)`` of pixels whose fixed-point
    gray exceeds ``black_threshold`` (the reference crop's content test).

    Only the FIRST/LAST content row and column are needed, so this scans
    block-wise from each edge inward, converting just the scanned strip
    with the exact fixed-point gray — microseconds for a mosaic with
    thin black margins instead of a full-canvas gray pass (~0.5 s for an
    18-image panorama).
    """
    from vfx_image_stitching_tpu_torch.ops.color import bgr_to_gray_u8_np

    h, w = mosaic.shape[:2]
    thr = np.uint8(black_threshold)

    def strip_mask(lo, hi, axis):
        sl = mosaic[lo:hi] if axis == 0 else mosaic[:, lo:hi]
        m = bgr_to_gray_u8_np(sl) > thr
        return np.any(m, axis=1 - axis)  # per-row (axis 0) / per-col

    def first_hit(extent, axis, from_end, block=64):
        for lo in range(0, extent, block):
            hi = min(lo + block, extent)
            if from_end:
                hits = strip_mask(extent - hi, extent - lo, axis)[::-1]
            else:
                hits = strip_mask(lo, hi, axis)
            nz = np.nonzero(hits)[0]
            if nz.size:
                return lo + int(nz[0])
        return None

    y_min = first_hit(h, 0, False)
    if y_min is None:  # all black: mirror the argmax-of-zeros result
        return 0, h - 1, 0, w - 1, False
    y_max = h - 1 - first_hit(h, 0, True)
    x_min = first_hit(w, 1, False)
    x_max = w - 1 - first_hit(w, 1, True)
    return y_min, y_max, x_min, x_max, True
