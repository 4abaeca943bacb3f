"""The sequential pairwise blend and the crop (the reference's
``pad_image``, ``blend_two_images``, the pass-2 fold of ``run_panorama``
and ``rectangle_crop``), frozen from the repository's NumPy test oracles
(``tests/oracles.py``).

``blend_two_images`` places both images on float32 canvases by pads
taken from the seam pair's x coordinates and the shift's dy, then walks
the columns: a column where both canvases hold a nonzero pixel gets
``(1 - a) A + a B`` with ``a = counter / overlap_range`` and the counter
stepping once per such column met, a column with one source copies it,
and the result is cast to uint8.  ``lowp`` is the control: each blended
column stored in bfloat16 before the cast.
"""

from __future__ import annotations

import numpy as np

from bench_port.reference.gray import gray_u8
from bench_port.reference.lowp import store


def pad_image(img: np.ndarray, move_x: float, move_y: float) -> np.ndarray:
    """Translate by zero padding: positive moves pad top and left."""
    mx = int(np.round(move_x))
    my = int(np.round(move_y))
    top, bottom = (my, 0) if my >= 0 else (0, -my)
    left, right = (mx, 0) if mx >= 0 else (0, -mx)
    return np.pad(img, ((top, bottom), (left, right), (0, 0)), "constant")


def blend_two_images(shift_vec, ref_match, img_a, img_b,
                     lowp: bool = False) -> np.ndarray:
    dx, dy = shift_vec
    if dx < 0:
        dx, dy = -dx, -dy
        ref_match = (ref_match[1], ref_match[0])
        img_a, img_b = img_b, img_a

    pad_a_x = img_b.shape[1] - img_a.shape[1] + ref_match[0][0] - ref_match[1][0]
    pad_b_x = ref_match[0][0] - ref_match[1][0]
    overlap_range = ref_match[1][0] - ref_match[0][0] + img_a.shape[1]

    shift_a = pad_image(img_a, -pad_a_x, -dy)
    shift_b = pad_image(img_b, pad_b_x, dy)

    hh = max(shift_a.shape[0], shift_b.shape[0])
    ww = max(shift_a.shape[1], shift_b.shape[1])
    canvas_a = np.zeros((hh, ww, 3), np.float32)
    canvas_b = np.zeros((hh, ww, 3), np.float32)
    canvas_a[: shift_a.shape[0], : shift_a.shape[1]] = shift_a
    canvas_b[: shift_b.shape[0], : shift_b.shape[1]] = shift_b

    has_a = np.count_nonzero(canvas_a, axis=(0, 2)) > 0
    has_b = np.count_nonzero(canvas_b, axis=(0, 2)) > 0
    result = np.zeros((hh, ww, 3), np.float32)
    result[:, has_a] = canvas_a[:, has_a]
    only_b = has_b & ~has_a
    result[:, only_b] = canvas_b[:, only_b]
    for counter, cc in enumerate(np.nonzero(has_a & has_b)[0]):
        alpha = counter / overlap_range if overlap_range != 0 else 0
        result[:, cc, :] = store((1 - alpha) * canvas_a[:, cc, :]
                                 + alpha * canvas_b[:, cc, :], lowp)
    return result.astype(np.uint8)


def compose_sequence(cyl_images, shifts, pairs, lowp: bool = False) -> np.ndarray:
    """The pass-2 fold: each image blended onto the mosaic in turn, padded
    at the top to the mosaic's height; an unreadable image is skipped."""
    mosaic = cyl_images[0].copy()
    for i in range(1, len(cyl_images)):
        if cyl_images[i] is None:
            continue
        img = cyl_images[i]
        diff_y = mosaic.shape[0] - img.shape[0]
        if diff_y != 0:
            img = pad_image(img, 0, diff_y)
        mosaic = blend_two_images(shifts[i - 1], pairs[i - 1], mosaic, img, lowp)
    return mosaic


def rectangle_crop(img: np.ndarray, black_threshold: int,
                   extra_margin: int) -> np.ndarray:
    """The bounding box of gray values over ``black_threshold``, its top
    and bottom moved in by ``extra_margin``; the image as it is when the
    box is empty or degenerate."""
    h = img.shape[0]
    mask = gray_u8(img) > black_threshold
    coords = np.where(mask)
    if coords[0].size == 0:
        return img
    y_min, y_max = coords[0].min(), coords[0].max()
    x_min, x_max = coords[1].min(), coords[1].max()
    y_min = max(0, y_min + extra_margin)
    y_max = min(h - 1, y_max - extra_margin)
    if y_min > y_max or x_min > x_max:
        return img
    return img[y_min: y_max + 1, x_min: x_max + 1]
