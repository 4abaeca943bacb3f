"""Canvas placement in place of the reference's translate-by-pad.

``pad_image(img, mx, my)`` in the reference (image_stitching_harris.py:
311-325) zero-pads an image so its content shifts by ``(max(round(mx),0),
max(round(my),0))`` and its size grows by ``(|round(mx)|, |round(my)|)``.
The device compose (:mod:`compose.blend`) places content into the
host-planned final canvas instead (:mod:`compose.plan` computes every
offset with the reference's float64 rounding).
"""

from __future__ import annotations

from typing import Tuple

import torch


def pad_amounts(move: float) -> Tuple[int, int]:
    """(content offset, size growth) for one axis of pad_image.

    ``int(round(move))`` in the reference is Python's banker's rounding.
    """
    m = int(round(move))
    return (max(m, 0), abs(m))


def clamp_offset(off: int, extent: int, limit: int) -> int:
    """An offset clamped so ``extent`` pixels fit in ``limit``, as the
    JAX package's ``lax.dynamic_update_slice`` clamps its start."""
    return min(max(int(off), 0), limit - extent)


def place_on_canvas(
    img: torch.Tensor, canvas_h: int, canvas_w: int, off_y: int, off_x: int
) -> torch.Tensor:
    """Place (H, W, C) content at (off_y, off_x) on a zero canvas, on the
    image's device.

    Offsets are clamped so the content fits, as the JAX package's
    ``lax.dynamic_update_slice`` does; the planner sizes the canvas to
    the exact union, so the clamp never moves planned content.
    """
    h, w = img.shape[:2]
    oy = clamp_offset(off_y, h, canvas_h)
    ox = clamp_offset(off_x, w, canvas_w)
    canvas = torch.zeros((canvas_h, canvas_w) + tuple(img.shape[2:]),
                         dtype=img.dtype, device=img.device)
    canvas[oy:oy + h, ox:ox + w] = img
    return canvas
