"""Device compositor: the plan's sequential fold on device tensors.

Replicates ``blend_two_images`` (image_stitching_harris.py:327-376) at
the planned final-canvas shape: per-column occupancy (any nonzero value
in the column), a counter alpha ramp (the exclusive cumsum of the overlap
columns, left to right), single-source copy-through, and a truncating
uint8 cast at every step.  The cast matters: a blended pixel that lands
in (0, 1) floors to 0 and counts as "no data" in later steps, a
reference artifact kept for pixel parity.

The arithmetic is the reference's and the host fold's
(:mod:`compose.host`): alpha is a float64 division whose ``alpha`` and
``1 - alpha`` round to float32 at the multiply; the two products and
their sum are separate float32 roundings (separate kernels, so no fused
multiply-add).  The device fold is therefore byte-identical to the host
fold.  The JAX package's device fold divides in float32 instead and
differs from its own host fold by one on a few pixels of a step
(its ``tests/test_compose_host.py``).

Each image is placed once at its absolute offset (``place_on_canvas``);
the fold is a Python loop over ``plan.steps`` with no host sync but the
step capture's pull.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch

from vfx_image_stitching_tpu_torch.compose.plan import ComposePlan
from vfx_image_stitching_tpu_torch.geometry.canvas import place_on_canvas
from vfx_image_stitching_tpu_torch.utils.profiling import (
    count,
    count_d2h,
    count_h2d,
)


def _col_any(canvas: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (W,) bool: any nonzero value in the column."""
    return torch.amax(canvas, dim=(0, 2)) != 0


def _blend_pair(
    canvas_a: torch.Tensor, canvas_b: torch.Tensor, overlap_range
) -> torch.Tensor:
    """One blend of two (H, W, 3) uint8 canvases on one device; the
    alpha denominator ``overlap_range`` is a number or a 0-dim tensor."""
    dev = canvas_a.device
    a = canvas_a.to(torch.float32)
    b = canvas_b.to(torch.float32)
    any_a = _col_any(canvas_a)
    any_b = _col_any(canvas_b)
    overlap = any_a & any_b
    ov = overlap.to(torch.float64)
    counter = torch.cumsum(ov, 0) - ov
    # a 0-dim tensor on the canvas's device: CUDA divides by a Python
    # number (or a CPU scalar) through its reciprocal
    rng = torch.as_tensor(overlap_range, dtype=torch.float64)
    if not (torch.is_tensor(overlap_range) and overlap_range.device == dev):
        count_h2d(rng.nbytes)
    rng = rng.to(dev)
    nonzero = rng != 0.0
    alpha = torch.where(
        nonzero, counter / torch.where(nonzero, rng, torch.ones_like(rng)),
        torch.zeros_like(counter))
    w_a = (1.0 - alpha).to(torch.float32)[None, :, None]
    w_b = alpha.to(torch.float32)[None, :, None]
    blended = w_a * a + w_b * b
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = torch.where(
        overlap[None, :, None], blended,
        torch.where(any_a[None, :, None], a,
                    torch.where(any_b[None, :, None], b, zero)))
    # Non-degenerate inputs stay in [0, 255]; degenerate match pairs can
    # push alpha outside [0, 1], where NumPy's cast would wrap: clamp, as
    # the JAX package and the host fold do.
    return torch.clamp(out, 0.0, 255.0).to(torch.uint8)


def compose_mosaic(
    images,
    plan: ComposePlan,
    return_steps: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, List[np.ndarray]]]:
    """Fold the cylindrical image batch into the final mosaic on the
    batch's device.

    Args:
      images: (N, H, W, 3) uint8 cylindrical batch (image order =
        pano.txt); only image 0 and the steps' images are read.
      plan: host compositing plan.
      return_steps: also return each step's mosaic cropped to its local
        canvas, on the host (the reference ``pano_step_*``
        intermediates).

    Counts ``n_fold_steps``, each host value put on the device and each
    step crop pulled in the current request.
    """
    images = torch.as_tensor(images)
    count("n_fold_steps", len(plan.steps))
    mosaic = place_on_canvas(images[0], plan.height, plan.width,
                             plan.mosaic0_off_y, plan.mosaic0_off_x)
    captured: List[np.ndarray] = []
    for s in plan.steps:
        img_canvas = place_on_canvas(images[s.img_index], plan.height,
                                     plan.width, s.img_off_y, s.img_off_x)
        if s.swapped:  # the image plays the "A" role
            mosaic = _blend_pair(img_canvas, mosaic, s.overlap_range)
        else:
            mosaic = _blend_pair(mosaic, img_canvas, s.overlap_range)
        if return_steps:
            step = mosaic[
                s.frame_off_y:s.frame_off_y + s.local_h,
                s.frame_off_x:s.frame_off_x + s.local_w,
            ]
            count_d2h(step.nbytes)
            captured.append(step.cpu().numpy())
    return (mosaic, captured) if return_steps else mosaic
