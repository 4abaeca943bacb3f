"""Device compositor: the plan's sequential fold on device tensors.

On a CUDA batch the fold is the hand-written kernel of
``csrc/compose_fold.cu`` (:func:`fold_kernel`, note below); on a CPU
batch it is the plain PyTorch fold, :func:`fold_plain` (:func:`_blend_pair`
over the whole canvas at every step), which the CPU tests hold against
the JAX package.

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

``fold_kernel`` replaces no TPU kernel: the JAX package's fold is XLA
ops, which the plain fold follows (about 33 full-canvas tensor ops a
step: a new canvas, casts, column maxima, products, selects).  It exists
because a step changes only the column band ``[x0, x0 + w)`` of its
image (``compose/host.py``), and in that band only the overlap columns
need arithmetic.  Its bound is bytes: the images read once and the
canvas written once, 17.5 MB for 18 images of 384x512 (about 5 us at
3.35 TB/s); at these sizes each launch is bound by its latency, a few
dependent loads.  The design: one batched launch flags every image's
occupied columns (any nonzero byte), and image 0's flags mark the
mosaic's; then one launch a step over the step's band only, 32 columns
a warp and 32 rows a block, in which each warp counts the overlap columns
left of its lanes (the alpha counter) from the flags with ballot and
popc, pastes image-only columns, blends overlap columns over every
canvas row with the host fold's arithmetic, and writes the mosaic's new
occupancy into the next of three buffers used in turn.  So a step costs
one launch and the band's bytes, the step's parameters travel as kernel
arguments (no copy of the alpha denominator), and no float32 canvas is
allocated.  The products and the sum are separate IEEE float32 roundings
(``-fmad=false``) on the float64 alpha, so the kernel's bytes are the
host fold's and the plain fold's.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple, Union

import numpy as np
import torch

from vfx_image_stitching_tpu_torch.compose.plan import ComposePlan
from vfx_image_stitching_tpu_torch.geometry.canvas import (
    clamp_offset,
    place_on_canvas,
)
from vfx_image_stitching_tpu_torch.utils import cuda_build
from vfx_image_stitching_tpu_torch.utils.profiling import (
    count,
    count_d2h,
    count_h2d,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = cuda_build.Library(
    "compose_fold", (cuda_build.CSRC / "compose_fold.cu",), (),
    signatures={
        "compose_column_occupancy": (_P, _I, _I, _I, _P, _P, _I, _P),
        "compose_fold_step": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              ctypes.c_double, _P, _P, _P, _P),
    },
    kernels=("compose_column_occupancy", "compose_fold_step"))
# Launch counts of the fold's kernels: the wrapper adds one where it
# launches (the plain fold on CPU tensors does not count).
LAUNCHES = LIBRARY.launches
reset_launch_counts = LIBRARY.reset


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
    batch's device: by :func:`fold_kernel` on a CUDA batch, by the plain
    fold on a CPU batch.

    Args:
      images: (N, H, W, 3) uint8 cylindrical batch (image order =
        pano.txt); only image 0 and the steps' images are read.
      plan: host compositing plan.
      return_steps: also return each step's mosaic cropped to its local
        canvas, on the host (the reference ``pano_step_*``
        intermediates).

    Counts ``n_fold_steps``, ``n_fold_kernel_steps`` (the steps the
    kernel folded: 0 on the CPU), each host value put on the device and
    each step crop pulled in the current request.
    """
    images = torch.as_tensor(images)
    count("n_fold_steps", len(plan.steps))
    if images.device.type == "cuda":
        out = fold_kernel(images.contiguous(), plan, return_steps)
    else:
        count("n_fold_kernel_steps", 0)
        out = fold_plain(images, plan, return_steps)
    return out if return_steps else out[0]


def fold_plain(
    images: torch.Tensor, plan: ComposePlan, return_steps: bool = False,
) -> Tuple[torch.Tensor, List[np.ndarray]]:
    """The plan's fold in plain tensor ops on the batch's device: each
    image placed on a full canvas and blended into the mosaic by
    :func:`_blend_pair`.  Returns the mosaic and, with ``return_steps``,
    each step's crop (else an empty list)."""
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
            captured.append(_step_crop(mosaic, s))
    return mosaic, captured


def _step_crop(mosaic: torch.Tensor, s) -> np.ndarray:
    """The mosaic after step ``s`` cropped to its local canvas, pulled."""
    step = mosaic[s.frame_off_y:s.frame_off_y + s.local_h,
                  s.frame_off_x:s.frame_off_x + s.local_w]
    count_d2h(step.nbytes)
    return step.cpu().numpy()


class FoldLaunch(NamedTuple):
    """One step's kernel arguments: the image, its offset on the canvas
    clamped as the host fold clamps it (its column band is ``[x0, x0 +
    W)``), the swap flag and the alpha denominator."""

    img_index: int
    oy: int
    x0: int
    swapped: bool
    overlap_range: float


def fold_launches(plan: ComposePlan, img_h: int,
                  img_w: int) -> List[FoldLaunch]:
    """The kernel's arguments for every step of ``plan`` on images of
    ``img_h`` x ``img_w``."""
    return [FoldLaunch(s.img_index,
                       clamp_offset(s.img_off_y, img_h, plan.height),
                       clamp_offset(s.img_off_x, img_w, plan.width),
                       bool(s.swapped), float(s.overlap_range))
            for s in plan.steps]


def _check_fold_inputs(images: torch.Tensor, plan: ComposePlan) -> None:
    """Raise unless ``images`` is a contiguous (N, H, W, 3) uint8 batch
    that holds every image ``plan`` reads and fits its canvas."""
    if images.dtype != torch.uint8:
        raise TypeError(f"fold_kernel: expected uint8, got {images.dtype}")
    if images.ndim != 4 or images.shape[-1] != 3 or images.shape[0] < 1:
        raise ValueError(
            f"fold_kernel: expected (N, H, W, 3), got {tuple(images.shape)}")
    if not images.is_contiguous():
        raise ValueError("fold_kernel: expected a contiguous batch")
    n, h, w = images.shape[:3]
    if h > plan.height or w > plan.width:
        raise ValueError(f"fold_kernel: {h}x{w} images exceed the "
                         f"{plan.height}x{plan.width} canvas")
    bad = [s.img_index for s in plan.steps if not 0 <= s.img_index < n]
    if bad:
        raise ValueError(f"fold_kernel: steps read images {bad} of {n}")


def fold_kernel(
    images: torch.Tensor, plan: ComposePlan, return_steps: bool = False,
) -> Tuple[torch.Tensor, List[np.ndarray]]:
    """The plan's fold of a CUDA batch by the kernels of
    ``csrc/compose_fold.cu``, on the batch's device and its current
    stream: one occupancy launch, then one launch a step (none without
    steps).  Returns the mosaic and, with ``return_steps``, each step's
    crop (else an empty list).  Counts ``n_fold_kernel_steps``."""
    _check_fold_inputs(images, plan)
    if images.device.type != "cuda":
        raise ValueError("fold_kernel: expected a CUDA batch (a CPU batch "
                         "takes compose_mosaic's plain fold)")
    dev = images.device
    n, h, w = images.shape[:3]
    hc, wc = plan.height, plan.width
    mosaic = place_on_canvas(images[0], hc, wc, plan.mosaic0_off_y,
                             plan.mosaic0_off_x)
    captured: List[np.ndarray] = []
    launches = fold_launches(plan, h, w)
    if launches:
        # the images' column flags, then the mosaic's occupancy in three
        # buffers used in turn (before, after, to clear for the next step)
        flags = torch.zeros(n * w + 3 * wc, dtype=torch.uint8, device=dev)
        img_occ, occ = flags.data_ptr(), flags.data_ptr() + n * w
        base, canvas = images.data_ptr(), mosaic.data_ptr()
        LIBRARY.launch("compose_column_occupancy", dev,
                       "compose_column_occupancy", base, n, h, w, img_occ,
                       occ, clamp_offset(plan.mosaic0_off_x, w, wc))
        for k, (f, s) in enumerate(zip(launches, plan.steps)):
            LIBRARY.launch("compose_fold_step", dev, "compose_fold_step",
                           base + f.img_index * h * w * 3,
                           img_occ + f.img_index * w, canvas, hc, wc, h, w,
                           f.oy, f.x0, int(f.swapped), f.overlap_range,
                           occ + k % 3 * wc, occ + (k + 1) % 3 * wc,
                           occ + (k + 2) % 3 * wc)
            if return_steps:
                captured.append(_step_crop(mosaic, s))
    count("n_fold_kernel_steps", len(launches))
    return mosaic, captured
