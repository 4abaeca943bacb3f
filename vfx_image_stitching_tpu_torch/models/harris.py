"""Harris corner backend: response, NMS, top-k and 128-d descriptors.

Counterpart of the JAX package's ``models/harris.py``, function for
function.  The reference behaviour it replicates:

  * ``HarrisCorner``: signed 3x3 gradients, 21x21 sigma=2 Gaussian
    structure tensor, ``R = det - 0.05 tr^2``, threshold ``0.02*max(R)``,
    strict 3x3 NMS over the interior, top-200 by response (ties in
    row-major order);
  * ``compute_keypoints_and_descriptors_harris``: keypoints within 8 px of
    the border dropped *after* top-k, (x, y) order;
  * ``gen_descriptor``: 16x16 patch of (magnitude, angle) on edge-padded
    fields anchored at (y..y+15, x..x+15), 9x9 sigma=4.5 blur of the
    magnitude patch, global 8-bin histogram -> main orientation
    ``(argmax+0.5)*45``, angle-shifted (not rotated) 4x4 cells x 8 bins =
    128-d, normalize -> clip 0.2 -> renormalize.

Plain PyTorch on the input's device, but for the corner response on the
card: every function takes leading batch dimensions (the JAX package's
``vmap``), so :func:`harris_batch` runs a whole (N, H, W, 3) batch as one
set of ops.  The keypoint capacity is fixed at ``max_points`` with a
validity mask.

The response (gray, gradients, the three blurred structure products and
``R``) of a CUDA batch is one launch of the hand-written kernel of
``csrc/harris_response.cu`` (:func:`harris_response_kernel`, its own
small library); of a CPU batch it is :func:`harris_response_plain`, the
tensor ops the CPU tests hold against the JAX package.  The device is the
only switch, so every caller on the card (the stitch, ``stitch_many``,
the mesh and batched multi-panorama steps, the visualizers) takes the
kernel.  The kernel replaces no TPU kernel (the JAX package's Harris is
XLA ops); it replaces the plain version's about 285 full-field passes
(three 21-tap blurs of two passes, each pass 21 scalar products and 20
adds, plus the padding gathers, casts, gradients and response) over an
(N, H, W) float32 field, about 8.7 GB of traffic for 18 images of
512x384.  Its bound is bytes: the BGR
bytes read once and ``ix``, ``iy`` and ``r`` written once, 53 MB there,
about 16 us at 3.35 TB/s (its 0.9 GFLOP of separate float32 operations
take about 14 us at 67 TFLOP/s, twice that without fused multiply-adds).
The design: one block per 32x32 output tile of an image stages the gray
image of the tile and its halo (10 pixels for the 21-tap blur, one more
for the gradients, clipped to the image; the reflected borders land
inside it) in shared memory once, forms the gradients over the halo
there, then runs the vertical pass into shared memory (each thread a
column and 8 rows, each gradient loaded once and slid over the taps) and
the horizontal pass in registers (4 columns a thread) with the response,
and writes ``ix``, ``iy`` and ``r`` once.  No atomics, no reduction
across blocks.  Every operation is one IEEE float32 rounding in the plain
version's order (``-fmad=false``), so its outputs are the plain
version's bits.

Numerics, against the JAX package run op by op:

  * the blurs are ``ops/gaussian.gaussian_blur``'s shifted adds in tap
    order (the kernel's sums follow it), so gradients, structure tensor
    and response are bit-exact;
  * NMS is ``max_pool2d`` (``-inf`` padding, the reduce-window's SAME);
  * top-k is the first ``max_points`` of a stable descending sort: ties,
    the ``-inf`` rows included, in ascending index order, as
    ``lax.top_k`` gives them (``torch.topk`` promises no tie order);
  * the histograms are one-hot products summed over fixed axes, not
    scatter-adds (float atomics would make repeated runs differ on CUDA);
    their summation order is not XLA's einsum's, so descriptors agree to
    the reference's own ``1e-5``, and a near-tie of the global histogram
    could flip the main orientation (the tests count such flips).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vfx_image_stitching_tpu_torch.config import HarrisConfig
from vfx_image_stitching_tpu_torch.ops.color import (
    bgr_to_gray_f32,
    bgr_to_gray_u8,
)
from vfx_image_stitching_tpu_torch.ops.gaussian import (
    cv2_auto_ksize,
    gaussian_blur,
    gaussian_kernel1d,
)
from vfx_image_stitching_tpu_torch.ops.gradients import (
    calc_orientation,
    reference_gradients,
)
from vfx_image_stitching_tpu_torch.utils import cuda_build
from vfx_image_stitching_tpu_torch.utils.profiling import count, span

_NEG_INF = float("-inf")

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = cuda_build.Library(
    "harris_response", (cuda_build.CSRC / "harris_response.cu",), (),
    signatures={"harris_response": (_P, _I, _I, _I, _I, _P, _I,
                                    ctypes.c_float, _P, _P, _P, _P)},
    kernels=("harris_response",))
# Launch counts of the response kernel: the wrapper adds one where it
# launches (the plain version on CPU tensors does not count).
LAUNCHES = LIBRARY.launches
reset_launch_counts = LIBRARY.reset
# the longest structure blur the kernel takes (kMaxTaps in the source)
MAX_TAPS = 63


def _structure_taps(cfg: HarrisConfig) -> np.ndarray:
    """The structure blur's float32 taps as ``gaussian_blur`` applies them:
    ``block_size`` (cv2's auto size if None), and no blur, a single tap of
    1 (exact), at a size of 1 or less."""
    ksize = cfg.block_size
    if ksize is None:
        ksize = cv2_auto_ksize(cfg.gauss_sigma)
    if ksize <= 1:
        return np.ones(1, dtype=np.float32)
    return gaussian_kernel1d(ksize, cfg.gauss_sigma)


def _is_bgr(img: torch.Tensor) -> bool:
    """``bgr_to_gray_u8``'s rule: a trailing axis of 3 is BGR."""
    return img.ndim >= 3 and img.shape[-1] == 3


def harris_response_plain(
    img_bgr: torch.Tensor, cfg: HarrisConfig = HarrisConfig()
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ix, iy, r)`` of (..., H, W, 3) uint8 BGR images (or gray ones) in
    plain tensor ops on their device: the (..., H, W) gradients and the
    (M, H, W) response, M the images."""
    gray = bgr_to_gray_f32(img_bgr)
    h, w = gray.shape[-2:]
    ix, iy = reference_gradients(gray)
    ix2 = gaussian_blur(ix * ix, cfg.gauss_sigma, cfg.block_size)
    iy2 = gaussian_blur(iy * iy, cfg.gauss_sigma, cfg.block_size)
    ixy = gaussian_blur(ix * iy, cfg.gauss_sigma, cfg.block_size)

    det = ix2 * iy2 - ixy * ixy
    tr = ix2 + iy2
    r = (det - cfg.k * (tr * tr)).reshape(-1, h, w)
    return ix, iy, r


def _check_response_input(images: torch.Tensor, cfg: HarrisConfig) -> int:
    """Raise unless ``images`` is what the kernel takes: an (N, H, W, 3)
    BGR or (N, H, W) gray uint8 batch with no empty axis, and a structure
    blur of at most ``MAX_TAPS`` taps.  Returns the channel count."""
    if images.dtype != torch.uint8:
        raise TypeError(
            f"harris_response_kernel: expected uint8, got {images.dtype}")
    if images.ndim == 4 and images.shape[-1] == 3:
        channels = 3
    elif images.ndim == 3:
        channels = 1
    else:
        raise ValueError("harris_response_kernel: expected (N, H, W, 3) BGR "
                         f"or (N, H, W) gray, got {tuple(images.shape)}")
    if images.numel() == 0:
        raise ValueError(f"harris_response_kernel: empty batch "
                         f"{tuple(images.shape)}")
    taps = len(_structure_taps(cfg))
    if taps > MAX_TAPS:
        raise ValueError(f"harris_response_kernel: a {taps}-tap structure "
                         f"blur exceeds the kernel's {MAX_TAPS}")
    return channels


def harris_response_kernel(
    images: torch.Tensor, cfg: HarrisConfig = HarrisConfig()
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ix, iy, r)``, each (N, H, W) float32, of a CUDA batch by the
    kernel of ``csrc/harris_response.cu``: one launch on the batch's
    device and its current stream, bit-equal to
    :func:`harris_response_plain`.  Counts ``n_harris_kernel_images``."""
    channels = _check_response_input(images, cfg)
    if images.device.type != "cuda":
        raise ValueError("harris_response_kernel: expected a CUDA batch (a "
                         "CPU batch takes harris_response_plain)")
    images = images.contiguous()
    n, h, w = images.shape[:3]
    taps = _structure_taps(cfg)
    ix, iy, r = torch.empty((3, n, h, w), dtype=torch.float32,
                            device=images.device)
    LIBRARY.launch("harris_response", images.device, "harris_response",
                   images.data_ptr(), n, h, w, channels, taps.ctypes.data,
                   len(taps), cfg.k, ix.data_ptr(), iy.data_ptr(),
                   r.data_ptr())
    count("n_harris_kernel_images", n)
    return ix, iy, r


def harris_corners(
    img_bgr: torch.Tensor, cfg: HarrisConfig = HarrisConfig()
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           Tuple[torch.Tensor, torch.Tensor]]:
    """Top-``max_points`` Harris corners of (..., H, W, 3) uint8 BGR
    images (or gray (H, W) / (N, H, W) ones).

    Returns ``(yy, xx, response, valid, (ix, iy))`` with (..., max_points)
    lanes ordered by response descending (row-major on ties) and the
    (..., H, W) gradient fields.  The response is
    :func:`harris_response_kernel`'s on a CUDA input and
    :func:`harris_response_plain`'s elsewhere (``n_harris_kernel_images``
    0).
    """
    if img_bgr.device.type == "cuda":
        if _is_bgr(img_bgr):
            lead, (h, w) = img_bgr.shape[:-3], img_bgr.shape[-3:-1]
            images = img_bgr.reshape(-1, h, w, 3)
        else:
            lead, (h, w) = img_bgr.shape[:-2], img_bgr.shape[-2:]
            images = bgr_to_gray_u8(img_bgr).reshape(-1, h, w)
        ix, iy, r = harris_response_kernel(images, cfg)
        ix, iy = ix.reshape(*lead, h, w), iy.reshape(*lead, h, w)
    else:
        count("n_harris_kernel_images", 0)
        ix, iy, r = harris_response_plain(img_bgr, cfg)
        h, w = ix.shape[-2:]
        lead = ix.shape[:-2]

    threshold = torch.amax(r, dim=(-2, -1), keepdim=True) * cfg.thresh_ratio
    # strict 3x3 local max: R[i, j] == max of its 3x3 patch
    rmax = F.max_pool2d(r[:, None], 3, stride=1, padding=1)[:, 0]
    interior = torch.zeros((h, w), dtype=torch.bool, device=r.device)
    interior[1:h - 1, 1:w - 1] = True
    cand = (r > threshold) & (r == rmax) & interior

    scores = torch.where(cand, r, torch.full((), _NEG_INF, device=r.device))
    top = torch.sort(scores.reshape(r.shape[0], h * w), dim=-1,
                     descending=True, stable=True)
    top_scores = top.values[:, :cfg.max_points]
    top_idx = top.indices[:, :cfg.max_points].to(torch.int32)
    valid = top_scores > _NEG_INF
    yy = top_idx // w
    xx = top_idx % w
    k = top_idx.shape[-1]
    return (yy.reshape(*lead, k), xx.reshape(*lead, k),
            top_scores.reshape(*lead, k), valid.reshape(*lead, k), (ix, iy))


def _descriptor_patches(
    field: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor, pad: int, size: int
) -> torch.Tensor:
    """(..., K, size, size) patches of (..., H, W) fields, rows and columns
    [p, p + size) of the field edge-padded by ``pad``, anchored at
    (``yy`` + pad, ``xx`` + pad) clamped into the padded field (as
    ``dynamic_slice`` clamps): read straight from the field with clamped
    indices, which is what the padding holds."""
    h, w = field.shape[-2:]
    lead = field.shape[:-2]
    k = yy.shape[-1]
    off = torch.arange(size, device=field.device)

    def axis(start, n):
        s = (start.to(torch.int64) + pad).clamp(0, n + 2 * pad - size)
        return (s[..., None] + off - pad).clamp(0, n - 1)

    rows = axis(yy, h).reshape(-1, k, size)
    cols = axis(xx, w).reshape(-1, k, size)
    flat = field.reshape(-1, h, w)
    b = torch.arange(flat.shape[0], device=field.device)[:, None, None, None]
    patches = flat[b, rows[..., :, None], cols[..., None, :]]
    return patches.reshape(*lead, k, size, size)


def _angle_bins(theta: torch.Tensor, bins: int) -> torch.Tensor:
    """``int(ang/360*bins) % bins`` for ang in [0, 360) (floor for ang>=0)."""
    idx = torch.floor(theta * (bins / 360.0)).to(torch.int32)
    return torch.remainder(idx, bins)


def _bin_sums(weights: torch.Tensor, idx: torch.Tensor, bins: int,
              dims: Tuple[int, ...]) -> torch.Tensor:
    """Sums of ``weights`` per bin ``idx`` over ``dims``: the one-hot
    product reduced over fixed axes (no atomics)."""
    onehot = F.one_hot(idx.long(), bins).to(torch.float32)
    return torch.sum(weights[..., None] * onehot, dim=dims)


def _normalize(desc: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(desc * desc, dim=-1, keepdim=True))
    return desc / (norm + 1e-7)


def harris_descriptors(
    yy: torch.Tensor,
    xx: torch.Tensor,
    ix: torch.Tensor,
    iy: torch.Tensor,
    cfg: HarrisConfig = HarrisConfig(),
) -> torch.Tensor:
    """(..., K, 128) descriptors for keypoints at rows ``yy``, cols ``xx``."""
    m, theta = calc_orientation(ix, iy)
    return harris_descriptors_from_fields(yy, xx, m, theta, cfg)


def harris_descriptors_from_fields(
    yy: torch.Tensor,
    xx: torch.Tensor,
    m: torch.Tensor,
    theta: torch.Tensor,
    cfg: HarrisConfig = HarrisConfig(),
) -> torch.Tensor:
    """Descriptors from precomputed magnitude/angle fields, the split the
    reference exposes as ``gen_descriptor(fpx, fpy, m, theta)``."""
    bins = cfg.desc_bins
    size = cfg.patch_size
    pad = size // 2
    patch_m = _descriptor_patches(m, yy, xx, pad, size)       # (..., K, 16, 16)
    patch_t = _descriptor_patches(theta, yy, xx, pad, size)

    # 9x9 sigma=4.5 blur of the magnitude patch, reflect-101 inside the patch
    patch_m = gaussian_blur(patch_m, cfg.desc_blur_sigma, cfg.desc_blur_ksize)

    # global 8-bin orientation histogram over the whole patch -> main angle
    gbin = _angle_bins(torch.remainder(patch_t, 360.0), bins)
    hist = _bin_sums(patch_m, gbin, bins, (-3, -2))
    main_theta = (torch.argmax(hist, dim=-1).to(torch.float32) + 0.5) * (
        360.0 / bins)

    shifted = torch.remainder(patch_t - main_theta[..., None, None] + 360.0,
                              360.0)

    # 4x4 cells x 8 bins; cell order (by, bx) row-major as the reference's
    # nested loops produce
    c = cfg.desc_cells
    cell = size // c
    lead = patch_m.shape[:-2]
    pm = patch_m.reshape(*lead, c, cell, c, cell)
    cbin = _angle_bins(torch.remainder(shifted, 360.0), bins).reshape(
        *lead, c, cell, c, cell)
    cell_hist = _bin_sums(pm, cbin, bins, (-4, -2))  # (..., by, bx, 8)
    desc = _normalize(cell_hist.reshape(*lead, c * c * bins))
    return _normalize(torch.clamp(desc, 0.0, cfg.desc_clip))


def harris_keypoints_and_descriptors(
    img_bgr: torch.Tensor, cfg: HarrisConfig = HarrisConfig()
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full Harris backend for (..., H, W, 3) uint8 BGR images.

    Returns ``(xy, descs, valid)``: (..., K, 2) int32 keypoints as (x, y),
    (..., K, 128) float32 descriptors, (..., K) validity.  Order is
    response-descending with border keypoints masked invalid in place
    (their relative order, which drives match/RANSAC tie-breaks, matches
    the reference's compacted list).  Spans ``extract.corners`` and
    ``extract.describe`` in the current request.
    """
    with span("extract.corners"):
        yy, xx, _, valid, (ix, iy) = harris_corners(img_bgr, cfg)
        h, w = ix.shape[-2:]
        mrg = cfg.border_margin
        valid = (valid & (yy >= mrg) & (yy < h - mrg) & (xx >= mrg)
                 & (xx < w - mrg))
    with span("extract.describe"):
        descs = harris_descriptors(yy, xx, ix, iy, cfg)
        xy = torch.stack([xx, yy], dim=-1).to(torch.int32)
    return xy, descs, valid


def harris_batch(
    batch_bgr: torch.Tensor, cfg: HarrisConfig = HarrisConfig()
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backend over an (N, H, W, 3) uint8 BGR batch (or an (N, H, W)
    gray one): (N, K, 2), (N, K, 128) and (N, K)."""
    if batch_bgr.ndim not in (3, 4):
        raise ValueError(
            f"harris_batch: expected (N, H, W, 3), got {tuple(batch_bgr.shape)}")
    return harris_keypoints_and_descriptors(batch_bgr, cfg)
