"""Reference-named per-stage API (sift_impl.py public surface parity).

The reference exposes 14 stage functions that its UI drives individually
(sift_visualizeUI.py:104-115).  The pyramid stages live in
:mod:`models.sift.pyramid` under the same names; this module adds the
keypoint-stage entry points operating on the pyramid lists, returning
fixed-capacity :class:`Keypoints` sets.  They run on the device of the
tensors they are given: localization through the Newton kernel
(:func:`localize.localize_candidates_resident`), orientation through the
orientation-histogram kernel and descriptors through the window gather,
each of which takes its plain version on CPU tensors.  The per-point
entries that take NumPy inputs run on ``device`` (the card unless the
caller asks for the CPU); tensor inputs keep their own device.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from vfx_image_stitching_tpu_torch.config import SiftConfig
from vfx_image_stitching_tpu_torch.models.sift.pyramid import (
    generate_dog_images,
    gradient_fields,
)
from vfx_image_stitching_tpu_torch.models.sift.extrema import (
    extract_candidates,
    extrema_threshold,
)
from vfx_image_stitching_tpu_torch.models.sift.localize import (
    Localized,
    compact_localized,
    localize_candidates_resident,
)
from vfx_image_stitching_tpu_torch.models.sift.orientation import (
    assign_orientations,
)
from vfx_image_stitching_tpu_torch.models.sift.descriptor import (
    compute_descriptors_chunked,
)
from vfx_image_stitching_tpu_torch.models.sift.keypoints import (
    Keypoints,
    concatenate,
    unpack_octave,
)

# reference-spelled alias (sift_impl.py:100 generate_DoG_images)
generate_DoG_images = generate_dog_images


def _on_device(x, device, dtype=torch.float32) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor (``None``: its own dtype): a tensor
    stays on its device, anything else goes to ``device`` (which must
    exist)."""
    if torch.is_tensor(x):
        return x.to(dtype=dtype)
    from vfx_image_stitching_tpu_torch.pipeline.stitch import resolve_device

    return torch.tensor(np.asarray(x)).to(resolve_device(device), dtype)


def find_scale_space_extrema(
    gaussian_images: List[torch.Tensor],
    dog_images: List[torch.Tensor],
    num_intervals: int = 3,
    sigma: float = 1.6,
    border: int = 5,
    cfg: SiftConfig | None = None,
) -> Keypoints:
    """Extrema -> localization -> orientation over every octave.

    Same stage grouping as sift_impl.py:117-140 (which also folds
    localization and orientation into this function); returns the
    concatenated un-deduplicated keypoint set at base-image scale.
    """
    cfg = cfg or SiftConfig(
        num_intervals=num_intervals, sigma=sigma, image_border_width=border
    )
    caps = cfg.capacities
    thresh = extrema_threshold(cfg.contrast_threshold, cfg.num_intervals)
    per_oct = []
    for o, dog in enumerate(dog_images):
        h_o, w_o = dog.shape[-2:]
        cand_cap = min(caps.scaled_candidates(o), 3 * h_o * w_o)
        layer, y, x, valid = extract_candidates(dog, border, thresh, cand_cap)
        loc = localize_candidates_resident(dog, layer, y, x, valid, o, cfg)
        loc = compact_localized(loc, min(caps.scaled_localized(o), cand_cap))
        mag, ang = gradient_fields(gaussian_images[o])
        per_oct.append(assign_orientations(mag, ang, loc, o, cfg))
    return concatenate(tuple(per_oct))


def generate_descriptors(
    keypoints: Keypoints,
    gaussian_images: List[torch.Tensor],
    cfg: SiftConfig | None = None,
) -> torch.Tensor:
    """(K, 128) descriptors for *converted* keypoints against the pyramid.

    Mirrors sift_impl.py:361-526; keypoints may span octaves — each
    octave's members are computed against its own gradient fields and
    merged back in place.
    """
    cfg = cfg or SiftConfig()
    octv, _layer, _scale = unpack_octave(keypoints.octave)
    desc = torch.zeros((keypoints.capacity, 128), dtype=torch.float32,
                       device=keypoints.x.device)
    for o, stack in enumerate(gaussian_images):
        sel = (octv + 1) == o
        sub = keypoints._replace(valid=keypoints.valid & sel)
        mag, ang = gradient_fields(stack)
        d = compute_descriptors_chunked(mag, ang, sub, o, cfg)
        desc = torch.where(sel[:, None], d, desc)
    return desc


def localize_extremum_via_quadratic_fit(
    x: int,
    y: int,
    layer: int,
    octave: int,
    num_intervals: int,
    dog_octave,
    sigma: float = 1.6,
    contrast_threshold: float = 0.04,
    border: int = 5,
    eigen_ratio: float = 10.0,
    max_iter: int = 5,
    *,
    device="cuda",
):
    """Per-point reference entry (sift_impl.py:169-211 signature parity).

    Delegates to the batched Newton localization with a single candidate.
    Returns ``(KeyPointRecord, localized_layer)`` or ``None`` when the
    candidate is rejected (out-of-bounds step, contrast, or edge
    response) — the reference's contract.
    """
    from vfx_image_stitching_tpu_torch.models.sift.extract import (
        KeyPointRecord,
    )

    cfg = SiftConfig(
        sigma=sigma,
        num_intervals=num_intervals,
        contrast_threshold=contrast_threshold,
        image_border_width=border,
        eigen_ratio=float(eigen_ratio),
        max_localize_iters=max_iter,
    )
    dog = _on_device(dog_octave, device)

    def one(v, dtype=torch.int32):
        return torch.tensor([v], dtype=dtype, device=dog.device)

    loc = localize_candidates_resident(
        dog, one(layer), one(y), one(x), one(True, torch.bool), octave, cfg,
    )
    loc = Localized(*[f.cpu() for f in loc])
    if not bool(loc.valid[0]):
        return None
    kp = KeyPointRecord(
        pt=(float(loc.pt_x[0]), float(loc.pt_y[0])),
        size=float(loc.size[0]),
        angle=-1.0,
        response=float(loc.response[0]),
        octave=int(loc.octave_packed[0]),
    )
    return kp, int(loc.layer[0])


def compute_keypoints_with_orientations(
    keypoint,
    octave: int,
    gauss_img,
    radius_factor: float = 3.0,
    num_bins: int = 36,
    peak_ratio: float = 0.8,
    scale_factor: float = 1.5,
    *,
    device="cuda",
):
    """Per-point orientation assignment (sift_impl.py:246-293 parity).

    ``keypoint`` carries cv2.KeyPoint-compatible fields (``pt``, ``size``,
    ``response``, ``octave``); ``gauss_img`` is the single (H, W) Gaussian
    image the keypoint was localized in.  Returns the (possibly several)
    oriented :class:`~.extract.KeyPointRecord`\\ s, peak bins ascending.
    """
    from vfx_image_stitching_tpu_torch.models.sift.extract import (
        KeyPointRecord,
    )

    cfg = SiftConfig(
        radius_factor=radius_factor,
        num_bins=num_bins,
        peak_ratio=peak_ratio,
        scale_factor=scale_factor,
    )
    img = _on_device(gauss_img, device)
    dev = img.device

    def one(v, dtype=torch.float32):
        return torch.tensor([v], dtype=dtype, device=dev)

    zero = one(0, torch.int32)
    loc = Localized(
        x=zero, y=zero,
        layer=zero,  # index into the 1-layer stack below
        pt_x=one(keypoint.pt[0]), pt_y=one(keypoint.pt[1]),
        size=one(keypoint.size), response=one(keypoint.response),
        octave_packed=one(keypoint.octave, torch.int32),
        valid=one(True, torch.bool),
        jx=zero, jy=zero, jl=zero,
    )
    mag, ang = gradient_fields(img[None])
    kps = Keypoints(*[f.cpu().numpy()
                      for f in assign_orientations(mag, ang, loc, octave, cfg)])
    return [
        KeyPointRecord(
            pt=(float(kps.x[i]), float(kps.y[i])),
            size=float(kps.size[i]),
            angle=float(kps.angle[i]),
            response=float(kps.response[i]),
            octave=int(kps.octave[i]),
        )
        for i in np.nonzero(kps.valid)[0]
    ]


def compare_keypoints(kp1, kp2) -> float:
    """6-key keypoint comparator (sift_impl.py:299-311 semantics).

    Orders by x, y, size (desc), angle, response (desc), class_id (desc);
    the device-side analogue is the lexsort key in
    :func:`~.keypoints.sort_and_dedup`.
    """
    if kp1.pt[0] != kp2.pt[0]:
        return kp1.pt[0] - kp2.pt[0]
    if kp1.pt[1] != kp2.pt[1]:
        return kp1.pt[1] - kp2.pt[1]
    if kp1.size != kp2.size:
        return kp2.size - kp1.size
    if kp1.angle != kp2.angle:
        return kp1.angle - kp2.angle
    if kp1.response != kp2.response:
        return kp2.response - kp1.response
    return getattr(kp2, "class_id", -1) - getattr(kp1, "class_id", -1)


def is_pixel_an_extremum(
    prev_patch: torch.Tensor, curr_patch: torch.Tensor,
    next_patch: torch.Tensor, threshold: float, *, device="cuda",
) -> torch.Tensor:
    """Single 3x3x3 test (sift_impl.py:143-163 parity), vectorizable
    over leading axes; NumPy patches go to ``device`` in their own
    dtype."""
    prev_patch, curr_patch, next_patch = (
        _on_device(p, device, None)
        for p in (prev_patch, curr_patch, next_patch))
    val = curr_patch[..., 1, 1]
    cube_max = torch.maximum(
        torch.maximum(torch.amax(prev_patch, dim=(-1, -2)),
                      torch.amax(next_patch, dim=(-1, -2))),
        torch.amax(curr_patch, dim=(-1, -2)),
    )
    cube_min = torch.minimum(
        torch.minimum(torch.amin(prev_patch, dim=(-1, -2)),
                      torch.amin(next_patch, dim=(-1, -2))),
        torch.amin(curr_patch, dim=(-1, -2)),
    )
    pos = (val > threshold) & (val == cube_max)
    neg = (val < -threshold) & (val == cube_min)
    return pos | neg
