"""SIFT orchestrator: the full per-image extraction, its batch loops and
the reference-signature entry point.

Stage order matches ``sift_impl.compute_keypoints_and_descriptors``
(sift_impl.py:15-39); conversion-to-input-size and descriptors run *per
octave* before the global sort/dedup — both are per-keypoint maps, so
the result set is identical while the descriptor windows use
contiguous per-octave gradient stacks.

Localization always takes the resident-kernel path
(:func:`localize.localize_candidates_resident`); on CPU tensors every
kernel runs its plain PyTorch version.

A batch runs in one of the JAX package's two schedules of the same
computation: ``mode="map"`` extracts one image at a time;
``mode="vmap"`` runs every stage of every octave once over all N images
(:func:`sift_keypoints_and_descriptors_batch`), so each kernel launches
once a stage (a bucket) for the batch, and each stage reads its
live-chunk bound back once for the batch instead of once an image.  The
two give the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from vfx_image_stitching_tpu_torch.config import SiftConfig
from vfx_image_stitching_tpu_torch.ops.color import bgr_to_gray_f32
from vfx_image_stitching_tpu_torch.models.sift.pyramid import (
    compute_number_of_octaves,
    generate_base_image,
    generate_dog_images,
    generate_gaussian_images,
    generate_gaussian_kernels,
    gradient_fields,
)
from vfx_image_stitching_tpu_torch.models.sift.extrema import (
    extract_candidates,
    extrema_threshold,
)
from vfx_image_stitching_tpu_torch.models.sift.localize import (
    compact_localized,
    localize_candidates_resident,
)
from vfx_image_stitching_tpu_torch.models.sift.orientation import (
    assign_orientations_chunked,
)
from vfx_image_stitching_tpu_torch.models.sift.descriptor import (
    compute_descriptors_bucketed,
    compute_descriptors_chunked,
)
from vfx_image_stitching_tpu_torch.models.sift.keypoints import (
    Keypoints,
    compact,
    concatenate,
    convert_keypoints_to_input_image_size,
    sort_and_dedup,
)
from vfx_image_stitching_tpu_torch.utils.profiling import count_h2d, span


def _to_gray(image: torch.Tensor) -> torch.Tensor:
    if image.ndim == 3 and image.shape[-1] == 3:
        return bgr_to_gray_f32(image)
    return image.to(torch.float32)


def sift_keypoints_and_descriptors(
    image: torch.Tensor, cfg: SiftConfig = SiftConfig()
) -> Tuple[Keypoints, torch.Tensor, Dict[str, torch.Tensor]]:
    """Full SIFT on one image -> (Keypoints, (K,128) descriptors, stats).

    ``stats`` carries per-stage occupancy counts so callers can verify
    that no fixed capacity truncated (the masked-array analogue of the
    reference's dynamic lists).
    """
    return _sift(_to_gray(image), cfg)


def sift_keypoints_and_descriptors_batch(
    batch: torch.Tensor, cfg: SiftConfig = SiftConfig()
) -> Tuple[Keypoints, torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`sift_keypoints_and_descriptors` of every image of an (N, H,
    W[, 3]) batch at once -> (Keypoints (N, K), (N, K, 128) descriptors,
    stats with a leading N axis), each image's values those of the
    one-image function.

    Every stage runs once over the batch's stacked octave: the kernels
    take all N images' rows in one launch, and each stage processes the
    live chunks of the image that needs the most (the rest of each
    image's rows come out zero, as the one-image function pads them).
    """
    gray = (bgr_to_gray_f32(batch) if batch.ndim == 4 and batch.shape[-1] == 3
            else batch.to(torch.float32))
    return _sift(gray, cfg)


def _sift(
    gray: torch.Tensor, cfg: SiftConfig
) -> Tuple[Keypoints, torch.Tensor, Dict[str, torch.Tensor]]:
    """The extraction of an (H, W) gray image, or of an (N, H, W) batch
    with every stage over the leading image axis.  Spans
    ``extract.pyramid`` and, in every octave, ``extract.extrema``,
    ``extract.localize``, ``extract.orientation`` and
    ``extract.descriptor`` in the current request."""
    dev = gray.device
    lead = gray.shape[:-2]
    with span("extract.pyramid"):
        base = generate_base_image(gray, cfg.sigma, cfg.assumed_blur)
        num_octaves = compute_number_of_octaves(base.shape[-2:])
        kernels = generate_gaussian_kernels(cfg.sigma, cfg.num_intervals)
        pyramid = generate_gaussian_images(base, num_octaves, kernels)
        dogs = generate_dog_images(pyramid)
    thresh = extrema_threshold(cfg.contrast_threshold, cfg.num_intervals)

    caps = cfg.capacities
    per_kps: List[Keypoints] = []
    per_desc: List[torch.Tensor] = []
    cand_counts, oriented_counts, cand_caps, oriented_caps = [], [], [], []
    loc_counts, loc_caps = [], []
    desc_big_counts, desc_big_caps = [], []
    for o in range(num_octaves):
        dog = dogs[o]
        h_o, w_o = dog.shape[-2:]
        cand_cap = min(caps.scaled_candidates(o), 3 * h_o * w_o)
        with span("extract.extrema"):
            layer, y, x, cand_valid = extract_candidates(
                dog, cfg.image_border_width, thresh, cand_cap
            )
        with span("extract.localize"):
            loc = localize_candidates_resident(dog, layer, y, x, cand_valid,
                                               o, cfg)
            loc_cap = min(caps.scaled_localized(o), cand_cap)
            loc_counts.append(torch.sum(loc.valid, dim=-1))
            loc_caps.append(loc_cap)
            loc = compact_localized(loc, loc_cap)
        with span("extract.orientation"):
            # gradient fields are consumed only at the localized layers
            # 1..num_intervals, and only when the octave localized
            # anything; a batch computes them for every image (JAX vmap's
            # select), and an image that localized nothing never reads
            # its own
            grad_src = pyramid[o][..., 1 : cfg.num_intervals + 1, :, :]
            if lead or bool(loc.valid.any()):
                mag, ang = gradient_fields(grad_src)
            else:
                mag, ang = (torch.zeros_like(grad_src),
                            torch.zeros_like(grad_src))
            kps = assign_orientations_chunked(mag, ang, loc, o, cfg,
                                              layer_base=1)
            o_cap = caps.scaled_oriented(o)
            kps_c = convert_keypoints_to_input_image_size(compact(kps, o_cap))
        with span("extract.descriptor"):
            if caps.desc_bucketed:
                big_cap = min(caps._table(caps.desc_big_caps, o), o_cap)
                desc, big_count = compute_descriptors_bucketed(
                    mag, ang, kps_c, o, cfg,
                    small_cap=min(caps._table(caps.desc_small_caps, o),
                                  o_cap),
                    big_cap=big_cap,
                    layer_base=1,
                )
                desc_big_counts.append(big_count)
                desc_big_caps.append(big_cap)
            else:
                desc = compute_descriptors_chunked(mag, ang, kps_c, o, cfg,
                                                   layer_base=1)
                desc_big_counts.append(
                    torch.zeros(lead, dtype=torch.int64, device=dev))
                desc_big_caps.append(1)
        per_kps.append(kps_c)
        per_desc.append(desc)
        cand_counts.append(torch.sum(cand_valid, dim=-1))
        oriented_counts.append(torch.sum(kps.valid, dim=-1))
        cand_caps.append(cand_cap)
        oriented_caps.append(o_cap)

    kps = concatenate(tuple(per_kps))
    desc = torch.cat(per_desc, dim=-2)
    kps, desc = sort_and_dedup(kps, desc, caps.max_keypoints)

    def caps_t(vals):
        t = torch.tensor(vals, dtype=torch.int32, device=dev)
        count_h2d(t.nbytes)
        return t.expand(lead + t.shape).contiguous()

    stats = {
        "cand_counts": torch.stack(cand_counts, dim=-1),
        "cand_caps": caps_t(cand_caps),
        "loc_counts": torch.stack(loc_counts, dim=-1),
        "loc_caps": caps_t(loc_caps),
        "oriented_counts": torch.stack(oriented_counts, dim=-1),
        "oriented_caps": caps_t(oriented_caps),
        "desc_big_counts": torch.stack(desc_big_counts, dim=-1),
        "desc_big_caps": caps_t(desc_big_caps),
        "final_count": kps.count(),
        "final_cap": caps_t(caps.max_keypoints),
    }
    return kps, desc, stats


def sift_extract(
    image: torch.Tensor, cfg: SiftConfig = SiftConfig()
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pipeline interface: (xy (K,2) f32, descriptors (K,128), valid)."""
    kps, desc, _ = sift_keypoints_and_descriptors(image, cfg)
    return torch.stack([kps.x, kps.y], dim=-1), desc, kps.valid


def _meta(kps: Keypoints) -> Dict[str, torch.Tensor]:
    return {
        "size": kps.size, "angle": kps.angle, "octave": kps.octave,
        "ix": kps.ix, "iy": kps.iy,
        "jx": kps.jx, "jy": kps.jy, "jl": kps.jl,
    }


def sift_batch(
    batch: torch.Tensor, cfg: SiftConfig = SiftConfig(), mode: str = "map"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`sift_extract` over an (N, H, W[, 3]) batch, stacked.

    ``mode`` picks the schedule, as in the JAX package: ``"vmap"`` runs
    every stage once over all N images
    (:func:`sift_keypoints_and_descriptors_batch`), any other mode
    (``"map"``, the default) one image at a time.  Both give the same
    bits; the batched schedule launches each kernel once a stage for the
    batch and holds every image's intermediates at once."""
    if mode == "vmap":
        return sift_batch_with_stats(batch, cfg, mode)[:3]
    outs = [sift_extract(im, cfg) for im in batch]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))


def sift_batch_with_stats(
    batch: torch.Tensor, cfg: SiftConfig = SiftConfig(), mode: str = "map"
) -> Tuple[
    torch.Tensor, torch.Tensor, torch.Tensor,
    Dict[str, torch.Tensor], Dict[str, torch.Tensor],
]:
    """SIFT over an (N, H, W[, 3]) batch, in :func:`sift_batch`'s
    schedule ``mode``.

    Returns ``(xy (N,K,2), descriptors (N,K,128), valid (N,K), meta,
    stats)``: ``meta`` carries (N, K) size/angle/octave and the Newton
    cells — what the knife-edge escalation (models/sift/strict.py) needs
    to recompute a descriptor on host; ``stats`` carries per-stage
    occupancy counts with an N-image leading axis.
    """
    if mode == "vmap":
        kps, desc, stats = sift_keypoints_and_descriptors_batch(batch, cfg)
        xy = torch.stack([kps.x, kps.y], dim=-1)
        return xy, desc, kps.valid, _meta(kps), stats
    outs = []
    for im in batch:
        kps, desc, stats = sift_keypoints_and_descriptors(im, cfg)
        xy = torch.stack([kps.x, kps.y], dim=-1)
        outs.append((xy, desc, kps.valid, _meta(kps), stats))
    xy, desc, valid = (torch.stack([o[i] for o in outs]) for i in range(3))
    meta, stats = (
        {key: torch.stack([o[i][key] for o in outs]) for key in outs[0][i]}
        for i in (3, 4)
    )
    return xy, desc, valid, meta, stats


@dataclasses.dataclass
class KeyPointRecord:
    """cv2.KeyPoint-compatible record for the API-parity surface."""

    pt: Tuple[float, float]
    size: float
    angle: float
    response: float
    octave: int
    class_id: int = -1


def compute_keypoints_and_descriptors(
    image: np.ndarray,
    sigma: float = 1.6,
    num_intervals: int = 3,
    assumed_blur: float = 0.5,
    image_border_width: int = 5,
    *,
    device="cuda",
) -> Tuple[List[KeyPointRecord], np.ndarray]:
    """Reference-signature entry point (sift_impl.py:15-39 parity), run
    on ``device`` (the card unless the caller asks for the CPU).

    Accepts a BGR uint8 or grayscale image; returns keypoint records
    (cv2.KeyPoint-compatible fields) and an (N, 128) float32 descriptor
    array, trimmed to the valid count.
    """
    from vfx_image_stitching_tpu_torch.pipeline.stitch import resolve_device

    cfg = SiftConfig(
        sigma=sigma,
        num_intervals=num_intervals,
        assumed_blur=assumed_blur,
        image_border_width=image_border_width,
    )
    img = torch.as_tensor(np.asarray(image)).to(resolve_device(device))
    kps, desc, _ = sift_keypoints_and_descriptors(img, cfg)
    kps = Keypoints(*[f.cpu().numpy() for f in kps])
    desc = desc.cpu().numpy()
    valid = kps.valid
    records = [
        KeyPointRecord(
            pt=(float(kps.x[i]), float(kps.y[i])),
            size=float(kps.size[i]),
            angle=float(kps.angle[i]),
            response=float(kps.response[i]),
            octave=int(kps.octave[i]),
        )
        for i in np.nonzero(valid)[0]
    ]
    return records, desc[valid]
