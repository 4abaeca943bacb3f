"""SIFT orchestrator: the full per-image extraction and its batch loop.

Stage order matches ``sift_impl.compute_keypoints_and_descriptors``
(sift_impl.py:15-39); conversion-to-input-size and descriptors run *per
octave* before the global sort/dedup — both are per-keypoint maps, so
the result set is identical while the descriptor windows use
contiguous per-octave gradient stacks.

Localization always takes the resident-kernel path
(:func:`localize.localize_candidates_resident`); on CPU tensors every
kernel runs its plain PyTorch version.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

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
    dev = image.device
    gray = _to_gray(image)
    base = generate_base_image(gray, cfg.sigma, cfg.assumed_blur)
    num_octaves = compute_number_of_octaves(base.shape)
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
        layer, y, x, cand_valid = extract_candidates(
            dog, cfg.image_border_width, thresh, cand_cap
        )
        loc = localize_candidates_resident(dog, layer, y, x, cand_valid, o, cfg)
        loc_cap = min(caps.scaled_localized(o), cand_cap)
        loc_counts.append(torch.sum(loc.valid))
        loc_caps.append(loc_cap)
        loc = compact_localized(loc, loc_cap)
        # gradient fields are consumed only at the localized layers
        # 1..num_intervals, and only when the octave localized anything
        grad_src = pyramid[o][..., 1 : cfg.num_intervals + 1, :, :]
        if bool(loc.valid.any()):
            mag, ang = gradient_fields(grad_src)
        else:
            mag, ang = torch.zeros_like(grad_src), torch.zeros_like(grad_src)
        kps = assign_orientations_chunked(mag, ang, loc, o, cfg, layer_base=1)
        o_cap = caps.scaled_oriented(o)
        kps_c = convert_keypoints_to_input_image_size(compact(kps, o_cap))
        if caps.desc_bucketed:
            big_cap = min(caps._table(caps.desc_big_caps, o), o_cap)
            desc, big_count = compute_descriptors_bucketed(
                mag, ang, kps_c, o, cfg,
                small_cap=min(caps._table(caps.desc_small_caps, o), o_cap),
                big_cap=big_cap,
                layer_base=1,
            )
            desc_big_counts.append(big_count)
            desc_big_caps.append(big_cap)
        else:
            desc = compute_descriptors_chunked(mag, ang, kps_c, o, cfg,
                                               layer_base=1)
            desc_big_counts.append(torch.zeros((), dtype=torch.int64, device=dev))
            desc_big_caps.append(1)
        per_kps.append(kps_c)
        per_desc.append(desc)
        cand_counts.append(torch.sum(cand_valid))
        oriented_counts.append(torch.sum(kps.valid))
        cand_caps.append(cand_cap)
        oriented_caps.append(o_cap)

    kps = concatenate(tuple(per_kps))
    desc = torch.cat(per_desc, dim=0)
    kps, desc = sort_and_dedup(kps, desc, caps.max_keypoints)

    def caps_t(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    stats = {
        "cand_counts": torch.stack(cand_counts),
        "cand_caps": caps_t(cand_caps),
        "loc_counts": torch.stack(loc_counts),
        "loc_caps": caps_t(loc_caps),
        "oriented_counts": torch.stack(oriented_counts),
        "oriented_caps": caps_t(oriented_caps),
        "desc_big_counts": torch.stack(desc_big_counts),
        "desc_big_caps": caps_t(desc_big_caps),
        "final_count": kps.count(),
        "final_cap": caps_t(caps.max_keypoints),
    }
    return kps, desc, stats


def sift_batch_with_stats(
    batch: torch.Tensor, cfg: SiftConfig = SiftConfig()
) -> Tuple[
    torch.Tensor, torch.Tensor, torch.Tensor,
    Dict[str, torch.Tensor], Dict[str, torch.Tensor],
]:
    """SIFT over an (N, H, W[, 3]) batch, one image at a time.

    Returns ``(xy (N,K,2), descriptors (N,K,128), valid (N,K), meta,
    stats)``: ``meta`` carries (N, K) size/angle/octave and the Newton
    cells — what the knife-edge escalation (models/sift/strict.py) needs
    to recompute a descriptor on host; ``stats`` carries per-stage
    occupancy counts with an N-image leading axis.
    """
    outs = []
    for im in batch:
        kps, desc, stats = sift_keypoints_and_descriptors(im, cfg)
        xy = torch.stack([kps.x, kps.y], dim=-1)
        meta = {
            "size": kps.size, "angle": kps.angle, "octave": kps.octave,
            "ix": kps.ix, "iy": kps.iy,
            "jx": kps.jx, "jy": kps.jy, "jl": kps.jl,
        }
        outs.append((xy, desc, kps.valid, meta, stats))
    xy, desc, valid = (torch.stack([o[i] for o in outs]) for i in range(3))
    meta, stats = (
        {key: torch.stack([o[i][key] for o in outs]) for key in outs[0][i]}
        for i in (3, 4)
    )
    return xy, desc, valid, meta, stats
