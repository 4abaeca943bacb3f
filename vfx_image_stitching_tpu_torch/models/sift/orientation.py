"""Orientation assignment (sift_impl.py:246-293 parity).

Per localized candidate: a Gaussian-weighted 36-bin histogram of gradient
directions over a data-dependent radius window (the orientation-histogram
kernel, :func:`kernels.orientation_histograms`), [1,4,6,4,1]/16 circular
smoothing, and one keypoint per local peak >= 0.8*max with a parabolic
sub-bin angle.
"""

from __future__ import annotations

import torch

from vfx_image_stitching_tpu_torch.config import SiftConfig
from vfx_image_stitching_tpu_torch.models.sift.chunking import (
    chunk_size,
    live_chunk_bound,
    zero_pad_rows,
)
from vfx_image_stitching_tpu_torch.models.sift.kernels import (
    orientation_histograms,
)
from vfx_image_stitching_tpu_torch.models.sift.keypoints import Keypoints
from vfx_image_stitching_tpu_torch.models.sift.localize import Localized

_INT_MIN = torch.iinfo(torch.int32).min


def orientation_inputs(loc: Localized, octave: int, cfg: SiftConfig,
                       n_layers: int, layer_base: int):
    """Per-candidate histogram window inputs ``(layer, cy, cx, radius,
    weight_factor)`` (sift_impl.py:250-256)."""
    inv_scale_o = float(2.0 ** -(octave))
    scale = cfg.scale_factor * loc.size * float(2.0 ** -(octave + 1))
    radius = torch.round(cfg.radius_factor * scale).to(torch.int32)
    weight_factor = -0.5 / (scale * scale)
    cx = torch.round(loc.pt_x * inv_scale_o).to(torch.int32)
    cy = torch.round(loc.pt_y * inv_scale_o).to(torch.int32)
    # filler slots carry layer 0, which re-bases below 0 — clamp so the
    # (masked-out) window fetch stays in bounds
    lyr = (loc.layer - layer_base).clamp(0, n_layers - 1)
    return lyr, cy, cx, radius, weight_factor


def assign_orientations(
    mag_stack: torch.Tensor,
    ang_stack: torch.Tensor,
    loc: Localized,
    octave: int,
    cfg: SiftConfig,
    layer_base: int = 0,
) -> Keypoints:
    """Emit up to ``max_orientations`` oriented keypoints per candidate.

    Returns a Keypoints set of capacity K * max_orientations, ordered
    (candidate-major, peak-bin ascending) to match the reference's
    emission order.  ``layer_base`` re-bases the gradient-stack plane
    index: the pipeline passes 3-level stacks holding layers
    1..num_intervals (layer_base=1).
    """
    nb = cfg.num_bins
    k = loc.x.shape[0]
    lyr, cy, cx, radius, weight_factor = orientation_inputs(
        loc, octave, cfg, mag_stack.shape[-3], layer_base
    )
    raw = orientation_histograms(
        mag_stack, ang_stack, lyr, cy, cx, radius, weight_factor, loc.valid,
        cfg.capacities.max_radius, nb,
    )

    # circular [1,4,6,4,1]/16 smoothing (sift_impl.py:273-277)
    smooth = (
        6.0 * raw
        + 4.0 * (torch.roll(raw, 1, dims=-1) + torch.roll(raw, -1, dims=-1))
        + torch.roll(raw, 2, dims=-1) + torch.roll(raw, -2, dims=-1)
    ) / 16.0
    maxv = torch.amax(smooth, dim=-1, keepdim=True)
    left = torch.roll(smooth, 1, dims=-1)
    right = torch.roll(smooth, -1, dims=-1)
    qualify = (
        (smooth > left) & (smooth > right)
        & (smooth >= cfg.peak_ratio * maxv)
        & loc.valid[:, None]
    )

    # first max_orientations qualifying bins in ascending order
    p_cap = cfg.capacities.max_orientations
    bin_ids = torch.arange(nb, dtype=torch.int32, device=raw.device)[None, :]
    sel_scores = torch.where(qualify, -bin_ids, torch.full_like(bin_ids, _INT_MIN))
    top = torch.sort(sel_scores, dim=-1, descending=True, stable=True).values[:, :p_cap]
    peak_valid = top > _INT_MIN
    p = torch.where(peak_valid, -top, torch.zeros_like(top)).to(torch.int64)

    s_p = torch.gather(smooth, 1, p)
    s_l = torch.gather(smooth, 1, torch.remainder(p - 1, nb))
    s_r = torch.gather(smooth, 1, torch.remainder(p + 1, nb))
    denom = s_l - 2.0 * s_p + s_r
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    interp = torch.remainder(p.to(torch.float32) + 0.5 * (s_l - s_r) / denom, nb)
    angle = 360.0 - interp * (360.0 / nb)
    angle = torch.where(torch.abs(angle - 360.0) < cfg.float_tolerance,
                        torch.zeros_like(angle), angle)

    def expand(f):
        return f[:, None].expand(k, p_cap).reshape(-1)

    return Keypoints(
        x=expand(loc.pt_x),
        y=expand(loc.pt_y),
        size=expand(loc.size),
        angle=angle.reshape(-1),
        response=expand(loc.response),
        octave=expand(loc.octave_packed),
        valid=(peak_valid & loc.valid[:, None]).reshape(-1),
        ix=expand(loc.x),
        iy=expand(loc.y),
        jx=expand(loc.jx),
        jy=expand(loc.jy),
        jl=expand(loc.jl),
    )


def assign_orientations_chunked(
    mag_stack: torch.Tensor,
    ang_stack: torch.Tensor,
    loc: Localized,
    octave: int,
    cfg: SiftConfig,
    chunk: int = 512,
    layer_base: int = 0,
) -> Keypoints:
    """:func:`assign_orientations` over the live leading candidate chunks.

    The live chunks run as one batch (rows are independent); the rows of
    chunks without a valid candidate come out all-zero and invalid, in
    the same candidate-major emission order as the JAX package.
    """
    k = loc.x.shape[0]
    p_cap = cfg.capacities.max_orientations
    chunk = chunk_size(k, chunk)
    n_rows = live_chunk_bound(loc.valid, chunk) * chunk
    kps = assign_orientations(
        mag_stack, ang_stack, Localized(*[f[:n_rows] for f in loc]),
        octave, cfg, layer_base=layer_base,
    )
    return zero_pad_rows(kps, k * p_cap)
