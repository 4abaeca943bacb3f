"""128-d SIFT descriptors as a batched trilinear two-hot GEMM.

Parity with ``generate_descriptors`` (sift_impl.py:361-526): per keypoint
a (2*half_width+1)^2 sample window, direct-differencing gradients, local
coordinates rotated by ``360 - angle``, 4x4 spatial x 8 orientation bins
with trilinear scatter, then clip at 0.2*|v|, renormalize, and
``round(512 v)`` clamped to [0, 255].

The reference's ``np.add.at`` scatter decomposes *separably*: every sample
contributes ``wm * R (x) C (x) O8`` where R/C/O8 are two-hot interpolation
vectors, so the descriptor is one batched matmul ``(16, S) @ (S, 8)`` per
keypoint over the inner 4x4 cells (the reference crops its padding ring).
The sample windows come from the window-gather kernel
(:func:`kernels.pair_window_gather`), one launch per size bucket; the
GEMM runs in chunks of ``desc_chunk`` keypoints to bound the two-hot
intermediates.
"""

from __future__ import annotations

import math

import torch

from vfx_image_stitching_tpu_torch.config import SiftConfig
from vfx_image_stitching_tpu_torch.models.sift.chunking import (
    chunk_size,
    live_chunk_bound,
)
from vfx_image_stitching_tpu_torch.models.sift.kernels import (
    pair_window_gather,
)
from vfx_image_stitching_tpu_torch.models.sift.keypoints import (
    Keypoints,
    _compact_order,
    take,
    unpack_octave,
)


def _two_hot(idx: torch.Tensor, frac_lo: torch.Tensor, frac_hi: torch.Tensor,
             n: int, wrap: bool) -> torch.Tensor:
    """(..., n) vector with frac_lo at idx and frac_hi at idx+1 (opt. mod n)."""
    pos = torch.arange(n, dtype=torch.int32, device=idx.device)
    idx0 = torch.remainder(idx, n) if wrap else idx
    idx1 = torch.remainder(idx + 1, n) if wrap else idx + 1
    zero = torch.zeros((), dtype=frac_lo.dtype, device=idx.device)
    lo = torch.where(pos == idx0[..., None], frac_lo[..., None], zero)
    hi = torch.where(pos == idx1[..., None], frac_hi[..., None], zero)
    return lo + hi


def _finalize(vec: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """Clip at 0.2*|v|, renormalize, round(512 v) clamped to [0, 255]."""
    norm = torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True))
    vec = torch.minimum(vec, norm * cfg.descriptor_max_value)
    norm2 = torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True))
    norm2 = torch.clamp(norm2, min=cfg.float_tolerance)
    vec = vec / norm2
    return torch.clamp(torch.round(512.0 * vec), 0.0, 255.0)


def _window_params(kps: Keypoints, cfg: SiftConfig, rows_dim: int,
                   cols_dim: int, half_cap: int):
    """Per-keypoint descriptor window geometry (sift_impl.py:370-387)."""
    _octv, layer, scl = unpack_octave(kps.octave)
    pt_x = torch.round(scl * kps.x).to(torch.int32)
    pt_y = torch.round(scl * kps.y).to(torch.int32)
    angle = 360.0 - kps.angle
    rad = torch.deg2rad(angle)
    hist_width = cfg.scale_multiplier * 0.5 * scl * kps.size
    ww = cfg.window_width
    half_w = torch.round(
        hist_width * (math.sqrt(2) * (ww + 1) * 0.5)
    ).to(torch.int32)
    diag = int(math.sqrt(rows_dim**2 + cols_dim**2))
    half_w = torch.clamp(half_w, max=diag)
    half_w = torch.clamp(half_w, max=half_cap)
    return (layer, pt_x, pt_y, angle, torch.cos(rad), torch.sin(rad),
            hist_width, half_w)


def compute_descriptors(
    magw: torch.Tensor,
    angw: torch.Tensor,
    sy: torch.Tensor,
    sx: torch.Tensor,
    kps: Keypoints,
    cfg: SiftConfig,
    half_cap: int,
    rows_dim: int,
    cols_dim: int,
) -> torch.Tensor:
    """(K, 128) descriptors for *converted* keypoints of one octave, from
    their (K, S, S) gradient windows starting at rows ``sy``, cols ``sx``
    of the octave's (rows_dim, cols_dim) gradient fields."""
    s = 2 * half_cap + 1
    nb = cfg.desc_bins
    ww = cfg.window_width
    (_layer, pt_x, pt_y, angle, cos_a, sin_a, hist_width, half_w) = (
        _window_params(kps, cfg, rows_dim, cols_dim, half_cap)
    )
    rng = torch.arange(s, dtype=torch.int32, device=magw.device)
    rows = sy[:, None] + rng[None, :]
    cols = sx[:, None] + rng[None, :]

    ys = rows - pt_y[:, None]                       # (K, S) row offsets
    xs = cols - pt_x[:, None]                       # (K, S) col offsets
    in_win = (
        (torch.abs(ys) <= half_w[:, None])[:, :, None]
        & (torch.abs(xs) <= half_w[:, None])[:, None, :]
    )
    in_bounds = (
        ((rows > 0) & (rows < rows_dim - 1))[:, :, None]
        & ((cols > 0) & (cols < cols_dim - 1))[:, None, :]
    )
    ysf = ys.to(torch.float32)[:, :, None]
    xsf = xs.to(torch.float32)[:, None, :]
    r_rot = xsf * sin_a[:, None, None] + ysf * cos_a[:, None, None]
    c_rot = xsf * cos_a[:, None, None] - ysf * sin_a[:, None, None]
    hw = hist_width[:, None, None]
    r_bin = r_rot / hw + 0.5 * ww - 0.5
    c_bin = c_rot / hw + 0.5 * ww - 0.5
    in_bin = (r_bin > -1.0) & (r_bin < ww) & (c_bin > -1.0) & (c_bin < ww)

    weight_mul = -0.5 / ((0.5 * ww) ** 2)
    weight = torch.exp(weight_mul * ((r_rot / hw) ** 2 + (c_rot / hw) ** 2))
    mask = in_win & in_bounds & in_bin & kps.valid[:, None, None]
    zero = torch.zeros((), dtype=torch.float32, device=magw.device)
    wm = torch.where(mask, weight * magw, zero)

    # sanitize masked samples: hist_width of an invalid slot can be 0,
    # making r_bin/c_bin inf/nan, and 0 * nan would poison the GEMM
    r_bin = torch.where(mask, r_bin, zero)
    c_bin = torch.where(mask, c_bin, zero)
    ob = torch.remainder((angw - angle[:, None, None]) * (nb / 360.0), nb)
    ob = torch.where(mask, ob, zero)

    r0 = torch.floor(r_bin).to(torch.int32)
    c0 = torch.floor(c_bin).to(torch.int32)
    o0 = torch.remainder(torch.floor(ob).to(torch.int32), nb)
    rf = r_bin - r0
    cf = c_bin - c0
    of = ob - o0

    k = wm.shape[0]
    # reference row split: c1 = wm*rf to row r0+2, (wm - c1) to row r0+1;
    # only the ww x ww inner cells (rows/cols 1..ww of the padded grid)
    c1 = wm * rf
    ra = torch.clamp(r0 + 1, 0, ww + 1)[..., None]
    ca = torch.clamp(c0 + 1, 0, ww + 1)[..., None]
    pos = torch.arange(ww * ww, dtype=torch.int32, device=magw.device)
    pa = torch.div(pos, ww, rounding_mode="floor") + 1
    pb = pos % ww + 1
    rv = torch.where(pa == ra, (wm - c1)[..., None], zero) + torch.where(
        pa == ra + 1, c1[..., None], zero
    )
    cv = torch.where(pb == ca, (1.0 - cf)[..., None], zero) + torch.where(
        pb == ca + 1, cf[..., None], zero
    )
    o8 = _two_hot(o0, (1.0 - of), of, nb, wrap=True)  # (K, S, S, 8)

    rc = (rv * cv).reshape(k, s * s, ww * ww)
    tensor = torch.bmm(rc.transpose(1, 2), o8.reshape(k, s * s, nb))
    return _finalize(tensor.reshape(k, ww * ww * nb), cfg)


def compute_descriptors_chunked(
    mag_stack: torch.Tensor,
    ang_stack: torch.Tensor,
    kps: Keypoints,
    octave: int,
    cfg: SiftConfig,
    half_cap: int | None = None,
    layer_base: int = 0,
) -> torch.Tensor:
    """(K, 128) descriptors over the live leading ``desc_chunk`` chunks.

    One window-gather launch covers every live keypoint (the copy is
    exact, so its batching does not change a value); the GEMM then runs
    chunk by chunk.  Rows of dead chunks are zero.
    """
    caps = cfg.capacities
    if half_cap is None:
        half_cap = caps.max_half_width
    k = kps.capacity
    out_dim = cfg.window_width * cfg.window_width * cfg.desc_bins
    out = torch.zeros((k, out_dim), dtype=torch.float32, device=mag_stack.device)
    if k == 0:
        return out
    chunk = chunk_size(k, min(caps.desc_chunk, k))
    n_rows = live_chunk_bound(kps.valid, chunk) * chunk
    if n_rows == 0:
        return out
    rows_dim, cols_dim = mag_stack.shape[-2:]
    live = Keypoints(*[f[:n_rows] for f in kps])
    layer, pt_x, pt_y, *_rest = _window_params(live, cfg, rows_dim, cols_dim,
                                               half_cap)
    lyr = (layer - layer_base).clamp(0, mag_stack.shape[-3] - 1)
    magw, angw, sy, sx = pair_window_gather(
        mag_stack, ang_stack, lyr, pt_y, pt_x, half_cap
    )
    for a in range(0, n_rows, chunk):
        b = a + chunk
        out[a:b] = compute_descriptors(
            magw[a:b], angw[a:b], sy[a:b], sx[a:b],
            Keypoints(*[f[a:b] for f in live]), cfg, half_cap,
            rows_dim, cols_dim,
        )
    return out


def compute_descriptors_bucketed(
    mag_stack: torch.Tensor,
    ang_stack: torch.Tensor,
    kps: Keypoints,
    octave: int,
    cfg: SiftConfig,
    small_cap: int,
    big_cap: int,
    layer_base: int = 0,
):
    """Size-bucketed descriptors: small windows for most keypoints.

    Keypoints with ``half_w <= desc_small_half`` are compacted into a
    small-window pass (correct because masks discard samples beyond each
    keypoint's own half_w); the rest — plus any small-group overflow,
    which the big window also computes correctly — take the full-window
    pass.  Returns ``(descriptors, big-bucket count)``.
    """
    caps = cfg.capacities
    k = kps.capacity
    rows_dim, cols_dim = mag_stack.shape[-2:]
    half_w = _window_params(kps, cfg, rows_dim, cols_dim,
                            caps.max_half_width)[-1]
    is_small = kps.valid & (half_w <= caps.desc_small_half)
    small_rank = torch.cumsum(is_small.to(torch.int32), 0) - 1
    in_small = is_small & (small_rank < small_cap)
    in_big = kps.valid & ~in_small

    idx_small = _compact_order(in_small)[:small_cap]
    idx_big = _compact_order(in_big)[:big_cap]
    d_small = compute_descriptors_chunked(
        mag_stack, ang_stack, take(kps, idx_small, in_small[idx_small]),
        octave, cfg, half_cap=caps.desc_small_half, layer_base=layer_base,
    )
    d_big = compute_descriptors_chunked(
        mag_stack, ang_stack, take(kps, idx_big, in_big[idx_big]), octave, cfg,
        layer_base=layer_base,
    )

    # scatter back (each index list is a permutation prefix, so no two
    # rows collide), masked by membership before merging
    full_small = torch.zeros((k, d_small.shape[-1]), dtype=torch.float32,
                             device=d_small.device)
    full_small[idx_small] = d_small
    full_big = torch.zeros_like(full_small)
    full_big[idx_big] = d_big
    zero = torch.zeros((), dtype=torch.float32, device=d_small.device)
    desc = torch.where(in_small[:, None], full_small,
                       torch.where(in_big[:, None], full_big, zero))
    return desc, torch.sum(in_big)
