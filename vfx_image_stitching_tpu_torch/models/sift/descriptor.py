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
GEMM (:func:`kernels.trilinear_histograms`) runs in chunks of
``desc_chunk`` keypoints to bound the two-hot intermediates.  That is
the stitch's route.  :func:`compute_descriptors_histogram` is the other
one, as in the JAX package: the whole octave's histograms from one
launch of the trilinear-histogram kernel, with no GEMM.
"""

from __future__ import annotations

import math

import torch

from vfx_image_stitching_tpu_torch.config import SiftConfig
from vfx_image_stitching_tpu_torch.models.sift.chunking import (
    batch_rows,
    chunk_size,
    live_chunk_bound,
    live_rows,
)
from vfx_image_stitching_tpu_torch.models.sift.kernels import (
    descriptor_histograms,
    pair_window_gather,
    trilinear_histograms,
)
from vfx_image_stitching_tpu_torch.models.sift.keypoints import (
    Keypoints,
    _compact_order,
    take,
    unpack_octave,
)

# Rows of one pass of the batched schedule's descriptor stage (a whole
# number of GEMM chunks): bounds its two-hot intermediates, about 3 MB a
# row at S = 89, while one pass still covers many images' rows.
BATCH_PASS_ROWS = 1024


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
    gemm_rows: int | None = None,
) -> torch.Tensor:
    """(K, 128) descriptors for *converted* keypoints of one octave, from
    their (K, S, S) gradient windows starting at rows ``sy``, cols ``sx``
    of the octave's (rows_dim, cols_dim) gradient fields; ``gemm_rows``
    is :func:`kernels.trilinear_histograms`'s."""
    (_layer, pt_x, pt_y, angle, cos_a, sin_a, hist_width, half_w) = (
        _window_params(kps, cfg, rows_dim, cols_dim, half_cap)
    )
    hist, _mask = trilinear_histograms(
        magw, angw, sy, sx, pt_y, pt_x, half_w, cos_a, sin_a, hist_width,
        angle, kps.valid, rows_dim, cols_dim, cfg.desc_bins, cfg.window_width,
        fused_offset=False, gemm_rows=gemm_rows,
    )
    return _finalize(hist, cfg)


def histogram_inputs(
    mag_stack: torch.Tensor,
    ang_stack: torch.Tensor,
    kps: Keypoints,
    cfg: SiftConfig,
    layer_base: int = 0,
) -> tuple:
    """The arguments of :func:`kernels.descriptor_histograms` for the live
    leading ``desc_chunk`` chunks of ``kps`` (window geometry at
    ``half_cap = max_half_width``; ``hist_width`` 1 where it is not
    positive, so an invalid row never divides by 0)."""
    caps = cfg.capacities
    k = kps.capacity
    chunk = chunk_size(k, min(caps.desc_chunk, k))
    n_rows = live_chunk_bound(kps.valid, chunk) * chunk if k else 0
    live = Keypoints(*[f[:n_rows] for f in kps])
    rows_dim, cols_dim = mag_stack.shape[-2:]
    layer, pt_x, pt_y, angle, cos_a, sin_a, hist_width, half_w = _window_params(
        live, cfg, rows_dim, cols_dim, caps.max_half_width)
    lyr = (layer - layer_base).clamp(0, mag_stack.shape[-3] - 1)
    safe_hw = torch.where(hist_width > 0.0, hist_width,
                          torch.ones_like(hist_width))
    return (mag_stack, ang_stack, lyr, pt_y, pt_x, half_w, cos_a, sin_a,
            safe_hw, angle, live.valid, caps.max_half_width, cfg.desc_bins,
            cfg.window_width)


def compute_descriptors_histogram(
    mag_stack: torch.Tensor,
    ang_stack: torch.Tensor,
    kps: Keypoints,
    octave: int,
    cfg: SiftConfig,
    layer_base: int = 0,
) -> torch.Tensor:
    """(K, 128) descriptors of one octave from one launch of the
    trilinear-histogram kernel (:func:`kernels.descriptor_histograms`)
    over the live leading rows, then the clip / renormalise / ``rint``
    of :func:`_finalize`; dead rows are zero.

    Counterpart of the JAX package's ``compute_descriptors_pallas``: the
    whole octave's histograms in one pass, with no two-hot GEMM.  It
    agrees with :func:`compute_descriptors_bucketed` (which the stitch
    runs) to 1 LSB on under 2% of entries: the two round ``r_bin``
    differently and sum in other orders."""
    out_dim = cfg.window_width * cfg.window_width * cfg.desc_bins
    out = torch.zeros((kps.capacity, out_dim), dtype=torch.float32,
                      device=mag_stack.device)
    args = histogram_inputs(mag_stack, ang_stack, kps, cfg, layer_base)
    n_rows = args[2].shape[0]
    if n_rows:
        out[:n_rows] = _finalize(descriptor_histograms(*args), cfg)
    return out


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

    (N, L, H, W) stacks take (N, K) keypoints and give (N, K, 128): one
    window-gather launch over the batch's live rows, each row at its own
    image's planes, then passes of :data:`BATCH_PASS_ROWS` rows whose
    elementwise work runs once a pass; the GEMM keeps the one-image
    schedule's shape, one ``desc_chunk`` a call, so its library picks the
    same algorithm and gives the same bits.
    """
    caps = cfg.capacities
    if half_cap is None:
        half_cap = caps.max_half_width
    k = kps.capacity
    lead = kps.x.shape[:-1]
    out_dim = cfg.window_width * cfg.window_width * cfg.desc_bins
    out = torch.zeros(lead + (k, out_dim), dtype=torch.float32,
                      device=mag_stack.device)
    if k == 0:
        return out
    chunk = chunk_size(k, min(caps.desc_chunk, k))
    n_rows, own = live_rows(kps.valid, chunk)
    if n_rows == 0:
        return out
    rows_dim, cols_dim = mag_stack.shape[-2:]
    n_layers = mag_stack.shape[-3]
    fields, img = batch_rows(mag_stack, *[f[..., :n_rows] for f in kps])
    live = Keypoints(*fields)
    layer, pt_x, pt_y, *_rest = _window_params(live, cfg, rows_dim, cols_dim,
                                               half_cap)
    lyr = (layer - layer_base).clamp(0, n_layers - 1)
    step = chunk
    res = out
    if img is not None:
        lyr = lyr + img * n_layers
        mag_stack = mag_stack.reshape((-1, rows_dim, cols_dim))
        ang_stack = ang_stack.reshape((-1, rows_dim, cols_dim))
        step = max(BATCH_PASS_ROWS // chunk, 1) * chunk
        res = torch.empty((live.x.shape[0], out_dim), dtype=torch.float32,
                          device=out.device)
    magw, angw, sy, sx = pair_window_gather(
        mag_stack, ang_stack, lyr, pt_y, pt_x, half_cap
    )
    for a in range(0, live.x.shape[0], step):
        b = a + step
        res[a:b] = compute_descriptors(
            magw[a:b], angw[a:b], sy[a:b], sx[a:b],
            Keypoints(*[f[a:b] for f in live]), cfg, half_cap,
            rows_dim, cols_dim, gemm_rows=chunk,
        )
    if img is not None:
        keep = torch.arange(n_rows, device=own.device) < own[:, None]
        out[:, :n_rows] = torch.where(
            keep[..., None], res.reshape(lead + (n_rows, out_dim)),
            torch.zeros((), dtype=torch.float32, device=out.device))
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
    pass.  Returns ``(descriptors, big-bucket count)``.  A batch of
    images ((N, L, H, W) stacks, (N, K) keypoints) splits and compacts
    each image's rows on its own and runs one window gather per bucket.
    """
    caps = cfg.capacities
    k = kps.capacity
    rows_dim, cols_dim = mag_stack.shape[-2:]
    half_w = _window_params(kps, cfg, rows_dim, cols_dim,
                            caps.max_half_width)[-1]
    is_small = kps.valid & (half_w <= caps.desc_small_half)
    small_rank = torch.cumsum(is_small.to(torch.int32), -1) - 1
    in_small = is_small & (small_rank < small_cap)
    in_big = kps.valid & ~in_small

    idx_small = _compact_order(in_small)[..., :small_cap]
    idx_big = _compact_order(in_big)[..., :big_cap]
    d_small = compute_descriptors_chunked(
        mag_stack, ang_stack,
        take(kps, idx_small, torch.take_along_dim(in_small, idx_small, -1)),
        octave, cfg, half_cap=caps.desc_small_half, layer_base=layer_base,
    )
    d_big = compute_descriptors_chunked(
        mag_stack, ang_stack,
        take(kps, idx_big, torch.take_along_dim(in_big, idx_big, -1)),
        octave, cfg, layer_base=layer_base,
    )

    # scatter back (each index list is a permutation prefix, so no two
    # rows collide), masked by membership before merging
    def scatter(idx, d):
        full = torch.zeros(idx.shape[:-1] + (k, d.shape[-1]),
                           dtype=torch.float32, device=d.device)
        return full.scatter(-2, idx[..., None].expand(d.shape), d)

    zero = torch.zeros((), dtype=torch.float32, device=d_small.device)
    desc = torch.where(in_small[..., None], scatter(idx_small, d_small),
                       torch.where(in_big[..., None], scatter(idx_big, d_big),
                                   zero))
    return desc, torch.sum(in_big, dim=-1)
