"""Knife-edge precision escalation for golden-exact match decisions.

The TPU descriptor path accumulates histograms in f32 (two-hot GEMM);
the reference (sift_impl.py:361-526) scatters f64 contributions into an
f32 tensor via ``np.add.at`` in a fixed order.  The two agree on the
final ``round(512*v)`` integers for >99.9% of components, but a
component that lands within f32-noise of a rounding boundary can flip
by +-1, and a +-1 flip can move a match's squared distance across the
absolute threshold (25000) — observed on parrington pair 13, where one
flipped match (24880 vs the oracle's 25036) changes a 4-way RANSAC vote
tie and shifts a seam by 1 px vs the author's golden.

Instead of slowing the whole TPU pipeline down to f64, the matcher
flags knife-edge decisions — |best_dist - thresh| or the argmin gap
within ``borderline_margin`` (default 1024 = two worst-case +-1
component flips: 2 * (2*255 + 1)) — and this module re-decides ONLY
those rows on host with reference-faithful arithmetic:

  * the Gaussian pyramid is rebuilt with cv2 exactly as the reference
    builds it (sift_impl.py:45-97), so the sampled image values match
    the oracle's bit-for-bit;
  * the descriptor is recomputed with f64 contributions accumulated
    into an f32 tensor by ``np.add.at`` in the reference's scatter
    order (sift_impl.py:361-526) — bit-identical by construction;
  * the pair's translation vote is re-run on host with the corrected
    match set (image_stitching_sift.py:86-111 semantics: every match a
    hypothesis, squared-distance < 3 votes, first strict-max wins).

Escalation is rare (one row on the four reference datasets) and costs
~2 descriptor windows + an M^2 vote on host, so the TPU fast path is
untouched.  Tested in tests/test_strict.py.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from vfx_image_stitching_tpu_torch.config import SiftConfig

# One +-1 component flip shifts a squared distance by at most 2*255 + 1;
# the default margin covers two such flips (one per descriptor endpoint):
# 2 * (2*255 + 1) = 1022, rounded up.  This is a PROBABILISTIC bound,
# not a worst case: a descriptor with >= 2 f32-noise-flipped components
# (or both endpoints flipping in the same row) could shift a distance
# past the margin and be decided without escalation.  Flips require a
# component to sit within f32-noise of a 0.5/512 rounding boundary
# (~1e-5 relative), so k simultaneous flips on one descriptor pair decay
# ~geometrically; across all four reference datasets the observed
# maximum is ONE flipped component per pair (PARITY.md deviation 1), so
# two is already a 2x headroom.  Raise MatchConfig.borderline_margin to
# 2048+ to cover deeper flip multiplicities at more escalation cost.
DEFAULT_BORDERLINE_MARGIN = 1024.0


def host_gaussian_pyramid(
    bgr_u8: np.ndarray, cfg: SiftConfig = SiftConfig()
) -> List[List[np.ndarray]]:
    """cv2-built Gaussian pyramid, value-identical to the reference's.

    Mirrors generate_base_image + compute_number_of_octaves +
    generate_gaussian_kernels + generate_gaussian_images
    (sift_impl.py:45-97): 2x INTER_LINEAR upsample, sigma_diff blur,
    num_intervals+3 incremental blurs per octave, next octave seeded
    from octave[-3] by INTER_NEAREST half-size resize.
    """
    import cv2

    if bgr_u8.ndim == 3:
        gray = cv2.cvtColor(bgr_u8, cv2.COLOR_BGR2GRAY).astype("float32")
    else:
        gray = bgr_u8.astype("float32")
    up = cv2.resize(gray, (0, 0), fx=2, fy=2, interpolation=cv2.INTER_LINEAR)
    sigma_diff = np.sqrt(
        max((cfg.sigma ** 2) - ((2 * cfg.assumed_blur) ** 2), 0.01)
    )
    image = cv2.GaussianBlur(up, (0, 0), sigmaX=sigma_diff, sigmaY=sigma_diff)

    num_octaves = int(np.round(np.log(min(image.shape)) / np.log(2) - 1))
    n_per = cfg.num_intervals + 3
    k = 2 ** (1.0 / cfg.num_intervals)
    kernels = np.zeros(n_per)
    kernels[0] = cfg.sigma
    for i in range(1, n_per):
        s_prev = (k ** (i - 1)) * cfg.sigma
        kernels[i] = np.sqrt((k * s_prev) ** 2 - s_prev ** 2)

    pyramid: List[List[np.ndarray]] = []
    for _ in range(num_octaves):
        octave = [image]
        for g in kernels[1:]:
            image = cv2.GaussianBlur(image, (0, 0), sigmaX=g, sigmaY=g)
            octave.append(image)
        pyramid.append(octave)
        seed = octave[-3]
        image = cv2.resize(
            seed,
            (seed.shape[1] // 2, seed.shape[0] // 2),
            interpolation=cv2.INTER_NEAREST,
        )
    return pyramid


def host_dog_octaves(
    pyramid: Sequence[Sequence[np.ndarray]],
) -> List[List[np.ndarray]]:
    """Per-octave DoG lists from a host pyramid (sift_impl.py:100-111)."""
    return [
        [b - a for a, b in zip(oct_, oct_[1:])] for oct_ in pyramid
    ]


def relocalize_strict(
    ix: int,
    iy: int,
    jx: int,
    jy: int,
    jl: int,
    layer: int,
    octave_orig: int,
    dog_octave: Sequence[np.ndarray],
    cfg: SiftConfig = SiftConfig(),
):
    """One Newton evaluation, reference arithmetic.

    The device localization (f32 adjugate solve) lands on the same
    integer cells as the reference's f64-path ``np.linalg.lstsq`` Newton
    loop (sift_impl.py:169-211) but its sub-pixel offset — and hence
    pt/size — differs at ~1e-5.  The reference's final state pairs the
    cube/grad/Hessian/update computed at the last-COMPUTE cell
    ``(jl, jy, jx)`` with the position cell ``(layer, iy, ix)``: for a
    converged point the two coincide (the loop breaks before moving);
    for the accepted-non-converged quirk the loop moved once more after
    the final compute (sift_impl.py:185-191), so the accept tests and
    the sub-pixel offset come from the pre-move cell while pt/size pack
    the post-move coordinates.  Re-evaluating once at the compute cell
    with the reference's exact operations reproduces the oracle's
    keypoint bit-for-bit in both cases.

    Returns ``(pt, size, response, octave_packed)`` at base-image scale
    (pre-convert), or ``None`` when the contrast/edge tests reject.
    """
    x, y = int(ix), int(iy)
    cx, cy = int(jx), int(jy)
    prev_l = dog_octave[jl - 1]
    curr = dog_octave[jl]
    nxt = dog_octave[jl + 1]
    cube = np.stack([
        prev_l[cy - 1 : cy + 2, cx - 1 : cx + 2],
        curr[cy - 1 : cy + 2, cx - 1 : cx + 2],
        nxt[cy - 1 : cy + 2, cx - 1 : cx + 2],
    ]).astype("float32") / 255.0
    dx = 0.5 * (cube[1, 1, 2] - cube[1, 1, 0])
    dy = 0.5 * (cube[1, 2, 1] - cube[1, 0, 1])
    ds = 0.5 * (cube[2, 1, 1] - cube[0, 1, 1])
    grad = np.array([dx, dy, ds])
    v = cube[1, 1, 1]
    dxx = cube[1, 1, 2] - 2 * v + cube[1, 1, 0]
    dyy = cube[1, 2, 1] - 2 * v + cube[1, 0, 1]
    dss = cube[2, 1, 1] - 2 * v + cube[0, 1, 1]
    dxy = 0.25 * (cube[1, 2, 2] - cube[1, 2, 0] - cube[1, 0, 2] + cube[1, 0, 0])
    dxs = 0.25 * (cube[2, 1, 2] - cube[2, 1, 0] - cube[0, 1, 2] + cube[0, 1, 0])
    dys = 0.25 * (cube[2, 2, 1] - cube[2, 0, 1] - cube[0, 2, 1] + cube[0, 0, 1])
    hess = np.array([[dxx, dxy, dxs], [dxy, dyy, dys], [dxs, dys, dss]])
    update = -np.linalg.lstsq(hess, grad, rcond=None)[0]

    val = cube[1, 1, 1] + 0.5 * np.dot(grad, update)
    if abs(val) * cfg.num_intervals < cfg.contrast_threshold:
        return None
    h2 = hess[:2, :2]
    tr = np.trace(h2)
    det = np.linalg.det(h2)
    if det <= 0 or cfg.eigen_ratio * (tr ** 2) >= (
        (cfg.eigen_ratio + 1) ** 2
    ) * det:
        return None
    pt = (
        (x + update[0]) * (2 ** octave_orig),
        (y + update[1]) * (2 ** octave_orig),
    )
    packed = (
        octave_orig
        + layer * (2 ** 8)
        + int(np.round((update[2] + 0.5) * 255)) * (2 ** 16)
    )
    size = (
        cfg.sigma
        * (2 ** ((layer + update[2]) / np.float32(cfg.num_intervals)))
        * (2 ** (octave_orig + 1))
    )
    return pt, float(size), float(abs(val)), packed


def orientations_strict(
    pt: Tuple[float, float],
    size: float,
    octave_orig: int,
    gauss_img: np.ndarray,
    cfg: SiftConfig = SiftConfig(),
) -> List[float]:
    """Orientation peaks in reference arithmetic (sift_impl.py:246-293).

    Vectorized over the window but accumulated via ``np.add.at`` in the
    reference's (dy, dx) row-major order; returns the peak angles.
    """
    nb = cfg.num_bins
    scale = cfg.scale_factor * size / np.float32(2 ** (octave_orig + 1))
    radius = int(np.round(cfg.radius_factor * scale))
    weight_fac = -0.5 / (scale ** 2)
    cy = int(np.round(pt[1] / np.float32(2 ** octave_orig)))
    cx = int(np.round(pt[0] / np.float32(2 ** octave_orig)))
    h, w = gauss_img.shape

    dys, dxs = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    dys = dys.ravel()
    dxs = dxs.ravel()
    yy = cy + dys
    xx = cx + dxs
    keep = (xx > 0) & (xx < w - 1) & (yy > 0) & (yy < h - 1)
    yy, xx, dys, dxs = yy[keep], xx[keep], dys[keep], dxs[keep]
    gx = gauss_img[yy, xx + 1] - gauss_img[yy, xx - 1]
    gy = gauss_img[yy - 1, xx] - gauss_img[yy + 1, xx]
    mag = np.sqrt(gx * gx + gy * gy)
    ang = np.rad2deg(np.arctan2(gy, gx)) % 360
    # reference: dx*dx+dy*dy is a weak Python int -> f32 product -> f32 exp
    # (sift_impl.py:269); int64 *arrays* would promote to f64 and round
    # differently, so force f32 here
    wgt = np.exp(weight_fac * (dxs * dxs + dys * dys).astype(np.float32))
    idx = np.round(ang * nb / 360.0).astype(int) % nb
    raw = np.zeros(nb)
    np.add.at(raw, idx, wgt * mag)

    smooth = np.zeros(nb)
    for i in range(nb):
        smooth[i] = (
            6 * raw[i]
            + 4 * (raw[i - 1] + raw[(i + 1) % nb])
            + raw[i - 2]
            + raw[(i + 2) % nb]
        ) / 16.0
    maxv = np.max(smooth)
    peaks = np.where(
        np.logical_and(smooth > np.roll(smooth, 1), smooth > np.roll(smooth, -1))
    )[0]
    out = []
    for p in peaks:
        if smooth[p] >= cfg.peak_ratio * maxv:
            left = smooth[(p - 1) % nb]
            right = smooth[(p + 1) % nb]
            interp = (
                p + 0.5 * (left - right) / (left - 2 * smooth[p] + right)
            ) % nb
            angle = 360.0 - interp * 360.0 / nb
            if abs(angle - 360.0) < cfg.float_tolerance:
                angle = 0
            out.append(float(angle))
    return out


def recompute_keypoint_strict(
    ix: int,
    iy: int,
    jx: int,
    jy: int,
    jl: int,
    octave_packed_conv: int,
    angle_f32: float,
    pyramid: Sequence[Sequence[np.ndarray]],
    dogs: Sequence[Sequence[np.ndarray]],
    cfg: SiftConfig = SiftConfig(),
):
    """Re-derive one keypoint's (pt, size, angle, packed octave) exactly.

    ``(ix, iy)`` is the Newton loop's final position cell, ``(jx, jy,
    jl)`` its last-compute cell (equal for converged points — see
    :func:`relocalize_strict`).  Returns the *converted*
    (input-image-scale) values, or ``None`` when the strict
    re-evaluation rejects the keypoint (a keypoint that only exists
    under f32 noise).  ``angle_f32`` selects among multiple orientation
    peaks (the closest, circularly).
    """
    ocv, layer, _scale = _unpack_octave(int(octave_packed_conv))
    o_orig = ocv + 1
    if o_orig < 0 or o_orig >= len(dogs):
        return None
    res = relocalize_strict(
        ix, iy, jx, jy, jl, layer, o_orig, dogs[o_orig], cfg
    )
    if res is None:
        return None
    pt0, size0, _resp, packed0 = res
    # cv2.KeyPoint stores pt/size/angle as C floats — the reference's
    # orientation and descriptor stages see the f32-quantized values
    pt0 = (float(np.float32(pt0[0])), float(np.float32(pt0[1])))
    size0 = float(np.float32(size0))
    angles = orientations_strict(
        pt0, size0, o_orig, pyramid[o_orig][layer], cfg
    )
    if not angles:
        return None
    diff = lambda a: min(
        abs(a - float(angle_f32)), 360.0 - abs(a - float(angle_f32))
    )
    angle = float(np.float32(min(angles, key=diff)))
    packed_conv = (packed0 & ~255) | ((packed0 - 1) & 255)
    return (pt0[0] * 0.5, pt0[1] * 0.5), size0 * 0.5, angle, packed_conv


def _unpack_octave(octave_packed: int) -> Tuple[int, int, np.float32]:
    """sift_impl.py:349-358 semantics (sign-extend, f32 scale)."""
    octave = octave_packed & 255
    layer = (octave_packed >> 8) & 255
    if octave >= 128:
        octave |= -128
    if octave >= 0:
        scale = 1 / np.float32(1 << octave)
    else:
        scale = np.float32(1 << -octave)
    return octave, layer, scale


def descriptor_strict(
    pt: Tuple[float, float],
    size: float,
    angle: float,
    octave_packed: int,
    pyramid: Sequence[Sequence[np.ndarray]],
    cfg: SiftConfig = SiftConfig(),
) -> np.ndarray:
    """One keypoint's 128-d descriptor, bit-identical to the reference.

    Follows sift_impl.py:361-526 step by step with the same operand
    dtypes and the same four-scatter ``np.add.at`` order, so the f32
    per-accumulation rounding matches the oracle exactly.
    """
    window_width = cfg.window_width
    num_bins = cfg.desc_bins
    octv, layer, scl = _unpack_octave(int(octave_packed))
    img = pyramid[octv + 1][layer]
    rows, cols = img.shape
    point = np.round(scl * np.array([float(pt[0]), float(pt[1])])).astype(int)

    ref_angle = 360.0 - float(angle)
    cos_a = np.cos(np.deg2rad(ref_angle))
    sin_a = np.sin(np.deg2rad(ref_angle))

    tensor = np.zeros(
        (window_width + 2, window_width + 2, num_bins), dtype=np.float32
    )

    hist_width = cfg.scale_multiplier * 0.5 * scl * float(size)
    half_w = int(np.round(hist_width * np.sqrt(2) * (window_width + 1) * 0.5))
    half_w = min(half_w, int(np.sqrt(rows ** 2 + cols ** 2)))

    ys, xs = np.mgrid[-half_w : half_w + 1, -half_w : half_w + 1]
    ys = ys.ravel()
    xs = xs.ravel()
    rr = point[1] + ys
    cc = point[0] + xs
    keep = (rr > 0) & (rr < rows - 1) & (cc > 0) & (cc < cols - 1)
    if not np.any(keep):
        return np.zeros(128, dtype=np.float32)
    rr, cc, ys, xs = rr[keep], cc[keep], ys[keep], xs[keep]

    gx = img[rr, cc + 1] - img[rr, cc - 1]
    gy = img[rr - 1, cc] - img[rr + 1, cc]
    mag = np.sqrt(gx * gx + gy * gy)
    orient = np.rad2deg(np.arctan2(gy, gx)) % 360

    r_rot = xs * sin_a + ys * cos_a
    c_rot = xs * cos_a - ys * sin_a
    r_bin = (r_rot / hist_width) + 0.5 * window_width - 0.5
    c_bin = (c_rot / hist_width) + 0.5 * window_width - 0.5
    keep2 = (
        (r_bin > -1.0)
        & (r_bin < window_width)
        & (c_bin > -1.0)
        & (c_bin < window_width)
    )
    if not np.any(keep2):
        return np.zeros(128, dtype=np.float32)
    r_bin, c_bin = r_bin[keep2], c_bin[keep2]
    mag, orient = mag[keep2], orient[keep2]
    r_rot, c_rot = r_rot[keep2], c_rot[keep2]

    weight_mul = -0.5 / ((0.5 * window_width) ** 2)
    w = np.exp(
        weight_mul * ((r_rot / hist_width) ** 2 + (c_rot / hist_width) ** 2)
    )
    weighted_mag = w * mag

    ob = (orient - ref_angle) * (num_bins / 360.0)
    ob = np.mod(ob, num_bins)

    r0 = np.floor(r_bin).astype(int)
    c0 = np.floor(c_bin).astype(int)
    o0 = np.floor(ob).astype(int) % num_bins
    rf = r_bin - r0
    cf = c_bin - c0
    of = ob - o0

    c1 = weighted_mag * rf
    c0w = weighted_mag - c1
    c10 = c1 * (1 - cf)
    c11 = c1 * cf
    c00 = c0w * (1 - cf)
    c01 = c0w * cf

    def scatter(magnitude, frac, r_ind, c_ind):
        np.add.at(tensor, (r_ind + 1, c_ind + 1, o0 % num_bins),
                  magnitude * (1 - frac))
        np.add.at(tensor, (r_ind + 1, c_ind + 1, (o0 + 1) % num_bins),
                  magnitude * frac)

    # same scatter order as the reference (sift_impl.py:508-511)
    scatter(c00, of, r0, c0)
    scatter(c01, of, r0, c0 + 1)
    scatter(c10, of, r0 + 1, c0)
    scatter(c11, of, r0 + 1, c0 + 1)

    vec = tensor[1:-1, 1:-1, :].ravel()
    thr = np.linalg.norm(vec) * cfg.descriptor_max_value
    vec[vec > thr] = thr
    norm_v = np.linalg.norm(vec)
    if norm_v < cfg.float_tolerance:
        norm_v = cfg.float_tolerance
    vec /= norm_v
    vec = np.round(512 * vec)
    vec[vec < 0] = 0
    vec[vec > 255] = 255
    return vec.astype("float32")


def reference_vote(
    moves: np.ndarray, thresh_sq: float = 3.0
) -> Tuple[int, int]:
    """First-strict-max exhaustive vote (image_stitching_sift.py:86-111).

    ``moves`` is the (M, 2) f64 array of matched (dx, dy) hypotheses in
    match-list order.  Returns (winner_index, votes); M == 0 -> (-1, 0).
    """
    m = moves.astype(np.float64)
    if m.shape[0] == 0:
        return -1, 0
    diff = m[:, None, :] - m[None, :, :]
    d2 = (diff * diff).sum(-1)
    votes = (d2 < thresh_sq).sum(1)
    best = int(np.argmax(votes))  # first max, matching the strict > scan
    return best, int(votes[best])


def _image_key(img: np.ndarray) -> bytes:
    """Content hash of an image for the strict-resolution caches."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(img).tobytes())
    h.update(str(img.shape).encode())
    return h.digest()


# content-addressed caches: warm benchmark/pipeline re-runs over the same
# images skip the host pyramid build and every strict re-decision.
# A full pyramid is ~46 MB of host RAM; the bound must exceed the number
# of distinct images the escalated pairs of one dataset touch (parrington
# touches 10 — an 8-entry cache thrashed and rebuilt 14 pyramids per warm
# run, ~240 ms, caught by a host trace).
_PYR_CACHE: "dict[bytes, tuple]" = {}
_DESC_CACHE: "dict[tuple, object]" = {}
_PYR_CACHE_MAX = 16
_DESC_CACHE_MAX = 65536
_STRICT_LOCK = __import__("threading").Lock()
_PYR_PENDING: "dict[bytes, object]" = {}


def _pyramid_for(img: np.ndarray, cfg: SiftConfig):
    """Content-cached host pyramid, safe under concurrent escalation.

    The escalation loop runs pairs in a small thread pool and adjacent
    pairs share an image, so same-key builds are deduplicated with a
    per-key pending event (the ~50 ms pyramid build runs OUTSIDE the
    lock; distinct images build in parallel).
    """
    import threading

    key = _image_key(img)
    while True:
        with _STRICT_LOCK:
            hit = _PYR_CACHE.get(key)
            if hit is not None:
                return key, hit
            ev = _PYR_PENDING.get(key)
            if ev is None:
                ev = threading.Event()
                _PYR_PENDING[key] = ev
                mine = True
            else:
                mine = False
        if mine:
            try:
                pyr = host_gaussian_pyramid(img, cfg)
                hit = (pyr, host_dog_octaves(pyr))
                with _STRICT_LOCK:
                    while len(_PYR_CACHE) >= _PYR_CACHE_MAX:
                        _PYR_CACHE.pop(next(iter(_PYR_CACHE)))
                    _PYR_CACHE[key] = hit
            finally:
                with _STRICT_LOCK:
                    _PYR_PENDING.pop(key, None)
                ev.set()
            return key, hit
        ev.wait()
        # retry: the entry may already have been evicted again


def _strict_desc_cached(img: np.ndarray, meta: Dict[str, np.ndarray],
                        k: int, cfg: SiftConfig):
    """Oracle-exact descriptor for keypoint ``k`` of ``img`` (cached), or
    ``None`` when the keypoint only exists under f32 noise."""
    img_key, (pyr, dogs) = _pyramid_for(img, cfg)
    key = (
        img_key, int(meta["ix"][k]), int(meta["iy"][k]),
        int(meta["jx"][k]), int(meta["jy"][k]), int(meta["jl"][k]),
        int(meta["octave"][k]), float(np.float32(meta["angle"][k])),
    )
    with _STRICT_LOCK:
        if key in _DESC_CACHE:
            return _DESC_CACHE[key]
    kp = recompute_keypoint_strict(
        key[1], key[2], key[3], key[4], key[5], key[6], key[7], pyr, dogs,
        cfg,
    )
    if kp is None:
        out = None
    else:
        (px, py), size, angle, packed = kp
        out = descriptor_strict(
            (px, py), size, angle, packed, pyr, cfg
        ).astype(np.float64)
    with _STRICT_LOCK:
        if len(_DESC_CACHE) >= _DESC_CACHE_MAX:
            _DESC_CACHE.clear()
        _DESC_CACHE[key] = out
    return out


def _first_max_winner(moves: np.ndarray, matched: np.ndarray,
                      thresh_sq: float) -> int:
    """Winner row index (into the full K rows) under reference voting."""
    idx = np.nonzero(matched)[0]
    if idx.size == 0:
        return -1
    win, _ = reference_vote(moves[idx], thresh_sq)
    return int(idx[win])


def _material_rows(moves: np.ndarray, matched: np.ndarray,
                   border_flip: np.ndarray, border_swap: np.ndarray,
                   alt_moves: np.ndarray, alt_valid: np.ndarray,
                   thresh_sq: float) -> np.ndarray:
    """Unresolved borderline rows still material in the CURRENT state.

    Host replay of estimate/ransac.translation_ransac_material — the
    same exact scenario space: per borderline row, (a) the flip scenario
    toggles the row's matched bit at its current move; (b) per valid
    alternative candidate (``alt_moves[r, c]`` where ``alt_valid[r, c]``)
    the swap scenario re-lands the row matched at the alternative move.
    A row is material when any of its scenarios changes the first-max
    winner row, changes ``any_match``, or makes the row itself win a
    swap scenario (the seed pair changes even on a vote tie).  Restricted
    to the matched+borderline subset for the fixed-point rounds of
    :func:`escalate_pair`; scenario counts reuse the base adjacency the
    same way the device analysis does (O(M) per scenario, not a
    from-scratch re-vote — this runs on the warm path per pipeline run).
    tests/test_strict.py fuzzes it against a from-scratch oracle.
    """
    candidates = border_flip | border_swap
    rows = np.nonzero(matched | candidates)[0]
    out = np.zeros_like(candidates)
    if rows.size == 0:
        return out
    sub = moves[rows]
    m_sub = matched[rows]
    diff = sub[:, None, :] - sub[None, :, :]
    d2 = (diff * diff).sum(-1)
    adj = d2 < thresh_sq
    votes = (adj & m_sub[None, :]).sum(1)
    any_now = bool(m_sub.any())
    best = int(np.argmax(np.where(m_sub, votes, -1))) if any_now else -1
    k = rows.size
    cand_j = np.nonzero(candidates[rows])[0]        # subset indices
    nj = cand_j.size

    # flip scenarios, vectorized over the candidate rows
    sign = np.where(m_sub[cand_j], -1, 1)
    counts = votes[None, :] + sign[:, None] * adj[cand_j].astype(np.int64)
    cand_m = np.broadcast_to(m_sub, (nj, k)).copy()
    cand_m[np.arange(nj), cand_j] = ~m_sub[cand_j]
    scen_any = cand_m.any(1)
    winner_j = np.argmax(np.where(cand_m, counts, -1), axis=1)
    flip_changes = (scen_any != any_now) | (
        scen_any & any_now & (winner_j != best)
    )
    out[rows[cand_j]] = flip_changes

    # swap scenarios (exact, per valid alternative; device formulas)
    for j in cand_j[border_swap[rows[cand_j]] & ~flip_changes]:
        j = int(j)
        r = int(rows[j])
        for c in np.nonzero(alt_valid[r])[0]:
            alt = alt_moves[r, int(c)]
            ad = sub - alt[None, :]
            alt_adj = (ad * ad).sum(-1) < thresh_sq
            dep = (adj[j] & m_sub[j]).astype(np.int64)
            cnt = votes - dep + alt_adj.astype(np.int64)
            cnt[j] = (
                int((alt_adj & m_sub).sum())
                - int(bool(alt_adj[j]) and bool(m_sub[j])) + 1
            )
            cand_s = m_sub.copy()
            cand_s[j] = True
            wj = int(np.argmax(np.where(cand_s, cnt, -1)))
            if wj != best or wj == j or not any_now:
                out[r] = True
                break
    return out


def escalate_pair(
    cyl_a: np.ndarray,
    cyl_b: np.ndarray,
    xy_a: np.ndarray,
    meta_a: Dict[str, np.ndarray],
    xy_b: np.ndarray,
    meta_b: Dict[str, np.ndarray],
    valid_a: np.ndarray,
    best_b: np.ndarray,
    cand_idx: np.ndarray,
    cand_inm: np.ndarray,
    matched: np.ndarray,
    border_flip: np.ndarray,
    border_swap: np.ndarray,
    material: np.ndarray,
    cfg: SiftConfig = SiftConfig(),
    desc_thresh: float = 25000.0,
    ransac_thresh: float = 3.0,
) -> Tuple[Tuple[float, float], Tuple[tuple, tuple], bool]:
    """Re-decide one image pair's shift with strict host arithmetic.

    Per material row the strict pass re-decides BOTH knife-edge classes:
    a ``border_swap`` row's argmin is re-ranked over every device
    candidate flagged in-margin (``cand_idx`` rows of the top-4 where
    ``cand_inm`` — the device-computed "within the borderline margin of
    the row's best" mask; the margin itself is applied ON DEVICE when
    that mask is built, so widening it requires re-running the device
    step) — only those can strictly win, since a single distance is off
    by at most margin/2.
    The strict winner follows the reference's strict-< scan (first
    minimal B index, image_stitching_sift.py:62-79); the threshold test
    then runs on the strict winner distance.

    Iterates to a fixed point: strict-resolve the rows the device marked
    material, re-vote, recompute materiality over the still-unresolved
    borderline rows in the new state (same scenario semantics as the
    device-side analysis, _material_rows), and repeat.  Individually
    immaterial borderline rows that become material after a change are
    therefore caught; joint multi-row interactions below that are not
    (second-order, never observed).

    Returns ``(shift, (pair_a, pair_b), any_match)``, or ``None`` when
    every strict resolution confirmed the fast path's decisions — the
    caller keeps the device result untouched in that case.
    """
    orig_matched = matched
    orig_best = best_b
    matched = matched.copy()
    best_b = best_b.copy()
    resolved = np.zeros_like(border_flip)
    moves = xy_a.astype(np.float64) - xy_b[best_b].astype(np.float64)
    # alternative hypothesis moves for the swap scenarios of the host
    # materiality replay — same candidate set the device analysis used
    # (non-best candidates within margin of the row's best)
    alt_valid = cand_inm[:, 1:].astype(bool)
    alt_moves = xy_a[:, None, :].astype(np.float64) - xy_b[
        cand_idx[:, 1:]
    ].astype(np.float64)

    to_resolve = material & valid_a & ~resolved
    for _ in range(8):  # fixed-point iteration bound
        if not to_resolve.any():
            break
        for r in np.nonzero(to_resolve)[0]:
            r = int(r)
            resolved[r] = True
            da = _strict_desc_cached(cyl_a, meta_a, r, cfg)
            if da is None:
                matched[r] = False   # endpoint doesn't survive strictly
                continue
            if border_swap[r]:
                cands = [
                    int(b) for b, m in zip(cand_idx[r], cand_inm[r]) if m
                ]
            else:
                cands = [int(best_b[r])]
            b1, d1 = -1, np.inf
            for b in sorted(set(cands)):
                db = _strict_desc_cached(cyl_b, meta_b, b, cfg)
                if db is None:
                    continue
                d = float(((da - db) ** 2).sum())
                # ascending b + strict < keeps the first minimal index,
                # matching the reference's argmin scan
                if d < d1:
                    b1, d1 = b, d
            if b1 < 0:
                matched[r] = False
                continue
            best_b[r] = b1
            moves[r] = xy_a[r].astype(np.float64) - xy_b[b1].astype(
                np.float64
            )
            matched[r] = bool(valid_a[r]) and d1 < desc_thresh
        if not ((matched != orig_matched).any()
                or (matched & (best_b != orig_best)).any()):
            # every material decision CONFIRMED the fast path: keep the
            # device vote untouched (a host re-vote would re-decide
            # near-threshold vote distances from f32-cast moves and could
            # churn a result that was already correct)
            return None
        unresolved = valid_a & ~resolved
        to_resolve = _material_rows(
            moves, matched, border_flip & unresolved,
            border_swap & unresolved, alt_moves, alt_valid, ransac_thresh,
        )

    win_row = _first_max_winner(moves, matched, ransac_thresh)
    if win_row < 0:
        return (0.0, 0.0), None, False
    pa = (float(xy_a[win_row, 0]), float(xy_a[win_row, 1]))
    pb = (float(xy_b[best_b[win_row], 0]), float(xy_b[best_b[win_row], 1]))
    return (pa[0] - pb[0], pa[1] - pb[1]), (pa, pb), True
