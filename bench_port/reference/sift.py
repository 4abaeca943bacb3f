"""Lowe's SIFT as the reference's ``sift_impl.py`` computes it, in NumPy
and cv2, image by image.

1. gray (:mod:`.gray`) as float32, 2x ``INTER_LINEAR`` upsample, blurred to
   ``sigma`` (``assumed_blur`` already in the image);
2. ``round(log2(min(h, w)) - 1)`` octaves of ``num_intervals + 3``
   incrementally blurred images (``cv2.GaussianBlur``), each next octave
   seeded by ``INTER_NEAREST`` halving of the third image from the top;
   differences of neighbours;
3. extrema: an interior pixel (``image_border_width`` from the edge) of
   a middle layer whose magnitude passes ``floor(0.5 * contrast /
   intervals * 255)`` and that is the maximum (positive) or minimum
   (negative) of its 3x3x3 neighbourhood, ties allowed; visited by
   octave, layer, row, column;
4. at most five Newton steps on the 3x3x3 cube (``/255``): stop when
   every update component is under 0.5, else move by the rounded update
   and reject a move out of the border or the layer range; a point still
   moving after the fifth step keeps its last move and last update; then
   the contrast test ``|D| * intervals >= contrast`` and the edge test on
   the 2x2 spatial Hessian;
5. orientations: a 36-bin histogram of Gaussian-weighted gradient
   magnitudes over a window of radius ``round(3 * 1.5 * size / 2^(o+1))``
   at the keypoint's layer, smoothed [1, 4, 6, 4, 1] / 16, one keypoint
   per local peak at 0.8 of the maximum or more, the peak interpolated by
   a parabola, angle ``360 - bin * 10``;
6. keypoints (float32, as ``cv2.KeyPoint`` stores them) sorted by x, y,
   size descending, angle, response descending (stable), a keypoint equal
   to its predecessor in (x, y, size, angle) dropped, coordinates and
   size halved to the input image;
7. descriptors: 4x4 cells of 8 orientation bins, trilinearly spread
   Gaussian-weighted gradient magnitudes over the rotated window, clipped
   at 0.2 of the norm, normalized, ``round(512 v)`` in 0..255.

Scalars follow NumPy's own promotion rules for float32 (a Python number
takes the array's or the NumPy scalar's type), spelt out so that every
NumPy version computes the same bits.  ``lowp`` is the control: the base
image stored in bfloat16.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np

from bench_port.reference.gray import gray_u8
from bench_port.reference.lowp import store

DEFAULTS = dict(sigma=1.6, num_intervals=3, assumed_blur=0.5,
                image_border_width=5, contrast_threshold=0.04,
                eigen_ratio=10.0, max_localize_iters=5, radius_factor=3.0,
                num_bins=36, peak_ratio=0.8, scale_factor=1.5, window_width=4,
                desc_bins=8, scale_multiplier=3.0, descriptor_max_value=0.2,
                float_tolerance=1e-7)

F32 = np.float32


def pyramid(gray: np.ndarray, prm: dict, lowp: bool = False) -> List[List[np.ndarray]]:
    """Per octave, the ``num_intervals + 3`` blurred float32 images."""
    import cv2

    up = cv2.resize(gray, (0, 0), fx=2, fy=2, interpolation=cv2.INTER_LINEAR)
    sigma = prm["sigma"]
    sigma_diff = np.sqrt(max(sigma ** 2 - (2 * prm["assumed_blur"]) ** 2, 0.01))
    image = cv2.GaussianBlur(up, (0, 0), sigmaX=sigma_diff, sigmaY=sigma_diff)
    image = store(image, lowp)
    n_octaves = int(np.round(np.log(min(image.shape)) / np.log(2) - 1))
    n_per = prm["num_intervals"] + 3
    k = 2 ** (1.0 / prm["num_intervals"])
    kernels = np.zeros(n_per)
    kernels[0] = sigma
    for i in range(1, n_per):
        s_prev = (k ** (i - 1)) * sigma
        kernels[i] = np.sqrt((k * s_prev) ** 2 - s_prev ** 2)
    out = []
    for _ in range(n_octaves):
        octave = [image]
        for g in kernels[1:]:
            image = cv2.GaussianBlur(image, (0, 0), sigmaX=g, sigmaY=g)
            octave.append(image)
        out.append(octave)
        seed = octave[-3]
        image = cv2.resize(seed, (seed.shape[1] // 2, seed.shape[0] // 2),
                           interpolation=cv2.INTER_NEAREST)
    return out


def extrema(dog: np.ndarray, border: int, threshold: float):
    """``(layer, y, x)`` of the extrema of a (L, H, W) DoG stack's middle
    layers, in (layer, y, x) order."""
    n, h, w = dog.shape
    if h <= 2 * border or w <= 2 * border:
        e = np.zeros(0, np.int64)
        return e, e, e
    shifts = [dog[1 + dl:n - 1 + dl, 1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]
              for dl in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    hi = functools.reduce(np.maximum, shifts)
    lo = functools.reduce(np.minimum, shifts)
    c = dog[1:n - 1, 1:h - 1, 1:w - 1]
    mask = ((c > threshold) & (c == hi)) | ((c < -threshold) & (c == lo))
    inner = np.zeros((h - 2, w - 2), bool)
    inner[border - 1:h - border - 1, border - 1:w - border - 1] = True
    layer, y, x = np.nonzero(mask & inner)
    return layer + 1, y + 1, x + 1


def _derivatives(cube: np.ndarray):
    """Gradient (K, 3) and Hessian (K, 3, 3), float32, of (K, 3, 3, 3)
    cubes indexed (layer, y, x)."""
    def c(dl, dy, dx):
        return cube[:, 1 + dl, 1 + dy, 1 + dx]

    v = c(0, 0, 0)
    grad = np.stack([F32(0.5) * (c(0, 0, 1) - c(0, 0, -1)),
                     F32(0.5) * (c(0, 1, 0) - c(0, -1, 0)),
                     F32(0.5) * (c(1, 0, 0) - c(-1, 0, 0))], axis=-1)
    dxx = c(0, 0, 1) - F32(2) * v + c(0, 0, -1)
    dyy = c(0, 1, 0) - F32(2) * v + c(0, -1, 0)
    dss = c(1, 0, 0) - F32(2) * v + c(-1, 0, 0)
    dxy = F32(0.25) * (c(0, 1, 1) - c(0, 1, -1) - c(0, -1, 1) + c(0, -1, -1))
    dxs = F32(0.25) * (c(1, 0, 1) - c(1, 0, -1) - c(-1, 0, 1) + c(-1, 0, -1))
    dys = F32(0.25) * (c(1, 1, 0) - c(1, -1, 0) - c(-1, 1, 0) + c(-1, -1, 0))
    hess = np.stack([np.stack([dxx, dxy, dxs], -1), np.stack([dxy, dyy, dys], -1),
                     np.stack([dxs, dys, dss], -1)], axis=-2)
    return grad, hess


def _solve(hess: np.ndarray, grad: np.ndarray) -> np.ndarray:
    """``lstsq(H, g)`` of each row in float64, rounded to float32."""
    out = np.zeros(grad.shape, np.float64)
    for i in range(len(grad)):
        out[i] = np.linalg.lstsq(hess[i].astype(np.float64),
                                 grad[i].astype(np.float64), rcond=None)[0]
    return out.astype(F32)


def localize(dog: np.ndarray, layer, y, x, octave: int, prm: dict):
    """Newton localization of an octave's extrema: the accepted ones'
    ``(pt (K, 2), size, response, packed octave, layer)``, float32 where
    ``cv2.KeyPoint`` stores floats, at the base image's scale."""
    n, h, w = dog.shape
    border, intervals = prm["image_border_width"], prm["num_intervals"]
    k = len(layer)
    l, i, j = (a.astype(np.int64).copy() for a in (layer, y, x))
    done = np.zeros(k, bool)
    out = np.zeros(k, bool)
    grad = np.zeros((k, 3), F32)
    hess = np.zeros((k, 3, 3), F32)
    upd = np.zeros((k, 3), F32)
    center = np.zeros(k, F32)
    off = np.arange(-1, 2)
    for _ in range(prm["max_localize_iters"]):
        act = np.nonzero(~done & ~out)[0]
        if act.size == 0:
            break
        cube = dog[(l[act][:, None, None, None] + off[None, :, None, None]),
                   (i[act][:, None, None, None] + off[None, None, :, None]),
                   (j[act][:, None, None, None] + off[None, None, None, :])]
        cube = cube.astype(F32) / F32(255.0)
        g, hs = _derivatives(cube)
        u = -_solve(hs, g)
        grad[act], hess[act], upd[act], center[act] = g, hs, u, cube[:, 1, 1, 1]
        conv = np.all(np.abs(u) < F32(0.5), axis=-1)
        done[act[conv]] = True
        mv = act[~conv]
        step = np.round(u[~conv]).astype(np.int64)
        j[mv] += step[:, 0]
        i[mv] += step[:, 1]
        l[mv] += step[:, 2]
        oob = ((i[mv] < border) | (i[mv] >= h - border) | (j[mv] < border)
               | (j[mv] >= w - border) | (l[mv] < 1) | (l[mv] > intervals))
        out[mv[oob]] = True
    keep = np.nonzero(~out)[0]
    g, hs, u, v = grad[keep], hess[keep], upd[keep], center[keep]
    val = v + F32(0.5) * np.einsum("kd,kd->k", g, u).astype(F32)
    contrast_ok = np.abs(val) * F32(intervals) >= F32(prm["contrast_threshold"])
    h2 = hs[:, :2, :2]
    tr = h2[:, 0, 0] + h2[:, 1, 1]
    det = np.linalg.det(h2.astype(np.float64)).astype(F32)
    er = F32(prm["eigen_ratio"])
    edge_ok = (det > 0) & (er * (tr * tr) < F32((prm["eigen_ratio"] + 1) ** 2) * det)
    ok = contrast_ok & edge_ok
    keep, u, val = keep[ok], u[ok], val[ok]
    scale = F32(2 ** octave)
    pt = np.stack([(j[keep].astype(F32) + u[:, 0]) * scale,
                   (i[keep].astype(F32) + u[:, 1]) * scale], axis=-1)
    lk = l[keep]
    packed = (octave + lk * 256
              + np.round((u[:, 2] + F32(0.5)) * F32(255)).astype(np.int64) * 65536)
    size = (F32(prm["sigma"])
            * np.power(F32(2), (lk.astype(F32) + u[:, 2]) / F32(intervals))
            * F32(2 ** (octave + 1)))
    return pt.astype(F32), size.astype(F32), np.abs(val).astype(F32), packed, lk


def orientations(pt, size, octave: int, img: np.ndarray, prm: dict) -> List[float]:
    """The keypoint's orientation peaks (degrees, float32 values)."""
    nb = prm["num_bins"]
    scale = F32(prm["scale_factor"] * float(size)) / F32(2 ** (octave + 1))
    radius = int(np.round(F32(prm["radius_factor"]) * scale))
    weight_fac = F32(-0.5) / (scale * scale)
    cy = int(np.round(F32(pt[1]) / F32(2 ** octave)))
    cx = int(np.round(F32(pt[0]) / F32(2 ** octave)))
    h, w = img.shape
    dys, dxs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    dys, dxs = dys.ravel(), dxs.ravel()
    yy, xx = cy + dys, cx + dxs
    keep = (xx > 0) & (xx < w - 1) & (yy > 0) & (yy < h - 1)
    yy, xx, dys, dxs = yy[keep], xx[keep], dys[keep], dxs[keep]
    gx = img[yy, xx + 1] - img[yy, xx - 1]
    gy = img[yy - 1, xx] - img[yy + 1, xx]
    mag = np.sqrt(gx * gx + gy * gy)
    ang = np.rad2deg(np.arctan2(gy, gx)) % F32(360)
    wgt = np.exp(weight_fac * (dxs * dxs + dys * dys).astype(F32))
    idx = np.round(ang * F32(nb) / F32(360.0)).astype(np.int64) % nb
    raw = np.zeros(nb)
    np.add.at(raw, idx, wgt * mag)
    smooth = np.array([(6 * raw[b] + 4 * (raw[b - 1] + raw[(b + 1) % nb])
                        + raw[b - 2] + raw[(b + 2) % nb]) / 16.0
                       for b in range(nb)])
    peak = np.max(smooth)
    out = []
    for p in np.nonzero((smooth > np.roll(smooth, 1)) & (smooth > np.roll(smooth, -1)))[0]:
        if smooth[p] >= prm["peak_ratio"] * peak:
            left, right = smooth[(p - 1) % nb], smooth[(p + 1) % nb]
            interp = (p + 0.5 * (left - right) / (left - 2 * smooth[p] + right)) % nb
            angle = 360.0 - interp * 360.0 / nb
            if abs(angle - 360.0) < prm["float_tolerance"]:
                angle = 0.0
            out.append(float(F32(angle)))
    return out


def _unpack(packed: int):
    octave = packed & 255
    layer = (packed >> 8) & 255
    if octave >= 128:
        octave |= -128
    scale = F32(1) / F32(1 << octave) if octave >= 0 else F32(1 << -octave)
    return octave, layer, scale


def descriptor(pt, size, angle, packed: int, pyr, prm: dict) -> np.ndarray:
    """One keypoint's 128 float32 values (integers 0..255)."""
    ww, nb = prm["window_width"], prm["desc_bins"]
    octave, layer, scl = _unpack(int(packed))
    img = pyr[octave + 1][layer]
    rows, cols = img.shape
    point = np.round(scl * np.array([float(pt[0]), float(pt[1])])).astype(np.int64)
    ref_angle = 360.0 - float(angle)
    cos_a = np.cos(np.deg2rad(ref_angle))
    sin_a = np.sin(np.deg2rad(ref_angle))
    tensor = np.zeros((ww + 2, ww + 2, nb), F32)
    hist_width = (F32(prm["scale_multiplier"] * 0.5) * scl) * F32(size)
    half_w = int(np.round(np.float64(hist_width) * np.sqrt(2) * (ww + 1) * 0.5))
    half_w = min(half_w, int(np.sqrt(rows ** 2 + cols ** 2)))
    ys, xs = np.mgrid[-half_w:half_w + 1, -half_w:half_w + 1]
    ys, xs = ys.ravel(), xs.ravel()
    rr, cc = point[1] + ys, point[0] + xs
    keep = (rr > 0) & (rr < rows - 1) & (cc > 0) & (cc < cols - 1)
    if not np.any(keep):
        return np.zeros(128, F32)
    rr, cc, ys, xs = rr[keep], cc[keep], ys[keep], xs[keep]
    gx = img[rr, cc + 1] - img[rr, cc - 1]
    gy = img[rr - 1, cc] - img[rr + 1, cc]
    mag = np.sqrt(gx * gx + gy * gy)
    orient = np.rad2deg(np.arctan2(gy, gx)) % F32(360)
    r_rot = xs * sin_a + ys * cos_a
    c_rot = xs * cos_a - ys * sin_a
    hw = np.float64(hist_width)
    r_bin = (r_rot / hw) + 0.5 * ww - 0.5
    c_bin = (c_rot / hw) + 0.5 * ww - 0.5
    keep = (r_bin > -1.0) & (r_bin < ww) & (c_bin > -1.0) & (c_bin < ww)
    if not np.any(keep):
        return np.zeros(128, F32)
    r_bin, c_bin, mag, orient = r_bin[keep], c_bin[keep], mag[keep], orient[keep]
    r_rot, c_rot = r_rot[keep], c_rot[keep]
    weight = np.exp(-0.5 / ((0.5 * ww) ** 2) * ((r_rot / hw) ** 2 + (c_rot / hw) ** 2))
    wmag = weight * mag
    ob = np.mod((orient - F32(ref_angle)) * F32(nb / 360.0), F32(nb))
    r0 = np.floor(r_bin).astype(np.int64)
    c0 = np.floor(c_bin).astype(np.int64)
    o0 = np.floor(ob).astype(np.int64) % nb
    rf, cf, of = r_bin - r0, c_bin - c0, ob - o0
    c1 = wmag * rf
    c0w = wmag - c1
    # the reference's scatter order: four corners, each into two bins
    for mag_c, r_i, c_i in ((c0w * (1 - cf), r0, c0), (c0w * cf, r0, c0 + 1),
                            (c1 * (1 - cf), r0 + 1, c0), (c1 * cf, r0 + 1, c0 + 1)):
        np.add.at(tensor, (r_i + 1, c_i + 1, o0 % nb), mag_c * (1 - of))
        np.add.at(tensor, (r_i + 1, c_i + 1, (o0 + 1) % nb), mag_c * of)
    vec = tensor[1:-1, 1:-1, :].ravel()
    thr = np.linalg.norm(vec) * F32(prm["descriptor_max_value"])
    vec[vec > thr] = thr
    norm = np.linalg.norm(vec)
    if norm < prm["float_tolerance"]:
        norm = F32(prm["float_tolerance"])
    vec /= norm
    vec = np.round(F32(512) * vec)
    return np.clip(vec, 0, 255).astype(F32)


def features(bgr: np.ndarray, prm: dict, lowp: bool = False):
    """``(xy, descriptors)`` of one BGR uint8 image: (K, 2) float32 (x, y)
    at the input's scale and (K, 128) float32, in the reference's order."""
    gray = gray_u8(bgr).astype(F32)
    pyr = pyramid(gray, prm, lowp)
    thresh = float(np.floor(0.5 * prm["contrast_threshold"] / prm["num_intervals"] * 255))
    kps = []          # (x, y, size, angle, response, packed), emission order
    for o, octave in enumerate(pyr):
        dog = np.stack([b - a for a, b in zip(octave, octave[1:])])
        layer, y, x = extrema(dog, prm["image_border_width"], thresh)
        if layer.size == 0:
            continue
        pts, sizes, resp, packed, lk = localize(dog, layer, y, x, o, prm)
        for p, s, r, pk, lay in zip(pts, sizes, resp, packed, lk):
            for a in orientations(p, s, o, octave[int(lay)], prm):
                kps.append((float(p[0]), float(p[1]), float(s), a, float(r), int(pk)))
    kps.sort(key=lambda k: (k[0], k[1], -k[2], k[3], -k[4]))
    unique = []
    for k in kps:
        if not unique or k[:4] != unique[-1][:4]:
            unique.append(k)
    xy = np.zeros((len(unique), 2), F32)
    desc = np.zeros((len(unique), 128), F32)
    for n, (x, y, s, a, _r, pk) in enumerate(unique):
        xy[n] = (F32(x) * F32(0.5), F32(y) * F32(0.5))
        conv = (pk & ~255) | ((pk - 1) & 255)
        desc[n] = descriptor(xy[n], F32(s) * F32(0.5), a, conv, pyr, prm)
    return xy, desc
