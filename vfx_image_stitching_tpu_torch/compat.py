"""Reference-named compatibility API (drop-in function surface).

Every public function of ``image_stitching_harris.py`` /
``image_stitching_sift.py`` under its original name and signature, backed
by the port's pipeline, with NumPy in / NumPy out:

    from vfx_image_stitching_tpu_torch.compat import (
        read_pano_data, cylindrical_projection, pad_image,
        compute_shift_harris, compute_shift_sift, simple_match, ransac,
        blend_two_images, rectangle_crop,
        compute_keypoints_and_descriptors_harris,
    )

The functions that compute on a device take one keyword-only argument
more, ``device``: the card (``"cuda"``) unless the caller asks for the
CPU.  (The SIFT module surface lives in
``vfx_image_stitching_tpu_torch.models.sift`` under the ``sift_impl``
names.)
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vfx_image_stitching_tpu_torch.io import read_pano_data  # noqa: F401  (re-export)
from vfx_image_stitching_tpu_torch.compose.crop import rectangle_crop  # noqa: F401
from vfx_image_stitching_tpu_torch.compose.blend import _blend_pair
from vfx_image_stitching_tpu_torch.config import HarrisConfig
from vfx_image_stitching_tpu_torch.estimate.ransac import translation_ransac
from vfx_image_stitching_tpu_torch.geometry.canvas import place_on_canvas
from vfx_image_stitching_tpu_torch.geometry.cylindrical import (
    cylindrical_project,
)
from vfx_image_stitching_tpu_torch.match.nn import match_descriptors
from vfx_image_stitching_tpu_torch.models.harris import (
    harris_corners,
    harris_descriptors_from_fields,
    harris_keypoints_and_descriptors,
)
from vfx_image_stitching_tpu_torch.ops.gradients import (
    calc_orientation as _calc_orientation_device,
    conv2d_edge,
)
from vfx_image_stitching_tpu_torch.pipeline.stitch import resolve_device


def _dev(x, device, dtype=None) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype).to(
        resolve_device(device))


def conv2d(img: np.ndarray, kernel: np.ndarray, *, device="cuda") -> np.ndarray:
    """Edge-padded 2-D convolution (image_stitching_harris.py:49-61),
    returned as float64."""
    out = conv2d_edge(_dev(img, device), np.asarray(kernel))
    return out.cpu().numpy().astype(np.float64)


def calc_orientation(Ix: np.ndarray, Iy: np.ndarray, *, device="cuda"):
    """Gradient magnitude + angle in [0, 360)
    (image_stitching_harris.py:63-70)."""
    m, theta = _calc_orientation_device(_dev(Ix, device), _dev(Iy, device))
    return m.cpu().numpy(), theta.cpu().numpy()


def HarrisCorner(
    img_bgr: np.ndarray,
    max_points: int = 200,
    k: float = 0.05,
    block_size: int = 21,
    gauss_sigma: float = 2.0,
    thresh_ratio: float = 0.02,
    *,
    device="cuda",
):
    """Reference-signature Harris detector (image_stitching_harris.py:135-185).

    Returns ``(corner_candidates, Ix, Iy)`` with candidates as a
    response-descending list of ``(y, x, R)`` tuples, exactly as the
    reference's Python-loop implementation produces them.
    """
    cfg = HarrisConfig(
        max_points=int(max_points), k=float(k), block_size=int(block_size),
        gauss_sigma=float(gauss_sigma), thresh_ratio=float(thresh_ratio),
    )
    yy, xx, resp, valid, (ix, iy) = harris_corners(_dev(img_bgr, device), cfg)
    yy, xx, resp, valid = (t.cpu().numpy() for t in (yy, xx, resp, valid))
    cands = [
        (int(y), int(x), float(r))
        for y, x, r, v in zip(yy, xx, resp, valid) if v
    ]
    return (cands, ix.cpu().numpy().astype(np.float64),
            iy.cpu().numpy().astype(np.float64))


def gen_descriptor(
    fpx: int, fpy: int, m: np.ndarray, theta: np.ndarray, *, device="cuda"
) -> np.ndarray:
    """128-d descriptor for one keypoint at row ``fpx``, col ``fpy`` over
    precomputed magnitude/angle fields (image_stitching_harris.py:72-133)."""
    desc = harris_descriptors_from_fields(
        _dev([int(fpx)], device, torch.int32),
        _dev([int(fpy)], device, torch.int32),
        _dev(m, device, torch.float32),
        _dev(theta, device, torch.float32),
    )
    return desc[0].cpu().numpy().astype(np.float32)


def cylindrical_projection(
    img_bgr: np.ndarray, focal_len: float, *, device="cuda"
) -> np.ndarray:
    """Forward-rounded cylindrical projection (image_stitching_harris.py:290)."""
    return cylindrical_project(_dev(img_bgr, device),
                               float(focal_len)).cpu().numpy()


def pad_image(img_bgr: np.ndarray, move_x: float, move_y: float) -> np.ndarray:
    """Translate-by-zero-pad (image_stitching_harris.py:311-325)."""
    mx = int(np.round(move_x))
    my = int(np.round(move_y))
    top, bottom = (my, 0) if my >= 0 else (0, -my)
    left, right = (mx, 0) if mx >= 0 else (0, -mx)
    return np.pad(np.asarray(img_bgr), ((top, bottom), (left, right), (0, 0)),
                  "constant")


def compute_keypoints_and_descriptors_harris(
    img_bgr: np.ndarray, max_points: int = 200, *, device="cuda"
) -> Tuple[List[Tuple[int, int]], np.ndarray]:
    """Harris keypoints + 128-d descriptors (image_stitching_harris.py:187)."""
    xy, desc, valid = (
        t.cpu().numpy() for t in harris_keypoints_and_descriptors(
            _dev(img_bgr, device), HarrisConfig(max_points=max_points)))
    v = valid.astype(bool)
    kps = [tuple(int(c) for c in p) for p in xy[v]]
    return kps, desc[v].astype(np.float32)


def simple_match(
    kps_a: Sequence, desc_a: np.ndarray, kps_b: Sequence, desc_b: np.ndarray,
    desc_thresh: float = 1.0, *, device="cuda",
) -> List[tuple]:
    """First-min NN matching under an absolute squared-L2 threshold
    (image_stitching_harris.py:219-240)."""
    desc_a = np.asarray(desc_a, np.float32)
    desc_b = np.asarray(desc_b, np.float32)
    if len(desc_a) == 0 or len(desc_b) == 0:
        return []
    best, matched = (
        t.cpu().numpy() for t in match_descriptors(
            _dev(desc_a, device), _dev(np.ones(len(desc_a), bool), device),
            _dev(desc_b, device), _dev(np.ones(len(desc_b), bool), device),
            float(desc_thresh),
        ))
    return [
        (tuple(kps_a[i]) if not hasattr(kps_a[i], "pt") else kps_a[i].pt,
         tuple(kps_b[best[i]]) if not hasattr(kps_b[best[i]], "pt")
         else kps_b[best[i]].pt)
        for i in range(len(desc_a)) if matched[i]
    ]


def ransac(matches: Sequence[tuple], dist_sq_thresh: float = 3, *,
           device="cuda"):
    """Exhaustive translation voting (image_stitching_harris.py:242-271)."""
    if len(matches) == 0:
        return (0, 0), None
    moves = np.array(
        [[a[0] - b[0], a[1] - b[1]] for a, b in matches], np.float32
    )
    idx, _votes, _any = translation_ransac(
        _dev(moves[None], device), _dev(np.ones((1, len(matches)), bool),
                                        device),
        float(dist_sq_thresh),
    )
    i = int(idx[0])
    return (moves[i][0].item(), moves[i][1].item()), matches[i]


def _compute_shift(imgs, feature_fn, ransac_thr, desc_thresh, device):
    kps_a, desc_a = feature_fn(imgs[0])
    kps_b, desc_b = feature_fn(imgs[1])
    matches = simple_match(kps_a, desc_a, kps_b, desc_b, desc_thresh,
                           device=device)
    return ransac(matches, dist_sq_thresh=ransac_thr, device=device)


def compute_shift_harris(
    img_a: np.ndarray, img_b: np.ndarray,
    ransac_thr: float = 3, desc_thresh: float = 1.0, *, device="cuda",
):
    """(best_move, best_pair) via Harris (image_stitching_harris.py:273)."""
    def feats(img):
        return compute_keypoints_and_descriptors_harris(img, device=device)

    return _compute_shift((img_a, img_b), feats, ransac_thr, desc_thresh,
                          device)


def compute_shift_sift(
    img_a: np.ndarray, img_b: np.ndarray,
    ransac_thr: float = 3, desc_thresh: float = 25000, *, device="cuda",
):
    """(best_move, best_pair) via SIFT (image_stitching_sift.py:52-83)."""
    from vfx_image_stitching_tpu_torch.models.sift import (
        compute_keypoints_and_descriptors,
    )

    def feats(img):
        records, desc = compute_keypoints_and_descriptors(img, device=device)
        return [r.pt for r in records], desc

    return _compute_shift((img_a, img_b), feats, ransac_thr, desc_thresh,
                          device)


def blend_two_images(
    shift_vec: Tuple[float, float],
    ref_match: Optional[tuple],
    img_a: np.ndarray,
    img_b: np.ndarray,
    *,
    device="cuda",
) -> np.ndarray:
    """Counter-alpha column blend of two images
    (image_stitching_harris.py:327-376) on ``device``.

    Unlike the pipeline's planned compositor this accepts arbitrary
    (possibly different-shaped) inputs, exactly like the reference
    function; out-of-range blends clamp instead of wrapping (as the JAX
    package's).
    """
    dx, dy = shift_vec
    if dx < 0:
        dx, dy = -dx, -dy
        ref_match = (ref_match[1], ref_match[0])
        img_a, img_b = img_b, img_a

    pad_a_x = img_b.shape[1] - img_a.shape[1] + ref_match[0][0] - ref_match[1][0]
    pad_b_x = ref_match[0][0] - ref_match[1][0]
    overlap_range = ref_match[1][0] - ref_match[0][0] + img_a.shape[1]

    amx, amy = int(np.round(-pad_a_x)), int(np.round(-dy))
    bmx, bmy = int(np.round(pad_b_x)), int(np.round(dy))
    hh = max(img_a.shape[0] + abs(amy), img_b.shape[0] + abs(bmy))
    ww = max(img_a.shape[1] + abs(amx), img_b.shape[1] + abs(bmx))

    canvas_a = place_on_canvas(_dev(img_a, device, torch.uint8), hh, ww,
                               max(amy, 0), max(amx, 0))
    canvas_b = place_on_canvas(_dev(img_b, device, torch.uint8), hh, ww,
                               max(bmy, 0), max(bmx, 0))
    return _blend_pair(canvas_a, canvas_b, float(overlap_range)).cpu().numpy()
