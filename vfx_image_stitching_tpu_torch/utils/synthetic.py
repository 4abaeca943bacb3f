"""Synthetic photo chains for the chip run, the probes and the tests.

NumPy only.  :func:`synth_chain` writes an AutoStitch-style folder (PPM
images + ``pano.txt``) of crops of one :func:`make_scene` scene; the
constants below are the chain ``chip_smoke.py`` stitches on the card and
the probe entry points extract.  :func:`pano18_fold_inputs` and
``FOLD_CASES`` are cylindrical batches and compose plans for the fold's
tests and the chip run.
"""

from __future__ import annotations

import os

import numpy as np

# the chip run's chain: 18 images of 384x512 (the reference parrington
# set's shape); one small block per 45 px puts octave 0 at the density of
# the capacity audit over the reference photo sets
N_IMAGES, IMG_H, IMG_W, FOCAL, SEED = 18, 384, 512, 700.0, 7
SCENE = dict(block_px=45, block_size=(2, 5))


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel-center bilinear resize of an (h, w, c) uint8 image."""
    def axis(n_out, n_in):
        c = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        c = np.clip(c, 0, n_in - 1)
        i0 = np.floor(c).astype(np.int64)
        i1 = np.minimum(i0 + 1, n_in - 1)
        return i0, i1, c - i0

    y0, y1, fy = axis(out_h, img.shape[0])
    x0, x1, fx = axis(out_w, img.shape[1])
    f = img.astype(np.float64)
    rows = f[y0] * (1 - fy)[:, None, None] + f[y1] * fy[:, None, None]
    out = rows[:, x0] * (1 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]
    return np.rint(out).astype(np.uint8)


def make_scene(h: int, total_w: int, seed: int, block_px: int = 250,
               block_size: tuple = (4, 12)) -> np.ndarray:
    """Photo-like BGR scene: smooth background + high-contrast blocks.

    Coarse noise on a 16-pixel grid, bilinear-upsampled, gives the
    shading; one sprinkled rectangle per ``block_px`` pixels, its sides
    drawn from ``block_size`` (low inclusive, high exclusive), gives the
    corners and blobs SIFT finds.  Small blocks feed octave 0, larger
    ones octaves 1 and 2.
    """
    rng = np.random.default_rng(seed)
    coarse = rng.integers(
        30, 226, ((h + 15) // 16 + 1, (total_w + 15) // 16 + 1, 3)
    ).astype(np.uint8)
    scene = _bilinear_resize(coarse, h, total_w)
    for _ in range(max(20, h * total_w // block_px)):
        y0 = int(rng.integers(0, h - 12))
        x0 = int(rng.integers(0, total_w - 12))
        hh = int(rng.integers(*block_size))
        ww = int(rng.integers(*block_size))
        scene[y0:y0 + hh, x0:x0 + ww] = rng.integers(0, 256, (3,)).astype(np.uint8)
    return scene


def write_ppm(path: str, bgr: np.ndarray) -> None:
    """Binary PPM (P6) of a BGR uint8 image."""
    h, w = bgr.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(bgr[..., ::-1]).tobytes())


def synth_chain(folder: str, n: int, h: int, w: int, seed: int,
                focal: float, overlap_frac: float = 0.65,
                **scene_kw) -> None:
    """Write an n-image chain of (h, w) crops of one scene + pano.txt.

    Crops run right-to-left so pairwise dx is negative, the pan direction
    of the reference datasets.  The images are binary PPM; their names end
    in ``.png.ppm`` because the reference pano.txt parser only takes lines
    naming ``.jpg``/``.png`` files, and every decoder reads the format from
    the file's content.
    """
    step = w - int(w * overlap_frac)
    scene = make_scene(h, w + (n - 1) * step + 8, seed, **scene_kw)
    lines = []
    for i in range(n):
        x0 = (n - 1 - i) * step
        fn = f"im{i:02d}.png.ppm"
        write_ppm(os.path.join(folder, fn), scene[:, x0:x0 + w])
        lines += [fn, f"{focal + i * 0.37:.3f}"]
    with open(os.path.join(folder, "pano.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def pano18_fold_inputs(seed: int = 18):
    """A compose fold at the benchmark's ``pano18`` shape: 18 cylindrical
    images of 512 x 384 (H x W), noise with 6 black columns at each edge
    as the projection leaves them, and the plan of a chain that steps
    240.7-252.4 px to the left (swapped steps) and 4.0-4.8 px up.
    Returns the (18, 512, 384, 3) uint8 images and the plan."""
    from vfx_image_stitching_tpu_torch.compose.plan import plan_compose

    rng = np.random.default_rng(seed)
    n, h, w = 18, 512, 384
    images = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    images[:, :, :6] = 0
    images[:, :, -6:] = 0
    shifts, pairs = [], []
    for _ in range(n - 1):
        dx, dy = -float(rng.uniform(240.7, 252.4)), -float(rng.uniform(4.0, 4.8))
        xa, ya = float(rng.uniform(20, 120)), float(rng.uniform(50, 450))
        shifts.append((dx, dy))
        pairs.append(((xa, ya), (xa - dx, ya - dy)))
    return images, plan_compose(h, w, n, [True] * n, shifts, pairs)


def _fold_chain(seed, n=5, h=60, w=80):
    """A random chain whose steps alternate between swapped and not; the
    pairs' x differ by a non-integer, so no alpha denominator is an
    integer; black leading columns."""
    from vfx_image_stitching_tpu_torch.compose.plan import plan_compose

    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    images[:, :, :3] = 0
    shifts, pairs = [], []
    for i in range(n - 1):
        dx = int(rng.integers(16, 56)) * (1 if (seed + i) % 2 == 0 else -1)
        dy = float(rng.integers(-5, 6)) + float(rng.random())
        xa = float(rng.integers(8, w - 8))
        ya = int(rng.integers(4, h - 4))
        shifts.append((float(dx), dy))
        pairs.append(((xa + 0.37, ya), (xa - dx, ya - int(dy))))
    return images, plan_compose(h, w, n, [True] * n, shifts, pairs)


def _fold_black_edges_and_invalid():
    """Both edges of every image black, as the projection leaves them, and
    image 2 unreadable (noise the plan skips)."""
    from vfx_image_stitching_tpu_torch.compose.plan import plan_compose

    rng = np.random.default_rng(12)
    n, h, w = 5, 40, 64
    images = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    images[:, :, :5] = 0
    images[:, :, -7:] = 0
    shifts = [(-22.0, 1.5), (0.0, 0.0), (-30.0, -2.25), (25.0, 3.0)]
    pairs = [((10.0, 20.0), (31.5, 18.0)), None, ((12.0, 9.0), (41.25, 11.0)),
             ((40.0, 7.0), (15.5, 4.0))]
    return images, plan_compose(h, w, n, [True, True, False, True, True],
                                shifts, pairs)


def _fold_hand_plan():
    """A plan built by hand, with overlapping bands whose alpha
    denominators are 0, negative (alpha below 0: the clamp) and not an
    integer, images at the canvas's bottom and top rows, and an x offset
    past the canvas (clamped to its edge)."""
    from vfx_image_stitching_tpu_torch.compose.plan import (
        ComposePlan,
        StepPlan,
    )

    rng = np.random.default_rng(21)
    n, h, w = 4, 30, 40
    images = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    images[:, :, :2] = 0
    images[:, :, -3:] = 0
    hc, wc = h + 9, 100
    steps = [StepPlan(1, False, 9, 25, 0.0), StepPlan(2, True, 0, 45, -17.5),
             StepPlan(3, False, 4, wc + 5, 23.7)]
    for s in steps:
        s.local_h, s.local_w = hc, wc
    return images, ComposePlan(hc, wc, 5, 0, steps)


def _fold_truncated():
    """Image 0 is 1 in row 0 only and image 1 is 1 in row 1 only, so every
    overlap column with 0 < alpha < 1 blends to values in (0, 1), which the
    uint8 cast floors to 0: those columns are empty at step 2, and image 2
    is pasted there instead of blended."""
    from vfx_image_stitching_tpu_torch.compose.plan import plan_compose

    h, w = 8, 16
    images = np.zeros((3, h, w, 3), np.uint8)
    images[0, 0] = 1
    images[1, 1] = 1
    images[2] = np.random.default_rng(3).integers(10, 256, (h, w, 3))
    shifts = [(8.0, 0.0), (8.0, 0.0)]
    pairs = [((10.0, 0.0), (2.0, 0.0)), ((10.0, 0.0), (2.0, 0.0))]
    return images, plan_compose(h, w, 3, [True] * 3, shifts, pairs)


# (N, H, W, 3) uint8 images and a plan for each case of the fold kernel's
# card tests (tests/test_torch_cuda.py; tests/test_torch_compose.py
# checks on the CPU that they cover what their docstrings say)
FOLD_CASES = {
    **{f"chain{s}": (lambda s=s: _fold_chain(s)) for s in range(3)},
    "black_edges_invalid": _fold_black_edges_and_invalid,
    "hand_plan": _fold_hand_plan,
    "truncated": _fold_truncated,
    "pano18": pano18_fold_inputs,
}
