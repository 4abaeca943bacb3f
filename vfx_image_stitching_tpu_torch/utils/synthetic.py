"""Synthetic photo chains for the chip run, the probes and the tests.

NumPy only.  :func:`synth_chain` writes an AutoStitch-style folder (PPM
images + ``pano.txt``) of crops of one :func:`make_scene` scene; the
constants below are the chain ``chip_smoke.py`` stitches on the card and
the probe entry points extract.
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
