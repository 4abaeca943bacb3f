"""The one generator of the benchmark's traffic: AutoStitch photo folders
made from a seed and a traffic file's parameters.

A traffic file (``bench_port/traffic/<name>.json``) names the entry point
each request calls, the pool of requests (each a group of photo sets,
cycled in order through a run) and the shape of every set: image count,
width and height, the range of focal lengths, the per-pair offsets the
neighbours have after the program's cylindrical projection, the crop
margin, and the images whose focal line ``pano.txt`` leaves out.

Each set is drawn from one seeded scene that lives on the cylinder (a
``make_scene``-style shading with small high-contrast blocks).  Image
``i`` is the inverse cylindrical projection, at its own focal length, of
the window of the scene centred at ``(X_i, Y_i)``, with ``X_{i+1} = X_i +
dx_i`` and ``Y_{i+1} = Y_i + dy_i``: the program's forward projection
puts neighbours back at the drawn offsets, to its half-pixel rounding.
The images are written as JPEG (cv2), as cameras give them.  Each
request then lists the set's focal lengths moved by a step of its own
(``focal_step``, :func:`request_focals`), so that no request of a run
hands the program a focal length it has seen, as no user's new folder
does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class PhotoSet:
    """One generated folder and what was drawn for it."""

    name: str
    folder: str
    shape: str
    focals: List[float]            # per image, as pano.txt lists them
    offsets: List[tuple]           # drawn (dx, dy) per adjacent pair
    margin: int                    # the crop margin a request passes
    listed: List[bool]             # False: the image's focal line is left out
    n_images: int                  # images the program stitches (listed ones)


@dataclasses.dataclass
class Request:
    """One entry of the pool: the sets a request hands the entry point,
    and the traffic's pool group it was drawn for."""

    index: int
    sets: List[PhotoSet]
    group: int = 0

    @property
    def images(self) -> int:
        return sum(s.n_images for s in self.sets)


def make_scene(h: int, w: int, rng: np.random.Generator, block_px: int,
               block_size: Sequence[int],
               shade: Sequence[int] = (30, 226)) -> np.ndarray:
    """Photo-like (h, w, 3) BGR scene: coarse noise in ``shade`` (low
    inclusive, high exclusive) on a 16-pixel grid, bilinear-upsampled,
    and one rectangle per ``block_px`` pixels, its sides drawn from
    ``block_size`` (low inclusive, high exclusive), in one random colour
    each: the corners and blobs the features find.  Where rectangles
    overlap, the later one is on top."""
    import cv2

    coarse = rng.integers(shade[0], shade[1],
                          ((h + 15) // 16 + 1, (w + 15) // 16 + 1, 3)
                          ).astype(np.uint8)
    scene = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_LINEAR)
    scene = scene.reshape(h * w, 3)
    n = max(20, h * w // block_px)
    ys = rng.integers(0, h - 12, n)
    xs = rng.integers(0, w - 12, n)
    hs = rng.integers(block_size[0], block_size[1], n)
    ws = rng.integers(block_size[0], block_size[1], n)
    colours = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    # every rectangle's pixels, rectangle after rectangle: a flat
    # assignment with repeated indices keeps the last value
    span = int(block_size[1])
    dy, dx = np.divmod(np.arange(span * span), span)
    inside = (dy[None, :] < hs[:, None]) & (dx[None, :] < ws[:, None])
    flat = (ys[:, None] + dy[None, :]) * w + xs[:, None] + dx[None, :]
    block = np.broadcast_to(np.arange(n)[:, None], flat.shape)
    scene[flat[inside]] = colours[block[inside]]
    return scene.reshape(h, w, 3)


def cylinder_coords(h: int, w: int, focal: float):
    """(h, w) float64 cylinder coordinates ``(theta, v)`` of every pixel of
    an (h, w) image at ``focal``, relative to its centre ``(w // 2, h //
    2)``: where the program's forward projection sends it before rounding."""
    xd = (np.arange(w) - w // 2).astype(np.float64)[None, :]
    yd = (np.arange(h) - h // 2).astype(np.float64)[:, None]
    theta = np.broadcast_to(focal * np.arctan(xd / focal), (h, w))
    return theta, focal * yd / np.sqrt(xd ** 2 + focal ** 2)


def sample_bilinear(scene: np.ndarray, y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """A uint8 ``scene`` at float coordinates (inside it), bilinear."""
    import cv2

    return cv2.remap(scene, x.astype(np.float32), y.astype(np.float32),
                     cv2.INTER_LINEAR)


def _uniform(rng: np.random.Generator, lo_hi: Sequence[float], n: int) -> np.ndarray:
    lo, hi = sorted(float(v) for v in lo_hi)
    return rng.uniform(lo, hi, n)


def make_set(folder: str, shape_name: str, shape: dict, scene_kw: dict,
             jpeg_quality: int, rng: np.random.Generator) -> PhotoSet:
    """Draw one set of ``shape`` and write its JPEG images (named after
    the shape) and ``pano.txt`` into ``folder``."""
    import cv2

    n, w, h = int(shape["images"]), int(shape["width"]), int(shape["height"])
    # as pano.txt lists them, so the program projects at the focal drawn
    focals = np.round(_uniform(rng, shape["focal"], n), 3)
    dx = _uniform(rng, shape["dx"], n - 1)
    dy = _uniform(rng, shape["dy"], n - 1)
    cx = np.concatenate([[0.0], np.cumsum(dx)])
    cy = np.concatenate([[0.0], np.cumsum(dy)])
    coords = [cylinder_coords(h, w, f) for f in focals]
    pad = 4.0
    lo_x = min(c + t.min() for c, (t, _v) in zip(cx, coords)) - pad
    hi_x = max(c + t.max() for c, (t, _v) in zip(cx, coords)) + pad
    lo_y = min(c + v.min() for c, (_t, v) in zip(cy, coords)) - pad
    hi_y = max(c + v.max() for c, (_t, v) in zip(cy, coords)) + pad
    scene = make_scene(int(np.ceil(hi_y - lo_y)) + 2, int(np.ceil(hi_x - lo_x)) + 2,
                       rng, int(scene_kw["block_px"]), scene_kw["block_size"],
                       scene_kw.get("shade", (30, 226)))
    os.makedirs(folder, exist_ok=True)
    missing = set(int(i) for i in shape.get("focal_missing", ()))
    for i, (theta, v) in enumerate(coords):
        img = sample_bilinear(scene, cy[i] + v - lo_y, cx[i] + theta - lo_x)
        fn = image_name(shape_name, i)
        if not cv2.imwrite(os.path.join(folder, fn), img,
                           [cv2.IMWRITE_JPEG_QUALITY, int(jpeg_quality)]):
            raise OSError(f"could not write {fn} into {folder}")
    listed = [i not in missing for i in range(n)]
    photo_set = PhotoSet(
        name=os.path.basename(folder), folder=folder, shape=shape_name,
        focals=focals.tolist(),
        offsets=list(zip(dx.tolist(), dy.tolist())),
        margin=int(shape["margin"]), listed=listed,
        n_images=int(sum(listed)))
    write_pano(photo_set, photo_set.focals)
    return photo_set


def request_focals(photo_set: PhotoSet, n: int, step: float) -> List[float]:
    """The focal lengths the ``n``-th request of a run lists for the set:
    each drawn focal (three decimals) moved by ``n * step``.  With ``n *
    step`` under 0.001 no two requests of a run list the same focal
    length for any image, as no two users' folders do, and the geometry
    moves by less than a thousandth of a pixel."""
    if n * step >= 1e-3:
        raise ValueError(f"request {n} at focal step {step} would repeat a focal")
    return [f + n * step for f in photo_set.focals]


def write_pano(photo_set: PhotoSet, focals: Sequence[float]) -> None:
    """Write the set's ``pano.txt``: each image's name, then its focal
    length unless the set leaves it out."""
    lines = []
    for i, f in enumerate(focals):
        lines.append(image_name(photo_set.shape, i))
        if photo_set.listed[i]:
            lines.append(f"{f:.7f}")
    with open(os.path.join(photo_set.folder, "pano.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


def image_name(shape_name: str, i: int) -> str:
    return f"{shape_name}{i:02d}.jpg"


def _make_requests(traffic: dict, groups: List[List[str]], seed: int,
                   stream: int, root: str, prefix: str) -> List[Request]:
    """Requests of the given groups of set shapes: set ``j`` drawn from its
    own stream ``(seed, stream, j)``, the sets written in a few threads."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = [(i, shape_name) for i, group in enumerate(groups)
            for shape_name in group]

    def one(j):
        i, shape_name = jobs[j]
        return make_set(os.path.join(root, f"{prefix}{i:02d}_{shape_name}"),
                        shape_name, traffic["shapes"][shape_name],
                        traffic["scene"], traffic["jpeg_quality"],
                        np.random.default_rng([int(seed), stream, j]))

    with ThreadPoolExecutor(max_workers=4) as ex:
        sets = list(ex.map(one, range(len(jobs))))
    reqs = [Request(index=i, sets=[]) for i in range(len(groups))]
    for (i, _shape), s in zip(jobs, sets):
        reqs[i].sets.append(s)
    return reqs


def make_pool(traffic: dict, seed: int, root: str) -> List[Request]:
    """The pool of requests of ``traffic`` drawn from ``seed``, written
    under ``root``: each pool entry is ``count`` requests of its group of
    set shapes, every set drawn anew."""
    groups = [list(entry["sets"]) for entry in traffic["pool"]
              for _ in range(int(entry["count"]))]
    reqs = _make_requests(traffic, groups, seed, 0, root, "r")
    owner = [g for g, entry in enumerate(traffic["pool"])
             for _ in range(int(entry["count"]))]
    for req, g in zip(reqs, owner):
        req.group = g
    return reqs


def make_warmup(traffic: dict, seed: int, root: str) -> List[Request]:
    """One warm-up request for each group of image sizes the pool holds
    (count, width and height of each set), of sets drawn apart from the
    pool's (its own stream of ``seed``), so the window finds no answer of
    its own in the program's caches."""
    groups, sizes = [], []
    for entry in traffic["pool"]:
        size = [tuple(int(traffic["shapes"][s][k])
                      for k in ("images", "width", "height"))
                for s in entry["sets"]]
        if size not in sizes:
            sizes.append(size)
            groups.append(list(entry["sets"]))
    return _make_requests(traffic, groups, seed, 1, root, "w")


def decoded(photo_set: PhotoSet, focals: Optional[Sequence[float]] = None) -> tuple:
    """The set's images as the reference receives them: each listed image
    decoded by cv2 (``None`` if unreadable), and their focal lengths
    (``focals``, one per image, or the drawn ones)."""
    import cv2

    focals = photo_set.focals if focals is None else focals
    images: List[Optional[np.ndarray]] = []
    listed = []
    for i, ok in enumerate(photo_set.listed):
        if ok:
            images.append(cv2.imread(os.path.join(
                photo_set.folder, image_name(photo_set.shape, i))))
            listed.append(float(focals[i]))
    return images, listed
