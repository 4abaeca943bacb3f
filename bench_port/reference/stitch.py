"""The plain reference stitch: one panorama from decoded images.

Load is the caller's (it hands the decoded BGR images and the focal
lengths).  Then, as the reference's ``run_panorama``: every image
projected, Harris or SIFT features of every image, each adjacent pair's
shift and seam pair, drift correction, the sequential blend and the
crop.  Features are computed image by image, in the processes of an
executor where one is handed in.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from bench_port.reference import harris, sift
from bench_port.reference.compose import compose_sequence, rectangle_crop
from bench_port.reference.cylindrical import project
from bench_port.reference.pairs import THRESHOLDS, correct_drift, shifts_and_pairs

PRECISIONS = ("float32", "bf16")
BACKENDS = {"harris": harris, "sift": sift}


@dataclasses.dataclass
class Stitched:
    panorama: np.ndarray
    shifts: List[Tuple[float, float]]
    corrected_shifts: List[Tuple[float, float]]
    pairs: list
    projected: List[Optional[np.ndarray]]


def params(backend: str, overrides: Optional[dict] = None) -> dict:
    """The backend's parameters: its defaults with ``overrides`` (a
    ``StitchConfig`` as a dict: the ``harris`` or ``sift`` group by field
    name) applied; any other setting is refused."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    prm = dict(BACKENDS[backend].DEFAULTS)
    for key, value in (overrides or {}).items():
        if key == backend and isinstance(value, dict):
            unknown = set(value) - set(prm)
            if unknown:
                raise ValueError(f"the reference has no {backend} setting {sorted(unknown)}")
            prm.update(value)
        else:
            raise ValueError(f"the reference does not take the setting {key!r}")
    return prm


def one_thread() -> None:
    """A feature process's set-up: cv2 on one thread (the processes
    share the cores)."""
    import cv2

    cv2.setNumThreads(1)


def _features(job):
    img, backend, prm, lowp = job
    if img is None:
        return None
    return BACKENDS[backend].features(img, prm, lowp)


def features(projected: Sequence[Optional[np.ndarray]], backend: str, prm: dict,
             lowp: bool, procs=None) -> list:
    """Per image ``(xy, descriptors)`` (``None`` for an unreadable one),
    in ``procs`` (an executor) where given."""
    jobs = [(img, backend, prm, lowp) for img in projected]
    if procs is None:
        return [_features(j) for j in jobs]
    return list(procs.map(_features, jobs))


def compose_and_crop(projected, corrected, pairs, margin: int,
                     lowp: bool = False) -> np.ndarray:
    """The blend of the projected images by ``corrected`` shifts and
    ``pairs``, cropped with ``margin``."""
    return rectangle_crop(compose_sequence(projected, corrected, pairs, lowp), 0,
                          margin)


def _shape_checked(images) -> None:
    shapes = {im.shape for im in images if im is not None}
    if len(shapes) != 1:
        raise ValueError(f"images disagree on shape or none is readable: {shapes}")


def stitch_sets(sets: Sequence[tuple], backend: str, precision: str = "float32",
                overrides: Optional[dict] = None, procs=None) -> List[Stitched]:
    """:func:`stitch` of several ``(images, focals, margin)`` sets, with
    the features of all their images computed in one pass over
    ``procs``."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    for images, _f, _m in sets:
        _shape_checked(images)
    lowp = precision == "bf16"
    prm = params(backend, overrides)
    projected = [[None if im is None else project(im, f) for im, f in zip(images, focals)]
                 for images, focals, _m in sets]
    flat = features([p for ps in projected for p in ps], backend, prm, lowp, procs)
    out = []
    for (images, _f, margin), proj in zip(sets, projected):
        feats, flat = flat[:len(proj)], flat[len(proj):]
        shifts, pairs = shifts_and_pairs(feats, THRESHOLDS[backend])
        corrected = correct_drift(shifts, len(images))
        pano = compose_and_crop(proj, corrected, pairs, margin, lowp)
        out.append(Stitched(panorama=pano, shifts=shifts, corrected_shifts=corrected,
                            pairs=pairs, projected=proj))
    return out


def stitch(images: Sequence[Optional[np.ndarray]], focals: Sequence[float],
           backend: str, margin: int, precision: str = "float32",
           overrides: Optional[dict] = None, procs=None) -> Stitched:
    """Stitch decoded (H, W, 3) uint8 BGR images (``None`` for an
    unreadable one) of one size with ``backend``'s features."""
    return stitch_sets([(images, focals, margin)], backend, precision, overrides,
                       procs)[0]
