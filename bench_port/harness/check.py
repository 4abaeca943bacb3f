"""The comparison that decides ``correct``: the program's answers against
the plain reference (``bench_port/reference/``), run after the window on
the images and focal lengths the benchmark handed the program, which it
decodes itself.

Two numbers, each the worst over the answers checked:

* ``pairs_off``: the pairs of one answer that are off.  A pair is off
  when its shift or either point of its seam pair lies more than
  ``TOL_PX`` from the reference's, when one side matched it and the other
  did not, or when its drift-corrected shift lies more than ``TOL_PX``
  from the reference's drift correction of the program's own shifts.
  ``TOL_PX`` is far above the gaps of float32 arithmetic against the
  reference's (a few 1e-5 px) and far below a different seam pair's.
* ``pano_off_pct``: the share of the panorama's bytes that differ from
  the reference's blend and crop of its own projected images by the
  program's corrected shifts and seam pairs (100 where the shapes
  differ or those shifts cannot be blended).  The reference reads the
  program's shifts only to judge its panorama: the shifts are judged by
  ``pairs_off``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np

NUMBERS = ("pairs_off", "pano_off_pct")
TOL_PX = 1e-3


@dataclasses.dataclass
class Answer:
    """What one request gave for one photo set."""

    shifts: list
    pairs: list
    corrected: list
    panorama: Optional[np.ndarray] = None


def _gap(a, b) -> float:
    return max((abs(float(x) - float(y)) for x, y in zip(a, b)), default=0.0)


def _pair_off(pair, ref_pair) -> bool:
    if (pair is None) != (ref_pair is None):
        return True
    if pair is None:
        return False
    return _gap(list(pair[0]) + list(pair[1]),
                list(ref_pair[0]) + list(ref_pair[1])) > TOL_PX


def compare(answer: Answer, ref, margin: int) -> Dict[str, float]:
    """The numbers of one answer against the reference's ``Stitched`` of
    the same images."""
    from bench_port.reference.pairs import correct_drift
    from bench_port.reference.stitch import compose_and_crop

    if len(answer.shifts) != len(ref.shifts):
        return {"pairs_off": float(max(len(answer.shifts), len(ref.shifts))),
                "pano_off_pct": 100.0, "shift_gap_max_px": float("inf"),
                "shift_gap_median_px": float("inf")}
    drift = correct_drift(answer.shifts, len(ref.projected))
    off = sum(
        _gap(s, rs) > TOL_PX or _pair_off(p, rp) or _gap(c, d) > TOL_PX
        for s, rs, p, rp, c, d in zip(answer.shifts, ref.shifts, answer.pairs,
                                      ref.pairs, answer.corrected, drift))
    gaps = [_gap(s, rs) for s, rs in zip(answer.shifts, ref.shifts)]
    # beside the numbers, not compared: the largest shift gap and the
    # median one, which ``controls.py`` reports
    out = {"pairs_off": float(off), "pano_off_pct": 0.0,
           "shift_gap_max_px": max(gaps, default=0.0),
           "shift_gap_median_px": float(np.median(gaps)) if gaps else 0.0}
    if answer.panorama is not None:
        try:
            own = compose_and_crop(ref.projected, answer.corrected, answer.pairs,
                                   margin)
        except (TypeError, IndexError, ValueError):
            own = None
        pano = answer.panorama
        if own is None or own.shape != pano.shape:
            out["pano_off_pct"] = 100.0
        else:
            out["pano_off_pct"] = 100.0 * np.count_nonzero(own != pano) / pano.size
    return out


def worst(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst reading over the answers."""
    out = dict.fromkeys(NUMBERS, 0.0)
    for r in readings:
        for k in NUMBERS:
            out[k] = max(out[k], float(r[k]))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit."""
    return all(numbers[k] <= float(limits[k]) for k in NUMBERS)
