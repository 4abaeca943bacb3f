"""The measured window: one caller, requests back to back (a closed loop).

A request starts while the clock is short of the deadline; the last one
started is finished and counted, and the window ends when it returns.
Each request's wall is the host clock around the call, which ends with
the panorama on the host and a device synchronize.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Record:
    index: int              # position in the window
    entry: int              # the pool entry it stitched
    images: int
    wall_s: float
    ok: bool
    timings: Optional[dict] = None     # the entry point's own phase seconds
    error: Optional[str] = None


@dataclasses.dataclass
class Window:
    records: List[Record]
    seconds: float          # first start to last return


def closed_loop(pool: Sequence[Any], call: Callable, seconds: float,
                on_answer: Callable[[int, int, Any], None] = lambda *_a: None,
                clock: Callable[[], float] = time.perf_counter) -> Window:
    """Call ``call(pool[k % len(pool)])`` back to back for ``seconds``.

    ``call`` returns ``(images, timings, answer)``; an exception counts
    the request as failed.  ``on_answer(k, entry, answer)`` gets each
    completed request's answer once its wall is taken (what it does not
    keep is dropped at once)."""
    records: List[Record] = []
    start = clock()
    deadline = start + seconds
    k = 0
    end = start
    while clock() < deadline:
        entry = k % len(pool)
        t0 = clock()
        try:
            images, timings, answer = call(pool[entry])
            ok, error = True, None
        except Exception as exc:  # a failed request is counted, not fatal
            images, timings, answer = 0, None, None
            ok, error = False, f"{type(exc).__name__}: {exc}"
        end = clock()
        records.append(Record(index=k, entry=entry, images=images,
                              wall_s=end - t0, ok=ok, timings=timings,
                              error=error))
        if ok:
            on_answer(k, entry, answer)
        answer = None
        k += 1
    return Window(records=records, seconds=end - start)


def images_per_s(window: Window) -> float:
    """Images of every completed request over all the time of the window."""
    return sum(r.images for r in window.records if r.ok) / window.seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def mean_phase_ms(window: Window, *phases: str) -> Optional[float]:
    """The window's sum of the entry point's ``timings[phase]`` (summed
    over ``phases``) over its completed requests, in ms per request;
    ``None`` where no request reports them."""
    done = [r for r in window.records if r.ok and r.timings is not None
            and all(p in r.timings for p in phases)]
    if not done:
        return None
    return 1e3 * sum(sum(r.timings[p] for p in phases) for r in done) / len(done)
