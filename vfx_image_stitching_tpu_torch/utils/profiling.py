"""Phase timers and the profiler hook.

The reference prints three wall-clock phase timers
(image_stitching_harris.py:447,474-475,499-500,547-548); ``PhaseTimer``
reproduces that and adds structured access.  ``profile_trace`` records a
``torch.profiler`` trace (host, and the card's kernels on CUDA) into a
directory when one is given.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional


class PhaseTimer:
    """Named phase wall-clock collection with reference-style printing."""

    def __init__(self, verbose: bool = False):
        self.phases: Dict[str, float] = {}
        self.verbose = verbose
        self._start = time.time()
        self._last = self._start

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.time()
        yield
        dt = time.time() - t0
        self.phases[name] = self.phases.get(name, 0.0) + dt
        self._last = time.time()
        if self.verbose:
            print(f"Timer: {dt:.2f} s {name}")

    def total(self) -> float:
        self.phases["total"] = time.time() - self._start
        if self.verbose:
            print(f"Total: {self.phases['total']:.2f} s")
        return self.phases["total"]


@contextlib.contextmanager
def profile_trace(profile_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` context writing a Chrome trace
    (``trace_<pid>_<time>.json``) into ``profile_dir``; records CPU
    activity, and CUDA activity when CUDA is available.  A no-op when
    ``profile_dir`` is None or empty."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
