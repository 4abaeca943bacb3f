"""The program's tracer, the reference's phase timer and the profiler hook.

**The tracer.**  :func:`request` opens a request: a root span (``stitch``)
with a process-wide request id, held in a :class:`contextvars.ContextVar`,
so that :func:`span` and :func:`count` anywhere below it on the same
thread act on that request's :class:`Trace` without new parameters.
Outside a request a count does nothing and a span only times itself
(two clock reads, recorded nowhere), so a caller may read its
``seconds`` either way.  A span in a request records
its name, its request, its parent (the span open around it on the
calling thread) and its start and end in ``time.time_ns()``, which is the
clock of ``torch.profiler``'s events; it never synchronizes the device.

* Per request, always: the trace sums each span's seconds and each
  counter under its name; :meth:`Trace.take` hands the sums out, which
  ``pipeline/stitch.py`` returns as ``StitchResult.timings``.
* While a ``torch.profiler`` session records in the process: every
  finished span is also kept as a :class:`SpanRecord`, and a request's
  records join a ring of the last :data:`RING_REQUESTS` requests when it
  ends; :func:`recent_spans` reads the ring.  Their stamps line up with
  the session's own events, device events included.
* Inside :func:`profile_trace` (the CLI's ``--profile-dir``) each span is
  also a ``record_function("vfx." + name)`` range, so the Chrome trace
  shows the program's spans nested under ``vfx.stitch``.  Nothing else in
  the program enters ``record_function``.

The reference prints three wall-clock phase timers
(image_stitching_harris.py:447,474-475,499-500,547-548); ``PhaseTimer``
reproduces that on the tracer's spans and adds structured access.
``profile_trace`` records a ``torch.profiler`` trace (host, and the card's
kernels on CUDA) into a directory when one is given.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import os
import sys
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

# requests whose span records the ring keeps
RING_REQUESTS = 256


class SpanRecord(NamedTuple):
    """One finished span, kept while a profiler session records."""

    name: str
    request: int
    id: int
    parent: int         # the enclosing span's id; 0 for a request's root
    start_ns: int       # time.time_ns(), the profiler's clock
    end_ns: int


# (the current request's Trace, the id of the span open on this thread)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "vfx_trace", default=None)
_REQUEST_IDS = itertools.count(1)
_SPAN_IDS = itertools.count(1)
_RING: collections.deque = collections.deque(maxlen=RING_REQUESTS)
_ANNOTATE_LOCK = threading.Lock()
_annotate = 0           # open profile_trace sessions


def _recording() -> bool:
    """Whether a ``torch.profiler`` session records in the process (no
    session can while torch is not imported)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class Trace:
    """One request's span seconds and counters (``totals``) and, while a
    profiler session records, its span records."""

    __slots__ = ("request", "totals", "records", "root")

    def __init__(self, request: int):
        self.request = request
        self.totals: Dict[str, float] = {}
        self.records: List[SpanRecord] = []
        self.root: Optional[Span] = None

    def take(self) -> dict:
        """Span seconds and counters since the last take, by name; the
        sums start again from nothing."""
        out, self.totals = self.totals, {}
        return out

    def elapsed(self) -> float:
        """Seconds since the request's root span opened."""
        return (time.time_ns() - self.root.start_ns) / 1e9


class Span:
    """A span of a :class:`Trace`; :attr:`seconds` once it has ended."""

    __slots__ = ("name", "trace", "parent", "id", "start_ns", "end_ns",
                 "_token", "_range")

    def __init__(self, name: str, trace: Trace, parent: int):
        self.name = name
        self.trace = trace
        self.parent = parent
        self.id = 0
        self.start_ns = self.end_ns = 0

    def __enter__(self) -> "Span":
        self.id = next(_SPAN_IDS)
        self._token = _CURRENT.set((self.trace, self.id))
        self._range = None
        if _annotate:
            from torch.autograd.profiler import record_function

            self._range = record_function("vfx." + self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _CURRENT.reset(self._token)
        totals = self.trace.totals
        totals[self.name] = totals.get(self.name, 0.0) + self.seconds
        if _recording():
            tr = self.trace
            tr.records.append(SpanRecord(self.name, tr.request, self.id,
                                         self.parent, self.start_ns,
                                         self.end_ns))
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _LoneSpan:
    """What :func:`span` gives outside a request: it times itself and is
    recorded nowhere."""

    __slots__ = ("start_ns", "end_ns")

    def __enter__(self) -> "_LoneSpan":
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def span(name: str):
    """A context manager timing ``name`` in the current request (a child
    of the span open around it); outside a request it only times itself.
    Either way its ``seconds`` hold the time once it has ended."""
    cur = _CURRENT.get()
    if cur is None:
        return _LoneSpan()
    return Span(name, cur[0], cur[1])


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the current request's counter ``name``; does nothing
    outside a request."""
    cur = _CURRENT.get()
    if cur is not None:
        totals = cur[0].totals
        totals[name] = totals.get(name, 0) + n


def count_h2d(nbytes: int) -> None:
    """Count one host array of ``nbytes`` put on the stitch's device
    (``h2d_bytes``, ``n_h2d``), whatever the device is."""
    count("h2d_bytes", int(nbytes))
    count("n_h2d")


def count_d2h(nbytes: int) -> None:
    """Count one explicit pull of ``nbytes`` to the host (``d2h_bytes``,
    ``n_d2h``), whatever the device is."""
    count("d2h_bytes", int(nbytes))
    count("n_d2h")


@contextlib.contextmanager
def request(name: str = "stitch") -> Iterator[Trace]:
    """Open a request with a root span ``name``, and yield its trace."""
    trace = Trace(next(_REQUEST_IDS))
    trace.root = Span(name, trace, 0)
    try:
        with trace.root:
            yield trace
    finally:
        if trace.records:
            _RING.append(tuple(trace.records))


def recent_spans() -> List[SpanRecord]:
    """The span records of the last :data:`RING_REQUESTS` requests that
    ended while a profiler session recorded, oldest request first."""
    return [r for req in list(_RING) for r in req]


class PhaseTimer:
    """Named phase wall-clock collection with reference-style printing.

    Each phase is a :func:`span` of the current request, if any."""

    def __init__(self, verbose: bool = False):
        self.phases: Dict[str, float] = {}
        self.verbose = verbose
        self._start_ns = time.time_ns()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        with span(name) as opened:
            yield
        dt = opened.seconds
        self.phases[name] = self.phases.get(name, 0.0) + dt
        if self.verbose:
            print(f"Timer: {dt:.2f} s {name}")

    def total(self) -> float:
        self.phases["total"] = (time.time_ns() - self._start_ns) / 1e9
        if self.verbose:
            print(f"Total: {self.phases['total']:.2f} s")
        return self.phases["total"]


@contextlib.contextmanager
def profile_trace(profile_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` context writing a Chrome trace
    (``trace_<pid>_<time>.json``) into ``profile_dir``; records CPU
    activity, and CUDA activity when CUDA is available, and the program's
    spans as ``vfx.<name>`` ranges.  A no-op when ``profile_dir`` is None
    or empty."""
    global _annotate
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
        with _ANNOTATE_LOCK:
            _annotate += 1
        try:
            yield
        finally:
            with _ANNOTATE_LOCK:
                _annotate -= 1
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
