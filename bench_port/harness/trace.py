"""What the profiler reads: the device's operations over every run's
measured window, and in a ``--trace 1`` run host syncs and a device
profile of whole requests, read from the benchmark's own files.

* The window (:class:`WindowActivity`): ``torch.profiler`` with the
  device's activity alone (kernels, copies, sets; no host ops, no spans)
  from the end of set-up to the window's close.
* Host syncs: ``torch.cuda.set_sync_debug_mode("warn")`` over requests of
  their own, counting its warnings.
* The profile: ``torch.profiler`` over a fixed number of whole requests,
  with a span (``record_function``) around each call into the program's
  phases (``PHASE_SITES``) and around each call of the functions a metric
  asks for (its ``SITES``), whose arguments are kept for it.  Events stay
  in memory; no trace file is written.  A session that records no device
  event is taken again, a few times at most.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import inspect
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

SPAN = "bench_port."
# (module whose attribute the stitch calls, function, phase name)
PHASE_SITES = (
    ("vfx_image_stitching_tpu_torch.pipeline.stitch", "load_dataset", "load"),
    ("vfx_image_stitching_tpu_torch.pipeline.stitch",
     "cylindrical_project_batch", "project"),
    ("vfx_image_stitching_tpu_torch.pipeline.stitch", "extract_features",
     "extract"),
    ("vfx_image_stitching_tpu_torch.pipeline.stitch", "dispatch_pair_step",
     "pairs"),
    ("vfx_image_stitching_tpu_torch.pipeline.stitch",
     "finalize_pairwise_shifts", "finalize"),
    ("vfx_image_stitching_tpu_torch.pipeline.stitch", "compose_mosaic",
     "compose"),
    ("vfx_image_stitching_tpu_torch.pipeline.stitch", "mosaic_with_bounds",
     "crop"),
)
PROFILE_ATTEMPTS = 4


@dataclasses.dataclass
class SiteCall:
    """One call of a wrapped function in the profiled requests."""

    tag: str
    args: dict                  # bound arguments, by parameter name
    start_ns: int = 0           # its span on the host
    end_ns: int = 0
    device_ns: int = 0          # device time of the kernels launched in it


@dataclasses.dataclass
class Profile:
    requests: int
    device_events: List[Tuple[str, int, int]]   # (name, start ns, end ns)
    calls: List[SiteCall]
    idle_gaps: List[Tuple[str, float]]   # host activity during idle, summed
    attempts: int


@dataclasses.dataclass
class Activity:
    """The device's operations over the measured window."""

    ops: int                    # kernels, copies and sets recorded
    busy_s: float               # union of every operation's interval
    kernel_s: float             # union of the kernels' intervals alone
    read_s: float               # host seconds the stop and the read took


def _is_copy_or_set(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def activity_of(events: Sequence[Tuple[str, int, int]], read_s: float = 0.0) -> Activity:
    """The :class:`Activity` of ``(name, start ns, end ns)`` device events."""
    kernels = [(s, e) for n, s, e in events if not _is_copy_or_set(n)]
    return Activity(
        ops=len(events),
        busy_s=sum(e - s for s, e in union_intervals([(s, e) for _n, s, e in events])) / 1e9,
        kernel_s=sum(e - s for s, e in union_intervals(kernels)) / 1e9,
        read_s=read_s)


class WindowActivity:
    """Records the device's operations from its start (the end of set-up,
    so that the profiler's own start-up is set-up's) to :meth:`stop`
    (once the window's last request has synchronized)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    def stop(self) -> Activity:
        import torch

        t0 = time.perf_counter()
        self._prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        events = [(e.name(), e.start_ns(), e.end_ns())
                  for e in self._prof.profiler.kineto_results.events()
                  if e.device_type() == cuda
                  and not (getattr(e, "is_user_annotation", None)
                           and e.is_user_annotation())]
        self._prof = None
        return activity_of(events, time.perf_counter() - t0)


def host_syncs(call: Callable[[], None]) -> int:
    """Synchronizing CUDA operations of one ``call()``, from
    ``torch.cuda.set_sync_debug_mode``'s warnings."""
    import torch

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in seen)


@contextlib.contextmanager
def _patched(sites: Sequence[Tuple[str, str, str]], make):
    """Replace each ``module.fn`` of ``sites`` by ``make(tag, fn)`` for the
    duration; a site the program no longer has is skipped."""
    saved = []
    try:
        for mod_name, fn_name, tag in sites:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name, None)
            if fn is None:
                continue
            saved.append((mod, fn_name, fn))
            setattr(mod, fn_name, make(tag, fn))
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def _span(tag: str, fn):
    from torch.profiler import record_function

    def call(*args, **kwargs):
        with record_function(SPAN + tag):
            return fn(*args, **kwargs)
    return call


def _recorder(calls: List[SiteCall]):
    from torch.profiler import record_function

    def make(tag, fn):
        sig = inspect.signature(fn)

        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            calls.append(SiteCall(tag=tag, args=dict(bound.arguments)))
            with record_function(SPAN + "site." + tag):
                return fn(*args, **kwargs)
        return call
    return make


def union_intervals(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def name_gaps(gaps: Sequence[Tuple[int, int]], phases: Sequence[Tuple[int, int, str]],
              ops: Sequence[Tuple[int, int, str]]) -> Dict[str, float]:
    """Seconds of idle device time by what the host was doing, ``phase/op``:
    each gap cut at the phase spans' edges (``harness`` outside them), each
    piece named by the innermost host op running at its start (``python``
    where none ran)."""
    phases = sorted(phases)
    edges = sorted({x for s, e, _n in phases for x in (s, e)})
    starts = [p[0] for p in phases]
    pieces = []
    for gs, ge in gaps:
        cuts = edges[bisect.bisect_right(edges, gs):bisect.bisect_left(edges, ge)]
        bounds = [gs, *cuts, ge]
        pieces += [(a, b) for a, b in zip(bounds, bounds[1:]) if b > a]
    ops = sorted(ops, key=lambda o: (o[0], -o[1]))
    out: Dict[str, float] = {}
    stack: List[Tuple[int, int, str]] = []
    j = 0
    for ps, pe in sorted(pieces):
        while j < len(ops) and ops[j][0] <= ps:
            while stack and stack[-1][1] <= ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] <= ps:
            stack.pop()
        op = stack[-1][2] if stack else "python"
        i = bisect.bisect_right(starts, ps) - 1
        phase = phases[i][2] if i >= 0 and phases[i][1] > ps else "harness"
        key = f"{phase}/{op}"
        out[key] = out.get(key, 0.0) + (pe - ps) / 1e9
    return out


def _read(prof, calls: List[SiteCall]):
    """Device events, site spans with their kernels' device time, and the
    idle gaps inside the ``window`` span named, from a finished session."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, launches, phases, ops, sites = [], {}, [], [], []
    main_thread = None
    t0_ns = t1_ns = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if name.startswith(SPAN):
                continue  # the device-side copy of a span, not an operation
            device.append((name, e.start_ns(), e.end_ns(), e.correlation_id(),
                           e.linked_correlation_id()))
            continue
        if name.startswith(SPAN):
            main_thread = e.start_thread_id()
            tag = name[len(SPAN):]
            if tag == "window":
                t0_ns, t1_ns = e.start_ns(), e.end_ns()
            elif tag.startswith("site."):
                sites.append((e.start_ns(), e.end_ns()))
            else:
                phases.append((e.start_ns(), e.end_ns(), tag))
            continue
        if name.startswith(("cuda", "cu")) and "Launch" in name:
            launches[e.correlation_id()] = e.start_ns()
        ops.append((e.start_ns(), e.end_ns(), name, e.start_thread_id()))
    ops = [(s, en, n) for s, en, n, th in ops if th == main_thread]
    sites.sort()
    for call, (s, e) in zip(calls, sites):
        call.start_ns, call.end_ns = s, e
    site_starts = [c.start_ns for c in calls]
    for _name, s, e, corr, linked in device:
        t = launches.get(corr, launches.get(linked))
        if t is None or not calls:
            continue
        i = bisect.bisect_right(site_starts, t) - 1
        if i >= 0 and t <= calls[i].end_ns:
            calls[i].device_ns += e - s
    spans = union_intervals([(s, e) for _n, s, e, _c, _l in device])
    edges = [t0_ns] + [x for iv in spans for x in iv] + [t1_ns]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    named = sorted(name_gaps(gaps, phases, ops).items(), key=lambda kv: -kv[1])
    return [(n, s, e) for n, s, e, _c, _l in device], named


def profile_requests(run_one: Callable[[], None], n: int,
                     sites: Sequence[Tuple[str, str, str]],
                     sync: Callable[[], None],
                     attempts: int = PROFILE_ATTEMPTS) -> Optional[Profile]:
    """Profile ``n`` calls of ``run_one`` (whole requests) with the phase
    spans and the ``sites`` recorded (``sync`` waits for the device);
    ``None`` when every session came back without device events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(1, attempts + 1):
        calls: List[SiteCall] = []
        with _patched(PHASE_SITES, _span), _patched(sites, _recorder(calls)):
            sync()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function(SPAN + "window"):
                    for _ in range(n):
                        run_one()
                    sync()
        device, named = _read(prof, calls)
        if device:
            return Profile(requests=n, device_events=device, calls=calls,
                           idle_gaps=named, attempts=attempt)
    return None
