"""The share of the device's idle time inside the profiled requests that
no leaf span of the program explains, in %: the tracing's own coverage.

Read from the program's span records (``utils/profiling.recent_spans``,
kept while a profiler session recorded, stamped with ``time.time_ns()``,
the profiler's clock) and the device events of the profiled requests
(``run.profile.device_events``):

1. the program's ``stitch`` spans that overlap the profile's range (the
   first device event's start to the last one's end), each clipped to
   that range, with their descendants;
2. the device's busy intervals: the union of the device events;
3. each idle nanosecond inside a ``stitch`` span goes to the innermost
   span of its request open then (a request's spans are on its thread);
4. it is unattributed where that span has children in its request: the
   self time of ``stitch``, or of a phase that has sub-spans;
5. 100 x unattributed / all idle inside the ``stitch`` spans.

Nothing to read without a profile, or where the program keeps no span
records (a program without ``recent_spans``)."""

import importlib
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = "stitch"


def _segments(spans) -> List[Tuple[int, int, object]]:
    """``(start, end, innermost span)`` pieces covering one request's
    spans (properly nested: one thread's context managers)."""
    depth = {}
    by_id = {s.id: s for s in spans}
    for s in spans:
        d, p = 0, s.parent
        while p in by_id:
            d, p = d + 1, by_id[p].parent
        depth[s.id] = d
    order = sorted(spans, key=lambda s: (s.start_ns, depth[s.id]))
    points = sorted({x for s in spans for x in (s.start_ns, s.end_ns)})
    out, stack, j = [], [], 0
    for a, b in zip(points, points[1:]):
        while j < len(order) and order[j].start_ns <= a:
            while stack and stack[-1].end_ns <= order[j].start_ns:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and stack[-1].end_ns <= a:
            stack.pop()
        if stack:
            out.append((a, b, stack[-1]))
    return out


def _idle(events: Sequence[Tuple[str, int, int]], lo: int, hi: int):
    """Sorted idle intervals of ``[lo, hi)`` outside every device event."""
    out, at = [], lo
    for s, e in sorted((s, e) for _n, s, e in events):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def idle_by_span(events: Sequence[Tuple[str, int, int]],
                 spans) -> Dict[Tuple[str, bool], int]:
    """Idle device ns inside the profile's ``stitch`` spans, by the
    innermost span open and whether that span has children:
    ``{(name, unattributed): ns}``."""
    if not events:
        return {}
    lo = min(s for _n, s, _e in events)
    hi = max(e for _n, _s, e in events)
    requests: Dict[int, list] = {}
    for s in spans:
        requests.setdefault(s.request, []).append(s)
    out: Dict[Tuple[str, bool], int] = {}
    for members in requests.values():
        roots = [s for s in members if s.parent == 0 and s.name == ROOT]
        if len(roots) != 1:
            continue
        root = roots[0]
        a, b = max(root.start_ns, lo), min(root.end_ns, hi)
        if a >= b:
            continue
        parents = {s.parent for s in members}
        gaps = _idle(events, a, b)
        k = 0
        for s0, e0, span in _segments(members):
            s0, e0 = max(s0, a), min(e0, b)
            if s0 >= e0:
                continue
            while k < len(gaps) and gaps[k][1] <= s0:
                k += 1
            i = k
            while i < len(gaps) and gaps[i][0] < e0:
                ns = min(e0, gaps[i][1]) - max(s0, gaps[i][0])
                if ns > 0:
                    key = (span.name, span.id in parents)
                    out[key] = out.get(key, 0) + ns
                i += 1
    return out


def unattributed_pct(events, spans) -> Optional[float]:
    by_span = idle_by_span(events, spans)
    idle = sum(by_span.values())
    if not idle:
        return None
    return 100.0 * sum(ns for (_n, open_), ns in by_span.items()
                       if open_) / idle


def recent_spans():
    """The program's span records, or ``None`` where it keeps none."""
    try:
        mod = importlib.import_module(
            "vfx_image_stitching_tpu_torch.utils.profiling")
    except ImportError:
        return None
    fn = getattr(mod, "recent_spans", None)
    return fn() if fn is not None else None


def read(run):
    if run.profile is None or not run.profile.device_events:
        return None
    spans = recent_spans()
    if not spans:
        return None
    return unattributed_pct(run.profile.device_events, spans)
