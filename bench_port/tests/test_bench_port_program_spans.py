"""The readers of the program's own spans and counters: the means of
``timings`` keys over the window, nothing to read on a program without
them, and the idle time no leaf span explains, on synthetic runs."""

from typing import NamedTuple

import pytest

from bench_port.harness import trace as T
from bench_port.harness import window as W
from bench_port.harness.spec import metric_reader

SPAN_METRICS = {"project_maps_ms": "project.maps", "load_decode_ms": "load.decode",
                "compose_fold_ms": "compose.fold"}


class Rec(NamedTuple):
    """The fields of the program's ``SpanRecord`` that the reader uses."""

    name: str
    request: int
    id: int
    parent: int
    start_ns: int
    end_ns: int


def _run(timings, profile=None):
    from bench_port.harness.cell import Run

    records = [W.Record(index=i, entry=0, images=18, wall_s=0.2, ok=ok,
                        timings=t) for i, (t, ok) in enumerate(timings)]
    return Run(cell=None, setup_s=1.0,
               window=W.Window(records=records, seconds=1.0), profile=profile)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_means_over_completed_requests(name):
    key = SPAN_METRICS[name]
    run = _run([({key: 0.010, "project": 0.1}, True),
                ({key: 0.030, "project": 0.1}, True),
                ({key: 9.0}, False)])
    assert metric_reader(name).read(run) == pytest.approx(20.0)
    # the parent commit's program has no such span
    assert metric_reader(name).read(_run([({"project": 0.1}, True)])) is None


def test_h2d_megabytes_per_request():
    images, maps, ranges = 18 * 384 * 512 * 3, 18 * 384 * 512 * 4, 17 * 8
    run = _run([({"h2d_bytes": images + maps + ranges}, True),
                ({"h2d_bytes": images + maps + ranges + 2000}, True),
                (None, False)])
    got = metric_reader("h2d_mb_per_request").read(run)
    assert got == pytest.approx((images + maps + ranges + 1000) / 1e6)
    assert 24.77 < got < 24.78
    assert metric_reader("h2d_mb_per_request").read(_run([({}, True)])) is None


def _profile(events):
    return T.Profile(requests=1, device_events=events, calls=[],
                     idle_gaps=[], attempts=1)


# one request: stitch > load > load.decode; stitch > project > (project.maps,
# project.gather); stitch > crop; busy on [2, 4), [62, 78), [96, 99)
SPANS = [
    Rec("stitch", 1, 10, 0, 0, 100),
    Rec("load", 1, 11, 10, 0, 30),
    Rec("load.decode", 1, 12, 11, 5, 25),
    Rec("project", 1, 13, 10, 30, 80),
    Rec("project.maps", 1, 14, 13, 30, 60),
    Rec("project.gather", 1, 15, 13, 60, 80),
    Rec("crop", 1, 16, 10, 80, 95),
    # a request outside the profile's range, and a request of another root
    Rec("stitch", 2, 20, 0, 200, 300),
    Rec("load", 2, 21, 20, 200, 300),
    Rec("a", 3, 30, 0, 0, 100),
]
EVENTS = [("k", 2, 4), ("Memcpy HtoD", 62, 70), ("k", 68, 78), ("k", 96, 99)]


def test_idle_by_innermost_span():
    """Idle [4, 62) and [78, 96) inside the range [2, 99): 1 ns of load's
    self time, 20 in load.decode, 5 of load's self time, 30 in
    project.maps, 2 + 2 in project.gather, 15 in crop, 1 of stitch's self
    time; the request outside the range and the other root count
    nothing."""
    mod = metric_reader("idle_unattributed_pct")
    assert mod.idle_by_span(EVENTS, SPANS) == {
        ("load", True): 6, ("load.decode", False): 20,
        ("project.maps", False): 30, ("project.gather", False): 4,
        ("crop", False): 15, ("stitch", True): 1}
    assert mod.unattributed_pct(EVENTS, SPANS) == pytest.approx(700 / 76)


def test_a_span_straddling_the_range_is_clipped():
    """A request that starts before the first device event counts only
    the idle time after it."""
    mod = metric_reader("idle_unattributed_pct")
    events = [("k", 40, 50), ("k", 90, 110)]
    spans = [Rec("stitch", 5, 1, 0, 0, 100), Rec("load", 5, 2, 1, 0, 60)]
    assert mod.idle_by_span(events, spans) == {("load", False): 10,
                                               ("stitch", True): 30}
    assert mod.unattributed_pct(events, spans) == pytest.approx(75.0)


def test_read_joins_the_programs_spans(monkeypatch):
    from vfx_image_stitching_tpu_torch.utils import profiling

    mod = metric_reader("idle_unattributed_pct")
    monkeypatch.setattr(profiling, "recent_spans", lambda: SPANS)
    assert mod.read(_run([], _profile(EVENTS))) == pytest.approx(700 / 76)
    assert mod.read(_run([], None)) is None
    assert mod.read(_run([], _profile([]))) is None
    monkeypatch.setattr(profiling, "recent_spans", lambda: [])
    assert mod.read(_run([], _profile(EVENTS))) is None
    # the parent commit's program keeps no span records
    monkeypatch.delattr(profiling, "recent_spans")
    assert mod.read(_run([], _profile(EVENTS))) is None
