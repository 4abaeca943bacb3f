"""The metric arithmetic: a rate over the whole window, a tail over all
requests, idle time from the union of device intervals, the device's and
the kernels' time per image."""

import pytest

from bench_port.harness import trace as T
from bench_port.harness import window as W


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_rate_over_whole_window_and_last_request_counted():
    clock = FakeClock()
    walls = iter([1.0, 2.0, 3.0, 4.0])

    def call(req):
        clock.t += next(walls)
        return req, {"load": 0.5}, None

    win = W.closed_loop([10, 20], call, seconds=5.0, clock=clock)
    # starts at 0, 1 and 3 s are before the 5 s deadline; the third runs
    # to 6 s and is counted; the window is 6 s
    assert [r.wall_s for r in win.records] == [1.0, 2.0, 3.0]
    assert win.seconds == 6.0
    assert W.images_per_s(win) == pytest.approx((10 + 20 + 10) / 6.0)
    assert W.mean_phase_ms(win, "load") == pytest.approx(500.0)


def test_failed_request_counts_in_time_not_images():
    clock = FakeClock()

    def call(req):
        clock.t += 1.0
        if req == 2:
            raise RuntimeError("boom")
        return req, {}, None

    win = W.closed_loop([1, 2], call, seconds=2.5, clock=clock)
    assert [r.ok for r in win.records] == [True, False, True]
    assert W.images_per_s(win) == pytest.approx(2 / 3.0)


def test_p95_over_all_requests():
    walls = [0.1] * 95 + [1.0] * 5
    assert W.percentile(walls, 95) == pytest.approx(0.1 + 0.05 * 0.9)
    assert W.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)


def test_idle_from_interval_union():
    spans = T.union_intervals([(0, 10), (5, 20), (30, 40), (35, 36), (40, 45)])
    assert spans == [(0, 20), (30, 45)]
    assert sum(e - s for s, e in T.union_intervals([(0, 10), (5, 20), (30, 40)])) == 30


def _window_run(events, walls_images, seconds):
    from bench_port.harness.cell import Run

    records = [W.Record(index=i, entry=0, images=n, wall_s=w, ok=ok)
               for i, (w, n, ok) in enumerate(walls_images)]
    return Run(cell=None, setup_s=1.0,
               window=W.Window(records=records, seconds=seconds),
               activity=T.activity_of(events))


def test_device_time_per_image_over_the_window():
    """Every operation's interval counts once (the union), over the images
    of the completed requests; the kernels' share leaves copies and sets
    out; the idle share is of the window's whole length."""
    from bench_port.harness.spec import metric_reader

    events = [("Memcpy HtoD (Pageable -> Device)", 0, 4_000_000),
              ("gather_kernel", 4_000_000, 5_000_000),
              ("reduce_kernel", 4_500_000, 6_000_000),
              ("Memset (Device)", 6_000_000, 6_500_000),
              ("fold_kernel", 9_000_000, 10_000_000)]
    run = _window_run(events, [(0.01, 18, True), (0.01, 18, True),
                               (0.01, 0, False)], seconds=0.1)
    assert run.activity.ops == 5
    assert run.activity.busy_s == pytest.approx(7.5e-3)
    assert run.activity.kernel_s == pytest.approx(3e-3)
    read = lambda name: metric_reader(name).read(run)  # noqa: E731
    assert read("device_ms_per_image") == pytest.approx(7.5 / 36)
    assert read("kernel_ms_per_image") == pytest.approx(3.0 / 36)
    assert read("device_idle_pct") == pytest.approx(100 * (1 - 7.5e-3 / 0.1))


@pytest.mark.parametrize("name", ["device_ms_per_image", "kernel_ms_per_image",
                                  "device_idle_pct"])
def test_device_metrics_read_nothing_without_device_events(name):
    from bench_port.harness.spec import metric_reader

    assert metric_reader(name).read(_window_run([], [(0.01, 18, True)], 0.1)) is None


def test_gaps_named_by_phase_and_innermost_op():
    phases = [(0, 100, "extract"), (100, 200, "pairs")]
    ops = [(0, 60, "aten::outer"), (10, 30, "aten::inner"), (120, 150, "aten::sort")]
    named = T.name_gaps([(15, 20), (40, 50), (70, 80), (130, 140)], phases, ops)
    assert named == pytest.approx({"extract/aten::inner": 5e-9,
                                   "extract/aten::outer": 10e-9,
                                   "extract/python": 10e-9,
                                   "pairs/aten::sort": 10e-9})


def test_a_gap_across_phases_is_split():
    phases = [(0, 100, "crop"), (150, 300, "load")]
    named = T.name_gaps([(90, 200)], phases, [(80, 120, "cudaMemcpyAsync")])
    assert named == pytest.approx({"crop/cudaMemcpyAsync": 10e-9,
                                   "harness/cudaMemcpyAsync": 50e-9,
                                   "load/python": 50e-9})


def test_kernel_bounds_read_the_recorded_calls(tmp_path):
    """The K1-K3 bounds of the roofline metric, computed from the
    arguments its sites record in a small SIFT stitch on the CPU: every
    tag is seen, every bound is finite, and each kernel's sum is
    positive (a call on an octave without rows is bound by nothing)."""
    import math

    from bench_port.harness import photosets as P
    from bench_port.tests.helpers import small_cell
    from vfx_image_stitching_tpu_torch.pipeline.stitch import stitch_panorama

    from bench_port.harness.spec import metric_reader

    reader = metric_reader("sift_kernels_roofline")
    cell = small_cell("sift.pano18")
    cell.traffic["pool"] = cell.traffic["pool"][:1]
    (req,) = P.make_pool(cell.traffic, 2**31 + 41, str(tmp_path))
    calls = []
    with T._patched(reader.SITES, T._recorder(calls)):
        stitch_panorama(req.sets[0].folder, backend="sift", device="cpu",
                        crop_margin=req.sets[0].margin)
    assert {c.tag for c in calls} == set(reader.BOUNDS)
    total = dict.fromkeys(reader.BOUNDS, 0.0)
    for c in calls:
        ms, _by = reader.BOUNDS[c.tag](c.args)
        assert 0 <= ms < math.inf
        total[c.tag] += ms
    assert all(v > 0 for v in total.values()), total
