"""PyTorch port, the tracer (``utils/profiling.py``): the spans and counters
of the stitch path, on the CPU.

Contracts: a stitch fills every span and counter of its path in
``StitchResult.timings``; each phase's sub-spans sum to no more than the
phase; the projection counts the map cache's misses and hits; the
host-to-device bytes are the images', the maps', the fold's overlap
ranges' and the padding indices' (each counted at the site that puts the
host array on the device); without a recording profiler no span record
is kept and, outside ``profile_trace``, no ``vfx.`` range is entered;
span stamps share the profiler's clock; ``profile_trace`` writes the
spans nested; ``PhaseTimer`` prints as before.
"""

import json
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vfx_image_stitching_tpu_torch import config as tc
from vfx_image_stitching_tpu_torch.pipeline import stitch as ST
from vfx_image_stitching_tpu_torch.utils import profiling as P
from vfx_image_stitching_tpu_torch.utils.synthetic import synth_chain

torch.set_num_threads(1)

N, H, W = 3, 96, 128
CAPS = tc.SiftCapacities(
    candidate_caps=(256,), localized_caps=(192,), oriented_caps=(192,),
    max_keypoints=384, max_radius=12, max_half_width=24,
    desc_small_half=14, desc_small_caps=(192,), desc_big_caps=(192,),
    desc_chunk=64,
)
SIFT_CFG = tc.StitchConfig(backend="sift", sift=tc.SiftConfig(capacities=CAPS))

COMMON_SPANS = (
    "stitch", "load", "load.read", "load.decode", "load.stack",
    "project", "project.maps", "project.upload", "project.gather",
    "extract", "pairs", "finalize", "finalize.pull",
    "compose", "compose.plan", "compose.fold", "compose.pull", "crop",
)
EXTRACT_SPANS = {
    "harris": ("extract.corners", "extract.describe"),
    "sift": ("extract.pyramid", "extract.extrema", "extract.localize",
             "extract.orientation", "extract.descriptor"),
}
COUNTERS = (
    "n_images", "n_decode_failed", "n_maps_built", "n_maps_cached",
    "h2d_bytes", "n_h2d", "d2h_bytes", "n_d2h",
    "n_fold_steps", "n_fold_kernel_steps", "esc_n_pairs", "esc_n_rows",
    "passes",
)
# the phases with sub-spans, and the spans directly below each
SUB_SPANS = {
    "load": ("load.read", "load.decode", "load.stack"),
    "project": ("project.maps", "project.upload", "project.gather"),
    "finalize": ("finalize.pull", "finalize.escalate"),
    "compose": ("compose.plan", "compose.fold", "compose.pull"),
}

_focal_base = iter(range(1, 1000))


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("trace_chain"))
    synth_chain(folder, N, H, W, seed=4, focal=300.0)
    return folder


def _fresh_focals(folder):
    """Rewrite ``pano.txt`` with focal lengths no other stitch of the
    process has used (the map cache is process-wide)."""
    base = 287.0 + 0.001 * next(_focal_base)
    names = sorted(f for f in os.listdir(folder) if f.endswith(".ppm"))
    with open(os.path.join(folder, "pano.txt"), "w") as f:
        for i, name in enumerate(names):
            f.write(f"{name}\n{base + 0.37 * i:.6f}\n")


def _stitch(folder, backend="harris"):
    cfg = SIFT_CFG if backend == "sift" else None
    return ST.stitch_panorama(folder, backend=backend, cfg=cfg,
                              crop_margin=5, device="cpu")


def _pad_index_bytes(h, w, cfg=tc.HarrisConfig()):
    """Bytes of the int64 index arrays the Harris path's padding uploads:
    two 3x3 gradient filters (edge pad 1 on each axis), three structure
    blurs (reflect pad ``block_size // 2``) and the descriptor patches'
    blur (pad ``desc_blur_ksize // 2`` on a ``patch_size`` square)."""
    grad = 2 * ((h + 2) + (w + 2))
    blur = cfg.block_size // 2
    structure = 3 * ((h + 2 * blur) + (w + 2 * blur))
    patch = cfg.patch_size + 2 * (cfg.desc_blur_ksize // 2)
    return 8 * (grad + structure + 2 * patch)


@pytest.mark.parametrize("backend", ["harris", "sift"])
def test_stitch_fills_every_span_and_counter(chain, backend):
    """Every span of the backend's path and every counter appear in
    ``timings``, next to the phase keys they always had; ``total`` is the
    sum of the pass's phases; spans are seconds, counters whole."""
    _fresh_focals(chain)
    res = _stitch(chain, backend)
    t = res.timings
    for name in COMMON_SPANS + EXTRACT_SPANS[backend]:
        assert isinstance(t[name], float) and t[name] >= 0, name
    for name in COUNTERS:
        assert isinstance(t[name], int) and t[name] >= 0, name
    assert t["total"] == pytest.approx(sum(t[k] for k in ST.PASS_PHASES))
    assert t["n_images"] == N and t["n_decode_failed"] == 0
    assert t["n_fold_steps"] == N - 1 and t["passes"] == 1
    # the CPU folds plainly; the kernel folds only on the card
    assert t["n_fold_kernel_steps"] == 0
    # the pair step's 7 result arrays, the mosaic and its bounds, and on
    # SIFT the capacity stats
    assert t["n_d2h"] == 9 if backend == "harris" else t["n_d2h"] > 9
    assert t["stitch"] >= t["load"] + t["total"]
    other = EXTRACT_SPANS["sift" if backend == "harris" else "harris"]
    assert not set(other) & set(t)


@pytest.mark.parametrize("backend", ["harris", "sift"])
def test_sub_spans_sum_within_their_phase(chain, backend):
    """Each phase's sub-spans, and the extraction's stages, sum to no more
    than the phase; the phases sum to no more than the request."""
    res = _stitch(chain, backend)
    t = res.timings
    subs = dict(SUB_SPANS, extract=EXTRACT_SPANS[backend])
    for phase, names in subs.items():
        assert sum(t.get(n, 0.0) for n in names) <= t[phase], phase
    assert t["load"] + sum(t[k] for k in ST.PASS_PHASES) <= t["stitch"]


def test_maps_built_on_fresh_focals_then_cached(chain):
    _fresh_focals(chain)
    first = _stitch(chain).timings
    assert (first["n_maps_built"], first["n_maps_cached"]) == (N, 0)
    again = _stitch(chain).timings
    assert (again["n_maps_built"], again["n_maps_cached"]) == (0, N)


def test_host_to_device_bytes(chain):
    """The images (uint8 BGR) and their int32 index maps, one float64
    overlap range a fold step, and the padding's index arrays: each host
    array put on the stitch's device, counted by its bytes."""
    t = _stitch(chain).timings
    steps = t["n_fold_steps"]
    assert t["h2d_bytes"] == (N * H * W * 3 + N * H * W * 4 + 8 * steps
                              + _pad_index_bytes(H, W))
    # images, maps, the overlap ranges, 4 gradient and 8 blur paddings
    assert t["n_h2d"] == 2 + steps + 12


def test_escalation_span_keeps_escalate(chain, monkeypatch):
    """An escalated pair opens ``finalize.escalate``, whose seconds are
    also ``escalate``; the escalation's pulls count: 17 result arrays
    (keypoints, 8 meta fields, 8 match arrays) and each pair's images."""
    from vfx_image_stitching_tpu_torch.models.sift import strict

    plain = _stitch(chain, "sift").timings
    step = ST.dispatch_pair_step

    def every_pair_material(xy, descs, valid_kp, cfg):
        out = list(step(xy, descs, valid_kp, cfg))
        out[13] = torch.ones_like(out[13])
        return tuple(out)

    monkeypatch.setattr(ST, "dispatch_pair_step", every_pair_material)
    monkeypatch.setattr(strict, "escalate_pair", lambda *a, **k: None)
    t = _stitch(chain, "sift").timings
    assert t["esc_n_pairs"] == N - 1
    assert t["escalate"] == t["finalize.escalate"] > 0
    assert t["finalize.pull"] + t["finalize.escalate"] <= t["finalize"]
    assert "finalize.escalate" not in plain and plain["esc_n_pairs"] == 0
    assert t["n_d2h"] - plain["n_d2h"] == 17 + (N - 1)
    assert t["d2h_bytes"] - plain["d2h_bytes"] > (N - 1) * 2 * H * W * 3


def test_no_records_and_no_ranges_without_a_trace(chain):
    """Without a recording profiler a stitch keeps no span record; under
    a profiler other than ``profile_trace`` it keeps one request's
    records and enters no ``vfx.`` range."""
    before = P.recent_spans()
    _stitch(chain)
    assert P.recent_spans() == before
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _stitch(chain)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names and not [n for n in names if n.startswith("vfx.")]
    last = P.recent_spans()[-1].request
    assert last not in {r.request for r in before}
    new = [r for r in P.recent_spans() if r.request == last]
    root = [r for r in new if r.name == "stitch"]
    assert len(root) == 1 and root[0].parent == 0
    ids = {r.id for r in new}
    assert all(r.parent in ids for r in new if r is not root[0])


def test_spans_share_the_profilers_clock(chain):
    """Under a CPU profiler each ``project.gather`` span holds its
    ``aten::gather`` op's start and end, to within 1 ms: the profiler
    stamps its events with a cycle counter converted to Unix time once a
    session, and a virtual machine whose real-time clock is stepped
    departs from that by a few hundred microseconds (a clock other than
    ``time.time_ns()`` would be off by years)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            _stitch(chain)
    gathers = [(e.start_ns(), e.end_ns())
               for e in prof.profiler.kineto_results.events()
               if e.name() == "aten::gather"]
    spans = [r for r in P.recent_spans() if r.name == "project.gather"][-2:]
    assert len(spans) == 2 and len(gathers) >= 2
    slack = 1_000_000
    for r in spans:
        inside = [(s, e) for s, e in gathers
                  if r.start_ns - slack <= s and e <= r.end_ns + slack]
        assert len(inside) == 1, (r, gathers)


def test_profile_trace_nests_the_programs_spans(chain, tmp_path):
    """``cfg.profile_dir`` writes a Chrome trace in which ``vfx.stitch``
    holds ``vfx.project``, which holds ``vfx.project.maps``."""
    cfg = tc.StitchConfig(profile_dir=str(tmp_path))
    ST.stitch_panorama(chain, cfg=cfg, crop_margin=5, device="cpu")
    (path,) = tmp_path.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("vfx."):
            spans.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"], e["tid"]))

    def within(inner, outer):
        return any(o[0] <= i[0] and i[1] <= o[1] and o[2] == i[2]
                   for i in spans[inner] for o in spans[outer])

    assert within("vfx.project", "vfx.stitch")
    assert within("vfx.project.maps", "vfx.project")
    assert within("vfx.extract.corners", "vfx.extract")


def test_span_and_count_outside_a_request():
    """Outside a request a span only times itself and a count goes
    nowhere, even under a recording profiler; inside one both land in its
    trace, nested."""
    before = P.recent_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with P.span("a") as lone:
            with P.span("b") as inner:
                P.count("n", 3)
    assert lone.seconds >= inner.seconds >= 0
    assert not hasattr(lone, "trace") and P.recent_spans() == before
    with P.request("r") as trace:
        with P.span("a") as a:
            with P.span("b") as b:
                P.count("n", 3)
        assert b.parent == a.id and a.parent == trace.root.id
        assert trace.take().keys() == {"a", "b", "n"}
    assert trace.root.seconds >= a.seconds >= b.seconds >= 0
    assert trace.take() == {"r": trace.root.seconds}
    assert P.RING_REQUESTS >= 200


def test_phase_timer_prints_as_before(capsys):
    timer = P.PhaseTimer(verbose=True)
    with timer.phase("a"):
        pass
    with timer.phase("b"):
        with timer.phase("c"):
            pass
    total = timer.total()
    out = capsys.readouterr().out.splitlines()
    assert [re.sub(r"\d+\.\d\d", "x", line) for line in out] == [
        "Timer: x s a", "Timer: x s c", "Timer: x s b", "Total: x s"]
    assert set(timer.phases) == {"a", "b", "c", "total"}
    assert total == timer.phases["total"] >= timer.phases["b"] >= \
        timer.phases["c"] >= 0


def test_stitch_many_is_one_request(chain, tmp_path):
    """``stitch_many`` is one request: each dataset's timings hold its
    ``load_wait`` span and its pass, and ``cumulative`` grows."""
    from vfx_image_stitching_tpu_torch.pipeline.multi import stitch_many

    other = str(tmp_path / "other")
    os.mkdir(other)
    synth_chain(other, N, H, W, seed=5, focal=310.0)
    names = [os.path.basename(chain), "other"]
    res = stitch_many([chain, other], backend="harris",
                      margins=dict.fromkeys(names, 5), device="cpu")
    first, second = (r.timings for r in res.values())
    for t in (first, second):
        assert t["load_wait"] >= 0 and t["n_h2d"] > 0
        assert "load" not in t and "stitch" not in t
        assert t["cumulative"] >= t["total"]
    assert second["cumulative"] >= first["cumulative"] + second["total"]
    assert np.array_equal(res["other"].panorama, _stitch(other).panorama)
