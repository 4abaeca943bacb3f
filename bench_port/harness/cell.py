"""One run of one cell: set-up, the window, the traced requests, the
metrics, and the comparison with the plain reference."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

from bench_port.harness import check as C
from bench_port.harness import photosets as P
from bench_port.harness import trace as T
from bench_port.harness import window as W
from bench_port.harness.spec import Cell, metric_reader


@dataclasses.dataclass
class Run:
    """What a metric reader reads (``bench_port/metrics/<name>.py``)."""

    cell: Cell
    setup_s: float
    window: W.Window
    peak_bytes: Optional[int] = None
    activity: Optional[T.Activity] = None     # the device over the window
    syncs: Optional[List[int]] = None          # per traced request
    profile: Optional[T.Profile] = None


def _entry(cell: Cell, device: str):
    """``call(request) -> (images, timings, answers)`` for the traffic's
    entry point, at the configuration's settings.  Each call first writes
    its sets' ``pano.txt`` with focal lengths no earlier call listed
    (``photosets.request_focals``), as a user's new folder has; ``answers``
    holds ``(StitchResult, focals)`` per set."""
    import torch

    from vfx_image_stitching_tpu_torch.config import config_from_dict

    backend = cell.config["backend"]
    overrides = cell.config.get("stitch_config") or {}
    cfg = config_from_dict(dict(overrides, backend=backend)) if overrides else None
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    step = float(cell.traffic.get("focal_step", 0.0))
    calls = itertools.count()

    def new_folders(req: P.Request) -> list:
        n = next(calls)
        focals = [P.request_focals(s, n, step) for s in req.sets]
        for s, f in zip(req.sets, focals):
            P.write_pano(s, f)
        return focals

    entry = cell.traffic["entry"]
    if entry == "stitch_panorama":
        from vfx_image_stitching_tpu_torch.pipeline.stitch import stitch_panorama

        def call(req: P.Request):
            focals = new_folders(req)
            (s,) = req.sets
            res = stitch_panorama(s.folder, backend=backend, cfg=cfg,
                                  crop_margin=s.margin, device=device)
            sync()
            return req.images, dict(res.timings), [(res, focals[0])]
        return call
    if entry == "stitch_many":
        from vfx_image_stitching_tpu_torch.pipeline.multi import stitch_many

        def call(req: P.Request):
            focals = new_folders(req)
            out = stitch_many([s.folder for s in req.sets], backend=backend,
                              margins={s.name: s.margin for s in req.sets},
                              cfg=cfg, device=device)
            sync()
            results = [out[s.name] for s in req.sets]
            timings = {}
            for r in results:
                for k, v in r.timings.items():
                    timings[k] = timings.get(k, 0) + v
            return req.images, timings, list(zip(results, focals))
        return call
    raise ValueError(f"unknown entry point {entry!r}")


class _Sample:
    """The window's answers the check keeps: ``n`` requests of each pool
    group, drawn from the seed (a reservoir over the window), whole."""

    def __init__(self, n: int, seed: int, groups: List[int]):
        self.n = n
        self.rng = np.random.default_rng([int(seed), 2])
        self.groups = groups            # pool entry -> its group
        self.seen = {}
        self.kept = {}                  # group -> [(entry, [(Answer, focals)])]

    def __call__(self, k: int, entry: int, answers) -> None:
        g = self.groups[entry]
        seen = self.seen.get(g, 0)
        self.seen[g] = seen + 1
        kept = self.kept.setdefault(g, [])
        if len(kept) < self.n:
            slot = len(kept)
            kept.append(None)
        else:
            slot = int(self.rng.integers(0, seen + 1))
            if slot >= self.n:
                return
        kept[slot] = (entry, [(C.Answer(shifts=r.shifts, pairs=r.pairs,
                                        corrected=r.corrected_shifts,
                                        panorama=r.panorama), f)
                              for r, f in answers])

    def items(self):
        return [item for g in sorted(self.kept) for item in self.kept[g]]


@contextlib.contextmanager
def reference_pool(workers: int):
    """The processes the reference computes features in (``None``: in
    this process), each on one thread: the environment they start with
    holds their BLAS and OpenMP libraries to one thread, so that they
    share the cores."""
    if workers <= 1:
        yield None
        return
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from bench_port.reference.stitch import one_thread

    keys = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(dict.fromkeys(keys, "1"))
    procs = ProcessPoolExecutor(max_workers=workers, initializer=one_thread,
                                mp_context=multiprocessing.get_context("spawn"))
    try:
        yield procs
    finally:
        procs.shutdown(wait=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_answers(cell: Cell, pool: List[P.Request], sample: _Sample,
                  workers: int = 1) -> dict:
    """The numbers compared: every kept answer against the reference's
    stitch of the same decoded images at the same focal lengths."""
    from bench_port.reference.stitch import stitch_sets

    jobs, answers = [], []
    for entry, kept in sample.items():
        for s, (answer, focals) in zip(pool[entry].sets, kept):
            images, listed = P.decoded(s, focals)
            jobs.append((images, listed, s.margin))
            answers.append(answer)
    with reference_pool(workers) as procs:
        refs = stitch_sets(jobs, cell.config["backend"], "float32",
                           cell.config.get("stitch_config"), procs)
    readings = [C.compare(a, ref, job[2]) for a, ref, job in zip(answers, refs, jobs)]
    return dict(numbers=C.worst(readings), answers=len(readings),
                entries=[e for e, _a in sample.items()])


def _metrics(entries: List[dict], run: Run) -> dict:
    out = {}
    for m in entries:
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _breakdown(profile: T.Profile) -> dict:
    by_name = {}
    for name, s, e in profile.device_events:
        by_name[name] = by_name.get(name, 0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], ns / 1e9] for n, ns in top],
            "idle_gaps": [[n[:120], s] for n, s in profile.idle_gaps[:10]]}


def check_workers() -> int:
    """Processes for the reference's features: one a CPU core, at most 8."""
    return max(1, min(8, os.cpu_count() or 1))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, work: str,
             device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """One run of ``cell``: the result object ``run.py`` prints."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = device == "cuda"
    marks = [("imports", time.perf_counter())]
    pool = P.make_pool(cell.traffic, seed, os.path.join(work, "pool"))
    warm = P.make_warmup(cell.traffic, seed, os.path.join(work, "warm"))
    marks.append(("photo_sets", time.perf_counter()))
    call = _entry(cell, device)
    marks.append(("program_import", time.perf_counter()))
    for req in warm:
        call(req)
    recorder = None
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        recorder = T.WindowActivity()
    marks.append(("warm_up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    print(json.dumps({"setup_s": {n: t - (marks[i - 1][1] if i else t_start)
                                  for i, (n, t) in enumerate(marks)}}),
          file=sys.stderr, flush=True)

    sample = _Sample(int(cell.config["check"]["answers_per_group"]), seed,
                     [r.group for r in pool])
    # the harness's own objects out of the collector's way; the program's
    # garbage is collected as it comes
    gc.collect()
    gc.freeze()
    window = W.closed_loop(pool, call, seconds, on_answer=sample)
    gc.unfreeze()
    run = Run(cell=cell, setup_s=setup_s, window=window,
              activity=recorder.stop() if recorder is not None else None)
    if run.activity is not None:
        print(json.dumps({"window_device": dataclasses.asdict(run.activity)}),
              file=sys.stderr, flush=True)
    print(json.dumps({"walls": [[r.entry, round(r.wall_s, 5)]
                                for r in window.records]}),
          file=sys.stderr, flush=True)
    if on_card:
        torch.cuda.synchronize()
        run.peak_bytes = int(torch.cuda.max_memory_allocated())

    breakdown = None
    if trace:
        n = int(cell.config["trace_requests"])
        run.syncs = ([T.host_syncs(lambda i=i: call(pool[i % len(pool)]))
                      for i in range(n)] if on_card else None)
        sites = [s for m in cell.per_layer
                 for s in getattr(metric_reader(m["name"]), "SITES", ())]
        entries = itertools.cycle(pool)
        run.profile = T.profile_requests(
            lambda: call(next(entries)), n, sites,
            torch.cuda.synchronize if on_card else (lambda: None),
            T.PROFILE_ATTEMPTS if on_card else 1)
        if on_card and run.profile is None:
            raise RuntimeError("the profiler recorded no device event in "
                               f"{T.PROFILE_ATTEMPTS} sessions")
        if run.profile is not None:
            breakdown = _breakdown(run.profile)
            prof = run.profile
            print(json.dumps({"traced": dict(
                requests=prof.requests, attempts=prof.attempts,
                device_ops=len(prof.device_events), site_calls=len(prof.calls),
                site_calls_timed=sum(c.device_ns > 0 for c in prof.calls),
                syncs=run.syncs)}), file=sys.stderr, flush=True)
    metrics = _metrics(cell.per_layer if trace else cell.end_to_end, run)

    run.profile = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checked = check_answers(cell, pool, sample, check_workers())
    print(json.dumps({"check_s": time.perf_counter() - t_check,
                      "answers": checked["answers"]}), file=sys.stderr, flush=True)
    limits = cell.config["limits"]
    failed = sum(not r.ok for r in window.records)
    correct = bool(window.records) and failed == 0 and checked["answers"] > 0 \
        and C.judge(checked["numbers"], limits)

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": run.peak_bytes}
    result = {"correct": correct, "attempted": len(window.records),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and breakdown is not None:
        result["breakdown"] = breakdown
    if trace and run.activity is not None:
        dev["busy_s"] = run.activity.busy_s
        dev["window_s"] = window.seconds
    result["compared"] = {k: {"value": v, "limit": float(limits[k])}
                          for k, v in checked["numbers"].items()}
    return result
