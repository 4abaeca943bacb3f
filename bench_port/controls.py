#!/usr/bin/env python3
"""The comparison's control, and its readings at a cell's own size.

    python3 bench_port/controls.py --workload <cell> --seeds 11,12,13 \
        [--precision bf16] [--entries 0,4] [--program]

For each seed, draws the cell's pool of photo sets as a run does and
stitches the pool entries listed (all by default) with the plain
reference put in the program's place, in a lower precision than the
configuration states (``bf16``: SIFT's base image, Harris's fields and
the blend stored in bfloat16).  Each answer is judged as a run judges
the program's: against the reference in float32.  With ``--program``
the program's own answers are read the same way beside them (without
``--precision``, the program's alone: its readings on every pool entry,
where a run checks a few).  One JSON line per seed and side, with the
numbers compared and whether they pass the cell's limits; the control
must come out not correct.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, entries, precision: str, device: str,
             program: bool, work: str, procs) -> list:
    """``[(side, numbers)]`` for one seed: the control's (and with
    ``program`` the program's) answers on ``entries`` against the
    reference in float32."""
    from bench_port.harness import check as C
    from bench_port.harness import photosets as P
    from bench_port.harness.cell import _entry
    from bench_port.reference.stitch import stitch as reference_stitch

    pool = P.make_pool(cell.traffic, seed, work)
    overrides = cell.config.get("stitch_config")
    backend = cell.config["backend"]
    entries = range(len(pool)) if entries is None else entries
    sides = {f"control_{precision}": []} if precision else {}
    if program:
        sides["program"] = []
        call = _entry(cell, device)
    for e in entries:
        answers = call(pool[e])[2] if program else [(None, s.focals) for s in pool[e].sets]
        for s, (res, focals) in zip(pool[e].sets, answers):
            images, listed = P.decoded(s, focals)
            ref = reference_stitch(images, listed, backend, s.margin, "float32",
                                   overrides, procs)
            if precision:
                ctl = reference_stitch(images, listed, backend, s.margin,
                                       precision, overrides, procs)
                sides[f"control_{precision}"].append(C.compare(C.Answer(
                    ctl.shifts, ctl.pairs, ctl.corrected_shifts, ctl.panorama),
                    ref, s.margin))
            if program:
                sides["program"].append(C.compare(C.Answer(
                    res.shifts, res.pairs, res.corrected_shifts, res.panorama),
                    ref, s.margin))
    return [(side, C.worst(r), r) for side, r in sides.items()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--precision", default=None, choices=("float32", "bf16"))
    p.add_argument("--entries", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--program", action="store_true")
    args = p.parse_args(argv)
    from bench_port.harness import check as C
    from bench_port.harness.cell import check_workers, reference_pool
    from bench_port.harness.spec import load_cell

    cell = load_cell(args.workload)
    entries = (None if args.entries is None
               else [int(e) for e in args.entries.split(",")])
    with reference_pool(check_workers()) as procs:
        for seed in (int(s) for s in args.seeds.split(",")):
            work = tempfile.mkdtemp(prefix="bench_port_control_")
            try:
                for side, numbers, each in readings(
                        cell, seed, entries, args.precision, args.device,
                        args.program, work, procs):
                    print(json.dumps(dict(
                        workload=cell.name, seed=seed, side=side, numbers=numbers,
                        correct=C.judge(numbers, cell.config["limits"]),
                        answers=each)), flush=True)
            finally:
                shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
