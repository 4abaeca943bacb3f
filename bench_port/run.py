#!/usr/bin/env python3
"""Run one cell of the PyTorch and CUDA port's benchmark once.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration (``bench_port/configs/``) and a traffic mix
(``bench_port/traffic/<name>.json``).  Set-up draws the traffic's photo
sets from ``--seed`` into a directory under ``TMPDIR``, imports the
program and stitches one warm-up set of each shape.  Then one caller
sends requests back to back for ``--seconds`` (the window).  With
``--trace 1`` the run then counts host syncs and profiles whole
requests, and reports the cell's per-layer metrics; with ``--trace 0`` it
reports the cell's end-to-end metrics.  Last, the answers of requests
drawn from the seed are compared with the plain reference
(``bench_port/reference/``), which runs on the CPU in up to 8 processes
that it starts and stops.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number compared with its
limit); the numbers compared are also the last lines of standard error.
Without CUDA, or with fewer cards than the cell asks for, the run exits
non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level modules that may not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "vfx_image_stitching_tpu")


def forbidden_modules() -> list:
    """Forbidden top-level names present in ``sys.modules`` (the part
    before the first dot, compared whole)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", required=True, type=int, choices=(0, 1))
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # every build and kernel cache of the run inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    import torch

    from bench_port.harness.cell import run_cell
    from bench_port.harness.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    work = tempfile.mkdtemp(prefix="bench_port_")
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          work, device="cuda", t_start=T_START)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    leaked = forbidden_modules()
    if leaked:
        print(f"the run loaded {leaked}, which the benchmark may not load",
              file=sys.stderr)
        return 3
    for name, v in result["compared"].items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
