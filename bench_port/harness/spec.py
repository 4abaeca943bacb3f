"""What one cell is, read from ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by name:

* ``configs`` of ``BENCHMARK.json`` name each configuration's file;
* ``bench_port/traffic/<traffic>.json`` is a traffic mix;
* ``bench_port/metrics/<metric>.py`` reads one metric (``read(run)``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]      # the cell's end-to-end metric entries
    per_layer: List[dict]       # the cell's per-layer metric entries


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; raises
    ``KeyError`` for a name it does not list."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "bench_port" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"],
        config=config, traffic_name=w["traffic"], traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def metric_reader(name: str, root: Path = ROOT):
    """The module ``bench_port/metrics/<name>.py``: its ``read(run)``
    returns the metric's value, or ``None`` where it finds nothing to
    read; an optional ``SITES`` lists the program's functions it needs
    wrapped in the traced requests."""
    path = root / "bench_port" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
