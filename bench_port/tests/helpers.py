"""Small cells for the CPU tests: the committed cells with their traffic
cut to a few small images, so a run takes seconds.

``sift.pano18`` is the SIFT configuration (``configs/sift.json``) on the
committed ``harris.pano18`` cell's traffic and metrics: BENCHMARK.json
leaves that cell out while the program's escalation fault stands
(PERF.md, Open questions), and the tests keep the harness and the
reference able to run it."""

from __future__ import annotations

import copy
import json

from bench_port.harness.spec import ROOT, load_cell

SIFT = "sift.pano18"


def cell_of(name: str):
    """The committed cell ``name``, or the SIFT cell built from files."""
    if name != SIFT:
        return copy.deepcopy(load_cell(name))
    cell = copy.deepcopy(load_cell("harris.pano18"))
    cell.name, cell.config_name = SIFT, "sift"
    cell.config = json.loads((ROOT / "bench_port/configs/sift.json").read_text())
    cell.per_layer = [m for m in cell.per_layer if m["name"] != "host_request_p95_s"]
    return cell

SMALL_SHAPE = dict(images=4, width=96, height=128, focal=[150.0, 155.0],
                   dx=[-55.0, -50.0], dy=[-2.0, -1.0], margin=5)


def small_cell(name: str, sets_per_shape: int = 1):
    """``name``'s cell with every set shape cut to ``SMALL_SHAPE`` and the
    pool to ``sets_per_shape`` sets of each shape group."""
    cell = cell_of(name)
    for shape in cell.traffic["shapes"].values():
        shape.update(SMALL_SHAPE)
    for entry in cell.traffic["pool"]:
        entry["count"] = sets_per_shape
    return cell


def few_images_cell(name: str, images: int, groups: int = 2):
    """``name``'s cell at its own image sizes with ``images`` images a set
    and one set of each of the first ``groups`` pool entries."""
    cell = cell_of(name)
    for shape in cell.traffic["shapes"].values():
        shape["images"] = images
    cell.traffic["pool"] = [dict(e, count=1) for e in cell.traffic["pool"][:groups]]
    return cell
