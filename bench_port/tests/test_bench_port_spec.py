"""The harness finds configurations, traffic and metrics by name, and a
cell that brings only new files runs with no edit to the harness."""

import json
import shutil
from pathlib import Path

from bench_port.harness import spec

ROOT = Path(__file__).resolve().parents[2]


def test_committed_cells_resolve():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["backend"] == cell.config_name
        assert cell.traffic["entry"] in ("stitch_panorama", "stitch_many")
        names = [m["name"] for m in cell.end_to_end + cell.per_layer]
        for name in names:
            assert callable(spec.metric_reader(name).read)
        assert {"setup_s", "device_ms_per_image", "host_images_per_s"} <= set(names)


def test_metric_workloads_select_cells(tmp_path):
    """A metric with a ``workloads`` key reaches only the cells it lists."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(bench["workloads"][0], name="harris.other"))
    bench["per_layer"].append({"name": "first_wall_s", "unit": "s",
                               "better": "lower", "source": "host_clock",
                               "layer": "device", "moves": "device_ms_per_image",
                               "workloads": ["harris.other"]})
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    one = spec.load_cell("harris.pano18", root=tmp_path)
    other = spec.load_cell("harris.other", root=tmp_path)
    assert "first_wall_s" in [m["name"] for m in other.per_layer]
    assert "first_wall_s" not in [m["name"] for m in one.per_layer]
    assert "host_request_p95_s" in [m["name"] for m in one.per_layer]


def test_new_files_add_a_cell(tmp_path):
    """A configuration, a traffic mix and a metric added as files, and
    entries added to BENCHMARK.json, make a cell the harness loads."""
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench_port/configs/harris.json").read_text())
    cfg["name"] = "harris_b"
    (tmp_path / "bench_port/configs/harris_b.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "bench_port/traffic/pano18.json").read_text())
    traffic["pool"] = [{"sets": ["grail"], "count": 2}]
    (tmp_path / "bench_port/traffic/grail2.json").write_text(json.dumps(traffic))
    (tmp_path / "bench_port/metrics/first_wall_s.py").write_text(
        "def read(run):\n    return run.window.records[0].wall_s\n")
    bench["configs"].append(dict(bench["configs"][0], name="harris_b",
                                 file="bench_port/configs/harris_b.json"))
    bench["workloads"].append({"name": "harris_b.grail2", "config": "harris_b",
                               "traffic": "grail2", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "first_wall_s", "unit": "s",
                               "better": "lower", "source": "host_clock",
                               "layer": "device", "moves": "device_ms_per_image",
                               "workloads": ["harris_b.grail2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("harris_b.grail2", root=tmp_path)
    assert cell.traffic["pool"] == [{"sets": ["grail"], "count": 2}]
    assert cell.config["name"] == "harris_b"
    assert "first_wall_s" in [m["name"] for m in cell.per_layer]
    reader = spec.metric_reader("first_wall_s", root=tmp_path)

    class Rec:
        wall_s = 1.5

    class Win:
        records = [Rec()]

    class Run:
        window = Win()

    assert reader.read(Run()) == 1.5
