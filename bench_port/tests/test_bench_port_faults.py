"""A whole run on the CPU (the look for a chip skipped) with the timed
path broken underneath: ``correct`` comes out false for each fault a
stitch can have, and true for the sound program."""

import numpy as np
import pytest

from bench_port.harness.cell import run_cell
from bench_port.tests.helpers import small_cell

SEED = 2**31 + 31
CELLS = ["harris.pano18", "sift.pano18"]


@pytest.fixture(autouse=True)
def _few_processes(monkeypatch):
    from bench_port.harness import cell

    monkeypatch.setattr(cell, "check_workers", lambda: 2)


def _run(tmp_path, name):
    cell = small_cell(name)
    return run_cell(cell, SEED, 0.5, False, str(tmp_path), device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tmp_path, name):
    out = _run(tmp_path, name)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out["compared"]) == ["pairs_off", "pano_off_pct"]
    # without a card the device's metrics find nothing to read
    assert set(out["metrics"]) == {"setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered_where_produced(tmp_path, monkeypatch, name):
    """One pair's shift moved by a pixel as the pair step returns it."""
    from vfx_image_stitching_tpu_torch.pipeline import stitch

    real = stitch.dispatch_pair_step

    def altered(*args, **kwargs):
        out = list(real(*args, **kwargs))
        out[0] = out[0].clone()
        out[0][0, 0] += 1.0
        return tuple(out)

    monkeypatch.setattr(stitch, "dispatch_pair_step", altered)
    out = _run(tmp_path, name)
    assert not out["correct"]
    assert out["compared"]["pairs_off"]["value"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_panorama_altered_where_produced(tmp_path, monkeypatch, name):
    """The mosaic's first 16 columns blacked as the fold returns it."""
    from vfx_image_stitching_tpu_torch.pipeline import stitch

    real = stitch.compose_mosaic

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        mosaic = out[0] if isinstance(out, tuple) else out
        mosaic[:, :16] = 0
        return out

    monkeypatch.setattr(stitch, "compose_mosaic", altered)
    out = _run(tmp_path, name)
    assert not out["correct"]
    assert out["compared"]["pano_off_pct"]["value"] > 1.0


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out(tmp_path, monkeypatch, name):
    """The features of the second half of the images dropped."""
    from vfx_image_stitching_tpu_torch.pipeline import stitch

    real = stitch.extract_features

    def halved(cyl, cfg):
        xy, descs, valid_kp, meta, stats = real(cyl, cfg)
        valid_kp = valid_kp.clone()
        valid_kp[valid_kp.shape[0] // 2:] = False
        return xy, descs, valid_kp, meta, stats

    monkeypatch.setattr(stitch, "extract_features", halved)
    out = _run(tmp_path, name)
    assert not out["correct"]
    assert out["compared"]["pairs_off"]["value"] >= 1


def test_failed_request_is_not_correct(tmp_path, monkeypatch):
    """Every request after the warm-up raises."""
    from vfx_image_stitching_tpu_torch.pipeline import stitch

    real, calls = stitch.compose_mosaic, []

    def broken(*args, **kwargs):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("the stitch failed")
        return real(*args, **kwargs)

    monkeypatch.setattr(stitch, "compose_mosaic", broken)
    out = _run(tmp_path, "harris.pano18")
    assert not out["correct"] and out["failed"] == out["attempted"] >= 1
    assert np.isfinite(out["compared"]["pairs_off"]["value"])


def test_stitch_many_entry_and_overrides(tmp_path):
    """A traffic whose requests hand several folders to ``stitch_many``,
    and a configuration that overrides the program's defaults, run
    correct with no change to the harness."""
    cell = small_cell("harris.pano18")
    cell.traffic["entry"] = "stitch_many"
    cell.traffic["pool"] = [{"sets": ["parrington", "grail"], "count": 1}]
    cell.traffic["shapes"]["grail"].update(images=3, width=80, height=112)
    cell.config["stitch_config"] = {"harris": {"max_points": 150}}
    out = run_cell(cell, SEED, 0.5, True, str(tmp_path), device="cpu")
    assert out["correct"] and out["attempted"] >= 1
    assert out["metrics"]["host_images_per_s"]["value"] > 0
