"""The plain reference agrees with the program's CPU path on small sets,
and its lower-precision control does not."""

import numpy as np
import pytest

from bench_port.harness import check as C
from bench_port.harness import photosets as P
from bench_port.reference.lowp import bf16
from bench_port.reference.stitch import stitch as reference_stitch
from bench_port.tests.helpers import few_images_cell, small_cell

SEED = 2**31 + 23
CELLS = ["harris.pano18", "sift.pano18"]


def _sets(tmp_path, name, cell=None):
    cell = cell or small_cell(name)
    return cell, [r.sets[0] for r in P.make_pool(cell.traffic, SEED, str(tmp_path))]


def _program(s, backend, device="cpu"):
    from vfx_image_stitching_tpu_torch.pipeline.stitch import stitch_panorama

    return stitch_panorama(s.folder, backend=backend, crop_margin=s.margin,
                           device=device)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_program_on_cpu(tmp_path, name):
    """Same seam pairs, shifts within float32 noise, and the program's
    panorama is the reference's blend by the program's shifts."""
    cell, sets = _sets(tmp_path, name)
    backend = cell.config["backend"]
    for s in sets:
        got = _program(s, backend)
        images, focals = P.decoded(s)
        ref = reference_stitch(images, focals, backend, s.margin)
        for a, b in zip(got.shifts, ref.shifts):
            assert a == pytest.approx(b, abs=C.TOL_PX)
        numbers = C.compare(C.Answer(got.shifts, got.pairs, got.corrected_shifts,
                                     got.panorama), ref, s.margin)
        assert numbers["pairs_off"] == 0 and numbers["pano_off_pct"] == 0
        assert C.judge(numbers, cell.config["limits"])


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_is_not_correct(tmp_path, name):
    """The reference with its fields stored in bfloat16, put in the
    program's place, fails the cell's comparison: on four images of the
    cell's own size, one set of each shape."""
    cell, sets = _sets(tmp_path, name, few_images_cell(name, 4, 2))
    backend = cell.config["backend"]
    readings = []
    for s in sets:
        images, focals = P.decoded(s)
        ref = reference_stitch(images, focals, backend, s.margin)
        ctl = reference_stitch(images, focals, backend, s.margin, "bf16")
        readings.append(C.compare(C.Answer(ctl.shifts, ctl.pairs,
                                           ctl.corrected_shifts, ctl.panorama),
                                  ref, s.margin))
    assert not C.judge(C.worst(readings), cell.config["limits"])


def test_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.00390625, 1.005859375, 1.0078125, 255.5, -3.3], np.float32)
    got = bf16(x)
    assert got.tolist() == [1.0, 1.0, 1.0078125, 1.0078125, 256.0, -3.296875]


def test_pano_judged_by_the_programs_own_shifts(tmp_path):
    """A panorama blended by other shifts than the program reported is
    off, though the reference's own shifts are not involved."""
    cell, sets = _sets(tmp_path, "harris.pano18")
    s = sets[0]
    got = _program(s, "harris")
    images, focals = P.decoded(s)
    ref = reference_stitch(images, focals, "harris", s.margin)
    moved = [(dx, dy + 3.0) for dx, dy in got.corrected_shifts]
    numbers = C.compare(C.Answer(got.shifts, got.pairs, moved, got.panorama),
                        ref, s.margin)
    assert numbers["pairs_off"] == len(moved)
    assert numbers["pano_off_pct"] > cell.config["limits"]["pano_off_pct"]


@pytest.mark.cuda
def test_program_on_the_card_agrees_with_reference(tmp_path):
    """On the card: the program's answers pass the cell's comparison."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in CELLS:
        cell, sets = _sets(tmp_path / name, name)
        for s in sets:
            got = _program(s, cell.config["backend"], "cuda")
            images, focals = P.decoded(s)
            ref = reference_stitch(images, focals, cell.config["backend"], s.margin)
            numbers = C.compare(C.Answer(got.shifts, got.pairs,
                                         got.corrected_shifts, got.panorama),
                                ref, s.margin)
            assert C.judge(numbers, cell.config["limits"])
