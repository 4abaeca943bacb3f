"""The pano18 generator: drawn offsets inside the reference sets' ranges,
and the program's stitched shifts near them."""

import copy
import os

import numpy as np
import pytest

from bench_port.harness import photosets as P
from bench_port.harness.spec import load_cell

SEED = 2**31 + 11


def _traffic(images: int):
    traffic = copy.deepcopy(load_cell("harris.pano18").traffic)
    for shape in traffic["shapes"].values():
        shape["images"] = images
    return traffic


def test_offsets_and_focals_in_range(tmp_path):
    traffic = _traffic(images=3)
    pool = P.make_pool(traffic, SEED, str(tmp_path))
    assert [r.sets[0].shape for r in pool] == ["parrington"] * 4 + ["grail"] * 4
    for req in pool:
        (s,) = req.sets
        shape = traffic["shapes"][s.shape]
        lo_x, hi_x = sorted(shape["dx"])
        lo_y, hi_y = sorted(shape["dy"])
        assert all(lo_x <= dx <= hi_x and lo_y <= dy <= hi_y for dx, dy in s.offsets)
        assert all(min(shape["focal"]) <= f <= max(shape["focal"]) for f in s.focals)
        images, focals = P.decoded(s)
        assert focals == s.focals
        assert all(im.shape == (shape["height"], shape["width"], 3) for im in images)


def test_same_seed_same_sets(tmp_path):
    traffic = _traffic(images=2)
    a = P.make_pool(traffic, SEED, str(tmp_path / "a"))
    b = P.make_pool(traffic, SEED, str(tmp_path / "b"))
    c = P.make_pool(traffic, SEED + 1, str(tmp_path / "c"))
    for x, y in zip(a, b):
        assert x.sets[0].offsets == y.sets[0].offsets
        for i in range(2):
            name = P.image_name(x.sets[0].shape, i)
            with open(os.path.join(x.sets[0].folder, name), "rb") as fa, \
                    open(os.path.join(y.sets[0].folder, name), "rb") as fb:
                assert fa.read() == fb.read()
    assert a[0].sets[0].offsets != c[0].sets[0].offsets


def test_missing_focal_drops_the_image(tmp_path):
    traffic = _traffic(images=2)
    traffic["shapes"]["parrington"]["focal_missing"] = [0]
    traffic["pool"] = [{"sets": ["parrington"], "count": 1}]
    (req,) = P.make_pool(traffic, SEED, str(tmp_path))
    assert req.images == 1
    from vfx_image_stitching_tpu_torch.io import read_pano_data

    paths, focals = read_pano_data(os.path.join(req.sets[0].folder, "pano.txt"))
    assert paths == [P.image_name("parrington", 1)] and len(focals) == 1


def test_program_shifts_near_drawn_offsets(tmp_path):
    """Four full-size images of each shape, stitched by the program with
    Harris on the CPU.  Tolerance 1.5 px per coordinate: Harris corners
    sit on whole pixels (the difference of two roundings, up to 1 px),
    and the forward projection rounds each pixel to the nearest (up to
    0.5 px more)."""
    from vfx_image_stitching_tpu_torch.pipeline.stitch import stitch_panorama

    traffic = _traffic(images=4)
    traffic["pool"] = [{"sets": ["parrington"], "count": 1},
                       {"sets": ["grail"], "count": 1}]
    for req in P.make_pool(traffic, SEED, str(tmp_path)):
        (s,) = req.sets
        res = stitch_panorama(s.folder, backend="harris", crop_margin=s.margin,
                              device="cpu")
        got = np.array(res.shifts)
        want = np.array(s.offsets)
        assert np.abs(got - want).max() <= 1.5, (got, want)


def test_every_request_lists_new_focal_lengths(tmp_path):
    """The n-th request's pano.txt lists each drawn focal moved by n
    steps, so no focal length repeats within a run, and the program reads
    them back as written."""
    from vfx_image_stitching_tpu_torch.io import read_pano_data

    traffic = _traffic(images=3)
    pool = P.make_pool(traffic, SEED, str(tmp_path))
    step = traffic["focal_step"]
    seen = set()
    for n in range(3 * len(pool)):
        s = pool[n % len(pool)].sets[0]
        focals = P.request_focals(s, n, step)
        P.write_pano(s, focals)
        _paths, read = read_pano_data(os.path.join(s.folder, "pano.txt"))
        assert np.allclose(read, focals, rtol=0, atol=1e-9)
        assert not seen & set(read)
        seen |= set(read)
    with pytest.raises(ValueError):
        P.request_focals(pool[0].sets[0], int(1e-3 / step), step)
