"""PyTorch port, ``pipeline/multi.py``: ``stitch_many`` against the loop
of ``stitch_panorama`` over the same folders (both backends), against the
JAX package's ``stitch_many`` (Harris, op by op under
``jax.disable_jit()``), and its ``mesh`` argument's type check (the
sharded runs are in ``tests/test_torch_parallel.py``).
"""

import os

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

H, W = 96, 128


def _caps(mod):
    """Small SIFT capacities, one per stage for every octave."""
    return mod.SiftCapacities(
        candidate_caps=(256,), localized_caps=(192,), oriented_caps=(192,),
        max_keypoints=384, max_radius=12, max_half_width=24,
        desc_small_half=14, desc_small_caps=(192,), desc_big_caps=(192,),
        desc_chunk=64,
    )


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Two 4-image chains, and a ``wind``-like folder whose pano.txt has
    an image line with no focal length (the parser drops it, so one image
    remains and the panorama is that image alone)."""
    from vfx_image_stitching_tpu_torch.utils.synthetic import synth_chain

    root = tmp_path_factory.mktemp("multi")
    out = []
    for name, n, seed in (("chain_a", 4, 3), ("chain_b", 4, 11), ("wind", 2, 5)):
        folder = str(root / name)
        os.makedirs(folder)
        synth_chain(folder, n, H, W, seed=seed, focal=300.0)
        out.append(folder)
    pano = os.path.join(out[-1], "pano.txt")
    lines = open(pano).read().split("\n")
    with open(pano, "w") as f:
        f.write("\n".join([lines[0], lines[2], lines[3]]) + "\n")
    return out


@pytest.mark.parametrize("backend", ["harris", "sift"])
def test_stitch_many_equals_stitch_panorama_loop(backend, folders):
    from vfx_image_stitching_tpu_torch import config as tc
    from vfx_image_stitching_tpu_torch.pipeline import (
        stitch_many,
        stitch_panorama,
    )

    cfg = tc.StitchConfig(backend=backend,
                          sift=tc.SiftConfig(capacities=_caps(tc)))
    res = stitch_many(folders, backend=backend, cfg=cfg, device="cpu")
    assert list(res) == ["chain_a", "chain_b", "wind"]
    for folder, (name, got) in zip(folders, res.items()):
        margin = tc.DEFAULT_CROP_MARGINS.get(name, 15)
        want = stitch_panorama(folder, backend=backend, cfg=cfg,
                               crop_margin=margin, device="cpu")
        assert got.shifts == want.shifts and got.pairs == want.pairs
        assert got.corrected_shifts == want.corrected_shifts
        assert np.array_equal(got.panorama, want.panorama)
        assert np.array_equal(got.mosaic, want.mosaic)
        assert got.capacity_stats is None and want.capacity_stats is None
        for key in ("project", "extract", "pairs", "finalize", "compose",
                    "total", "load_wait", "cumulative"):
            assert got.timings[key] >= 0
    assert all(p is not None for p in res["chain_a"].pairs + res["chain_b"].pairs)
    assert res["wind"].shifts == [] and res["wind"].pairs == []


def test_stitch_many_mesh_raises(folders):
    """A mesh that is not the port's (a JAX mesh, say) raises."""
    from vfx_image_stitching_tpu_torch.pipeline import stitch_many

    with pytest.raises(TypeError, match="parallel Mesh"):
        stitch_many(folders, mesh=object(), device="cpu")


def test_stitch_many_harris_matches_jax(folders):
    from vfx_image_stitching_tpu.pipeline.multi import stitch_many as jmany
    from vfx_image_stitching_tpu_torch.pipeline import stitch_many

    got = stitch_many(folders[:1], backend="harris", device="cpu")
    with jax.disable_jit():
        want = jmany(folders[:1], backend="harris")
    assert list(got) == list(want)
    for name in got:
        assert got[name].shifts == want[name].shifts
        assert got[name].pairs == want[name].pairs
        assert np.array_equal(got[name].panorama, want[name].panorama)
