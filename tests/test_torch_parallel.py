"""PyTorch port, ``parallel/mesh.py`` and ``stitch_many(mesh=...)``: the
cases of ``tests/test_parallel.py`` on logical CPU slots (torch has one
CPU device, so a mesh repeats it; each slot still runs in a thread of its
own).

Sharded outputs equal the port's unsharded step bit for bit on every
leaf, and ``stitch_many`` on a mesh equals ``stitch_many`` without one
in shifts, pairs and panorama bytes.  ``tests/test_torch_parallel_jax.py``
holds the sharded step against the JAX package's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from vfx_image_stitching_tpu_torch.config import StitchConfig, config_from_dict
from vfx_image_stitching_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


def _small_sift():
    """``__graft_entry__._small_sift_config`` (JAX) and its port twin."""
    import __graft_entry__ as ge

    jcfg = ge._small_sift_config()
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


def _batch(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _chain(seed, n, h, w, step=4):
    """(n, h, w, 3) crops of one synthetic scene, ``step`` px apart: small
    images on which SIFT still matches every pair (uniform noise at 32x24
    gives it no match)."""
    from vfx_image_stitching_tpu_torch.utils.synthetic import make_scene

    scene = make_scene(h, w + (n - 1) * step, seed, block_px=30, block_size=(2, 6))
    return np.stack([scene[:, step * (n - 1 - i):step * (n - 1 - i) + w]
                     for i in range(n)])


def _leaves(tree):
    out = []
    M._tree_map(out.append, tree)
    return out


def _assert_bit_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a, b), i


@pytest.mark.parametrize("case", ["harris_8", "sift_8", "harris_11"])
def test_sharded_pairwise_shifts_matches_unsharded(case):
    """Harris 8x64x48, small-config SIFT 8x32x24 and Harris 11x64x48 (an
    uneven split) on 8 slots equal the unsharded step on every leaf."""
    if case == "sift_8":
        batch, cfg = _chain(2, 8, 32, 24), _small_sift()[1]
    else:
        n = 11 if case == "harris_11" else 8
        batch, cfg = _batch(2 if n == 11 else 0, (n, 64, 48, 3)), StitchConfig(backend="harris")
    mesh = M.make_mesh(8, devices=CPU8)
    got = M.sharded_pairwise_shifts(batch, mesh, cfg)
    want = M._pairwise_shift_step(torch.as_tensor(batch), cfg)
    assert got[0].shape[0] == batch.shape[0] - 1 and bool(want[3].any())
    _assert_bit_equal(got, want)


def test_shard_batch_splits_contiguously():
    mesh = M.make_mesh(devices=["cpu"] * 4)
    shards = M.shard_batch(np.arange(11), mesh)
    assert [s.numel() for s in shards] == [3, 3, 3, 2]
    assert torch.equal(torch.cat(shards), torch.arange(11))
    with pytest.raises(ValueError, match="no 'pano'"):
        M.shard_batch(np.arange(4), mesh, axis_name="pano")


def test_sharded_multi_pano_matches_unsharded():
    """The 2-D (pano, images) mesh of 8 slots is (2, 4); its minimal step
    over P=2 panoramas equals the unsharded multi-panorama step."""
    mesh2 = M.make_mesh_2d(8, devices=CPU8)
    assert mesh2.devices.shape == (2, 4) and mesh2.axis_names == ("pano", "images")
    assert all(d == torch.device("cpu") for d in mesh2.devices.flat)
    batch = torch.as_tensor(_batch(3, (2, 4, 64, 48, 3)))
    cfg = StitchConfig(backend="harris")
    _assert_bit_equal(M.sharded_multi_pano_shifts(batch, mesh2, cfg),
                      M._multi_pano_step(batch, cfg))
    assert M.make_mesh_2d(devices=["cpu"] * 3).devices.shape == (1, 3)


def test_sharded_multi_pano_full_matches_per_pano_step():
    """P=3 on the 2-wide pano axis of the 2-D mesh (uneven over the pano
    axis, each panorama's 4 images over a row of 4): every leaf of every
    panorama equals its unsharded ``_full_shift_step``, and ``mode="vmap"``
    gives the same leaves as the default."""
    _jcfg, cfg = _small_sift()
    batch = torch.as_tensor(np.stack([_chain(s, 4, 64, 48) for s in (3, 4, 5)]))
    mesh2 = M.make_mesh_2d(8, devices=CPU8)
    got = M.sharded_multi_pano_full(batch, mesh2, cfg)
    assert got[2] is not None and got[3] is not None  # SIFT meta and stats
    assert bool(got[4][3].all())
    for p in range(3):
        _assert_bit_equal(M._tree_map(lambda x: x[p], got),
                          M._full_shift_step(batch[p], cfg))
    _assert_bit_equal(M.sharded_multi_pano_full(batch, mesh2, cfg, mode="vmap"), got)
    with pytest.raises(ValueError, match="mode"):
        M.sharded_multi_pano_full(batch, mesh2, cfg, mode="pmap")


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Three 3-image chains of one shape and a 2-image chain of another:
    two groups for the sharded stitch."""
    from vfx_image_stitching_tpu_torch.utils.synthetic import synth_chain

    root = tmp_path_factory.mktemp("mesh")
    out = []
    for name, n, h, seed in (("pma", 3, 96, 3), ("pmb", 3, 96, 11),
                             ("pmc", 3, 96, 5), ("pmd", 2, 80, 9)):
        folder = str(root / name)
        os.makedirs(folder)
        synth_chain(folder, n, h, 128, seed=seed, focal=300.0)
        out.append(folder)
    return out


@pytest.mark.parametrize("layout", ["pano_2", "mesh_2d"])
@pytest.mark.parametrize("backend", ["harris", "sift"])
def test_stitch_many_mesh_matches_unsharded(layout, backend, folders):
    """``stitch_many`` on ``make_mesh_pano(2)`` (P=3 on 2 slots) and on the
    (2, 2) mesh equals ``stitch_many`` without a mesh: shifts, pairs,
    corrected shifts and panorama bytes; capacity hits are reported."""
    from vfx_image_stitching_tpu_torch import config as tc
    from vfx_image_stitching_tpu_torch.pipeline import stitch_many

    caps = tc.SiftCapacities(
        candidate_caps=(256,), localized_caps=(192,), oriented_caps=(192,),
        max_keypoints=384, max_radius=12, max_half_width=24,
        desc_small_half=14, desc_small_caps=(192,), desc_big_caps=(192,),
        desc_chunk=64)
    cfg = tc.StitchConfig(backend=backend, sift=tc.SiftConfig(capacities=caps))
    mesh = (M.make_mesh_pano(2, devices=["cpu"] * 2) if layout == "pano_2"
            else M.make_mesh_2d(4, devices=["cpu"] * 4))
    margins = {"pma": 2, "pmb": 2, "pmc": 2, "pmd": 2}
    got = stitch_many(folders, backend=backend, cfg=cfg, margins=margins, mesh=mesh)
    want = stitch_many(folders, backend=backend, cfg=cfg, margins=margins,
                       device="cpu")
    assert list(got) == list(want) == ["pma", "pmb", "pmc", "pmd"]
    for name in want:
        g, w = got[name], want[name]
        assert g.shifts == w.shifts and g.pairs == w.pairs
        assert g.corrected_shifts == w.corrected_shifts
        assert np.array_equal(g.panorama, w.panorama)
        assert (g.capacity_stats is None) == (w.capacity_stats is None)
        assert all(p is not None for p in g.pairs)
        assert g.timings["shift_stage"] >= 0 and g.timings["cumulative"] >= 0


def test_launch_counts_survive_slot_threads():
    """Slot threads launching at once lose no count: 16 threads add 2000
    each to one count, with the interpreter switching threads as often as
    it can."""
    import sys
    import threading

    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    def add():
        for _ in range(2000):
            K.count_launch("feas1_stack_sum")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        K.reset_launch_counts()
        threads = [threading.Thread(target=add) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert K.LAUNCHES["feas1_stack_sum"] == 32000
    finally:
        sys.setswitchinterval(old)
        K.reset_launch_counts()


def test_cuda_mesh_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (M.make_mesh, M.make_mesh_pano, M.make_mesh_2d):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(devices=["cuda:0"] * 2)
