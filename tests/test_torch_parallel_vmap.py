"""PyTorch port, ``parallel/mesh.py``: the batched multi-panorama steps.

``sharded_multi_pano_full(mode="vmap")`` and ``sharded_multi_pano_shifts``
run all of a mesh row's panoramas at once: each slot extracts its shard
of every panorama in one batched pass and matches all their local pairs
in one pair step.  ``mode="shard_map"`` (the default) runs them one
panorama after another.  Here the two modes are held bit for bit on
every leaf, for SIFT and Harris, on an uneven batch (a dense panorama,
one with a nearly blank image, one with an image that fills a capacity)
over a 2-D mesh, a one-slot and a two-slot pano mesh; the one-device
steps ``_multi_pano_full_step`` / ``_multi_pano_step`` against the stack
of the per-panorama steps; the calls each slot makes; and
``stitch_many(mesh=...)`` against the unsharded ``stitch_many`` in both
SIFT schedules.  No JAX computation runs here
(``tests/test_torch_parallel_vmap_jax.py`` holds the steps against the
JAX package's).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import (  # noqa: F401 (folders: a fixture)
    _assert_bit_equal,
    _chain,
    _small_sift,
    folders,
)
from vfx_image_stitching_tpu_torch.config import StitchConfig
from vfx_image_stitching_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)

H, W = 64, 48
LAYOUTS = ("mesh_2d_8", "pano_1", "pano_2")


def uneven_batch() -> torch.Tensor:
    """(3, 4, 64, 48, 3) uint8: a dense chain; a chain whose third image is
    nearly blank (one blob); a chain whose second image is 3-px random
    blocks, which fill ``_small_sift``'s oriented capacity at octave 0."""
    dense = _chain(3, 4, H, W)
    blank = _chain(4, 4, H, W)
    blank[2] = 90
    blank[2, 29:35, 20:28] = 200
    full = _chain(5, 4, H, W)
    blocks = np.random.default_rng(1).integers(0, 256, (H // 3 + 1, W // 3 + 1, 3))
    full[1] = blocks.astype(np.uint8).repeat(3, 0).repeat(3, 1)[:H, :W]
    return torch.as_tensor(np.stack([dense, blank, full]))


def config(backend: str) -> StitchConfig:
    return _small_sift()[1] if backend == "sift" else StitchConfig(backend="harris")


def make(layout: str) -> M.Mesh:
    if layout == "mesh_2d_8":
        return M.make_mesh_2d(8, devices=["cpu"] * 8)
    return M.make_mesh_pano(devices=["cpu"] * int(layout[-1]))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("backend", ["sift", "harris"])
def test_modes_agree(backend, layout):
    """``mode="vmap"`` equals ``mode="shard_map"`` on every leaf of the
    uneven batch: P=3 over the 2 rows of the (2, 4) mesh (2 and 1), over
    one slot holding every panorama, and over two slots."""
    batch, cfg, mesh = uneven_batch(), config(backend), make(layout)
    got = M.sharded_multi_pano_full(batch, mesh, cfg, mode="vmap")
    want = M.sharded_multi_pano_full(batch, mesh, cfg)
    assert got[4][0].shape[:2] == (3, 3) and bool(got[4][3].any())
    assert (got[2] is None) == (backend == "harris")
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("backend", ["sift", "harris"])
def test_steps_match_per_pano_steps(backend, full):
    """``_multi_pano_full_step`` / ``_multi_pano_step`` (one batched
    extraction, one pair step) equal the stack of the per-panorama
    ``_full_shift_step`` / ``_pairwise_shift_step`` on every leaf; the
    batch is uneven (one image at a capacity, a nearly blank one)."""
    batch, cfg = uneven_batch(), config(backend)
    step, one = ((M._multi_pano_full_step, M._full_shift_step) if full
                 else (M._multi_pano_step, M._pairwise_shift_step))
    got = step(batch, cfg)
    want = M._tree_map(lambda *xs: torch.stack(xs), *(one(b, cfg) for b in batch))
    _assert_bit_equal(got, want)
    if backend == "sift" and full:
        stats, valid = got[3], got[1]
        at_cap = stats["oriented_counts"] >= stats["oriented_caps"]
        assert at_cap[..., 0].nonzero().tolist() == [[2, 1]]
        assert int(valid[1, 2].sum()) < 8 < int(valid[1, [0, 1, 3]].sum(-1).min())


@pytest.mark.parametrize("layout", ["mesh_2d_8", "pano_2"])
@pytest.mark.parametrize("backend", ["sift", "harris"])
def test_sharded_multi_pano_shifts_matches_step(backend, layout):
    """``sharded_multi_pano_shifts`` (always batched, as the JAX vmap)
    equals the one-device ``_multi_pano_step`` on every leaf."""
    batch, cfg = uneven_batch(), config(backend)
    _assert_bit_equal(M.sharded_multi_pano_shifts(batch, make(layout), cfg),
                      M._multi_pano_step(batch, cfg))


# per layout and mode: the (P, N) of each slot's extraction calls and the
# pairs of each pair-step call, for P=3 panoramas of N=4 images
CALLS = {
    ("pano_1", "vmap"): ([(3, 4)], [9]),
    ("pano_1", "shard_map"): ([(1, 4)] * 3, [3] * 3),
    ("pano_2", "vmap"): ([(1, 4), (2, 4)], [3, 6]),
    ("pano_2", "shard_map"): ([(1, 4)] * 3, [3] * 3),
    ("mesh_2d_8", "vmap"): ([(1, 1)] * 4 + [(2, 1)] * 4, [0, 0, 1, 1, 1, 2, 2, 2]),
    ("mesh_2d_8", "shard_map"): ([(1, 1)] * 12, [0] * 3 + [1] * 9),
    ("one_device", "vmap"): ([(3, 4)], [9]),
}


@pytest.mark.parametrize("layout,mode", list(CALLS))
def test_one_pass_per_slot(layout, mode, monkeypatch):
    """Under ``mode="vmap"`` each slot makes one extraction call, over its
    shard of every panorama of its row, in SIFT's batched schedule, and
    one pair-step call over all their local pairs, whatever P; under
    ``"shard_map"`` one of each per panorama, the SIFT schedule left to
    ``VFX_SIFT_BATCH_MODE`` (unset: ``map``).  ``one_device`` is
    ``_multi_pano_full_step``."""
    from vfx_image_stitching_tpu_torch.models.sift import extract as te

    monkeypatch.delenv("VFX_SIFT_BATCH_MODE", raising=False)
    extracts, pairs, sift = [], [], []

    def count(fn, log, what):
        def wrapped(*args, **kw):
            log.append(what(*args, **kw))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(M, "_extract", count(
        M._extract, extracts, lambda cyl, *_a: tuple(cyl.shape[:2])))
    monkeypatch.setattr(M, "_pair_shift", count(
        M._pair_shift, pairs, lambda xy, *_a, **_k: xy.shape[0]))
    monkeypatch.setattr(te, "sift_batch_with_stats", count(
        te.sift_batch_with_stats, sift, lambda b, _c, m="map": (b.shape[0], m)))
    batch, cfg = uneven_batch(), config("sift")
    if layout == "one_device":
        M._multi_pano_full_step(batch, cfg)
    else:
        M.sharded_multi_pano_full(batch, make(layout), cfg, mode=mode)
    want_extracts, want_pairs = CALLS[layout, mode]
    assert sorted(extracts) == want_extracts
    assert sorted(pairs) == want_pairs
    schedule = "vmap" if mode == "vmap" else "map"
    assert sorted(sift) == sorted((p * n, schedule) for p, n in want_extracts)


@pytest.mark.parametrize("schedule", ["map", "vmap"])
def test_stitch_many_mesh_keeps_default_mode(schedule, folders, monkeypatch):
    """``stitch_many(folders, mesh=...)`` calls ``sharded_multi_pano_full``
    with its default mode and gives the unsharded ``stitch_many``'s
    shifts, pairs and bytes, in either SIFT schedule."""
    from vfx_image_stitching_tpu_torch import config as tc
    from vfx_image_stitching_tpu_torch.pipeline import stitch_many

    monkeypatch.setenv("VFX_SIFT_BATCH_MODE", schedule)
    modes = []
    full = M.sharded_multi_pano_full

    def record(*args, **kw):
        modes.append(kw.get("mode", "shard_map"))
        return full(*args, **kw)

    monkeypatch.setattr(M, "sharded_multi_pano_full", record)
    caps = tc.SiftCapacities(
        candidate_caps=(256,), localized_caps=(192,), oriented_caps=(192,),
        max_keypoints=384, max_radius=12, max_half_width=24,
        desc_small_half=14, desc_small_caps=(192,), desc_big_caps=(192,),
        desc_chunk=64)
    cfg = tc.StitchConfig(backend="sift", sift=tc.SiftConfig(capacities=caps))
    margins = dict.fromkeys(("pma", "pmb", "pmc", "pmd"), 2)
    got = stitch_many(folders, backend="sift", cfg=cfg, margins=margins,
                      mesh=M.make_mesh_pano(2, devices=["cpu"] * 2))
    want = stitch_many(folders, backend="sift", cfg=cfg, margins=margins,
                       device="cpu")
    assert modes == ["shard_map", "shard_map"]
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.shifts == w.shifts and g.pairs == w.pairs
        assert np.array_equal(g.panorama, w.panorama)
