"""PyTorch port: the batched SIFT schedule (``mode="vmap"``), which runs
every stage of every octave once over all N images, against the
one-image schedule (``mode="map"``), which the other test files hold to
the JAX package.

The two schedules are held bit for bit on every leaf of
``sift_batch_with_stats``, on an uneven batch: a busy image that fills
capacities, a nearly blank one (dead chunks, empty octaves: the batch's
live-row bound exceeds its own) and one between.  The batched plain
versions of K1-K4 (one (N*L, H, W) stack, or K1's (N, L, H, W) batch with
an image index per row) equal per-image calls, and K1's walk never
leaves its image.  ``VFX_SIFT_BATCH_MODE=vmap`` gives the map stitch's
shifts, pairs and bytes.  This file imports no JAX: the GPU tests
(tests/test_torch_cuda.py) take its inputs.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

H, W = 96, 128


def small_caps(**kw):
    """Small capacities (both descriptor buckets live at H x W)."""
    from vfx_image_stitching_tpu_torch.config import SiftCapacities

    caps = dict(
        candidate_caps=(256, 128, 64), localized_caps=(128, 64),
        oriented_caps=(128, 64), max_keypoints=256, max_radius=12,
        max_half_width=24, desc_small_half=20, desc_small_caps=(128, 64),
        desc_big_caps=(64,), desc_chunk=64)
    caps.update(kw)
    return SiftCapacities(**caps)


def uneven_batch(h=H, w=W, device="cpu") -> torch.Tensor:
    """(3, h, w) f32 gray: busy (fills the oriented and big-bucket caps of
    :func:`small_caps` at octave 0), nearly blank (one blob), between."""
    from vfx_image_stitching_tpu_torch.utils.synthetic import make_scene

    busy = make_scene(h, w, 3, block_px=40, block_size=(2, 5))[..., 1]
    blank = np.full((h, w), 90, np.uint8)
    blank[h // 2 - 3:h // 2 + 3, w // 2 - 4:w // 2 + 4] = 200
    mid = make_scene(h, w, 4)[..., 1]
    return torch.as_tensor(np.stack([busy, blank, mid]).astype(np.float32),
                           device=device)


def leaves(out) -> list:
    """The tensors of ``sift_batch_with_stats``' output, in a fixed order."""
    xy, desc, valid, meta, stats = out
    return ([("xy", xy), ("desc", desc), ("valid", valid)]
            + [(f"meta.{k}", meta[k]) for k in sorted(meta)]
            + [(f"stats.{k}", stats[k]) for k in sorted(stats)])


def octave0_stacks(batch: torch.Tensor):
    """Octave 0 of every image of an (N, h, w) gray batch: the (N, 5, 2h,
    2w) DoG stacks and the (N, 3, 2h, 2w) gradient fields of layers 1-3."""
    from vfx_image_stitching_tpu_torch.models.sift import pyramid as tp

    base = tp.generate_base_image(batch)
    gauss = tp.generate_gaussian_images(
        base, 1, tp.generate_gaussian_kernels(1.6, 3))[0]
    mag, ang = tp.gradient_fields(gauss[:, 1:4])
    return tp.generate_dog_images([gauss])[0], mag, ang


def edge_dog_batch(device="cpu", n=3, h=21, w=131, seed=2):
    """(n, 5, h, w) random stacks, each image's values offset by 10^4 from
    its neighbours', so a walk that reached into another image's stack
    would see a step of 10^4 and move elsewhere; and the stacks without
    the offsets, whose extrema are the candidates."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(-80, 80, (n, 5, h, w)).astype(np.float32)
    dog = raw + 1e4 * np.arange(n, dtype=np.float32)[:, None, None, None]
    return torch.as_tensor(dog, device=device), torch.as_tensor(raw, device=device)


def newton_batch_args(dog: torch.Tensor, search: torch.Tensor, cap: int = 256):
    """K1's batched arguments for the (N, 5, H, W) stacks ``dog``: every
    image's candidates (the extrema of ``search``) flattened, with each
    row's image index, and each image's (cap,) candidates."""
    from vfx_image_stitching_tpu_torch.models.sift import extrema as te
    from vfx_image_stitching_tpu_torch.models.sift.chunking import batch_rows

    per = [te.extract_candidates(s, 5, 1.0, cap) for s in search]
    cand = [torch.stack([p[j] for p in per]) for j in range(4)]
    rows, img = batch_rows(dog, *cand)
    return rows, img, per


def orientation_batch_args(mag: torch.Tensor, ang: torch.Tensor, k: int = 200,
                           half: int = 12, seed: int = 5):
    """K2/K4 arguments over the (N*3, H, W) stack of (N, 3, H, W) fields:
    per image k rows, centres inside and just past every edge (the top
    and bottom rows of each layer included), radii 0..half+2; and each
    image's own (3, H, W) arguments."""
    rng = np.random.default_rng(seed)
    n_img, n_l, h, w = mag.shape
    dev = mag.device
    per = []
    for _ in range(n_img):
        lyr = rng.integers(0, n_l, k)
        cy = rng.integers(-3, h + 3, k)
        cy[:8] = (0, 1, h - 2, h - 1, 0, h - 1, 2, h - 3)
        cx = rng.integers(-3, w + 3, k)
        rad = rng.integers(0, half + 3, k)
        wf = (-0.5 / (rng.random(k) * 4 + 1) ** 2).astype(np.float32)
        valid = rng.random(k) > 0.2
        per.append([torch.as_tensor(a.astype(np.int32), device=dev)
                    for a in (lyr, cy, cx, rad)]
                   + [torch.as_tensor(wf, device=dev),
                      torch.as_tensor(valid, device=dev)])
    flat = [torch.cat([p[j] for p in per]) for j in range(6)]
    img = torch.arange(n_img, dtype=torch.int32, device=dev).repeat_interleave(k)
    flat[0] = flat[0] + img * n_l
    stacks = (mag.reshape(-1, h, w), ang.reshape(-1, h, w))
    return (*stacks, *flat), per


def test_live_rows_batch_bound():
    """One image: the live chunks' rows, no per-image bound; a batch: the
    largest image's, each image's own on the device; finish_rows zeroes
    each image's rows past its own bound and pads."""
    from vfx_image_stitching_tpu_torch.models.sift.chunking import (
        finish_rows, live_chunk_bound, live_rows,
    )
    from vfx_image_stitching_tpu_torch.models.sift.localize import Localized

    valid = torch.zeros((3, 40), dtype=torch.bool)
    valid[0, [0, 17]] = True
    valid[2, 3] = True
    n_rows, own = live_rows(valid, 8)
    assert n_rows == 24 and own.tolist() == [24, 0, 8]
    for i in range(3):
        assert live_rows(valid[i], 8) == (8 * live_chunk_bound(valid[i], 8), None)
    fields = Localized(*[torch.ones((3, 24), dtype=torch.int32)] * 12)
    out = finish_rows(fields, own, 40)
    for f in out:
        assert f.shape == (3, 40)
        assert f.sum(1).tolist() == [24, 0, 8]


def test_batched_extrema_candidates_equal_per_image():
    """The (N, 5, H, W) candidate search gives each image's (layer, y, x,
    valid) rows of the one-image search."""
    from vfx_image_stitching_tpu_torch.models.sift import extrema as te

    dog = octave0_stacks(uneven_batch())[0]
    got = te.extract_candidates(dog, 5, te.extrema_threshold(0.04, 3), 256)
    for i in range(dog.shape[0]):
        want = te.extract_candidates(dog[i], 5, te.extrema_threshold(0.04, 3), 256)
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)
    counts = got[3].sum(1).tolist()
    assert counts[0] > counts[2] > counts[1]


@pytest.mark.parametrize("case", ["octave0", "edge"])
def test_batched_newton_plain_equals_per_image(case):
    """K1's plain version over a batch of stacks (an image index per row)
    gives each image's lanes of the one-stack call, through the wrapper
    too; on random stacks 10^4 apart, candidates on the bottom and top
    layers beside the next image's stack walk, move across layers and
    are rejected at their own stack's layer bounds, as alone."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    if case == "octave0":
        dog = search = octave0_stacks(uneven_batch())[0]
    else:
        dog, search = edge_dog_batch()
    (layer, y, x, valid), img, per = newton_batch_args(dog, search)
    got = K.localize_newton_plain(dog, layer, y, x, valid, 5, 3, 5, img=img)
    via = K.localize_newton_resident(dog, layer, y, x, valid, 5, 3, 5, img=img)
    assert all(torch.equal(a, b) for a, b in zip(got, via))
    cap = per[0][0].shape[0]
    for i, cand in enumerate(per):
        want = K.localize_newton_plain(dog[i], *cand, 5, 3, 5)
        for g, w in zip(got, want):
            assert torch.equal(g[i * cap:(i + 1) * cap], w)
    if case == "edge":
        lanes = got[0][valid]
        start = layer[valid]
        assert bool(((start == 1) | (start == 3)).any())
        moved = lanes[:, 2] != start
        assert bool(moved.any())
        assert bool((lanes[:, 7] == 1).any())


def test_newton_inputs_checks_batch():
    """A batch of stacks needs an int32 image index of the rows' length;
    one stack takes none."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    dog, search = edge_dog_batch()
    (layer, y, x, valid), img, _per = newton_batch_args(dog, search)
    with pytest.raises(ValueError):
        K.localize_newton_resident(dog, layer, y, x, valid, 5, 3, 5)
    with pytest.raises(TypeError):
        K.localize_newton_resident(dog, layer, y, x, valid, 5, 3, 5,
                                   img=img.long())
    with pytest.raises(ValueError):
        K.localize_newton_resident(dog, layer, y, x, valid, 5, 3, 5,
                                   img=img[:-1])
    with pytest.raises(ValueError):
        K.localize_newton_resident(dog[0], layer, y, x, valid, 5, 3, 5, img=img)


@pytest.mark.parametrize("half", [12, 30])
def test_batched_orientation_and_window_plain_equal_per_image(half):
    """K2/K4's plain version and K3's over the (N*3, H, W) stack, each row
    at its image's layers, equal the per-image calls (windows at every
    layer edge: rows clamp and zero-fill within the row's own layer)."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    _dog, mag, ang = octave0_stacks(uneven_batch(48, 64))
    args, per = orientation_batch_args(mag, ang, half=half)
    k = per[0][0].shape[0]
    hist = K.orientation_histograms_plain(*args, half, 36)
    assert torch.equal(hist, K.orientation_histograms(*args, half, 36))
    assert torch.equal(hist, K.orientation_histograms_v1(*args, half, 36))
    win = K.pair_window_gather_plain(*args[:5], half)
    assert all(torch.equal(a, b)
               for a, b in zip(win, K.pair_window_gather(*args[:5], half)))
    for i, p in enumerate(per):
        rows = slice(i * k, (i + 1) * k)
        assert torch.equal(hist[rows], K.orientation_histograms_plain(
            mag[i], ang[i], *p, half, 36))
        want = K.pair_window_gather_plain(mag[i], ang[i], *p[:3], half)
        for g, w in zip(win, want):
            assert torch.equal(g[rows], w)
    assert int((hist.sum(1) > 0).sum()) > 100


@pytest.mark.parametrize("case", ["bucketed", "one_bucket", "orient_v1"])
def test_vmap_equals_map_every_leaf(case, monkeypatch):
    """``sift_batch_with_stats(batch, cfg, "vmap")`` equals ``"map"`` on
    every leaf, bit for bit, on the uneven batch: the busy image reaches
    the oriented and big-bucket caps, the blank one finds almost nothing
    (its own live rows stay under the batch's), the stats differ per
    image.  Also without the size buckets and with the v1 orientation
    kernel's route; ``sift_batch`` is the same function's first three."""
    from vfx_image_stitching_tpu_torch.config import SiftConfig
    from vfx_image_stitching_tpu_torch.models.sift import extract as te

    caps = small_caps(desc_bucketed=case != "one_bucket")
    if case == "orient_v1":
        monkeypatch.setenv("VFX_ORIENT_V2", "0")
    cfg = SiftConfig(capacities=caps)
    batch = uneven_batch()
    want = te.sift_batch_with_stats(batch, cfg, "map")
    got = te.sift_batch_with_stats(batch, cfg, "vmap")
    for (name, g), (_n, w) in zip(leaves(got), leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    for g, w in zip(te.sift_batch(batch, cfg, "vmap"), want[:3]):
        assert torch.equal(g, w)
    stats = want[4]
    final = stats["final_count"].tolist()
    assert final[0] > 100 and 0 < final[1] < 5 and 20 < final[2] < final[0]
    full = stats["oriented_counts"] >= stats["oriented_caps"]
    assert full[0].any() and not full[1:].any()
    if case != "one_bucket":
        big = stats["desc_big_counts"] >= stats["desc_big_caps"]
        assert big[0].any() and not big[1:].any()
        small = want[2].sum(1) - stats["desc_big_counts"].sum(1)
        assert bool((small[[0, 2]] > 0).all())


def test_vmap_mode_other_than_map_and_vmap_runs_map():
    """A mode other than ``"map"`` and ``"vmap"`` keeps the one-image
    schedule (as before the batched schedule existed)."""
    from vfx_image_stitching_tpu_torch.config import SiftConfig
    from vfx_image_stitching_tpu_torch.models.sift import extract as te

    cfg = SiftConfig(capacities=small_caps())
    batch = uneven_batch(48, 64)[[0, 2]]
    want = te.sift_batch_with_stats(batch, cfg, "map")
    got = te.sift_batch_with_stats(batch, cfg, "scan")
    assert all(torch.equal(g, w) for (_a, g), (_b, w) in zip(leaves(got),
                                                             leaves(want)))


def test_vmap_stitch_equals_map_stitch(tmp_path, monkeypatch):
    """``stitch_panorama(..., backend="sift", device="cpu")`` with
    ``VFX_SIFT_BATCH_MODE=vmap``: the map stitch's shifts, pairs,
    escalation counts and panorama bytes; the variable reaches the
    extraction."""
    from vfx_image_stitching_tpu_torch.config import StitchConfig
    from vfx_image_stitching_tpu_torch.models.sift import extract as te
    from vfx_image_stitching_tpu_torch.pipeline.stitch import stitch_panorama
    from vfx_image_stitching_tpu_torch.utils.synthetic import synth_chain

    synth_chain(str(tmp_path), 3, 80, 112, seed=21, focal=260.0)
    cfg = StitchConfig(backend="sift")
    cfg = dataclasses.replace(cfg, sift=dataclasses.replace(
        cfg.sift, capacities=small_caps(candidate_caps=(512, 256, 128, 64),
                                        localized_caps=(256, 128, 64),
                                        oriented_caps=(256, 128, 64),
                                        max_keypoints=512)))
    modes = []
    real = te.sift_batch_with_stats

    def spy(batch, scfg, mode="map"):
        modes.append(mode)
        return real(batch, scfg, mode)

    monkeypatch.setattr(te, "sift_batch_with_stats", spy)
    runs = {}
    for mode in ("map", "vmap"):
        monkeypatch.setenv("VFX_SIFT_BATCH_MODE", mode)
        runs[mode] = stitch_panorama(str(tmp_path), backend="sift", cfg=cfg,
                                     crop_margin=8, device="cpu")
    assert modes == ["map", "vmap"]
    a, b = runs["map"], runs["vmap"]
    assert len(a.shifts) == 2 and all(p is not None for p in a.pairs)
    assert a.shifts == b.shifts and a.pairs == b.pairs
    for key in ("esc_n_pairs", "esc_n_rows"):
        assert a.timings[key] == b.timings[key]
    assert np.array_equal(a.panorama, b.panorama)
