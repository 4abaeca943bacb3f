"""PyTorch port, the stitch surface beyond the main path: the stage split
of ``pipeline/stitch.py`` (its device fold against the host fold, step
capture, save, profile), ``compat``, the ``sift_impl``-named stages and extractors, the
capacity audit, ``utils/metrics``, ``utils/profiling`` and the CLI.

The JAX side runs op by op (``jax.disable_jit()``), the port with
``device="cpu"``.  Every SIFT comparison uses one image shape (H, W) and
small capacities (``_caps``), so the JAX side compiles its
per-operation programs once for the file.  Contracts as in
ROADMAP: integer, mask and byte outputs exact; size, angle and response
to rtol 1e-5; Harris descriptors and gradient angles to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import oracles
from tests.test_compose import _assert_blend_parity

torch.set_num_threads(1)

H, W, N, FOCAL, SEED = 80, 112, 3, 260.0, 21


def _caps(mod):
    """Small capacities, one per stage for every octave: the octaves then
    share their capacity-shaped programs, which halves the JAX side's
    compile time."""
    return mod.SiftCapacities(
        candidate_caps=(128,), localized_caps=(96,), oriented_caps=(96,),
        max_keypoints=256, max_radius=12, max_half_width=24,
        desc_small_half=14, desc_small_caps=(96,), desc_big_caps=(96,),
        desc_chunk=32,
    )


def _sift_cfg(mod):
    return mod.SiftConfig(capacities=_caps(mod))


@pytest.fixture(scope="module")
def pair():
    """Two overlapping (H, W) BGR crops of one scene (dx = -40)."""
    from vfx_image_stitching_tpu_torch.utils.synthetic import make_scene

    scene = make_scene(H, W + 40, 5, block_px=60, block_size=(2, 6))
    return scene[:, 40:].copy(), scene[:, :W].copy()


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    from vfx_image_stitching_tpu_torch.utils.synthetic import synth_chain

    folder = str(tmp_path_factory.mktemp("chain"))
    synth_chain(folder, N, H, W, seed=SEED, focal=FOCAL)
    return folder


def _tcfg(backend):
    from vfx_image_stitching_tpu_torch import config as tc

    return tc.StitchConfig(backend=backend, sift=_sift_cfg(tc))


# ---------------------------------------------------------------------------
# the stage split, compose routes, steps, save
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["harris", "sift"])
def test_stage_api_and_compose_routes_equal_stitch_panorama(
        backend, chain, tmp_path):
    """``compute_pairwise_shifts`` + ``finalize_to_panorama`` equal
    ``stitch_panorama``; its device fold, with and without
    ``return_steps``, gives the host fold's bytes (``compose/host.py`` on
    the same plan); a ``.png`` ``save_path`` reads back equal."""
    from vfx_image_stitching_tpu_torch.compose.crop import apply_crop
    from vfx_image_stitching_tpu_torch.compose.host import (
        compose_mosaic_host,
        content_bounds_host,
    )
    from vfx_image_stitching_tpu_torch.compose.plan import plan_compose
    from vfx_image_stitching_tpu_torch.geometry.cylindrical import (
        cylindrical_project_batch,
    )
    from vfx_image_stitching_tpu_torch.io import (
        load_bgr,
        load_dataset,
        stack_dataset,
    )
    from vfx_image_stitching_tpu_torch.pipeline import (
        compute_pairwise_shifts,
        stitch_panorama,
    )
    from vfx_image_stitching_tpu_torch.pipeline.stitch import (
        dispatch_pair_step,
        extract_features,
        finalize_to_panorama,
    )

    cfg = _tcfg(backend)
    ref = stitch_panorama(chain, backend=backend, cfg=cfg, crop_margin=8,
                          device="cpu")
    assert len(ref.shifts) == N - 1 and all(p is not None for p in ref.pairs)
    assert ref.steps is None

    images, focals, _ = load_dataset(chain)
    batch, valid = stack_dataset(images)
    cyl = cylindrical_project_batch(torch.as_tensor(batch), focals)
    shifts, pairs, counts = compute_pairwise_shifts(cyl, valid, cfg)
    assert shifts == ref.shifts and pairs == ref.pairs and len(counts) == N - 1
    feats = extract_features(cyl, cfg)
    pair_out = dispatch_pair_step(*feats[:3], cfg)
    fin = finalize_to_panorama(cyl, feats[0], feats[2], *feats[3:], pair_out,
                               list(valid), cfg, H, W, 8)
    assert fin.shifts == ref.shifts and fin.corrected == ref.corrected_shifts
    assert np.array_equal(fin.panorama, ref.panorama)

    plan = plan_compose(H, W, N, list(valid), ref.corrected_shifts,
                        ref.pairs)
    host = compose_mosaic_host(list(cyl.numpy()), plan)
    assert np.array_equal(host, ref.mosaic)
    assert np.array_equal(
        apply_crop(host, content_bounds_host(host, 0), 8), ref.panorama)
    out = str(tmp_path / "pano.png")
    steps = stitch_panorama(chain, backend=backend, cfg=cfg, crop_margin=8,
                            device="cpu", return_steps=True, save_path=out)
    assert steps.shifts == ref.shifts and steps.pairs == ref.pairs
    assert np.array_equal(steps.panorama, ref.panorama)
    assert np.array_equal(steps.mosaic, ref.mosaic)
    assert len(steps.steps) == N - 1
    assert steps.steps[-1].shape == steps.mosaic.shape
    assert np.array_equal(steps.steps[-1], steps.mosaic)
    assert np.array_equal(load_bgr(out), ref.panorama)


def test_save_bgr_raises_on_failed_write(tmp_path):
    from vfx_image_stitching_tpu_torch.io import save_bgr

    with pytest.raises(OSError):
        save_bgr(str(tmp_path / "missing" / "pano.png"),
                 np.zeros((4, 4, 3), np.uint8))


# ---------------------------------------------------------------------------
# compat
# ---------------------------------------------------------------------------

def _compat_case(name, pair, monkeypatch):
    """(port value, JAX value, how to compare) of one compat function."""
    from vfx_image_stitching_tpu import compat as jc
    from vfx_image_stitching_tpu import config as jcfg
    from vfx_image_stitching_tpu.models.sift import extract as jx
    from vfx_image_stitching_tpu_torch import compat as tc
    from vfx_image_stitching_tpu_torch import config as tcfg
    from vfx_image_stitching_tpu_torch.models.sift import extract as tx

    a, b = pair
    gray = a[..., 1].astype(np.float32)
    kern = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], np.float32)
    kps = [(5, 5), (20, 9), (33, 40)]
    rng = np.random.default_rng(0)
    da = rng.random((6, 128)).astype(np.float32)
    db = np.concatenate([da[[3, 0]] + 1e-3, rng.random((4, 128))]).astype(np.float32)
    matches = [((10.0, 4.0), (2.0, 3.0)), ((11.0, 4.0), (3.0, 3.5)),
               ((40.0, 9.0), (1.0, 1.0))]
    # overlap range 18 - 10 + 24 = 32 on the 24-column crops: dyadic
    dyadic = ((10.0, 5.0), (18.0, 5.0))
    if name == "compute_shift_sift":
        # both extractors at the file's small capacities
        monkeypatch.setattr(jx, "SiftConfig",
                            lambda **kw: jcfg.SiftConfig(capacities=_caps(jcfg), **kw))
        monkeypatch.setattr(tx, "SiftConfig",
                            lambda **kw: tcfg.SiftConfig(capacities=_caps(tcfg), **kw))
    calls = {
        "conv2d": ((gray, kern), "exact"),
        "calc_orientation": ((gray, gray[::-1].copy()), "close"),
        "HarrisCorner": ((a,), "harris"),
        "cylindrical_projection": ((a, 140.0), "exact"),
        "compute_keypoints_and_descriptors_harris": ((a,), "kps_desc"),
        "simple_match": ((kps * 2, da, kps * 2, db, 0.5), "exact"),
        "ransac": ((matches, 3), "exact"),
        "compute_shift_harris": ((a, b), "exact"),
        "compute_shift_sift": ((a, b), "exact"),
        "blend_two_images": (((-12.0, 1.4), ((50.3, 9.0), (62.0, 7.6)), a, b),
                             "blend"),
        "blend_two_images_dyadic": (((12.0, 0.0), dyadic, a[:, :24], b[:, :24]),
                                    "exact"),
        "gen_descriptor": None,
    }
    if name == "gen_descriptor":
        m, theta = tc.calc_orientation(gray, gray[::-1].copy(), device="cpu")
        args, how = (30, 41, m, theta), "close"
    else:
        args, how = calls[name]
    fn = name.replace("_dyadic", "")
    got = getattr(tc, fn)(*args, device="cpu")
    with jax.disable_jit():
        want = getattr(jc, fn)(*args)
    return got, want, how


COMPAT = ["conv2d", "calc_orientation", "HarrisCorner", "gen_descriptor",
          "cylindrical_projection", "compute_keypoints_and_descriptors_harris",
          "simple_match", "ransac", "compute_shift_harris",
          "compute_shift_sift", "blend_two_images", "blend_two_images_dyadic"]


@pytest.mark.parametrize("name", COMPAT)
def test_compat_matches_jax(name, pair, monkeypatch):
    got, want, how = _compat_case(name, pair, monkeypatch)
    if how == "exact" and isinstance(got, np.ndarray):
        assert np.array_equal(got, want) and got.dtype == want.dtype
    elif how == "exact":  # tuples and lists of Python numbers
        assert repr(got) == repr(want)
    elif how == "close":
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    elif how == "harris":
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            assert np.array_equal(g, w) and g.dtype == w.dtype
    elif how == "kps_desc":
        assert got[0] == want[0] and len(got[0]) > 5
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    else:  # the port blends as the reference; JAX within its route bound
        args = ((-12.0, 1.4), ((50.3, 9.0), (62.0, 7.6)), *pair)
        assert np.array_equal(got, oracles.blend_two_images(*args))
        _assert_blend_parity(want, got)


def test_compat_host_functions_match_jax(pair, tmp_path):
    """The NumPy-only re-exports and pad_image."""
    from vfx_image_stitching_tpu import compat as jc
    from vfx_image_stitching_tpu_torch import compat as tc

    a, _ = pair
    for mx, my in ((3.5, -2.5), (-4.2, 1.6), (0, 0)):
        assert np.array_equal(tc.pad_image(a, mx, my), jc.pad_image(a, mx, my))
    img = np.zeros((30, 40, 3), np.uint8)
    img[4:25, 6:33] = a[:21, :27]
    assert np.array_equal(tc.rectangle_crop(img, 0, 3),
                          jc.rectangle_crop(img, 0, 3))
    pano = tmp_path / "pano.txt"
    pano.write_text("C:\\x\\a.jpg\n1 2\n700.5\nb.png\nc.JPG\n680\n")
    assert tc.read_pano_data(str(pano)) == jc.read_pano_data(str(pano))


# ---------------------------------------------------------------------------
# sift_impl-named stages and extractors
# ---------------------------------------------------------------------------

def _assert_kps_equal(got, want, v=None):
    """Keypoint sets: mask, positions, packed octave exact; size, angle,
    response to rtol 1e-5."""
    vj = np.asarray(want.valid)
    assert np.array_equal(np.asarray(got.valid), vj) and vj.sum() > 10
    for key in ("x", "y", "octave"):
        assert np.array_equal(np.asarray(getattr(got, key))[vj],
                              np.asarray(getattr(want, key))[vj]), key
    for key in ("size", "angle", "response"):
        np.testing.assert_allclose(np.asarray(getattr(got, key))[vj],
                                   np.asarray(getattr(want, key))[vj],
                                   rtol=1e-5)


def test_stage_functions_match_jax(pair):
    """The 14-function stage chain of ``models.sift`` on one image, then
    the per-point entries on its octave-0 candidates."""
    from vfx_image_stitching_tpu import config as jcfg
    from vfx_image_stitching_tpu.models import sift as J
    from vfx_image_stitching_tpu.models.sift.extrema import extract_candidates as jcand
    from vfx_image_stitching_tpu_torch import config as tcfg
    from vfx_image_stitching_tpu_torch.models import sift as T

    assert T.__all__ == J.__all__
    gray = pair[0][..., 1].astype(np.float32)

    def chain(mod, g, cfg):
        base = mod.generate_base_image(g, cfg.sigma, cfg.assumed_blur)
        n_oct = mod.compute_number_of_octaves(base.shape)
        kern = mod.generate_gaussian_kernels(cfg.sigma, cfg.num_intervals)
        pyr = mod.generate_gaussian_images(base, n_oct, kern)
        dogs = mod.generate_DoG_images(pyr)
        # the first three octaves (the stage API takes any prefix of the
        # pyramid; the later octaves of this image hold no keypoint)
        kps = mod.find_scale_space_extrema(pyr[:3], dogs[:3], cfg=cfg)
        kps = mod.convert_keypoints_to_input_image_size(kps)
        desc = mod.generate_descriptors(kps, pyr[:3], cfg=cfg)
        return (pyr, dogs) + tuple(mod.remove_duplicate_keypoints(kps, desc))

    jc_, tc_ = _sift_cfg(jcfg), _sift_cfg(tcfg)
    with jax.disable_jit():
        j_pyr, j_dogs, j_kps, j_desc = chain(J, jnp.asarray(gray), jc_)
    t_pyr, t_dogs, t_kps, t_desc = chain(T, torch.as_tensor(gray), tc_)
    assert np.array_equal(t_dogs[0].numpy(), np.asarray(j_dogs[0]))
    _assert_kps_equal(t_kps, j_kps)
    v = np.asarray(j_kps.valid)
    assert np.array_equal(t_desc.numpy()[v], np.asarray(j_desc)[v])

    # per-point entries on octave 0's first candidates
    dog0 = np.asarray(j_dogs[0])
    layer, y, x, cv = (np.asarray(t) for t in jcand(jnp.asarray(dog0), 5, 1.0, 64))
    seen = 0
    for i in np.nonzero(cv)[0][:12]:
        args = (int(x[i]), int(y[i]), int(layer[i]), 0, 3, dog0)
        got = T.localize_extremum_via_quadratic_fit(*args, device="cpu")
        with jax.disable_jit():
            want = J.localize_extremum_via_quadratic_fit(*args)
        assert (got is None) == (want is None)
        if got is None:
            continue
        seen += 1
        (gk, gl), (wk, wl) = got, want
        assert gl == wl and gk.pt == wk.pt and gk.octave == wk.octave
        np.testing.assert_allclose([gk.size, gk.response],
                                   [wk.size, wk.response], rtol=1e-5)
        gimg = np.asarray(j_pyr[0][gl])
        got_o = T.compute_keypoints_with_orientations(gk, 0, gimg, device="cpu")
        with jax.disable_jit():
            want_o = J.compute_keypoints_with_orientations(wk, 0, gimg)
        assert len(got_o) == len(want_o)
        for go, wo in zip(got_o, want_o):
            assert go.pt == wo.pt and go.octave == wo.octave
            np.testing.assert_allclose(go.angle, wo.angle, rtol=1e-5)
        assert T.compare_keypoints(gk, wk) == J.compare_keypoints(gk, wk)
    assert seen > 2

    rng = np.random.default_rng(3)
    patches = rng.integers(-4, 5, (3, 50, 3, 3)).astype(np.float32)
    got = T.is_pixel_an_extremum(*patches, 1.0, device="cpu").numpy()
    with jax.disable_jit():
        want = np.asarray(J.is_pixel_an_extremum(*jnp.asarray(patches), 1.0))
    assert np.array_equal(got, want) and got.any()


def test_extractors_match_jax(pair, monkeypatch):
    """``sift_extract``, ``sift_batch`` and the reference-signature
    ``compute_keypoints_and_descriptors`` against the JAX package's."""
    from vfx_image_stitching_tpu import config as jcfg
    from vfx_image_stitching_tpu.models.sift import extract as jx
    from vfx_image_stitching_tpu_torch import config as tcfg
    from vfx_image_stitching_tpu_torch.models.sift import extract as tx

    a, b = pair
    jc_, tc_ = _sift_cfg(jcfg), _sift_cfg(tcfg)
    with jax.disable_jit():
        j_xy, j_d, j_v = jx.sift_batch(jnp.asarray(np.stack([a, b])), jc_)
    t_xy, t_d, t_v = tx.sift_batch(torch.as_tensor(np.stack([a, b])), tc_)
    v = np.asarray(j_v)
    assert np.array_equal(t_v.numpy(), v)
    assert np.array_equal(t_xy.numpy()[v], np.asarray(j_xy)[v])
    assert np.array_equal(t_d.numpy()[v], np.asarray(j_d)[v])
    one = tx.sift_extract(torch.as_tensor(a), tc_)
    assert all(np.array_equal(o.numpy(), t[0].numpy()) for o, t in
               zip(one, (t_xy, t_d, t_v)))

    monkeypatch.setattr(jx, "SiftConfig",
                        lambda **kw: jcfg.SiftConfig(capacities=_caps(jcfg), **kw))
    monkeypatch.setattr(tx, "SiftConfig",
                        lambda **kw: tcfg.SiftConfig(capacities=_caps(tcfg), **kw))
    recs, desc = tx.compute_keypoints_and_descriptors(a, device="cpu")
    with jax.disable_jit():
        j_recs, j_desc = jx.compute_keypoints_and_descriptors(a)
    assert [r.pt for r in recs] == [r.pt for r in j_recs] and len(recs) > 10
    assert [r.octave for r in recs] == [r.octave for r in j_recs]
    np.testing.assert_allclose([r.size for r in recs], [r.size for r in j_recs],
                               rtol=1e-5)
    assert np.array_equal(desc, j_desc)


def test_audit_sift_capacities_matches_jax(pair):
    from vfx_image_stitching_tpu import config as jcfg
    from vfx_image_stitching_tpu.utils.capacity import (
        audit_sift_capacities as jaudit,
    )
    from vfx_image_stitching_tpu_torch import config as tcfg
    from vfx_image_stitching_tpu_torch.utils.capacity import (
        audit_sift_capacities,
    )

    got = audit_sift_capacities(list(pair), _sift_cfg(tcfg), device="cpu")
    with jax.disable_jit():
        want = jaudit(list(pair), _sift_cfg(jcfg))
    assert sorted(got) == sorted(want)
    for key in got:
        if key == "caps":
            assert dataclasses.asdict(got[key]) == {
                k: v for k, v in dataclasses.asdict(want[key]).items()
                if k in dataclasses.asdict(got[key])}
        else:
            assert np.array_equal(got[key], np.asarray(want[key])), key

    # a capacity the content overflows: raises, or grows to fit
    small = tcfg.SiftConfig(capacities=dataclasses.replace(
        _caps(tcfg), candidate_caps=(8, 128)))
    with pytest.raises(RuntimeError, match="overflow"):
        audit_sift_capacities(list(pair), small, device="cpu")
    grown = audit_sift_capacities(list(pair), small, autogrow=True, device="cpu")
    assert grown["caps"].candidate_caps[0] > 8
    assert (grown["cand_counts"] < grown["cand_caps"]).all()
    assert np.array_equal(grown["cand_counts"], got["cand_counts"])


# ---------------------------------------------------------------------------
# utils and CLI
# ---------------------------------------------------------------------------

def test_aligned_rmse_pinned_to_jax():
    from vfx_image_stitching_tpu.utils.metrics import aligned_rmse as jrmse
    from vfx_image_stitching_tpu_torch.utils.metrics import aligned_rmse

    rng = np.random.default_rng(8)
    gold = rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)
    for ours in (gold, gold[3:, 2:], np.clip(gold[:-2, 1:] + 3, 0, 255)):
        assert aligned_rmse(ours, gold, 4) == jrmse(ours, gold, 4)
    assert aligned_rmse(gold[3:, 2:], gold, 4) == (0.0, (-3, -2))


def test_phase_timer_and_profile_trace(tmp_path, capsys):
    from vfx_image_stitching_tpu_torch.utils.profiling import (
        PhaseTimer,
        profile_trace,
    )

    timer = PhaseTimer(verbose=True)
    with timer.phase("a"):
        pass
    with timer.phase("a"):
        pass
    assert timer.total() >= timer.phases["a"] >= 0
    assert "Timer:" in capsys.readouterr().out
    with profile_trace(None):
        torch.ones(3).sum()
    trace = tmp_path / "trace"
    with profile_trace(str(trace)):
        torch.ones(8).cumsum(0)
    files = list(trace.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert files[0].stat().st_size > 0


def test_cli_main_on_cpu(chain, tmp_path):
    """``main([...])`` with the output, step files and a trace, on the
    CPU; the panorama equals ``stitch_panorama``'s."""
    from vfx_image_stitching_tpu_torch.io import load_bgr
    from vfx_image_stitching_tpu_torch.pipeline import stitch_panorama
    from vfx_image_stitching_tpu_torch.pipeline.cli import main

    out = tmp_path / "out" / "pano.png"
    out.parent.mkdir()
    rc = main([chain, "--backend", "harris", "--out", str(out),
               "--save-steps", "--profile-dir", str(tmp_path / "trace"),
               "--margin", "8", "--device", "cpu"])
    assert rc == 0
    ref = stitch_panorama(chain, backend="harris", crop_margin=8, device="cpu")
    assert np.array_equal(load_bgr(str(out)), ref.panorama)
    steps = sorted(p.name for p in out.parent.iterdir() if p.name != "pano.png")
    assert steps == [f"pano{i}.jpg" for i in range(1, N)]
    assert len(list((tmp_path / "trace").iterdir())) == 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a machine without CUDA")
@pytest.mark.parametrize("entry", ["stitch_panorama", "stitch_many", "compat",
                                   "audit", "cli", "stages",
                                   "is_pixel_an_extremum"])
def test_entry_points_raise_without_cuda(entry, chain, pair):
    """Every entry point defaults to the card and raises without CUDA;
    none falls back to the CPU."""
    from vfx_image_stitching_tpu_torch import compat
    from vfx_image_stitching_tpu_torch.models.sift import stages
    from vfx_image_stitching_tpu_torch.pipeline import stitch_many, stitch_panorama
    from vfx_image_stitching_tpu_torch.pipeline.cli import main
    from vfx_image_stitching_tpu_torch.utils.capacity import audit_sift_capacities

    call = {
        "stitch_panorama": lambda: stitch_panorama(chain),
        "stitch_many": lambda: stitch_many([chain]),
        "compat": lambda: compat.compute_shift_harris(*pair),
        "audit": lambda: audit_sift_capacities(list(pair)),
        "cli": lambda: main([chain, "--backend", "harris"]),
        "stages": lambda: stages.localize_extremum_via_quadratic_fit(
            5, 5, 1, 0, 3, np.zeros((5, 16, 16), np.float32)),
        "is_pixel_an_extremum": lambda: stages.is_pixel_an_extremum(
            *np.zeros((3, 3, 3), np.float32), 1.0),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
