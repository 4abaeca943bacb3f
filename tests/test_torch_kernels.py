"""PyTorch port: the three kernels' plain versions against the JAX
package's Pallas kernels (interpret mode), the stages built on them, and
the matching / voting step.  The CUDA kernels themselves are held against
these plain versions in tests/test_torch_cuda.py, on a GPU.

Contracts: the Newton kernel's integer lanes bit for bit; orientation
histograms to rtol 2e-5 / atol 2e-3 (reduction order,
tests/test_pallas_kernels.py); the window gather bit for bit; matching
and voting exact.  The JAX stage functions run op by op
(``jax.disable_jit()``), so the port's arithmetic — which never fuses a
multiply-add — is compared with the same arithmetic (see
tests/test_torch_ops.py); the remaining float gaps come from XLA's CPU
``exp``/``exp2``/``sin``/``cos`` differing from PyTorch's and are bounded
where they appear.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _ulp(a, b) -> int:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max(initial=0))


def _octave_dog(h=64, w=96, seed=0, octave=0):
    """A real DoG octave and its candidates, from the JAX package."""
    from chip_smoke import make_scene
    from vfx_image_stitching_tpu.models.sift import extrema as je
    from vfx_image_stitching_tpu.models.sift import pyramid as jp

    gray = make_scene(h, w, seed).astype(np.float32)[..., 1]
    with jax.disable_jit():
        base = jp.generate_base_image(jnp.asarray(gray))
        gauss = jp.generate_gaussian_images(
            base, octave + 1, jp.generate_gaussian_kernels(1.6, 3))
        dog = jp.generate_dog_images(gauss)[octave]
        cand = je.extract_candidates(dog, 5, je.extrema_threshold(0.04, 3), 512)
    return (np.array(gauss[octave]), np.array(dog),
            [np.array(a) for a in cand])


def _random_dog():
    """(5, 21, 131): a height that is not a multiple of 8, as
    tests/test_sift.py:398 covers, with walks reaching the bottom rows."""
    from vfx_image_stitching_tpu.models.sift import extrema as je

    dog = np.random.default_rng(2).integers(-80, 80, (5, 21, 131)).astype(np.float32)
    cand = je.extract_candidates(jnp.asarray(dog), 5,
                                 je.extrema_threshold(0.04, 3), 256)
    return dog, [np.array(a) for a in cand]


# ---------------------------------------------------------------------------
# K1: Newton localization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["octave", "h21"])
def test_localize_newton_plain_matches_pallas_interpret(case):
    from vfx_image_stitching_tpu.models.sift.chunking import live_chunk_bound
    from vfx_image_stitching_tpu.models.sift.pallas_kernels import (
        localize_newton_resident as pallas_k1,
    )
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    if case == "octave":
        _, dog, (layer, y, x, cv) = _octave_dog()
    else:
        dog, (layer, y, x, cv) = _random_dog()
    assert cv.sum() > 0
    chunk = 256
    _f, outi = pallas_k1(
        jnp.asarray(dog), jnp.asarray(layer), jnp.asarray(y), jnp.asarray(x),
        jnp.asarray(cv), live_chunk_bound(jnp.asarray(cv), chunk), 5, 3, 5,
        chunk, interpret=True,
    )
    got = K.localize_newton_resident(
        torch.as_tensor(dog), *(torch.as_tensor(a) for a in (layer, y, x, cv)),
        5, 3, 5)
    assert np.array_equal(got.numpy(), np.asarray(outi)[:, :8])
    assert got[:, 6].sum() > 0 and (got[:, 7].sum() > 0 or case == "octave")


@pytest.mark.parametrize("case", ["octave", "h21"])
def test_localize_resident_matches_jax_plain(case):
    """The port's resident localize == the JAX plain chunked path on valid
    rows (tests/test_sift.py:328-396 contract: every field bit-identical,
    ``response`` within 4 ulp), except ``size``, whose ``exp2`` comes from
    each library's math: XLA's CPU exp2 is up to 9 ulp from PyTorch's."""
    from vfx_image_stitching_tpu.config import SiftConfig as JCfg
    from vfx_image_stitching_tpu.models.sift.localize import (
        localize_candidates_chunked,
    )
    from vfx_image_stitching_tpu_torch.config import SiftConfig as TCfg
    from vfx_image_stitching_tpu_torch.models.sift.localize import (
        localize_candidates_resident,
    )

    if case == "octave":
        _, dog, cand = _octave_dog()
    else:
        dog, cand = _random_dog()
    with jax.disable_jit():
        plain = localize_candidates_chunked(
            jnp.asarray(dog), *(jnp.asarray(a) for a in cand), 0, JCfg())
    res = localize_candidates_resident(
        torch.as_tensor(dog), *(torch.as_tensor(a) for a in cand), 0, TCfg())
    vp = np.asarray(plain.valid)
    assert np.array_equal(res.valid.numpy(), vp) and vp.sum() > 0
    for name in plain._fields:
        a = np.asarray(getattr(plain, name))[vp]
        b = getattr(res, name).numpy()[vp]
        if name in ("response", "size"):
            assert _ulp(a, b) <= (4 if name == "response" else 9), name
        else:
            assert np.array_equal(a, b), name


# ---------------------------------------------------------------------------
# K2: orientation histograms
# ---------------------------------------------------------------------------

def _orientation_case(k=23, half=17, h=150, w=170):
    rng = np.random.default_rng(3)
    mag = (rng.random((3, h, w)) * 100).astype(np.float32)
    ang = (rng.random((3, h, w)) * 360).astype(np.float32)
    ang[0, :4, :4] = 359.99          # rint(ang * 36/360) == 36 -> bin 0
    layer = rng.integers(0, 3, k).astype(np.int32)
    cy = rng.integers(-5, h + 5, k).astype(np.int32)   # incl. outside
    cx = rng.integers(-5, w + 5, k).astype(np.int32)
    cy[0], cx[0] = 2, 2
    radius = rng.integers(2, half + 1, k).astype(np.int32)
    wf = (-0.5 / (rng.random(k).astype(np.float32) * 4 + 1) ** 2).astype(np.float32)
    valid = rng.random(k) > 0.2
    valid[0] = True
    return mag, ang, layer, cy, cx, radius, wf, valid, half


def test_orientation_histograms_plain_matches_pallas_interpret():
    from vfx_image_stitching_tpu.models.sift.pallas_kernels import (
        orientation_histograms_v2,
    )
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    mag, ang, layer, cy, cx, radius, wf, valid, half = _orientation_case()
    h, w = mag.shape[-2:]
    ref = np.asarray(orientation_histograms_v2(
        *(jnp.asarray(a) for a in (mag, ang, layer, cy, cx, radius, wf, valid)),
        half, h, w, 36, interpret=True))
    got = K.orientation_histograms(
        *(torch.as_tensor(a) for a in (mag, ang, layer, cy, cx, radius, wf, valid)),
        half, 36).numpy()
    assert got.shape == (len(layer), 36)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-3)
    assert np.all(got[~valid] == 0) and got[0, 0] > 0


def test_assign_orientations_matches_jax():
    """Peaks, interpolation and the max_orientations expansion on real
    localized candidates: valid rows and every position field exact,
    angles within the float gap the histograms' ``exp`` leaves."""
    from vfx_image_stitching_tpu.config import SiftConfig as JCfg
    from vfx_image_stitching_tpu.models.sift import localize as jl
    from vfx_image_stitching_tpu.models.sift import orientation as jo
    from vfx_image_stitching_tpu.models.sift.pyramid import gradient_fields
    from vfx_image_stitching_tpu_torch.config import SiftConfig as TCfg
    from vfx_image_stitching_tpu_torch.models.sift import localize as tl
    from vfx_image_stitching_tpu_torch.models.sift import orientation as to

    gauss, dog, cand = _octave_dog(seed=4)
    with jax.disable_jit():
        loc_j = jl.compact_localized(jl.localize_candidates_chunked(
            jnp.asarray(dog), *(jnp.asarray(a) for a in cand), 0, JCfg()), 256)
        mag, ang = gradient_fields(jnp.asarray(gauss[1:4]))
        kj = jo.assign_orientations_chunked(mag, ang, loc_j, 0, JCfg(),
                                            chunk=128, layer_base=1)
    loc_t = tl.Localized(*(torch.tensor(np.asarray(f)) for f in loc_j))
    kt = to.assign_orientations_chunked(
        torch.tensor(np.asarray(mag)), torch.tensor(np.asarray(ang)), loc_t, 0,
        TCfg(), chunk=128, layer_base=1)
    v = np.asarray(kj.valid)
    assert np.array_equal(kt.valid.numpy(), v) and v.sum() > 0
    for name in kj._fields:
        a, b = np.asarray(getattr(kj, name))[v], getattr(kt, name).numpy()[v]
        if name == "angle":
            np.testing.assert_allclose(b, a, rtol=0, atol=2e-3)
        else:
            assert np.array_equal(a, b), name


# ---------------------------------------------------------------------------
# K3: descriptor window gather, and the descriptors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("half", [28, 44])
def test_pair_window_gather_plain_matches_pallas_interpret(half):
    """S = 57 and 89, starts clamped at every edge, a stack narrower than
    the window."""
    from vfx_image_stitching_tpu.models.sift.pallas_kernels import (
        pair_window_gather as pallas_k3,
    )
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    rng = np.random.default_rng(half)
    for h, w in ((97, 120), (60, 300)):
        mag = (rng.random((3, h, w)) * 100).astype(np.float32)
        ang = (rng.random((3, h, w)) * 360).astype(np.float32)
        k = 13
        layer = rng.integers(0, 3, k).astype(np.int32)
        cy = rng.integers(-5, h + 5, k).astype(np.int32)
        cx = rng.integers(-5, w + 5, k).astype(np.int32)
        cy[:3] = (-9, 0, h + 9)
        cx[:3] = (w + 9, -9, 0)
        ref = pallas_k3(*(jnp.asarray(a) for a in (mag, ang, layer, cy, cx)),
                        half, interpret=True)
        got = K.pair_window_gather(
            *(torch.as_tensor(a) for a in (mag, ang, layer, cy, cx)), half)
        for a, b in zip(got, ref):
            assert np.array_equal(a.numpy(), np.asarray(b))


def test_descriptors_bucketed_match_jax():
    """Both size buckets, and the unbucketed path, on real keypoints:
    descriptors exact.  (The float gap of XLA's ``sin``/``cos``/``exp``
    could in principle flip a value sitting on a rint boundary by 1; none
    does on this input, and any that appears is a fault to trace.)"""
    from vfx_image_stitching_tpu.config import SiftCapacities as JCaps
    from vfx_image_stitching_tpu.config import SiftConfig as JCfg
    from vfx_image_stitching_tpu.models.sift import descriptor as jd
    from vfx_image_stitching_tpu.models.sift import keypoints as jk
    from vfx_image_stitching_tpu.models.sift import localize as jl
    from vfx_image_stitching_tpu.models.sift import orientation as jo
    from vfx_image_stitching_tpu.models.sift.pyramid import gradient_fields
    from vfx_image_stitching_tpu_torch.config import config_from_dict
    from vfx_image_stitching_tpu_torch.models.sift import descriptor as td
    from vfx_image_stitching_tpu_torch.models.sift import keypoints as tk

    import dataclasses

    caps = JCaps(max_half_width=36, desc_small_half=24, desc_chunk=32)
    jcfg = JCfg(capacities=caps)
    tcfg = config_from_dict(dataclasses.asdict(
        __import__("vfx_image_stitching_tpu.config", fromlist=["x"]).StitchConfig(
            sift=jcfg))).sift
    gauss, dog, cand = _octave_dog(96, 128, seed=6)
    with jax.disable_jit():
        loc = jl.compact_localized(jl.localize_candidates_chunked(
            jnp.asarray(dog), *(jnp.asarray(a) for a in cand), 0, jcfg), 256)
        mag, ang = gradient_fields(jnp.asarray(gauss[1:4]))
        kps = jk.convert_keypoints_to_input_image_size(jk.compact(
            jo.assign_orientations_chunked(mag, ang, loc, 0, jcfg,
                                           layer_base=1), 256))
        dj, big_j = jd.compute_descriptors_bucketed(
            mag, ang, kps, 0, jcfg, small_cap=256, big_cap=128, layer_base=1)
    tkps = tk.Keypoints(*(torch.tensor(np.asarray(f)) for f in kps))
    dt, big_t = td.compute_descriptors_bucketed(
        torch.tensor(np.asarray(mag)), torch.tensor(np.asarray(ang)), tkps, 0,
        tcfg, small_cap=256, big_cap=128, layer_base=1)
    v = np.asarray(kps.valid)
    assert int(big_t) == int(big_j) and 0 < int(big_j) < v.sum()
    assert np.array_equal(dt.numpy()[v], np.asarray(dj)[v])
    assert np.all(dt.numpy()[~v] == 0)

    # the unbucketed path (desc_bucketed=False): one window size for all
    with jax.disable_jit():
        dj1 = jd.compute_descriptors_chunked(mag, ang, kps, 0, jcfg,
                                             layer_base=1)
    dt1 = td.compute_descriptors_chunked(
        torch.tensor(np.asarray(mag)), torch.tensor(np.asarray(ang)), tkps, 0,
        tcfg, layer_base=1)
    assert np.array_equal(dt1.numpy()[v], np.asarray(dj1)[v])


# ---------------------------------------------------------------------------
# matching and voting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("refine", [1, 8])
def test_match_descriptors_matches_jax(refine):
    from vfx_image_stitching_tpu.match.nn import match_descriptors as jmatch
    from vfx_image_stitching_tpu_torch.match.nn import match_descriptors as tmatch

    rng = np.random.default_rng(refine)
    k = 60
    da = rng.integers(0, 40, (2, k, 128)).astype(np.float32)
    db = da.copy()
    db[:, ::3] = rng.integers(0, 40, (2, 20, 128))
    db[:, 5] = db[:, 7]                               # exact tie
    va = rng.random((2, k)) > 0.1
    vb = rng.random((2, k)) > 0.1
    # integer-valued descriptors keep every distance sum exact, so the
    # refine path is compared exactly too
    got = tmatch(torch.as_tensor(da), torch.as_tensor(va), torch.as_tensor(db),
                 torch.as_tensor(vb), 25000.0, refine=refine, return_dist=True,
                 margin=1024.0)
    for b in range(2):
        ref = jmatch(jnp.asarray(da[b]), jnp.asarray(va[b]), jnp.asarray(db[b]),
                     jnp.asarray(vb[b]), 25000.0, refine=refine,
                     return_dist=True, margin=1024.0)
        for g, r in zip(got, ref):
            assert np.array_equal(g[b].numpy(), np.asarray(r))


def test_translation_ransac_material_fuzz_matches_jax():
    """Fuzzed vote configurations (as tests/test_strict.py): the batched
    port equals the JAX analysis row for row."""
    from vfx_image_stitching_tpu.estimate import ransac as jr
    from vfx_image_stitching_tpu_torch.estimate import ransac as tr

    rng = np.random.default_rng(42)
    centers = np.array([[0, 0], [1, 0], [9, 9], [10, 9], [50, 50]])
    for case in range(40):
        k = int(rng.integers(1, 13))
        n_alt = int(rng.integers(0, 4))
        bsz = 3
        moves = (centers[rng.integers(0, 5, (bsz, k))]
                 + rng.integers(0, 2, (bsz, k, 2))).astype(np.float32)
        matched = rng.random((bsz, k)) < 0.7
        flip = rng.random((bsz, k)) < 0.3
        swap = rng.random((bsz, k)) < 0.3
        alt = (centers[rng.integers(0, 5, (bsz, k, n_alt))]
               + rng.integers(0, 2, (bsz, k, n_alt, 2))).astype(np.float32)
        alt_v = rng.random((bsz, k, n_alt)) < 0.6
        swap_cap = 64 if case % 2 else 2
        got = tr.translation_ransac_material(
            *(torch.as_tensor(a) for a in (moves, matched, flip, swap, alt, alt_v)),
            swap_cap=swap_cap)
        plain = tr.translation_ransac(torch.as_tensor(moves),
                                      torch.as_tensor(matched))
        for b in range(bsz):
            ref = jr.translation_ransac_material(
                *(jnp.asarray(a[b]) for a in (moves, matched, flip, swap, alt,
                                              alt_v)), swap_cap=swap_cap)
            for g, r in zip(got, ref):
                assert np.array_equal(g[b].numpy(), np.asarray(r)), case
            ref2 = jr.translation_ransac(jnp.asarray(moves[b]),
                                         jnp.asarray(matched[b]))
            for g, r in zip(plain, ref2):
                assert np.array_equal(g[b].numpy(), np.asarray(r)), case


def test_pair_step_matches_jax():
    """The batched adjacent-pair step == the JAX package's vmapped one,
    all 15 outputs, on descriptor sets with near-threshold and near-tie
    rows (so the escalation signals are live)."""
    from vfx_image_stitching_tpu.config import StitchConfig as JStitch
    from vfx_image_stitching_tpu.pipeline.stitch import (
        dispatch_pair_step as jstep,
    )
    from vfx_image_stitching_tpu_torch.config import StitchConfig as TStitch
    from vfx_image_stitching_tpu_torch.pipeline.stitch import (
        dispatch_pair_step as tstep,
    )

    rng = np.random.default_rng(11)
    n, k = 4, 48
    base = rng.integers(0, 60, (k, 128)).astype(np.float32)
    desc = np.stack([base] * n)
    desc[:, k // 2:] = rng.integers(0, 60, (n, k - k // 2, 128))
    desc[1:, 3, :8] += 13        # squared distance 1352: near a runner-up
    xy = (rng.random((n, k, 2)) * 100).astype(np.float32)
    xy[1:, : k // 2] = xy[:-1, : k // 2] + np.float32(-40.0)
    valid = rng.random((n, k)) > 0.1
    got = tstep(*(torch.as_tensor(a) for a in (xy, desc, valid)), TStitch())
    ref = jstep(*(jnp.asarray(a) for a in (xy, desc, valid)), JStitch())
    for i, (g, r) in enumerate(zip(got, ref)):
        assert np.array_equal(g.numpy(), np.asarray(r)), i
