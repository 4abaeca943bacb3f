"""PyTorch port: the descriptor-histogram kernel (K5) and the v1
orientation-histogram kernel (K4), their plain versions against the JAX
package's Pallas kernels (interpret mode), and the stages that reach
them.  The CUDA kernels themselves are held against these plain versions
in tests/test_torch_cuda.py, on a GPU.

Contracts: raw descriptor histograms to rtol 1e-5 / atol 1e-3 (summation
order, and XLA's CPU ``exp`` 1 ulp from PyTorch's); final descriptors to
1 LSB on under 2% of valid entries (tests/test_pallas_kernels.py:89-135);
orientation histograms to rtol 2e-5 / atol 2e-3
(tests/test_pallas_kernels.py:17-53).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _descriptor_case(k, size_scale=1.0, pos_scale=1.0):
    """The keypoints and (6, 96, 120) fields of
    tests/test_pallas_kernels.py:89-135 (K=8 there, where most centers lie
    outside the fields; K=11 runs the JAX kernel's pad-to-8 path;
    ``size_scale`` > 1 makes some half-widths reach the cap, ``pos_scale``
    0.5 puts every center inside): numpy arrays, keypoint fields by name."""
    rng = np.random.default_rng(1)
    h, w = 96, 120
    mag = rng.random((6, h, w)).astype(np.float32) * 100
    ang = rng.random((6, h, w)).astype(np.float32) * 360
    kps = dict(
        x=(rng.random(k) * w * 2 * pos_scale).astype(np.float32),
        y=(rng.random(k) * h * 2 * pos_scale).astype(np.float32),
        size=((rng.random(k) * 4 + 1) * size_scale).astype(np.float32),
        angle=(rng.random(k) * 360).astype(np.float32),
        response=np.ones(k, np.float32),
        # packed octave for converted kps of octave 1: octv=0, layer 1..3
        octave=(0 + (rng.integers(1, 4, k) << 8) + (128 << 16)).astype(np.int32),
        valid=np.arange(k) < k - 2,
    )
    for f in ("ix", "iy", "jx", "jy", "jl"):
        kps[f] = np.zeros(k, np.int32)
    return mag, ang, kps


def _keypoints(mod, kps, to):
    return mod.Keypoints(**{f: to(v) for f, v in kps.items()})


@pytest.mark.parametrize("k,half_cap,size_scale,pos_scale",
                         [(8, 44, 1.0, 1.0), (11, 28, 1.5, 0.5)])
def test_descriptor_histograms_plain_matches_pallas_interpret(
        k, half_cap, size_scale, pos_scale):
    """Raw (K, 128) histograms on identical per-row inputs (the window
    geometry of ``compute_descriptors_pallas``, half-widths capped at
    ``half_cap``): rtol 1e-5, atol 1e-3; invalid rows exactly zero.  The
    second case is the small bucket's window (57 wide, on the JAX
    kernel's 56-row tile) with an odd K.  (Each case compiles the
    interpreted kernel once, ~20 s; the first shares its compile with
    the next test.)"""
    from vfx_image_stitching_tpu.config import SiftConfig as JCfg
    from vfx_image_stitching_tpu.models.sift import keypoints as jk
    from vfx_image_stitching_tpu.models.sift.descriptor import _window_params
    from vfx_image_stitching_tpu.models.sift.pallas_kernels import (
        descriptor_histograms as pallas_k5,
    )
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    mag, ang, kps = _descriptor_case(k, size_scale, pos_scale)
    h, w = mag.shape[-2:]
    with jax.disable_jit():
        layer, px, py, angle, cos_a, sin_a, hist_w, half_w = (
            np.array(a) for a in _window_params(
                _keypoints(jk, kps, jnp.asarray), JCfg(), h, w))
    half_w = np.minimum(half_w, half_cap).astype(np.int32)
    hist_w = np.where(hist_w > 0, hist_w, 1).astype(np.float32)
    rows = (layer.astype(np.int32), py, px, half_w, cos_a, sin_a, hist_w,
            angle, kps["valid"])
    assert half_w[kps["valid"]].max() >= 20
    assert (half_w == half_cap).any() == (size_scale > 1)
    tile = {} if half_cap == 44 else dict(tile_r=56)
    ref = np.asarray(pallas_k5(         # interpret mode: automatic on CPU
        jnp.asarray(mag), jnp.asarray(ang), *(jnp.asarray(a) for a in rows),
        half_cap, h, w, 8, 4, **tile))
    got = K.descriptor_histograms(
        torch.as_tensor(mag), torch.as_tensor(ang),
        *(torch.as_tensor(a) for a in rows), half_cap).numpy()
    assert got.shape == (k, 128)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    assert np.all(got[~kps["valid"]] == 0)
    live = (got[kps["valid"]].max(axis=1) > 0).sum()
    assert live == (kps["valid"].sum() if pos_scale < 1 else 2)


@pytest.mark.parametrize("size_scale,pos_scale", [(1.0, 1.0), (2.0, 0.5)])
def test_compute_descriptors_histogram_matches_pallas(size_scale, pos_scale):
    """Final descriptors: the port's histogram route against the JAX
    package's ``compute_descriptors_pallas``, 1 LSB on under 2% of valid
    entries; invalid rows zero.  The second case puts every center inside
    the fields and two half-widths at the cap (44), so every valid row
    has a non-trivial descriptor."""
    from vfx_image_stitching_tpu.config import SiftConfig as JCfg
    from vfx_image_stitching_tpu.models.sift import keypoints as jk
    from vfx_image_stitching_tpu.models.sift.descriptor import (
        compute_descriptors_pallas,
    )
    from vfx_image_stitching_tpu_torch.config import SiftConfig as TCfg
    from vfx_image_stitching_tpu_torch.models.sift import keypoints as tk
    from vfx_image_stitching_tpu_torch.models.sift.descriptor import (
        compute_descriptors_histogram,
    )

    mag, ang, kps = _descriptor_case(8, size_scale, pos_scale)
    ref = np.asarray(compute_descriptors_pallas(
        jnp.asarray(mag), jnp.asarray(ang), _keypoints(jk, kps, jnp.asarray),
        1, JCfg()))
    got = compute_descriptors_histogram(
        torch.as_tensor(mag), torch.as_tensor(ang),
        _keypoints(tk, kps, torch.as_tensor), 1, TCfg()).numpy()
    v = kps["valid"]
    assert np.abs(got[v] - ref[v]).max() <= 1.0
    assert (got[v] != ref[v]).mean() < 0.02
    assert np.all(got[~v] == 0) and got[v].max() > 100
    live = (got[v].max(axis=1) > 0).sum()
    assert live == (v.sum() if pos_scale < 1 else 2)


@pytest.mark.parametrize("num_bins", [36, 72, 128])
def test_orientation_histograms_v1_plain_matches_pallas_interpret(num_bins):
    """The v1 wrapper (its plain version on the CPU) against the JAX v1
    kernel on the input of tests/test_pallas_kernels.py:17-53 (K=11,
    half 20, centers outside the image), at 36, 72 and 128 bins: rtol
    2e-5, atol 2e-3."""
    from vfx_image_stitching_tpu.models.sift.pallas_kernels import (
        orientation_histograms as pallas_k4,
    )
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    rng = np.random.default_rng(0)
    h, w, half, k = 150, 170, 20, 11
    mag = rng.random((6, h, w)).astype(np.float32) * 100
    ang = rng.random((6, h, w)).astype(np.float32) * 360
    ints = [rng.integers(lo, hi, k).astype(np.int32)
            for lo, hi in ((0, 6), (-5, h + 5), (-5, w + 5))]
    radius = rng.integers(2, half + 1, k).astype(np.int32)
    wf = (-0.5 / (rng.random(k).astype(np.float32) * 4 + 1) ** 2).astype(np.float32)
    valid = rng.random(k) > 0.2
    args = (mag, ang, *ints, radius, wf, valid)
    ref = np.asarray(pallas_k4(*(jnp.asarray(a) for a in args), half, h, w,
                               num_bins, interpret=True))
    got = K.orientation_histograms_v1(
        *(torch.as_tensor(a) for a in args), half, num_bins).numpy()
    assert got.shape == (k, num_bins)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-3)
    assert np.all(got[~valid] == 0) and got[valid].sum() > 0


def test_assign_orientations_v1_matches_jax(monkeypatch):
    """``VFX_ORIENT_V2=0`` on both sides: the port's orientation stage on
    the v1 wrapper against the JAX stage on its v1 Pallas kernel
    (``use_pallas``; interpret mode), on real localized candidates at a
    small capacity.  Valid rows and every position field exact, angles
    within the float gap the histograms' ``exp`` leaves (2e-3 deg)."""
    import dataclasses

    from test_torch_kernels import _octave_dog
    from vfx_image_stitching_tpu.config import SiftConfig as JCfg
    from vfx_image_stitching_tpu.models.sift import localize as jl
    from vfx_image_stitching_tpu.models.sift import orientation as jo
    from vfx_image_stitching_tpu.models.sift.pyramid import gradient_fields
    from vfx_image_stitching_tpu_torch.config import SiftConfig as TCfg
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.models.sift import localize as tl
    from vfx_image_stitching_tpu_torch.models.sift import orientation as to

    monkeypatch.setenv("VFX_ORIENT_V2", "0")
    calls = []
    monkeypatch.setattr(to, "orientation_histograms_v1",
                        lambda *a: calls.append(1) or K.orientation_histograms_v1(*a))
    gauss, dog, cand = _octave_dog(96, 128, seed=4)
    jcfg = dataclasses.replace(JCfg(), use_pallas=True)
    with jax.disable_jit():
        loc_j = jl.compact_localized(jl.localize_candidates_chunked(
            jnp.asarray(dog), *(jnp.asarray(a) for a in cand), 0, jcfg), 64)
        mag, ang = gradient_fields(jnp.asarray(gauss[1:4]))
        kj = jo.assign_orientations(mag, ang, loc_j, 0, jcfg, layer_base=1)
    loc_t = tl.Localized(*(torch.tensor(np.asarray(f)) for f in loc_j))
    kt = to.assign_orientations(
        torch.tensor(np.asarray(mag)), torch.tensor(np.asarray(ang)), loc_t, 0,
        TCfg(), layer_base=1)
    assert calls == [1]
    v = np.asarray(kj.valid)
    assert np.array_equal(kt.valid.numpy(), v) and v.sum() >= 20
    for name in kj._fields:
        a, b = np.asarray(getattr(kj, name))[v], getattr(kt, name).numpy()[v]
        if name == "angle":
            np.testing.assert_allclose(b, a, rtol=0, atol=2e-3)
        else:
            assert np.array_equal(a, b), name
