"""PyTorch port: dense ops, pyramid, extrema and keypoint-set operations
against the JAX package on the same numpy inputs.

The JAX side runs op by op (``jax.disable_jit()``).  Under ``jit``, XLA's
CPU backend fuses elementwise chains and contracts multiply-adds into
FMAs, which no PyTorch op does: the jitted blur differs from the op-by-op
blur (and from the port) by up to 3 ulp (measured here,
``test_jitted_blur_fma_gap``).  Op by op, the arithmetic is the same and
the results are bit-exact, except where XLA's CPU math library differs
from PyTorch's: ``sqrt`` and ``atan2`` by 1 ulp on some inputs, which the
gradient-field tests bound.
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


def _gray(h=48, w=64, seed=0):
    from vfx_image_stitching_tpu_torch.utils.synthetic import make_scene

    return make_scene(h, w, seed).astype(np.float32)[..., 1]


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_color_matches():
    from vfx_image_stitching_tpu.ops import color as jc
    from vfx_image_stitching_tpu_torch.ops import color as tc

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (17, 23, 3)).astype(np.uint8)
    ref = np.asarray(jc.bgr_to_gray_u8(jnp.asarray(img)))
    assert np.array_equal(tc.bgr_to_gray_u8(torch.as_tensor(img)).numpy(), ref)
    assert np.array_equal(tc.bgr_to_gray_u8_np(img), ref)
    assert np.array_equal(tc.bgr_to_gray_f32(torch.as_tensor(img)).numpy(),
                          np.asarray(jc.bgr_to_gray_f32(jnp.asarray(img))))
    gray = img[..., 0]
    assert np.array_equal(tc.bgr_to_gray_u8(torch.as_tensor(gray)).numpy(), gray)


@pytest.mark.parametrize("sigma,shape", [(1.6, (48, 64)), (1.2262735, (5, 7)),
                                         (3.3, (9, 40))])
def test_gaussian_blur_bit_exact(sigma, shape):
    """Including pads wider than the image (multi-reflection)."""
    from vfx_image_stitching_tpu.ops import gaussian as jg
    from vfx_image_stitching_tpu_torch.ops import gaussian as tg

    assert tg.cv2_auto_ksize(sigma) == jg.cv2_auto_ksize(sigma)
    k = tg.cv2_auto_ksize(sigma)
    assert np.array_equal(tg.gaussian_kernel1d(k, sigma),
                          jg.gaussian_kernel1d(k, sigma))
    img = np.random.default_rng(1).random((2,) + shape).astype(np.float32) * 255
    with jax.disable_jit():
        ref = np.asarray(jg.gaussian_blur(jnp.asarray(img), sigma))
    got = tg.gaussian_blur(torch.as_tensor(img), sigma).numpy()
    assert np.array_equal(got, ref)


def test_jitted_blur_fma_gap():
    """The measured gap to XLA's jitted (FMA-contracted) blur: <= 3 ulp."""
    from vfx_image_stitching_tpu.ops import gaussian as jg
    from vfx_image_stitching_tpu_torch.ops import gaussian as tg

    img = _gray()
    ref = np.asarray(jax.jit(lambda x: jg.gaussian_blur(x, 1.6))(jnp.asarray(img)))
    got = tg.gaussian_blur(torch.as_tensor(img), 1.6).numpy()
    assert _ulp(got, ref) <= 3


def test_resize_and_gradients_bit_exact():
    from vfx_image_stitching_tpu.ops import gradients as jgr
    from vfx_image_stitching_tpu.ops import resize as jr
    from vfx_image_stitching_tpu_torch.ops import gradients as tgr
    from vfx_image_stitching_tpu_torch.ops import resize as tr

    img = _gray(37, 53)
    with jax.disable_jit():
        up = np.asarray(jr.upsample2x_linear(jnp.asarray(img)))
        down = np.asarray(jr.downsample2x_nearest(jnp.asarray(img)))
        ix, iy = (np.asarray(a) for a in jgr.reference_gradients(jnp.asarray(img)))
        m, th = (np.asarray(a) for a in jgr.calc_orientation(jnp.asarray(ix),
                                                             jnp.asarray(iy)))
    t = torch.as_tensor(img)
    assert np.array_equal(tr.upsample2x_linear(t).numpy(), up)
    assert np.array_equal(tr.downsample2x_nearest(t).numpy(), down)
    tix, tiy = tgr.reference_gradients(t)
    assert np.array_equal(tix.numpy(), ix) and np.array_equal(tiy.numpy(), iy)
    tm, tth = tgr.calc_orientation(tix, tiy)
    assert _ulp(tm.numpy(), m) <= 1          # XLA CPU sqrt: 1 ulp off
    # atan2 differs by <= 1 ulp; the degree scaling and the mod can carry
    # that to a few ulp of the angle
    np.testing.assert_allclose(tth.numpy(), th, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# pyramid and extrema
# ---------------------------------------------------------------------------

def _jax_pyramid(gray):
    from vfx_image_stitching_tpu.models.sift import pyramid as jp

    with jax.disable_jit():
        base = jp.generate_base_image(jnp.asarray(gray))
        n = jp.compute_number_of_octaves(base.shape)
        kern = jp.generate_gaussian_kernels(1.6, 3)
        gauss = jp.generate_gaussian_images(base, n, kern)
        dogs = jp.generate_dog_images(gauss)
        return ([np.array(g) for g in gauss], [np.array(d) for d in dogs],
                base.shape)


def test_pyramid_bit_exact():
    from vfx_image_stitching_tpu.models.sift import pyramid as jp
    from vfx_image_stitching_tpu_torch.models.sift import pyramid as tp

    gray = _gray(40, 56)
    gauss_j, dogs_j, base_shape = _jax_pyramid(gray)
    base = tp.generate_base_image(torch.as_tensor(gray))
    n = tp.compute_number_of_octaves(base.shape)
    assert n == jp.compute_number_of_octaves(base_shape) == len(gauss_j)
    kern = tp.generate_gaussian_kernels(1.6, 3)
    assert np.array_equal(kern, jp.generate_gaussian_kernels(1.6, 3))
    assert tp.octave_shapes(tuple(base.shape), n) == jp.octave_shapes(
        tuple(base_shape), n)
    gauss = tp.generate_gaussian_images(base, n, kern)
    dogs = tp.generate_dog_images(gauss)
    for o in range(n):
        assert np.array_equal(gauss[o].numpy(), gauss_j[o]), o
        assert np.array_equal(dogs[o].numpy(), dogs_j[o]), o


def test_gradient_fields_ulp_gap():
    """sqrt and atan2 of XLA's CPU math library differ from PyTorch's by
    <= 1 ulp; the measured gap is pinned here."""
    from vfx_image_stitching_tpu.models.sift import pyramid as jp
    from vfx_image_stitching_tpu_torch.models.sift import pyramid as tp

    gauss_j, _, _ = _jax_pyramid(_gray(40, 56))
    stack = gauss_j[0][1:4]
    with jax.disable_jit():
        mag_j, ang_j = (np.asarray(a) for a in jp.gradient_fields(jnp.asarray(stack)))
    mag, ang = tp.gradient_fields(torch.tensor(stack))
    assert _ulp(mag.numpy(), mag_j) <= 1
    assert _ulp(ang.numpy(), ang_j) <= 4
    # the angle bin the orientation stage takes agrees almost everywhere
    frac = np.mean(np.rint(ang.numpy() * 0.1) != np.rint(ang_j * 0.1))
    assert frac < 1e-3


def test_extrema_bit_exact():
    from vfx_image_stitching_tpu.models.sift import extrema as je
    from vfx_image_stitching_tpu_torch.models.sift import extrema as te

    _, dogs_j, _ = _jax_pyramid(_gray(48, 64, seed=3))
    thresh = te.extrema_threshold(0.04, 3)
    assert thresh == je.extrema_threshold(0.04, 3)
    for o, dog in enumerate(dogs_j[:3]):
        h, w = dog.shape[-2:]
        with jax.disable_jit():
            mask_j = np.asarray(je.extrema_mask(jnp.asarray(dog), 5, thresh))
            cand_j = [np.asarray(a) for a in je.extract_candidates(
                jnp.asarray(dog), 5, thresh, 256)]
        assert np.array_equal(
            te.extrema_mask(torch.as_tensor(dog), 5, thresh).numpy(), mask_j)
        cand = te.extract_candidates(torch.as_tensor(dog), 5, thresh, 256)
        for a, b in zip(cand, cand_j):
            assert np.array_equal(a.numpy(), b), o
        if o == 0:
            assert 0 < int(cand_j[3].sum()) < 256


# ---------------------------------------------------------------------------
# keypoint sets
# ---------------------------------------------------------------------------

def _keypoint_set(rng, k):
    """Random keypoints with exact duplicates, ties on every sort key and
    invalid rows carrying NaN/garbage."""
    x = rng.integers(0, 20, k).astype(np.float32) * 0.5
    y = rng.integers(0, 4, k).astype(np.float32)
    size = rng.integers(1, 4, k).astype(np.float32)
    angle = rng.integers(0, 3, k).astype(np.float32) * 10
    resp = rng.integers(1, 3, k).astype(np.float32) * 0.25
    dup = rng.integers(0, k, k // 4)
    x[dup[1:]], y[dup[1:]] = x[dup[0]], y[dup[0]]
    octave = (rng.integers(-1, 6, k) & 255) + (rng.integers(1, 4, k) << 8) + (
        rng.integers(0, 256, k) << 16)
    valid = rng.random(k) > 0.2
    angle[~valid] = np.nan
    ints = [rng.integers(0, 50, k).astype(np.int32) for _ in range(5)]
    return [x, y, size, angle, resp, octave.astype(np.int32), valid] + ints


def test_keypoint_set_ops_bit_exact():
    from vfx_image_stitching_tpu.models.sift import keypoints as jk
    from vfx_image_stitching_tpu_torch.models.sift import keypoints as tk

    rng = np.random.default_rng(5)
    fields = _keypoint_set(rng, 97)
    desc = rng.integers(0, 256, (97, 128)).astype(np.float32)
    jkps = jk.Keypoints(*[jnp.asarray(f) for f in fields])
    tkps = tk.Keypoints(*[torch.as_tensor(f) for f in fields])

    for a, b in zip(tk.unpack_octave(tkps.octave), jk.unpack_octave(jkps.octave)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tk.convert_keypoints_to_input_image_size(tkps),
                    jk.convert_keypoints_to_input_image_size(jkps)):
        assert np.array_equal(a.numpy(), np.asarray(b), equal_nan=True)
    for a, b in zip(tk.compact(tkps, 64), jk.compact(jkps, 64)):
        assert np.array_equal(a.numpy(), np.asarray(b), equal_nan=True)
    idx = rng.integers(0, 97, 30)
    iv = rng.random(30) > 0.5
    for a, b in zip(tk.take(tkps, torch.as_tensor(idx), torch.as_tensor(iv)),
                    jk.take(jkps, jnp.asarray(idx), jnp.asarray(iv))):
        assert np.array_equal(a.numpy(), np.asarray(b), equal_nan=True)

    with jax.disable_jit():
        kj, dj = jk.sort_and_dedup(jkps, jnp.asarray(desc), 80)
    kt, dt = tk.sort_and_dedup(tkps, torch.as_tensor(desc), 80)
    v = np.asarray(kj.valid)
    assert np.array_equal(kt.valid.numpy(), v)
    assert 0 < v.sum() < 80
    for a, b in zip(kt, kj):
        assert np.array_equal(a.numpy()[v], np.asarray(b)[v])
    assert np.array_equal(dt.numpy()[v], np.asarray(dj)[v])
    cat = tk.concatenate((tkps, tkps))
    assert cat.capacity == 2 * 97 and int(cat.count()) == 2 * int(tkps.count())
