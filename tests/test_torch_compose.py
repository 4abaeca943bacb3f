"""PyTorch port, device compose: canvas placement, the blend, the step
capture and the device crop bounds, against the JAX package (run op by op
under ``jax.disable_jit()``), the port's host fold and the reference
oracle (``tests/oracles.py``).

The port's device fold computes alpha as the reference and the host fold
do (a float64 division whose weights round to float32 at the multiply),
so it equals both byte for byte on every case.  The JAX device fold
divides in float32; where every step's alpha denominator is 0 or a power
of two its alphas are exact and it equals the port byte for byte, and
elsewhere it differs from the host fold, and so from the port, by one on
a few pixels, the bound its own tests hold its two routes to
(``tests/test_compose.py::_assert_blend_parity``).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import oracles
from tests.test_compose import _assert_blend_parity

torch.set_num_threads(1)


def _chain(seed, n=4, h=36, w=48):
    """A random chain as tests/test_compose_host.py builds it (black
    leading columns exercise the occupancy tests)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    images[:, :, :3] = 0
    shifts, pairs = [], []
    for i in range(n - 1):
        dx = int(rng.integers(10, 34)) * (1 if (seed + i) % 2 == 0 else -1)
        dy = float(rng.integers(-5, 6)) + float(rng.random())
        xa = int(rng.integers(8, w - 8))
        ya = int(rng.integers(4, h - 4))
        shifts.append((float(dx), dy))
        # a fractional x, as SIFT keypoints give, makes the alpha
        # denominator a non-integer
        pairs.append(((xa + 0.25 * (seed % 3), ya), (xa - dx, ya - int(dy))))
    return images, [True] * n, shifts, pairs


def _dyadic():
    """overlap_range = 64: every alpha is dyadic."""
    rng = np.random.default_rng(11)
    images = rng.integers(10, 256, (2, 32, 56, 3), dtype=np.uint8)
    return images, [True, True], [(20.0, 2.0)], [((10, 9), (18, 9))]


def _zero_range():
    """xb - xa + W == 0: alpha stays 0."""
    rng = np.random.default_rng(5)
    images = rng.integers(10, 256, (2, 20, 30, 3), dtype=np.uint8)
    return images, [True, True], [(5.0, 0.0)], [((30.0, 5.0), (0.0, 5.0))]


def _unreadable():
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (4, 30, 40, 3), dtype=np.uint8)
    images[2] = 0
    shifts = [(12.0, 1.5), (0.0, 0.0), (-15.0, -2.0)]
    pairs = [((20, 10), (8, 9)), None, ((10, 12), (25, 14))]
    return images, [True, True, False, True], shifts, pairs


def _no_steps():
    rng = np.random.default_rng(9)
    images = rng.integers(0, 256, (3, 24, 32, 3), dtype=np.uint8)
    images[1:] = 0
    return images, [True, False, False], [(0.0, 0.0)] * 2, [None, None]


def _artifact():
    """Image 0 is 1 in row 0 only and image 1 is 1 in row 1 only, so every
    overlap column with 0 < alpha < 1 blends to values in (0, 1), which the
    uint8 cast floors to 0: those columns are empty at step 2, and image 2
    is pasted there instead of blended."""
    h, w = 8, 16
    images = np.zeros((3, h, w, 3), np.uint8)
    images[0, 0] = 1
    images[1, 1] = 1
    images[2] = np.random.default_rng(3).integers(10, 256, (h, w, 3))
    shifts = [(8.0, 0.0), (8.0, 0.0)]
    pairs = [((10.0, 0.0), (2.0, 0.0)), ((10.0, 0.0), (2.0, 0.0))]
    return images, [True, True, True], shifts, pairs


CASES = {
    **{f"seed{s}": (lambda s=s: _chain(s)) for s in range(4)},
    "dyadic": _dyadic,
    "zero_range": _zero_range,
    "unreadable": _unreadable,
    "no_steps": _no_steps,
    "artifact": _artifact,
}


def _exact_alpha(plan) -> bool:
    """Every step's alpha is exact in float32 (denominator 0 or 2^k)."""
    return all(s.overlap_range == 0.0
               or math.log2(s.overlap_range).is_integer()
               for s in plan.steps)


@pytest.mark.parametrize("case", list(CASES))
def test_compose_mosaic_matches_host_oracle_and_jax(case):
    from vfx_image_stitching_tpu.compose.blend import compose_mosaic as jcompose
    from vfx_image_stitching_tpu.compose.plan import plan_compose as jplan
    from vfx_image_stitching_tpu_torch.compose.blend import compose_mosaic
    from vfx_image_stitching_tpu_torch.compose.host import compose_mosaic_host
    from vfx_image_stitching_tpu_torch.compose.plan import plan_compose

    images, valid, shifts, pairs = CASES[case]()
    n, h, w = images.shape[:3]
    plan = plan_compose(h, w, n, valid, shifts, pairs)
    assert dataclasses.asdict(plan) == dataclasses.asdict(
        jplan(h, w, n, valid, shifts, pairs))
    mosaic, steps = compose_mosaic(torch.as_tensor(images), plan,
                                   return_steps=True)
    mosaic = mosaic.numpy()
    assert np.array_equal(compose_mosaic(torch.as_tensor(images), plan).numpy(),
                          mosaic)
    host = compose_mosaic_host({i: images[i] for i in range(n) if valid[i]},
                               plan)
    assert np.array_equal(mosaic, host)
    if all(p is not None for p, v in zip(pairs, valid[1:]) if v):
        oracle = oracles.compose_sequence(
            [images[i] if valid[i] else None for i in range(n)], shifts, pairs)
        assert np.array_equal(mosaic, oracle)
    assert len(steps) == len(plan.steps)
    if steps:
        s = plan.steps[-1]
        assert np.array_equal(steps[-1], mosaic[
            s.frame_off_y:s.frame_off_y + s.local_h,
            s.frame_off_x:s.frame_off_x + s.local_w])
    else:
        assert np.array_equal(
            mosaic[plan.mosaic0_off_y:plan.mosaic0_off_y + h,
                   plan.mosaic0_off_x:plan.mosaic0_off_x + w], images[0])

    with jax.disable_jit():
        j_mosaic, j_steps = jcompose(jnp.asarray(images), plan,
                                     return_steps=True)
    j_mosaic = np.asarray(j_mosaic)
    if _exact_alpha(plan):
        assert np.array_equal(mosaic, j_mosaic)
        assert all(np.array_equal(a, b) for a, b in zip(steps, j_steps))
    else:
        _assert_blend_parity(j_mosaic, mosaic)
        for a, b in zip(steps, j_steps):
            _assert_blend_parity(b, a)

    if case == "artifact":
        # step 1's blended overlap columns floored to 0 ...
        assert not steps[0][:, 9:16].any() and steps[0][0, 8].any()
        # ... so step 2 pastes image 2 there instead of blending it
        assert np.array_equal(mosaic[:, 9:16], images[2][:, 1:8])


@pytest.mark.parametrize("off", [(0, 0), (3, 5), (9, 20), (2, 30)])
def test_place_on_canvas_matches_jax(off):
    """Placement, and the clamp of an offset past the canvas's edge."""
    from vfx_image_stitching_tpu.geometry.canvas import place_on_canvas as jplace
    from vfx_image_stitching_tpu.geometry.canvas import pad_amounts as jpad
    from vfx_image_stitching_tpu_torch.geometry.canvas import (
        pad_amounts,
        place_on_canvas,
    )

    img = np.random.default_rng(1).integers(0, 256, (7, 9, 3), dtype=np.uint8)
    got = place_on_canvas(torch.as_tensor(img), 16, 32, *off).numpy()
    with jax.disable_jit():
        want = np.asarray(jplace(jnp.asarray(img), 16, 32, *off))
    assert np.array_equal(got, want)
    for move in (-2.5, -1.5, 0.5, 1.5, 3.7, -8.2):
        assert pad_amounts(move) == jpad(move)


@pytest.mark.parametrize("overlap_range", [0.0, 16.0, 24.0, 37.25])
def test_blend_pair_matches_oracle_and_jax(overlap_range):
    """One blend of two overlapping canvases: the reference's bytes; the
    JAX blend's where alpha is exact, its route bound elsewhere."""
    from vfx_image_stitching_tpu.compose.blend import _blend_pair as jblend
    from vfx_image_stitching_tpu_torch.compose.blend import _blend_pair

    rng = np.random.default_rng(int(overlap_range))
    a = np.zeros((12, 40, 3), np.uint8)
    b = np.zeros((12, 40, 3), np.uint8)
    a[:, :28] = rng.integers(0, 256, (12, 28, 3))
    b[:, 12:] = rng.integers(0, 256, (12, 28, 3))
    got = _blend_pair(torch.as_tensor(a), torch.as_tensor(b),
                      overlap_range).numpy()
    # the reference's column loop (tests/oracles.py) on the same canvases
    af, bf = a.astype(np.float32), b.astype(np.float32)
    ov = a.any((0, 2)) & b.any((0, 2))
    want = np.where(a.any((0, 2))[None, :, None], af, bf)
    counter = 0
    for c in np.nonzero(ov)[0]:
        alpha = counter / overlap_range if overlap_range != 0 else 0
        counter += 1
        want[:, c] = (1 - alpha) * af[:, c] + alpha * bf[:, c]
    assert np.array_equal(got, want.astype(np.uint8))
    with jax.disable_jit():
        j = np.asarray(jblend(jnp.asarray(a), jnp.asarray(b),
                              jnp.float32(overlap_range)))
    if overlap_range in (0.0, 16.0):
        assert np.array_equal(got, j)
    else:
        _assert_blend_parity(j, got)


@pytest.mark.parametrize("case", ["box", "all_black", "threshold", "edge"])
def test_device_crop_bounds_match_jax_and_host(case):
    from vfx_image_stitching_tpu.compose.crop import crop_bounds as jbounds
    from vfx_image_stitching_tpu_torch.compose.crop import (
        crop_bounds,
        mosaic_with_bounds,
    )
    from vfx_image_stitching_tpu_torch.compose.host import content_bounds_host

    rng = np.random.default_rng(4)
    img = np.zeros((50, 70, 3), np.uint8)
    thr = 0
    if case == "box":
        img[8:44, 5:61] = rng.integers(1, 256, (36, 56, 3))
    elif case == "threshold":
        img[3:40, 2:30] = 20
        img[10:20, 12:22] = 200
        thr = 50
    elif case == "edge":
        img[0, 69] = 255
        img[49, 0] = 255
    got = crop_bounds(torch.as_tensor(img), thr)
    with jax.disable_jit():
        want = tuple(np.asarray(v).item() for v in jbounds(jnp.asarray(img), thr))
    assert got == tuple(int(v) if not isinstance(v, bool) else v
                        for v in want)
    assert got == content_bounds_host(img, thr)
    mosaic, bounds = mosaic_with_bounds(torch.as_tensor(img), thr)
    assert np.array_equal(mosaic, img) and bounds == got
