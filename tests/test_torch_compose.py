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


# ---------------------------------------------------------------------------
# the fold kernel's Python side (compose/blend.py: fold_kernel): what runs
# before any launch, on the CPU
# ---------------------------------------------------------------------------

def _bad_batches():
    good = np.zeros((3, 12, 16, 3), np.uint8)
    return {
        "float": torch.zeros((3, 12, 16, 3), dtype=torch.float32),
        "three_dims": torch.as_tensor(good[0]),
        "four_channels": torch.zeros((3, 12, 16, 4), dtype=torch.uint8),
        "not_contiguous": torch.as_tensor(good).transpose(1, 2),
        "too_tall": torch.zeros((3, 40, 16, 3), dtype=torch.uint8),
        "missing_image": torch.as_tensor(good[:2]),
    }


def _small_plan():
    from vfx_image_stitching_tpu_torch.compose.plan import plan_compose

    return plan_compose(12, 16, 3, [True] * 3, [(6.0, 1.0), (-5.0, 0.5)],
                        [((9.0, 4.0), (3.0, 3.0)), ((2.0, 5.0), (7.5, 5.0))])


@pytest.mark.parametrize("bad", list(_bad_batches()))
def test_fold_kernel_checks_its_inputs_before_any_launch(bad):
    """dtype, shape, contiguity and the plan's image indices and canvas
    are checked in Python before the library is built or a kernel
    launched, so a bad batch raises on the CPU too."""
    from vfx_image_stitching_tpu_torch.compose import blend

    before = dict(blend.LAUNCHES)
    with pytest.raises((TypeError, ValueError)):
        blend.fold_kernel(_bad_batches()[bad], _small_plan())
    assert blend.LAUNCHES == before and not blend.LIBRARY.loaded


def test_fold_kernel_refuses_a_cpu_batch_and_compose_folds_it_plainly():
    """A good CPU batch: ``fold_kernel`` refuses it before any launch,
    and ``compose_mosaic`` takes the plain fold, equal to the host fold,
    with ``n_fold_kernel_steps`` 0 beside ``n_fold_steps``."""
    from vfx_image_stitching_tpu_torch.compose import blend
    from vfx_image_stitching_tpu_torch.compose.host import compose_mosaic_host
    from vfx_image_stitching_tpu_torch.utils.profiling import request

    images = np.random.default_rng(4).integers(0, 256, (3, 12, 16, 3),
                                               dtype=np.uint8)
    plan = _small_plan()
    before = dict(blend.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        blend.fold_kernel(torch.as_tensor(images), plan)
    with request() as trace:
        mosaic, steps = blend.compose_mosaic(torch.as_tensor(images), plan,
                                             return_steps=True)
        t = trace.take()
    assert np.array_equal(mosaic.numpy(), compose_mosaic_host(list(images),
                                                              plan))
    plain, plain_steps = blend.fold_plain(torch.as_tensor(images), plan, True)
    assert np.array_equal(plain.numpy(), mosaic.numpy()) and len(steps) == 2
    assert all(np.array_equal(a, b) for a, b in zip(steps, plain_steps))
    assert t["n_fold_kernel_steps"] == 0 and t["n_fold_steps"] == 2
    assert blend.LAUNCHES == before and not blend.LIBRARY.loaded


def test_library_counts_launches_from_threads_and_resets():
    """``utils/cuda_build.Library``, which the fold's and the SIFT
    kernels' wrappers share: counts added from many threads at once (the
    mesh layer's slot threads) all land, ``reset`` zeroes them, and
    nothing is built or loaded by counting."""
    import threading

    from vfx_image_stitching_tpu_torch.compose import blend
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.utils.cuda_build import CSRC, Library

    lib = Library("count_only", (CSRC / "compose_fold.cu",), (), {},
                  kernels=("a", "b"))

    def add():
        for _ in range(500):
            lib.count("a")
        lib.count("b")

    threads = [threading.Thread(target=add) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert lib.launches == {"a": 4000, "b": 8} and not lib.loaded
    lib.reset()
    assert lib.launches == {"a": 0, "b": 0}
    assert blend.LAUNCHES is blend.LIBRARY.launches
    assert K.LAUNCHES is K.LIBRARY.launches
    assert set(blend.LAUNCHES) == {"compose_column_occupancy",
                                   "compose_fold_step"}


@pytest.mark.parametrize("seed", range(6))
def test_fold_launches_give_the_host_folds_offsets_and_band(seed):
    """On random plans (some offsets past the canvas), each step's launch
    arguments are the host fold's clamped ``oy`` and ``x0`` (its own
    clamp), where ``place_on_canvas`` puts the image, and the host fold
    step changes no column outside the band ``[x0, x0 + W)``."""
    from vfx_image_stitching_tpu_torch.compose.blend import fold_launches
    from vfx_image_stitching_tpu_torch.compose.host import (
        _clamped,
        _fold_step,
        _init_canvas,
    )
    from vfx_image_stitching_tpu_torch.compose.plan import plan_compose
    from vfx_image_stitching_tpu_torch.geometry.canvas import place_on_canvas

    images, valid, shifts, pairs = _chain(seed, n=5)
    n, h, w = images.shape[:3]
    plan = plan_compose(h, w, n, valid, shifts, pairs)
    rng = np.random.default_rng(seed)
    for s in plan.steps[::2]:  # push some offsets past the canvas
        s.img_off_x += int(rng.integers(-2, 3)) * plan.width
        s.img_off_y += int(rng.integers(-2, 3)) * plan.height
    launches = fold_launches(plan, h, w)
    canvas, occ = _init_canvas(images, plan)
    for f, s in zip(launches, plan.steps):
        assert (f.img_index, f.swapped, f.overlap_range) == (
            s.img_index, s.swapped, s.overlap_range)
        assert f.oy == _clamped(s.img_off_y, h, plan.height)
        assert f.x0 == _clamped(s.img_off_x, w, plan.width)
        assert 0 <= f.oy <= plan.height - h and 0 <= f.x0 <= plan.width - w
        placed = place_on_canvas(torch.as_tensor(images[f.img_index]),
                                 plan.height, plan.width, s.img_off_y,
                                 s.img_off_x).numpy()
        assert np.array_equal(placed[f.oy:f.oy + h, f.x0:f.x0 + w],
                              images[f.img_index])
        prev = canvas.copy()
        _fold_step(canvas, occ, images[f.img_index], s)
        changed = np.nonzero((canvas != prev).any(axis=(0, 2)))[0]
        assert changed.size and f.x0 <= changed.min() <= changed.max() < f.x0 + w


def _fold_case_steps(images, plan):
    """Per step of the host fold: (launch, overlap columns, of them the
    ones the step leaves empty)."""
    from vfx_image_stitching_tpu_torch.compose.blend import fold_launches
    from vfx_image_stitching_tpu_torch.compose.host import (
        _col_occupancy,
        _fold_step,
        _init_canvas,
    )

    h, w = images.shape[1:3]
    canvas, occ = _init_canvas(images, plan)
    out = []
    for f, s in zip(fold_launches(plan, h, w), plan.steps):
        img = images[f.img_index]
        ovl = _col_occupancy(img) & occ[f.x0:f.x0 + w]
        _fold_step(canvas, occ, img, s)
        out.append((f, int(ovl.sum()),
                    int((ovl & ~occ[f.x0:f.x0 + w]).sum())))
    return out


def test_fold_kernel_card_cases_cover_what_they_claim():
    """The card's fold cases (``utils/synthetic.FOLD_CASES``)
    hold swapped and unswapped steps; blended steps whose alpha
    denominator is 0, negative and not an integer; images at the
    canvas's top and bottom rows and an x offset clamped; a skipped
    image; a blended column the cast empties; one plan at the
    benchmark's size (18 images of 512x384, steps of about 246 px); and
    on each but that one the plain fold equals the host fold."""
    from vfx_image_stitching_tpu_torch.compose.blend import fold_plain
    from vfx_image_stitching_tpu_torch.compose.host import compose_mosaic_host
    from vfx_image_stitching_tpu_torch.utils.synthetic import FOLD_CASES

    steps, skipped, clamped = [], False, False
    for name, make in FOLD_CASES.items():
        images, plan = make()
        n, h, w = images.shape[:3]
        per_step = _fold_case_steps(images, plan)
        steps += [(plan, h) + st for st in per_step]
        read = {0} | {s.img_index for s in plan.steps}
        skipped |= len(read) < n
        clamped |= any(s.img_off_x > plan.width - w for s in plan.steps)
        if name == "pano18":
            assert (n, h, w) == (18, 512, 384) and len(plan.steps) == 17
            x0s = [f.x0 for f, _n, _z in per_step]
            gaps = np.abs(np.diff(x0s))
            assert all(240 <= g <= 253 for g in gaps)
            assert all(ov > 0 for _f, ov, _z in per_step)
            continue
        plain = fold_plain(torch.as_tensor(images), plan)[0].numpy()
        assert np.array_equal(plain, compose_mosaic_host(list(images), plan))
    blended = [(f, ov) for _p, _h, f, ov, _z in steps if ov]
    assert {f.swapped for f, _ov in blended} == {False, True}
    ranges = [f.overlap_range for f, _ov in blended]
    assert 0.0 in ranges and min(ranges) < 0
    assert any(not float(r).is_integer() for r in ranges)
    assert any(f.oy == 0 for _p, _h, f, _ov, _z in steps)
    assert any(f.oy == p.height - h and f.oy > 0
               for p, h, f, _ov, _z in steps)
    assert skipped and clamped
    assert any(z for *_rest, z in steps)
