"""PyTorch port: each CUDA kernel against its plain PyTorch version, on the
card.  Marked ``cuda``; skipped without a GPU.  This file imports neither
JAX nor the test conftest, so on the GPU machine it runs as

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Contracts: the Newton kernel's integer and float lanes and the window
gather (all three load stages) bit for bit; orientation histograms (both
kernels, 36 and 128 bins, each load stage) to rtol 2e-5 / atol 2e-3 and
raw descriptor histograms to rtol 1e-5 / atol 1e-3 (reduction order),
each bit-identical from launch to launch; the descriptor kernels'
orientation remainder and bins equal to ``fmodf`` and integer modulo on
every float.  The probe kernels (``probes/kernels.py``): the stack sum (every
compiled layer count and both load widths) and cube sums and the
float-lane Newton kernel bit for bit (P4 also against
K1, on long walks, at the stack's edges, at 4 and 6 layers), each one
device kernel per call; the tensor-core
descriptor histogram within 2e-3 (TF32) and 1e-5 (3xTF32) of its plain
version's maximum.  The Harris response kernel
(``csrc/harris_response.cu``) bit-equal to its plain version on the same
CUDA tensor (the ``pano18`` shape, odd sizes, an image shorter than the
blur's pad, gray input, extra leading dims, a blur other than 21 taps),
one device kernel a call; the Harris backend on the card
against the CPU: keypoints equal, descriptors within 1e-5, a chain's
shifts, pairs and panorama bytes equal, one response launch a stitch.  The device compose (the fold
kernel, ``compose/blend.py``) on the card byte-equal to the host fold
and the CPU's plain fold, steps and crop bounds included, one launch a
step; both compose routes, the step capture and the stage
API equal to the CPU's stitch for both backends; ``stitch_many`` equal to
the loop of ``stitch_panorama``.  The mesh layer on two logical slots of
the card equal to the unsharded step and ``stitch_many``, and its batched
multi-panorama steps (``mode="vmap"``, ``sharded_multi_pano_shifts``)
equal to ``shard_map`` and the per-panorama step on logical slots, with
one extraction and one pair step a slot and K1-K3 once an octave (a
bucket) for the slot's whole batch; the
visualizers' ``compute_stages`` and ``harris_match_pair`` on the card
against the CPU; the localize probe's ``fused`` phase, ``plain`` equal to
``resident`` with K1 the only kernel launched.  The matcher's Lowe ratio
test, equal to the CPU's.
"""

import numpy as np
import pytest
import torch

from vfx_image_stitching_tpu_torch.utils.synthetic import FOLD_CASES

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run with -m cuda on the card)")
    return torch.device("cuda")


def _one_device_kernel(fn, counter: str, launches: dict | None = None) -> bool:
    """Whether a call of ``fn``, a call of the wrapper that counts its
    launches in ``launches[counter]`` (by default the SIFT library's
    ``LAUNCHES``), runs exactly one device kernel (``timing.one_kernel_ms``
    raises if not)."""
    from vfx_image_stitching_tpu_torch.utils.timing import one_kernel_ms

    return one_kernel_ms(fn, counter, reps=5, launches=launches) > 0


def _octave0(dev, h=96, w=128, seed=0):
    """Octave 0 of a synthetic image: Gaussian stack, DoG, candidates."""
    from vfx_image_stitching_tpu_torch.utils.synthetic import make_scene
    from vfx_image_stitching_tpu_torch.models.sift import extrema as te
    from vfx_image_stitching_tpu_torch.models.sift import pyramid as tp

    gray = torch.as_tensor(make_scene(h, w, seed)[..., 1], device=dev)
    base = tp.generate_base_image(gray.to(torch.float32))
    gauss = tp.generate_gaussian_images(base, 1, tp.generate_gaussian_kernels(1.6, 3))[0]
    dog = tp.generate_dog_images([gauss])[0]
    cand = te.extract_candidates(dog, 5, te.extrema_threshold(0.04, 3), 1024)
    return gauss, dog, cand


def test_localize_newton_kernel_matches_plain(dev):
    """Integer and float lanes bit for bit on octave 0 of a synthetic image
    and on a random (5, 21, 131) stack (W not a multiple of 4); repeated
    launches identical."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    rng = np.random.default_rng(2)
    rand = torch.as_tensor(rng.integers(-80, 80, (5, 21, 131)).astype(np.float32),
                           device=dev)
    from vfx_image_stitching_tpu_torch.models.sift import extrema as te

    cases = [_octave0(dev)[1:],
             (rand, te.extract_candidates(rand, 5, 1.0, 256))]
    for dog, cand in cases:
        assert int(cand[3].sum()) > 0
        n0 = K.LAUNCHES["localize_newton_resident"]
        got_i, got_f = K.localize_newton_resident(dog, *cand, 5, 3, 5)
        assert K.LAUNCHES["localize_newton_resident"] == n0 + 1
        want_i, want_f = K.localize_newton_plain(dog, *cand, 5, 3, 5)
        assert torch.equal(got_i, want_i) and torch.equal(got_f, want_f)
        again = K.localize_newton_resident(dog, *cand, 5, 3, 5)
        assert torch.equal(got_i, again[0]) and torch.equal(got_f, again[1])


def _orientation_args(dev, seed, k, half, h, w, rad_hi, num_bins, offset=0):
    """Random (3, h, w) fields (at a 4-byte ``offset`` from their
    allocation), centers inside and outside them, radii 0..rad_hi."""
    rng = np.random.default_rng(seed)
    n = 3 * h * w
    mag, ang = (torch.as_tensor((rng.random(n + offset) * sc).astype(np.float32),
                                device=dev)[offset:].view(3, h, w) for sc in (100, 360))
    ints = [torch.as_tensor(rng.integers(lo, hi, k).astype(np.int32), device=dev)
            for lo, hi in ((0, 3), (-5, h + 5), (-5, w + 5), (0, rad_hi + 1))]
    wf = torch.as_tensor((-0.5 / (rng.random(k) * 4 + 1) ** 2).astype(np.float32),
                         device=dev)
    valid = torch.as_tensor(rng.random(k) > 0.2, device=dev)
    return (mag, ang, *ints, wf, valid, half, num_bins)


@pytest.mark.parametrize("num_bins,w,offset,rad_over,load", [
    (36, 172, 0, 0, "cp.async.16"),
    (128, 172, 0, 0, "cp.async.16"),
    (36, 170, 0, 0, "cp.async.4"),      # W not a multiple of 4
    (128, 172, 1, 0, "cp.async.4"),     # stacks at a 4-byte offset
    (36, 172, 0, 6, "cp.async.16"),     # radii up to half + 6
    (128, 170, 0, 6, "cp.async.4"),
])
def test_orientation_histograms_kernel_matches_plain(dev, num_bins, w, offset,
                                                     rad_over, load):
    """K2 (staged) and K4 (unstaged) against the plain version and each
    other (rtol 2e-5, atol 2e-3), one launch and one device kernel per
    call, repeated launches bit-identical, invalid rows zero."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    half = 20
    args = _orientation_args(dev, 3 + num_bins + w, 300, half, 150, w,
                             half + rad_over, num_bins, offset)
    assert K.orientation_load(args[0], args[1], half, num_bins) == load
    want = K.orientation_histograms_plain(*args)
    valid = args[7]
    outs = []
    for name, fn in (("orientation_histograms", K.orientation_histograms),
                     ("orientation_histograms_v1", K.orientation_histograms_v1)):
        n0 = K.LAUNCHES[name]
        got = fn(*args)
        assert K.LAUNCHES[name] == n0 + 1
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-3)
        assert torch.equal(got, fn(*args))  # deterministic
        assert not got[~valid].any() and (got[valid].sum(1) > 0).sum() > 150
        assert _one_device_kernel(lambda: fn(*args), name)
        outs.append(got)
    torch.testing.assert_close(outs[0], outs[1], rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("num_bins", [36, 128])
def test_orientation_histograms_kernel_unstaged_window(dev, num_bins):
    """A window too large for K2's two stages (half 60): K2's call bins it
    with K4's kernel; both against the plain version."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    half = 60
    args = _orientation_args(dev, 60 + num_bins, 200, half, 200, 260, half,
                             num_bins)
    assert K.orientation_load(args[0], args[1], half, num_bins) == "direct"
    want = K.orientation_histograms_plain(*args)
    for fn in (K.orientation_histograms, K.orientation_histograms_v1):
        got = fn(*args)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-3)
        assert torch.equal(got, fn(*args))


def test_orientation_histograms_kernel_edge_cases(dev):
    """Every row invalid (zeros, nothing loaded), no rows (no launch), a
    single-pixel interior, and every center outside the fields."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    for fn, name in ((K.orientation_histograms, "orientation_histograms"),
                     (K.orientation_histograms_v1, "orientation_histograms_v1")):
        args = list(_orientation_args(dev, 8, 100, 20, 90, 120, 20, 36))
        args[7] = torch.zeros_like(args[7])
        got = fn(*args)
        assert got.shape == (100, 36) and not got.any()
        empty = [a[:0] if torch.is_tensor(a) and a.ndim == 1 else a for a in args]
        n0 = K.LAUNCHES[name]
        got = fn(*empty)
        assert got.shape == (0, 36) and K.LAUNCHES[name] == n0
        tiny = _orientation_args(dev, 9, 64, 20, 3, 3, 20, 128)
        torch.testing.assert_close(fn(*tiny), K.orientation_histograms_plain(*tiny),
                                   rtol=2e-5, atol=2e-3)
        far = list(_orientation_args(dev, 10, 64, 20, 90, 120, 20, 36))
        far[3] = far[3] + 500
        got = fn(*far)
        torch.testing.assert_close(got, K.orientation_histograms_plain(*far),
                                   rtol=2e-5, atol=2e-3)
        assert not got.any()


@pytest.mark.parametrize("half_cap", [28, 44])
def test_descriptor_histograms_kernel_matches_plain(dev, half_cap):
    """Raw trilinear histograms against the plain version (rtol 1e-5,
    atol 1e-3: summation order), repeated launches bit-identical, invalid
    rows zero."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    rng = np.random.default_rng(half_cap)
    k, h, w = 257, 120, 160
    mag, ang = (torch.as_tensor(rng.random((3, h, w)).astype(np.float32) * s,
                                device=dev) for s in (100, 360))
    ints = [torch.as_tensor(rng.integers(lo, hi, k).astype(np.int32), device=dev)
            for lo, hi in ((0, 3), (-5, h + 5), (-5, w + 5), (0, half_cap + 1))]
    hist_width = ints[3].to(torch.float32) / 3.5355 + 0.5
    theta = torch.as_tensor(rng.random(k).astype(np.float32) * 360, device=dev)
    rad = torch.deg2rad(theta)
    valid = torch.as_tensor(rng.random(k) > 0.2, device=dev)
    args = (mag, ang, *ints, torch.cos(rad), torch.sin(rad), hist_width, theta,
            valid, half_cap)
    n0 = K.LAUNCHES["descriptor_histograms"]
    got = K.descriptor_histograms(*args)
    assert K.LAUNCHES["descriptor_histograms"] == n0 + 1
    torch.testing.assert_close(got, K.descriptor_histograms_plain(*args),
                               rtol=1e-5, atol=1e-3)
    assert torch.equal(got, K.descriptor_histograms(*args))  # deterministic
    assert not got[~valid].any() and (got[valid].amax(1) > 0).sum() > k // 2


def _descriptor_args(dev, seed, k, half_cap, h, w, ww=4, nb=8, half_lo=0,
                     py=None, px=None):
    """Random (3, h, w) fields and k keypoints: centers ``py``/``px`` (or
    random, some outside the fields), half-widths half_lo..half_cap, the
    bin width that half-width implies, random angles, 80% valid."""
    rng = np.random.default_rng(seed)
    mag, ang = (torch.as_tensor(rng.random((3, h, w)).astype(np.float32) * s,
                                device=dev) for s in (100, 360))
    if py is None:
        py = rng.integers(-5, h + 5, k)
    if px is None:
        px = rng.integers(-5, w + 5, k)
    ints = [torch.as_tensor(np.asarray(a).astype(np.int32), device=dev)
            for a in (rng.integers(0, 3, k), py, px,
                      rng.integers(half_lo, half_cap + 1, k))]
    hist_width = ints[3].to(torch.float32) / (0.7071 * (ww + 1)) + 0.5
    theta = torch.as_tensor(rng.random(k).astype(np.float32) * 360, device=dev)
    rad = torch.deg2rad(theta)
    valid = torch.as_tensor(rng.random(k) > 0.2, device=dev)
    return [mag, ang, *ints, torch.cos(rad), torch.sin(rad), hist_width, theta,
            valid, half_cap, nb, ww]


def _check_descriptor(args):
    """K5 against its plain version (rtol 1e-5, atol 1e-3), one launch
    and one device kernel per call, bit-identical repeats, invalid rows
    zero; returns the histograms."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    n0 = K.LAUNCHES["descriptor_histograms"]
    got = K.descriptor_histograms(*args)
    assert K.LAUNCHES["descriptor_histograms"] == n0 + 1
    torch.testing.assert_close(got, K.descriptor_histograms_plain(*args),
                               rtol=1e-5, atol=1e-3)
    assert torch.equal(got, K.descriptor_histograms(*args))
    assert not got[~args[10]].any()
    assert _one_device_kernel(lambda: K.descriptor_histograms(*args),
                              "descriptor_histograms")
    return got


def test_descriptor_histograms_kernel_tail(dev):
    """Every row at half_w = 44, the largest box (89x89 samples, the
    tail of the histogram route)."""
    args = _descriptor_args(dev, 44, 300, 44, 220, 260, half_lo=44)
    got = _check_descriptor(args)
    assert (got[args[10]].amax(1) > 0).sum() > 200


def test_descriptor_histograms_kernel_edge_cases(dev):
    """One keypoint; every row invalid (zeros); no rows (no launch);
    boxes that touch each edge of the fields, and centers past them."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    h, w = 120, 150
    one = _descriptor_args(dev, 11, 1, 44, h, w, py=[60], px=[70])
    one[10] = torch.ones_like(one[10])
    assert _check_descriptor(one).amax() > 0
    dead = _descriptor_args(dev, 12, 64, 44, h, w)
    dead[10] = torch.zeros_like(dead[10])
    assert not _check_descriptor(dead).any()
    empty = [a[:0] if torch.is_tensor(a) and a.ndim == 1 else a for a in dead]
    n0 = K.LAUNCHES["descriptor_histograms"]
    assert K.descriptor_histograms(*empty).shape == (0, 128)
    assert K.LAUNCHES["descriptor_histograms"] == n0
    edge = np.array([-3, 0, 1, 2, 3, 44, 45])
    ys = np.concatenate([edge, h - 1 - edge])
    xs = np.concatenate([edge, w - 1 - edge])
    py, px = (a.ravel() for a in np.meshgrid(ys, xs, indexing="ij"))
    _check_descriptor(_descriptor_args(dev, 13, py.size, 44, h, w, py=py, px=px))


@pytest.mark.parametrize("ww,nb", [(2, 32), (3, 14), (1, 128), (4, 1), (2, 5)])
def test_descriptor_histograms_kernel_other_shapes(dev, ww, nb):
    """Cells and bins other than 4 x 8 (ww^2 * nb <= 128), one bin
    included, against the plain version."""
    _check_descriptor(_descriptor_args(dev, 20 + ww * nb, 200, 30, 100, 140, ww, nb))


@pytest.mark.parametrize("nb", [8, 1, 5, 14, 32, 128])
def test_descriptor_arith_matches_library(dev, nb):
    """The descriptor kernels' floor-style remainder and orientation bins
    (K5's and P1's) equal fmodf and integer modulo, and (with nb = 8)
    their division by the bin width equals IEEE division for 64 bin
    widths from 0.05 to 200 (the path's lie near 1 to 20), bit for bit on
    all 2^32 float bit patterns: the path's arguments are a subset of
    them."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    rng = np.random.default_rng(nb)
    widths = np.geomspace(0.05, 200.0, 64) * (1 + rng.random(64) * 1e-3)
    assert K.descriptor_arith_mismatches(nb, widths if nb == 8 else []) == (0, 0)


@pytest.mark.parametrize("half,h,w,offset,load", [
    (28, 200, 300, 0, "tma"),
    (44, 200, 300, 0, "tma"),
    (44, 60, 300, 0, "tma"),          # h < S: rows past the stack are zero
    (10, 97, 120, 0, "tma"),          # S given at run time
    (28, 60, 301, 0, "cp.async"),     # W not a multiple of 4
    (44, 60, 301, 0, "cp.async"),
    (44, 200, 300, 1, "cp.async"),    # stacks at a 4-byte offset
    (58, 200, 300, 0, "tma"),         # S = 117: the largest staged window
    (59, 200, 300, 0, "direct"),      # S = 119: past the staged limit
    (80, 200, 300, 0, "direct"),      # S = 161
    (80, 60, 301, 1, "direct"),       # h < S, W % 4 != 0, 4-byte offset
])
def test_pair_window_gather_kernel_matches_plain(dev, half, h, w, offset, load):
    """Bit for bit against the plain version, starts clamped at every
    edge, more keypoints than the persistent grid has blocks; repeated
    launches identical; one device kernel per call."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    rng = np.random.default_rng(9 + half)
    n = 3 * h * w
    mag, ang = (torch.as_tensor(rng.random(n + offset).astype(np.float32),
                                device=dev)[offset:].view(3, h, w) for _ in range(2))
    assert K.pair_window_load(mag, ang, 2 * half + 1) == load
    k = 1200
    idx = [torch.as_tensor(rng.integers(lo, hi, k).astype(np.int32), device=dev)
           for lo, hi in ((0, 3), (-5, h + 5), (-5, w + 5))]
    n0 = K.LAUNCHES["pair_window_gather"]
    got = K.pair_window_gather(mag, ang, *idx, half)
    assert K.LAUNCHES["pair_window_gather"] == n0 + 1
    want = K.pair_window_gather_plain(mag, ang, *idx, half)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(got, K.pair_window_gather(mag, ang, *idx, half)):
        assert torch.equal(a, b)
    assert _one_device_kernel(lambda: K.pair_window_gather(mag, ang, *idx, half),
                              "pair_window_gather")


def test_stitch_on_cuda_matches_cpu(dev, tmp_path):
    """A small chain stitched on the card and on the CPU: equal shifts and
    pairs, byte-identical panorama."""
    from vfx_image_stitching_tpu_torch.utils.synthetic import synth_chain
    from vfx_image_stitching_tpu_torch.pipeline.stitch import stitch_panorama

    synth_chain(str(tmp_path), 3, 96, 128, seed=4, focal=300.0)
    gpu = stitch_panorama(str(tmp_path), backend="sift", crop_margin=8,
                          device="cuda")
    cpu = stitch_panorama(str(tmp_path), backend="sift", crop_margin=8,
                          device="cpu")
    assert gpu.shifts == cpu.shifts and gpu.pairs == cpu.pairs
    assert np.array_equal(gpu.panorama, cpu.panorama)


def _feas1_stack(dev, n_l, layout, seed=5):
    """An (n_l, 20, w) f32 stack laid out as ``layout``: ``aligned`` (w =
    200, 16-byte rows), ``w130`` (W % 4 != 0), ``col1`` (a view at column
    offset 1 of an (n_l, 20, 201) stack: misaligned base, strided rows),
    ``flat1`` (contiguous, its base one float past an aligned buffer)."""
    rng = np.random.default_rng(seed)
    w = {"aligned": 200, "w130": 130, "col1": 201, "flat1": 200}[layout]
    full = torch.as_tensor(
        rng.standard_normal(n_l * 20 * w + 1).astype(np.float32), device=dev)
    if layout == "flat1":
        return full[1:].view(n_l, 20, w)
    dog = full[:-1].view(n_l, 20, w)
    return dog[:, :, 1:] if layout == "col1" else dog


@pytest.mark.parametrize("n_l", [*range(1, 10), 17])
@pytest.mark.parametrize("layout", ["aligned", "w130", "col1", "flat1"])
def test_feas1_stack_sum_kernel_matches_plain(dev, n_l, layout):
    """P2 bit-exact against its plain version at each compiled layer count
    (1-8), past it (9, 17: chunks of 8), on 16-byte and 4-byte loads; a
    strided view is read in place: one device kernel per call."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.probes import kernels as PK

    dog = _feas1_stack(dev, n_l, layout)
    assert (dog.data_ptr() % 16 == 0) == (layout in ("aligned", "w130"))
    n0 = K.LAUNCHES["feas1_stack_sum"]
    got = PK.feas1_stack_sum(dog)
    assert K.LAUNCHES["feas1_stack_sum"] == n0 + 1
    assert torch.equal(got, PK.feas1_stack_sum_plain(dog))
    assert torch.equal(got, PK.feas1_stack_sum(dog))
    assert _one_device_kernel(lambda: PK.feas1_stack_sum(dog), "feas1_stack_sum")


def _cube_sum_args(dev, seed, k, n_l=5, h=40, w=70):
    """A random (n_l, h, w) stack and k candidates, some past every edge
    of it (indices clamped alike by kernel and plain version)."""
    rng = np.random.default_rng(seed)
    dog = torch.as_tensor(rng.standard_normal((n_l, h, w)).astype(np.float32),
                          device=dev)
    idx = [torch.as_tensor(rng.integers(lo, hi, k).astype(np.int32), device=dev)
           for lo, hi in ((-1, n_l + 1), (-1, h + 1), (-1, w + 1))]
    return dog, *idx


def test_feas2_cube_sums_kernel_matches_plain(dev):
    """Interior and out-of-stack candidates (indices clamped alike)."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.probes import kernels as PK

    args = _cube_sum_args(dev, 6, 1000)
    n0 = K.LAUNCHES["feas2_cube_sums"]
    got = PK.feas2_cube_sums(*args)
    assert K.LAUNCHES["feas2_cube_sums"] == n0 + 1
    assert torch.equal(got, PK.feas2_cube_sums_plain(*args))
    assert torch.equal(got, PK.feas2_cube_sums(*args))
    assert _one_device_kernel(lambda: PK.feas2_cube_sums(*args), "feas2_cube_sums")


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 13, 2048])
def test_feas2_cube_sums_kernel_counts(dev, k):
    """Candidate counts that fill part of a warp (three candidates a
    warp) or of a block (twelve), and the probe's 2048, bit for bit."""
    from vfx_image_stitching_tpu_torch.probes import kernels as PK

    args = _cube_sum_args(dev, 60 + k, k)
    got = PK.feas2_cube_sums(*args)
    assert got.shape == (k,)
    assert torch.equal(got, PK.feas2_cube_sums_plain(*args))


# P4's walk cases: name -> (layers, h, w, border); num_intervals is
# layers - 2.  Random candidates anywhere inside random stacks, whose
# walks often move by more than one row or column; candidates on rows 1
# and h - 2 and columns 1 and w - 2 with border 0 (their cubes touch the
# stack's edges, and their moves are clamped there); stacks of 4 and 6
# layers; a 3x4 stack (an octave smaller than a 5x5 neighbourhood).
P4_WALK_CASES = {
    "reload": (5, 40, 64, 1),
    "edges": (5, 24, 40, 0),
    "layers4": (4, 40, 64, 1),
    "layers6": (6, 40, 64, 1),
    "tiny": (5, 3, 4, 0),
}


def p4_walk_case(name: str):
    """``(dog, [layer, y, x, valid], border, num_intervals)`` as numpy
    arrays for :data:`P4_WALK_CASES` ``name``."""
    n_l, h, w, border = P4_WALK_CASES[name]
    rng = np.random.default_rng(list(P4_WALK_CASES).index(name))
    dog = rng.integers(-80, 80, (n_l, h, w)).astype(np.float32)
    if name == "edges":
        n = 20
        y = np.concatenate([np.full(n, 1), np.full(n, h - 2),
                            rng.integers(1, h - 1, 2 * n), [1, 1, h - 2, h - 2]])
        x = np.concatenate([rng.integers(1, w - 1, 2 * n), np.full(n, 1),
                            np.full(n, w - 2), [1, w - 2, 1, w - 2]])
    elif name == "tiny":
        y, x = np.ones(6), np.tile([1, 2], 3)
    else:
        y, x = rng.integers(1, h - 1, 400), rng.integers(1, w - 1, 400)
    k = len(y)
    layer = rng.integers(1, n_l - 1, k)
    valid = rng.random(k) > 0.1 if name in ("reload", "layers4", "layers6") \
        else np.ones(k, bool)
    cand = [layer.astype(np.int32), np.asarray(y, np.int32),
            np.asarray(x, np.int32), valid]
    return dog, cand, border, n_l - 2


def _check_p4(dog, cand, border, num_intervals):
    """P4 against its plain version and K1, bit for bit, one launch and
    one device kernel per call, repeats identical; returns the plain
    version's integer lanes."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.probes import kernels as PK

    walk = (border, num_intervals, 5)
    n0 = K.LAUNCHES["localize_resident_r4"]
    outf, outi = PK.localize_resident_r4_lanes(dog, *cand, *walk)
    assert K.LAUNCHES["localize_resident_r4"] == n0 + 1
    want_f, want_i = PK.localize_resident_r4_lanes_plain(dog, *cand, *walk)
    assert torch.equal(outi, want_i) and torch.equal(outf, want_f)
    k1_i, k1_f = K.localize_newton_resident(dog, *cand, *walk)
    assert torch.equal(outi, k1_i) and torch.equal(outf, k1_f)
    again = PK.localize_resident_r4_lanes(dog, *cand, *walk)
    assert torch.equal(outf, again[0]) and torch.equal(outi, again[1])
    assert _one_device_kernel(
        lambda: PK.localize_resident_r4_lanes(dog, *cand, *walk), "localize_resident_r4")
    return want_i


def test_localize_resident_r4_kernel_matches_plain(dev):
    """Float and integer lanes bit for bit, and equal to K1's."""
    from vfx_image_stitching_tpu_torch.models.sift import extrema as te

    rng = np.random.default_rng(2)
    rand = torch.as_tensor(rng.integers(-80, 80, (5, 21, 131)).astype(np.float32),
                           device=dev)
    for dog, cand in (_octave0(dev)[1:], (rand, te.extract_candidates(rand, 5, 1.0, 256))):
        assert int(cand[3].sum()) > 0
        _check_p4(dog, cand, 5, 3)


@pytest.mark.parametrize("case", list(P4_WALK_CASES))
def test_localize_resident_r4_kernel_walk_cases(dev, case):
    """:data:`P4_WALK_CASES` against the plain version and K1: walks
    that compute at a cell more than one row or column from their start
    in the random cases, candidates on the rows and columns next to every
    edge, 4 and 6 layers, a 3x4 stack."""
    dog, cand, border, num_intervals = p4_walk_case(case)
    dog = torch.as_tensor(dog, device=dev)
    cand = [torch.as_tensor(a, device=dev) for a in cand]
    want_i = _check_p4(dog, cand, border, num_intervals)
    valid = cand[3]
    far = ((want_i[:, 3] - cand[2]).abs() > 1) | ((want_i[:, 4] - cand[1]).abs() > 1)
    if case != "tiny":
        assert int(far[valid].sum()) >= 10
    if case == "edges":
        h, w = dog.shape[-2:]
        assert all(bool((c == v).any()) for c, v in ((cand[1], 1), (cand[1], h - 2),
                                                       (cand[2], 1), (cand[2], w - 2)))


@pytest.mark.parametrize("highest", [False, True])
def test_desc_scratch_dot_kernel_matches_plain(dev, highest):
    """The probe's inputs (two invalid rows) plus keypoints near and past
    the fields' edges."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.probes import desc_scratch_dot as DS
    from vfx_image_stitching_tpu_torch.probes import kernels as PK

    rng = np.random.default_rng(7)
    k, hs, ws = 200, 120, 160
    args = list(DS.make_inputs(rng, k, 3, hs, ws))
    args[3][:20] = rng.integers(-10, hs + 10, 20)   # py
    args[4][:20] = rng.integers(-10, ws + 10, 20)   # px
    targs = DS.to_torch(args, dev)
    n0 = K.LAUNCHES["desc_scratch_dot"]
    got = PK.desc_scratch_dot(*targs, hs, ws, highest=highest)
    assert K.LAUNCHES["desc_scratch_dot"] == n0 + 1
    want = PK.desc_scratch_dot_plain(*targs, hs, ws)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= (1e-5 if highest else 2e-3), err
    assert torch.equal(got, PK.desc_scratch_dot(*targs, hs, ws, highest=highest))
    assert not got[-2:].any()


@pytest.mark.parametrize("highest", [False, True])
def test_desc_scratch_dot_kernel_masked_and_edges(dev, highest):
    """Rows whose whole box misses the histogram (center outside the
    interior, a bin width so small that no other sample reaches a cell)
    are zero; rows at every edge of the fields; both precisions, against
    the plain version and against K5 on the same rows; one device kernel
    per call."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.probes import desc_scratch_dot as DS
    from vfx_image_stitching_tpu_torch.probes import kernels as PK

    rng = np.random.default_rng(17)
    hs, ws = 100, 130
    edge = np.array([-2, 0, 1, 2, 28, 29])
    ys = np.concatenate([edge, hs - 1 - edge])
    xs = np.concatenate([edge, ws - 1 - edge])
    py, px = (a.ravel() for a in np.meshgrid(ys, xs, indexing="ij"))
    k = py.size + 8
    args = list(DS.make_inputs(rng, k, 3, hs, ws))
    args[3][:py.size], args[4][:px.size] = py, px
    # the last 8 rows: centers on the border rows and columns, tiny bins
    args[3][-8:] = [0, 0, hs - 1, hs - 1, 40, 50, 0, hs - 1]
    args[4][-8:] = [40, 60, 70, 90, 0, ws - 1, 0, ws - 1]
    args[8][-8:] = 0.01
    args[10][:] = 1
    targs = DS.to_torch(args, dev)
    got = PK.desc_scratch_dot(*targs, hs, ws, highest=highest)
    want = PK.desc_scratch_dot_plain(*targs, hs, ws)
    assert not want[-8:].any() and not got[-8:].any()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= (1e-5 if highest else 2e-3), err
    assert torch.equal(got, PK.desc_scratch_dot(*targs, hs, ws, highest=highest))
    assert _one_device_kernel(
        lambda: PK.desc_scratch_dot(*targs, hs, ws, highest=highest), "desc_scratch_dot")
    k5 = K.descriptor_histograms(*targs, PK.P1_HALF).reshape(got.shape)
    assert float((got - k5).abs().max() / k5.abs().max()) <= (1e-5 if highest else 2e-3)


# ---------------------------------------------------------------------------
# Harris backend (the response kernel, csrc/harris_response.cu; the rest
# plain tensor ops)
# ---------------------------------------------------------------------------

def _harris_response_case(case):
    """(images, config) of a response-kernel case: the benchmark's
    ``pano18`` batch (18 x 512 x 384, noise with black edge columns); three
    scenes of 192x256; an odd 97x131 image; 7x40 and 40x7 crops, shorter
    than the 21-tap blur's 10-px pad on one axis (the reflection repeats);
    a gray (N, H, W) batch; extra leading dims; a 9-tap and a 4-tap blur
    (the kernel's runtime tap count)."""
    from vfx_image_stitching_tpu_torch.config import HarrisConfig
    from vfx_image_stitching_tpu_torch.utils.synthetic import (
        make_scene,
        pano18_fold_inputs,
    )

    cfg = HarrisConfig()
    rng = np.random.default_rng(22)
    if case == "pano18":
        return pano18_fold_inputs()[0], cfg
    if case == "scene":
        return np.stack([make_scene(192, 256, s) for s in range(3)]), cfg
    if case == "odd":
        return make_scene(97, 131, 5), cfg
    if case == "short":
        return np.ascontiguousarray(make_scene(64, 40, 1)[:7]), cfg
    if case == "narrow":
        return np.ascontiguousarray(
            make_scene(64, 40, 2)[:7].transpose(1, 0, 2)), cfg
    if case == "gray":
        return rng.integers(0, 256, (3, 50, 70), dtype=np.uint8), cfg
    if case == "lead":
        return rng.integers(0, 256, (2, 2, 33, 65, 3), dtype=np.uint8), cfg
    if case == "taps9":
        return make_scene(97, 131, 6), HarrisConfig(block_size=9)
    return make_scene(45, 70, 6), HarrisConfig(block_size=4)


@pytest.mark.parametrize("case", ["pano18", "scene", "odd", "short", "narrow",
                                  "gray", "lead", "taps9", "taps4"])
def test_harris_response_kernel_matches_plain(dev, case):
    """``harris_corners`` on a CUDA tensor, whose response is the kernel's
    (one launch), against the plain version on the same CUDA tensor:
    ``ix``, ``iy`` and the response bit-equal; its corners equal to the
    CPU's; the kernel one device kernel a call on a contiguous batch;
    repeated runs identical."""
    from vfx_image_stitching_tpu_torch.models import harris as TH

    images, cfg = _harris_response_case(case)
    img = torch.as_tensor(images, device=dev)
    ix, iy, r = TH.harris_response_plain(img, cfg)
    h, w = ix.shape[-2:]
    before = TH.LAUNCHES["harris_response"]
    got = TH.harris_corners(img, cfg)
    assert TH.LAUNCHES["harris_response"] == before + 1
    assert torch.equal(got[4][0], ix) and torch.equal(got[4][1], iy)
    cpu = TH.harris_corners(img.cpu(), cfg)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got[:4], cpu[:4]))
    batch = (img.reshape(-1, h, w, 3) if TH._is_bgr(img)
             else img.reshape(-1, h, w))
    out = TH.harris_response_kernel(batch, cfg)
    for a, b in zip(out, (ix, iy, r)):
        assert torch.equal(a, b.reshape(a.shape))
    for a, b in zip(out, TH.harris_response_kernel(batch, cfg)):
        assert torch.equal(a, b)
    # a strided batch (make_scene's images) costs the wrapper a copy first
    batch = batch.contiguous()
    assert _one_device_kernel(lambda: TH.harris_response_kernel(batch, cfg),
                              "harris_response", TH.LAUNCHES)


def test_harris_batch_on_cuda_matches_cpu(dev):
    """``harris_batch`` on the card against the CPU on a synthetic batch:
    keypoints, validity and response equal (the response kernel's sums
    are IEEE ops in the plain order), descriptors within the reference's 1e-5
    (reduction order); repeated runs bit-identical."""
    from vfx_image_stitching_tpu_torch.models.harris import (
        harris_batch,
        harris_corners,
    )
    from vfx_image_stitching_tpu_torch.utils.synthetic import make_scene

    batch = torch.as_tensor(np.stack([make_scene(192, 256, s) for s in range(3)]))
    gxy, gd, gv = harris_batch(batch.to(dev))
    cxy, cd, cv = harris_batch(batch)
    assert torch.equal(gv.cpu(), cv) and torch.equal(gxy.cpu(), cxy)
    assert cv.sum() > 50
    assert float((gd.cpu()[cv] - cd[cv]).abs().max()) < 1e-5
    for a, b in zip((gxy, gd, gv), harris_batch(batch.to(dev))):
        assert torch.equal(a, b)
    g = harris_corners(batch.to(dev))
    c = harris_corners(batch)
    assert torch.equal(g[2].cpu(), c[2])


def test_harris_stitch_on_cuda_matches_cpu(dev, tmp_path):
    """A small chain stitched with Harris (the default backend) on the card
    and on the CPU: equal shifts and pairs, byte-identical panorama; a
    repeat on the card is identical; none of the SIFT library's kernels
    launches, the Harris response kernel once a stitch, over every image
    (``n_harris_kernel_images``; 0 on the CPU)."""
    from vfx_image_stitching_tpu_torch.models import harris as TH
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.pipeline.stitch import stitch_panorama
    from vfx_image_stitching_tpu_torch.utils.synthetic import synth_chain

    synth_chain(str(tmp_path), 4, 128, 168, seed=11, focal=300.0)
    before = dict(K.LAUNCHES)
    harris_before = TH.LAUNCHES["harris_response"]
    gpu = stitch_panorama(str(tmp_path), crop_margin=8, device="cuda")
    assert K.LAUNCHES == before
    assert TH.LAUNCHES["harris_response"] == harris_before + 1
    assert gpu.timings["n_harris_kernel_images"] == 4
    cpu = stitch_panorama(str(tmp_path), crop_margin=8, device="cpu")
    assert cpu.timings["n_harris_kernel_images"] == 0
    again = stitch_panorama(str(tmp_path), crop_margin=8, device="cuda")
    assert all(p is not None for p in gpu.pairs)
    assert gpu.shifts == cpu.shifts and gpu.pairs == cpu.pairs
    assert np.array_equal(gpu.panorama, cpu.panorama)
    assert again.shifts == gpu.shifts and np.array_equal(again.panorama, gpu.panorama)


# ---------------------------------------------------------------------------
# device compose (the fold kernel), the stage split, stitch_many
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_device_compose_on_cuda_matches_host_fold(dev, seed):
    """``compose_mosaic`` on the card against the host fold, steps
    included, on random chains whose alpha denominators are not integers
    (float64 division on the card), and the device crop bounds against
    the host's."""
    from vfx_image_stitching_tpu_torch.compose.blend import compose_mosaic
    from vfx_image_stitching_tpu_torch.compose.crop import crop_bounds
    from vfx_image_stitching_tpu_torch.compose.host import (
        compose_mosaic_host,
        content_bounds_host,
    )
    from vfx_image_stitching_tpu_torch.compose.plan import plan_compose

    rng = np.random.default_rng(seed)
    n, h, w = 5, 60, 80
    images = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    images[:, :, :3] = 0
    shifts, pairs = [], []
    for i in range(n - 1):
        dx = int(rng.integers(16, 56)) * (1 if (seed + i) % 2 == 0 else -1)
        dy = float(rng.integers(-5, 6)) + float(rng.random())
        xa = float(rng.integers(8, w - 8)) + 0.37
        ya = int(rng.integers(4, h - 4))
        shifts.append((float(dx), dy))
        pairs.append(((xa, ya), (xa - dx, ya - int(dy))))
    plan = plan_compose(h, w, n, [True] * n, shifts, pairs)
    mosaic, steps = compose_mosaic(torch.as_tensor(images, device=dev), plan,
                                   return_steps=True)
    host = compose_mosaic_host(list(images), plan)
    assert np.array_equal(mosaic.cpu().numpy(), host)
    cpu_mosaic, cpu_steps = compose_mosaic(torch.as_tensor(images), plan,
                                           return_steps=True)
    assert all(np.array_equal(a, b) for a, b in zip(steps, cpu_steps))
    assert crop_bounds(mosaic, 0) == content_bounds_host(host, 0)


@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_fold_kernel_matches_host_and_plain_fold(dev, case):
    """``compose_mosaic`` on the card, which folds by the kernel, with and
    without the step capture: the mosaic equal to the host fold's and to
    the plain fold's on the CPU, the steps to the plain fold's; one
    occupancy launch and one launch a step per fold;
    ``n_fold_kernel_steps`` equal to ``n_fold_steps``."""
    from vfx_image_stitching_tpu_torch.compose import blend
    from vfx_image_stitching_tpu_torch.compose.host import compose_mosaic_host
    from vfx_image_stitching_tpu_torch.utils.profiling import request

    images, plan = FOLD_CASES[case]()
    host = compose_mosaic_host(list(images), plan)
    cpu_mosaic, cpu_steps = blend.compose_mosaic(
        torch.as_tensor(images), plan, return_steps=True)
    assert np.array_equal(cpu_mosaic.numpy(), host)
    before = dict(blend.LAUNCHES)
    with request() as trace:
        cuda_images = torch.as_tensor(images, device=dev)
        mosaic, steps = blend.compose_mosaic(cuda_images, plan,
                                             return_steps=True)
        alone = blend.compose_mosaic(cuda_images, plan)
        torch.cuda.synchronize()
        t = trace.take()
    assert np.array_equal(mosaic.cpu().numpy(), host)
    assert np.array_equal(alone.cpu().numpy(), host)
    assert len(steps) == len(cpu_steps) == len(plan.steps)
    assert all(np.array_equal(a, b) for a, b in zip(steps, cpu_steps))
    n = len(plan.steps)
    assert blend.LAUNCHES["compose_column_occupancy"] == (
        before["compose_column_occupancy"] + 2)
    assert blend.LAUNCHES["compose_fold_step"] == (
        before["compose_fold_step"] + 2 * n)
    assert t["n_fold_kernel_steps"] == t["n_fold_steps"] == 2 * n


def test_stitch_on_cuda_folds_with_the_kernel(dev, tmp_path):
    """A stitch on the card folds every step by the kernel
    (``n_fold_kernel_steps == n_fold_steps``) and puts no host value on
    the device for the fold: the images, their maps and the padding
    indices only (on the card none for the Harris response, whose
    kernel reflects its borders itself)."""
    from vfx_image_stitching_tpu_torch.models.harris import (
        harris_response_plain,
    )
    from vfx_image_stitching_tpu_torch.pipeline import stitch_panorama
    from vfx_image_stitching_tpu_torch.utils.profiling import request
    from vfx_image_stitching_tpu_torch.utils.synthetic import synth_chain

    synth_chain(str(tmp_path), 4, 96, 128, seed=5, focal=300.0)
    gpu = stitch_panorama(str(tmp_path), crop_margin=8, device="cuda").timings
    cpu = stitch_panorama(str(tmp_path), crop_margin=8, device="cpu").timings
    assert gpu["n_fold_kernel_steps"] == gpu["n_fold_steps"] == 3
    assert cpu["n_fold_kernel_steps"] == 0 and cpu["n_fold_steps"] == 3
    # the plain fold counts one 8-byte overlap range a step, the plain
    # Harris response its padding indices
    with request() as trace:
        harris_response_plain(torch.zeros((4, 96, 128, 3), dtype=torch.uint8))
        plain = trace.take()
    assert cpu["n_h2d"] - gpu["n_h2d"] == 3 + plain["n_h2d"]
    assert cpu["h2d_bytes"] - gpu["h2d_bytes"] == 3 * 8 + plain["h2d_bytes"]


@pytest.mark.parametrize("backend", ["harris", "sift"])
def test_compose_routes_and_stage_api_on_cuda(dev, backend, tmp_path):
    """On the card: the stitch's device fold, with and without the step
    capture, gives the host fold's bytes (``compose/host.py`` on the same
    plan), the stage split equals ``stitch_panorama``, and all equal the
    CPU's stitch."""
    from vfx_image_stitching_tpu_torch.compose.host import compose_mosaic_host
    from vfx_image_stitching_tpu_torch.compose.plan import plan_compose
    from vfx_image_stitching_tpu_torch.geometry.cylindrical import (
        cylindrical_project_batch,
    )
    from vfx_image_stitching_tpu_torch.io import load_dataset, stack_dataset
    from vfx_image_stitching_tpu_torch.pipeline import (
        compute_pairwise_shifts,
        stitch_panorama,
    )
    from vfx_image_stitching_tpu_torch.utils.synthetic import synth_chain

    synth_chain(str(tmp_path), 4, 128, 168, seed=11, focal=300.0)

    def run(**kw):
        return stitch_panorama(str(tmp_path), backend=backend, crop_margin=8,
                               **kw)

    host = run(device="cuda")
    cpu = run(device="cpu")
    steps = run(device="cuda", return_steps=True)
    for res in (cpu, steps):
        assert res.shifts == host.shifts and res.pairs == host.pairs
        assert np.array_equal(res.panorama, host.panorama)
        assert np.array_equal(res.mosaic, host.mosaic)
    assert len(steps.steps) == 3 and np.array_equal(steps.steps[-1], steps.mosaic)
    images, focals, _ = load_dataset(str(tmp_path))
    batch, valid = stack_dataset(images)
    cyl = cylindrical_project_batch(torch.as_tensor(batch, device=dev), focals)
    plan = plan_compose(128, 168, 4, list(valid), host.corrected_shifts,
                        host.pairs)
    assert np.array_equal(compose_mosaic_host(list(cyl.cpu().numpy()), plan),
                          host.mosaic)
    from vfx_image_stitching_tpu_torch.config import StitchConfig

    shifts, pairs, _ = compute_pairwise_shifts(cyl, valid,
                                               StitchConfig(backend=backend))
    assert shifts == host.shifts and pairs == host.pairs


def test_stitch_many_on_cuda_matches_loop(dev, tmp_path):
    """``stitch_many`` on the card (SIFT: the kernels launch) against the
    loop of ``stitch_panorama``."""
    import os

    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.pipeline import stitch_many, stitch_panorama
    from vfx_image_stitching_tpu_torch.utils.synthetic import synth_chain

    folders = []
    for name, seed in (("a", 4), ("b", 9)):
        folders.append(str(tmp_path / name))
        os.makedirs(folders[-1])
        synth_chain(folders[-1], 3, 96, 128, seed=seed, focal=300.0)
    K.reset_launch_counts()
    res = stitch_many(folders)
    assert all(K.LAUNCHES[k] > 0 for k in ("localize_newton_resident",
                                           "orientation_histograms",
                                           "pair_window_gather"))
    for folder, got in zip(folders, res.values()):
        want = stitch_panorama(folder, backend="sift", crop_margin=15)
        assert got.shifts == want.shifts and got.pairs == want.pairs
        assert np.array_equal(got.panorama, want.panorama)


@pytest.mark.parametrize("backend", ["harris", "sift"])
def test_mesh_on_cuda_matches_unsharded(dev, backend, tmp_path):
    """Two logical slots of one card (a stream each): the sharded minimal
    step over 5 images (an uneven split) equals the unsharded step on
    every leaf, and ``stitch_many`` on a 2-slot pano mesh and on the
    (1, 2) mesh equals it without a mesh; SIFT launches its kernels."""
    import os

    from vfx_image_stitching_tpu_torch.config import StitchConfig
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.parallel import mesh as M
    from vfx_image_stitching_tpu_torch.pipeline import stitch_many
    from vfx_image_stitching_tpu_torch.utils.synthetic import make_scene, synth_chain

    scene = make_scene(128, 168 + 4 * 40, 3, block_px=60, block_size=(2, 6))
    batch = torch.as_tensor(np.stack([scene[:, 40 * i:40 * i + 168]
                                      for i in range(5)]), device=dev)
    cfg = StitchConfig(backend=backend)
    K.reset_launch_counts()
    got = M.sharded_pairwise_shifts(batch, M.make_mesh(devices=[dev] * 2), cfg)
    torch.cuda.synchronize()
    launched = dict(K.LAUNCHES)
    want = M._pairwise_shift_step(batch, cfg)
    assert bool(want[3].all())
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(launched[k] > 0 for k in ("localize_newton_resident",
                                         "orientation_histograms",
                                         "pair_window_gather")) == (backend == "sift")
    folders = []
    for name, n, seed in (("a", 3, 4), ("b", 3, 9), ("c", 2, 5)):
        folders.append(str(tmp_path / name))
        os.makedirs(folders[-1])
        synth_chain(folders[-1], n, 96, 128, seed=seed, focal=300.0)
    plain = stitch_many(folders, backend=backend)
    for mesh in (M.make_mesh_pano(devices=[dev] * 2),
                 M.make_mesh_2d(devices=[dev] * 2)):
        res = stitch_many(folders, backend=backend, mesh=mesh)
        for name, want_r in plain.items():
            assert res[name].shifts == want_r.shifts and res[name].pairs == want_r.pairs
            assert np.array_equal(res[name].panorama, want_r.panorama)


def test_compute_stages_on_cuda_matches_cpu(dev):
    """``viz.sift_visualizer.compute_stages`` on the card (K1-K3 launch)
    against the CPU: base image and pyramids bit-equal (plain tensor ops
    with no contraction), the records' positions and octaves equal, size
    and response within rtol 1e-5 (the card's ``exp2`` and ``exp``), angles
    within 2e-5 of a full turn (K2's histograms; an angle is 360 minus the
    peak's position, so its rounding does not shrink with it),
    descriptors within 1 LSB on under 2% of entries (``api_surface``'s
    contract in ``chip_smoke.py``); and Harris's ``harris_match_pair``
    equal."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.utils.synthetic import make_scene
    from vfx_image_stitching_tpu_torch.viz.harris_demo import harris_match_pair
    from vfx_image_stitching_tpu_torch.viz.sift_visualizer import (
        _gray_f32,
        compute_stages,
    )

    scene = make_scene(128, 200, 5, block_px=60, block_size=(2, 6))
    gray = _gray_f32(scene[:, :168])
    K.reset_launch_counts()
    base, pyr, dogs, recs, desc = compute_stages(gray, device=dev)
    torch.cuda.synchronize()
    assert {k for k, v in K.LAUNCHES.items() if v} == {
        "localize_newton_resident", "orientation_histograms", "pair_window_gather"}
    c_base, c_pyr, c_dogs, c_recs, c_desc = compute_stages(gray, device="cpu")
    for t, c in zip([base, *pyr, *dogs], [c_base, *c_pyr, *c_dogs]):
        assert torch.equal(t.cpu(), c)
    assert len(recs) == len(c_recs) > 10
    assert [(r.pt, r.octave) for r in recs] == [(r.pt, r.octave) for r in c_recs]
    for key in ("size", "response"):
        np.testing.assert_allclose([getattr(r, key) for r in recs],
                                   [getattr(r, key) for r in c_recs], rtol=1e-5)
    turn = (np.array([r.angle for r in recs]) - [r.angle for r in c_recs] + 180) % 360 - 180
    assert np.abs(turn).max() <= 360 * 2e-5
    d = np.abs(desc - c_desc)
    assert d.max() <= 1.0 and (d > 0).mean() < 0.02
    assert harris_match_pair(scene[:, 32:200], scene[:, :168], device=dev) == (
        harris_match_pair(scene[:, 32:200], scene[:, :168], device="cpu"))


def test_fused_probe_on_cuda(dev):
    """The localize probe's ``fused`` phase on the card: ``plain`` equals
    ``resident`` on every octave, and of the kernels only K1 launches."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.probes import localize_resident_r4 as R

    K.reset_launch_counts()
    res = R.fused(dev, chain=dict(n=3, h=128, w=168, seed=4, focal=300.0),
                  group=2, reps=1, rounds=1)
    torch.cuda.synchronize()
    assert res["ok"] and res["plain_vs_resident"]["valid_rows"] > 40
    assert {k for k, v in K.LAUNCHES.items() if v} == {"localize_newton_resident"}


# ---------------------------------------------------------------------------
# the matcher's Lowe ratio test
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("refine", [1, 8])
def test_match_descriptors_lowe_ratio_on_cuda_matches_cpu(dev, refine):
    """``match_descriptors`` with a Lowe ratio on the card against the CPU
    over a leading pair axis: every output equal, for integer descriptors
    and the same ones / 64 (every distance sum exact in f32)."""
    from vfx_image_stitching_tpu_torch.match.nn import match_descriptors

    rng = np.random.default_rng(refine)
    a = rng.integers(0, 40, (3, 300, 128))
    b = rng.integers(0, 40, (3, 320, 128))
    b[:, :300:2] = np.clip(a[:, ::2] + rng.integers(-6, 7, (3, 150, 128)), 0, 255)
    b[:, 11] = b[:, 12]
    va, vb = rng.random((3, 300)) > 0.1, rng.random((3, 320)) > 0.1
    for scale, thresh in ((1.0, 25000.0), (64.0, 1.0)):
        args = [torch.as_tensor(x) for x in ((a / scale).astype(np.float32), va,
                                             (b / scale).astype(np.float32), vb)]
        for ratio in (0.6, 0.8, 1.0):
            for return_dist in (False, True):
                kw = dict(refine=refine, lowe_ratio=ratio,
                          return_dist=return_dist, margin=0.5)
                want = match_descriptors(*args, thresh, **kw)
                got = match_descriptors(*(x.to(dev) for x in args), thresh, **kw)
                for g, w in zip(got, want):
                    assert torch.equal(g.cpu(), w)
        assert 0 < int(want[1].sum()) < int(va.sum())


# ---------------------------------------------------------------------------
# the batched SIFT schedule (mode="vmap"): kernels over every image's rows
# ---------------------------------------------------------------------------

def _batch_helpers():
    """tests/test_torch_batch_vmap.py (which imports no JAX), loaded by
    path: the batches and arguments it makes."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "test_torch_batch_vmap.py")
    spec = importlib.util.spec_from_file_location("_torch_batch_vmap", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", ["octave0", "edge"])
def test_localize_newton_kernel_batch_matches_plain(dev, case):
    """K1 over a batch of stacks (an image index per row): integer and
    float lanes bit for bit against the plain version and against one
    launch per image; one launch, one device kernel a call; on stacks
    10^4 apart, walks from the bottom and top layers stay in their image."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    B = _batch_helpers()
    if case == "octave0":
        dog = search = B.octave0_stacks(B.uneven_batch(device=dev))[0]
    else:
        dog, search = B.edge_dog_batch(dev)
    (layer, y, x, valid), img, per = B.newton_batch_args(dog, search)
    n0 = K.LAUNCHES["localize_newton_resident"]
    got = K.localize_newton_resident(dog, layer, y, x, valid, 5, 3, 5, img=img)
    assert K.LAUNCHES["localize_newton_resident"] == n0 + 1
    want = K.localize_newton_plain(dog, layer, y, x, valid, 5, 3, 5, img=img)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    cap = per[0][0].shape[0]
    for i, cand in enumerate(per):
        alone = K.localize_newton_resident(dog[i], *cand, 5, 3, 5)
        assert all(torch.equal(g[i * cap:(i + 1) * cap], a)
                   for g, a in zip(got, alone))
    assert _one_device_kernel(
        lambda: K.localize_newton_resident(dog, layer, y, x, valid, 5, 3, 5, img=img),
        "localize_newton_resident")


@pytest.mark.parametrize("half", [12, 28, 44])
def test_orientation_and_window_kernels_batch_stack(dev, half):
    """K2, K4 and K3 over the (N*3, H, W) stack of a batch's gradient
    fields, each row at its image's layers (windows at every layer edge):
    K2 and K4 within the orientation contract of the plain version and
    bit for bit equal to a launch on each image's rows alone; K3 bit for
    bit against the plain version (its tensor map over the taller stack)."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    B = _batch_helpers()
    _dog, mag, ang = B.octave0_stacks(B.uneven_batch(device=dev))
    args, per = B.orientation_batch_args(mag, ang, k=300, half=min(half, 20))
    k = per[0][0].shape[0]
    want = K.orientation_histograms_plain(*args, min(half, 20), 36)
    for fn in (K.orientation_histograms, K.orientation_histograms_v1):
        got = fn(*args, min(half, 20), 36)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-3)
        for i, p in enumerate(per):
            alone = fn(mag[i], ang[i], *p, min(half, 20), 36)
            assert torch.equal(got[i * k:(i + 1) * k], alone)
    assert K.pair_window_load(*args[:2], 2 * half + 1) == "tma"
    got = K.pair_window_gather(*args[:5], half)
    want = K.pair_window_gather_plain(*args[:5], half)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_vmap_extraction_and_stitch_on_cuda_match_map(dev, tmp_path, monkeypatch):
    """On the card, ``mode="vmap"`` equals ``mode="map"`` on every leaf of
    the uneven batch, launching K1 and K2 at most once an octave and K3
    at most twice (a bucket each), where map launches per image; the
    ``VFX_SIFT_BATCH_MODE=vmap`` stitch gives the map stitch's shifts,
    pairs and bytes."""
    from vfx_image_stitching_tpu_torch.config import SiftConfig
    from vfx_image_stitching_tpu_torch.models.sift import extract as te
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.pipeline.stitch import stitch_panorama
    from vfx_image_stitching_tpu_torch.utils.synthetic import synth_chain

    B = _batch_helpers()
    cfg = SiftConfig(capacities=B.small_caps())
    batch = B.uneven_batch(device=dev)
    runs = {}
    for mode in ("map", "vmap"):
        K.reset_launch_counts()
        runs[mode] = (te.sift_batch_with_stats(batch, cfg, mode), dict(K.LAUNCHES))
    for (name, g), (_n, w) in zip(B.leaves(runs["vmap"][0]), B.leaves(runs["map"][0])):
        assert torch.equal(g, w), name
    octaves = runs["map"][0][4]["cand_caps"].shape[1]
    vl, ml = runs["vmap"][1], runs["map"][1]
    assert 0 < vl["localize_newton_resident"] <= octaves
    assert 0 < vl["orientation_histograms"] <= octaves
    assert 0 < vl["pair_window_gather"] <= 2 * octaves
    assert ml["localize_newton_resident"] > vl["localize_newton_resident"]

    synth_chain(str(tmp_path), 3, 96, 128, seed=4, focal=300.0)
    out = {}
    for mode in ("map", "vmap"):
        monkeypatch.setenv("VFX_SIFT_BATCH_MODE", mode)
        out[mode] = stitch_panorama(str(tmp_path), backend="sift", crop_margin=8,
                                    device="cuda")
    assert out["map"].shifts == out["vmap"].shifts
    assert out["map"].pairs == out["vmap"].pairs
    assert np.array_equal(out["map"].panorama, out["vmap"].panorama)


# ---------------------------------------------------------------------------
# the batched multi-panorama steps (parallel/mesh.py, mode="vmap")
# ---------------------------------------------------------------------------

def _pano_batch(dev, p: int = 3, n: int = 3):
    """(p, n, 128, 168, 3) uint8 on ``dev``: p synthetic chains, 40 px
    apart, the second chain's middle image nearly blank (one blob)."""
    from vfx_image_stitching_tpu_torch.utils.synthetic import make_scene

    panos = []
    for s in range(p):
        scene = make_scene(128, 168 + (n - 1) * 40, 3 + s, block_px=60,
                           block_size=(2, 6))
        panos.append(np.stack([scene[:, 40 * i:40 * i + 168] for i in range(n)]))
    batch = np.stack(panos)
    batch[1, n // 2] = 90
    batch[1, n // 2, 60:68, 80:90] = 200
    return torch.as_tensor(batch, device=dev)


@pytest.mark.parametrize("backend", ["harris", "sift"])
def test_batched_multi_pano_on_cuda_matches_shard_map(dev, backend):
    """On logical slots of the card (the (2, 2) mesh, P=3 uneven over its
    rows, and a 2-slot pano mesh), ``mode="vmap"`` equals ``shard_map`` on
    every leaf, and ``sharded_multi_pano_shifts`` equals the stack of the
    per-panorama minimal steps."""
    from vfx_image_stitching_tpu_torch.config import StitchConfig
    from vfx_image_stitching_tpu_torch.parallel import mesh as M

    batch, cfg = _pano_batch(dev), StitchConfig(backend=backend)
    want_min = M._tree_map(lambda *xs: torch.stack(xs),
                           *(M._pairwise_shift_step(b, cfg) for b in batch))
    assert bool(want_min[3][0].all())
    for mesh in (M.make_mesh_2d(devices=[dev] * 4),
                 M.make_mesh_pano(devices=[dev] * 2)):
        got, want = (M.sharded_multi_pano_full(batch, mesh, cfg, mode=m)
                     for m in ("vmap", "shard_map"))
        g, w = [], []
        M._tree_map(g.append, got)
        M._tree_map(w.append, want)
        assert len(g) == len(w) and all(torch.equal(a, b) for a, b in zip(g, w))
        shifts = M.sharded_multi_pano_shifts(batch, mesh, cfg)
        assert all(torch.equal(a, b) for a, b in zip(shifts, want_min))


def test_batched_multi_pano_on_cuda_launches_once_per_slot(dev, monkeypatch):
    """One slot holding 3 panoramas: ``mode="vmap"`` makes one extraction
    and one pair-step call and launches K1 and K2 at most once an octave
    and K3 at most twice (a bucket each) for the whole batch, where
    ``shard_map`` launches per panorama."""
    from vfx_image_stitching_tpu_torch.config import StitchConfig
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.parallel import mesh as M

    monkeypatch.delenv("VFX_SIFT_BATCH_MODE", raising=False)
    batch, cfg = _pano_batch(dev), StitchConfig(backend="sift")
    mesh = M.make_mesh_pano(devices=[dev])
    calls = []

    def count(name, fn):
        def wrapped(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(M, "_extract", count("extract", M._extract))
    monkeypatch.setattr(M, "_pair_shift", count("pairs", M._pair_shift))
    launches = {}
    for mode in ("vmap", "shard_map"):
        calls.clear()
        K.reset_launch_counts()
        out = M.sharded_multi_pano_full(batch, mesh, cfg, mode=mode)
        torch.cuda.synchronize()
        launches[mode] = dict(K.LAUNCHES)
        per = 1 if mode == "vmap" else batch.shape[0]
        assert sorted(calls) == ["extract"] * per + ["pairs"] * per
    octaves = out[3]["cand_caps"].shape[-1]
    v, s = launches["vmap"], launches["shard_map"]
    assert 0 < v["localize_newton_resident"] <= octaves
    assert 0 < v["orientation_histograms"] <= octaves
    assert 0 < v["pair_window_gather"] <= 2 * octaves
    assert s["localize_newton_resident"] > v["localize_newton_resident"]
