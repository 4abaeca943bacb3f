"""PyTorch port: each CUDA kernel against its plain PyTorch version, on the
card.  Marked ``cuda``; skipped without a GPU.  This file imports neither
JAX nor the test conftest, so on the GPU machine it runs as

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Contracts: the Newton kernel's integer lanes and the window gather bit for
bit; orientation histograms to rtol 2e-5 / atol 2e-3 (reduction order).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run with -m cuda on the card)")
    return torch.device("cuda")


def _octave0(dev, h=96, w=128, seed=0):
    """Octave 0 of a synthetic image: Gaussian stack, DoG, candidates."""
    from chip_smoke import make_scene
    from vfx_image_stitching_tpu_torch.models.sift import extrema as te
    from vfx_image_stitching_tpu_torch.models.sift import pyramid as tp

    gray = torch.as_tensor(make_scene(h, w, seed)[..., 1], device=dev)
    base = tp.generate_base_image(gray.to(torch.float32))
    gauss = tp.generate_gaussian_images(base, 1, tp.generate_gaussian_kernels(1.6, 3))[0]
    dog = tp.generate_dog_images([gauss])[0]
    cand = te.extract_candidates(dog, 5, te.extrema_threshold(0.04, 3), 1024)
    return gauss, dog, cand


def test_localize_newton_kernel_matches_plain(dev):
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
        got = K.localize_newton_resident(dog, *cand, 5, 3, 5)
        want = K.localize_newton_plain(dog, *cand, 5, 3, 5)
        assert torch.equal(got, want)
        assert K.LAUNCHES["localize_newton_resident"] == n0 + 1


def test_orientation_histograms_kernel_matches_plain(dev):
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    rng = np.random.default_rng(3)
    k, half, h, w = 300, 20, 150, 170
    mag = torch.as_tensor((rng.random((3, h, w)) * 100).astype(np.float32), device=dev)
    ang = torch.as_tensor((rng.random((3, h, w)) * 360).astype(np.float32), device=dev)
    ints = [torch.as_tensor(rng.integers(lo, hi, k).astype(np.int32), device=dev)
            for lo, hi in ((0, 3), (-5, h + 5), (-5, w + 5), (2, half + 1))]
    wf = torch.as_tensor((-0.5 / (rng.random(k) * 4 + 1) ** 2).astype(np.float32),
                         device=dev)
    valid = torch.as_tensor(rng.random(k) > 0.2, device=dev)
    args = (mag, ang, *ints, wf, valid, half, 36)
    got = K.orientation_histograms(*args)
    torch.testing.assert_close(got, K.orientation_histograms_plain(*args),
                               rtol=2e-5, atol=2e-3)
    assert torch.equal(got, K.orientation_histograms(*args))  # deterministic


def test_pair_window_gather_kernel_matches_plain(dev):
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    rng = np.random.default_rng(9)
    for half, (h, w) in ((28, (200, 300)), (44, (60, 300))):
        mag, ang = (torch.as_tensor(rng.random((3, h, w)).astype(np.float32),
                                    device=dev) for _ in range(2))
        idx = [torch.as_tensor(rng.integers(lo, hi, 40).astype(np.int32), device=dev)
               for lo, hi in ((0, 3), (-5, h + 5), (-5, w + 5))]
        got = K.pair_window_gather(mag, ang, *idx, half)
        want = K.pair_window_gather_plain(mag, ang, *idx, half)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_stitch_on_cuda_matches_cpu(dev, tmp_path):
    """A small chain stitched on the card and on the CPU: equal shifts and
    pairs, byte-identical panorama."""
    from chip_smoke import synth_chain
    from vfx_image_stitching_tpu_torch.pipeline.stitch import stitch_panorama

    synth_chain(str(tmp_path), 3, 96, 128, seed=4, focal=300.0)
    gpu = stitch_panorama(str(tmp_path), crop_margin=8, device="cuda")
    cpu = stitch_panorama(str(tmp_path), crop_margin=8, device="cpu")
    assert gpu.shifts == cpu.shifts and gpu.pairs == cpu.pairs
    assert np.array_equal(gpu.panorama, cpu.panorama)
