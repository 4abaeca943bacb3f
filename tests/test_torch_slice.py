"""PyTorch port, the whole slice: the SIFT extraction of one image and the
stitch of a synthetic chain, against the JAX package on the same files.

The JAX side runs op by op (``jax.disable_jit()``) so its arithmetic is
the port's (no fused multiply-adds; see tests/test_torch_ops.py).  The
port runs with ``device="cpu"``, where every kernel takes its plain
version.  Both share this file's JAX compile work: the extraction test
uses the chain's own image shape and configuration.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

H, W, N, FOCAL, SEED = 80, 112, 3, 260.0, 21


def _caps(mod):
    """Small capacities (fast JAX compile), both size buckets live."""
    return mod.SiftCapacities(
        candidate_caps=(512, 256, 128, 64), localized_caps=(256, 128, 64),
        oriented_caps=(256, 128, 64), max_keypoints=512, max_radius=12,
        max_half_width=24, desc_small_half=14, desc_small_caps=(256, 128, 64),
        desc_big_caps=(128, 64), desc_chunk=64,
    )


@pytest.fixture(scope="module")
def configs():
    from vfx_image_stitching_tpu import config as jc
    from vfx_image_stitching_tpu_torch.config import config_from_dict

    jcfg = jc.StitchConfig(
        backend="sift", sift=dataclasses.replace(jc.SiftConfig(),
                                                 capacities=_caps(jc)))
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    from vfx_image_stitching_tpu_torch.utils.synthetic import synth_chain

    folder = str(tmp_path_factory.mktemp("chain"))
    synth_chain(folder, N, H, W, seed=SEED, focal=FOCAL)
    return folder


def test_extract_matches_jax(chain, configs):
    """One projected gray image through the whole extraction: the valid
    mask, keypoint positions, every integer field and the descriptors are
    exact; size, angle and response carry the ulp gaps of XLA's CPU
    ``exp2``/``exp`` (tests/test_torch_kernels.py)."""
    from vfx_image_stitching_tpu.geometry.cylindrical import (
        cylindrical_project_host,
    )
    from vfx_image_stitching_tpu.io import load_bgr
    from vfx_image_stitching_tpu.models.sift.extract import (
        sift_batch_with_stats as jextract,
    )
    from vfx_image_stitching_tpu.ops.color import bgr_to_gray_u8_np
    from vfx_image_stitching_tpu_torch.models.sift.extract import (
        sift_batch_with_stats as textract,
    )

    jcfg, tcfg = configs
    img = load_bgr(os.path.join(chain, "im01.png.ppm"))
    gray = cylindrical_project_host(bgr_to_gray_u8_np(img), FOCAL + 0.37)
    with jax.disable_jit():
        xy_j, d_j, v_j, meta_j, st_j = jextract(jnp.asarray(gray[None]), jcfg.sift)
    xy_t, d_t, v_t, meta_t, st_t = textract(
        torch.as_tensor(gray[None]).to(torch.float32), tcfg.sift)
    v = np.asarray(v_j)
    assert np.array_equal(v_t.numpy(), v) and v.sum() > 50
    assert np.array_equal(xy_t.numpy()[v], np.asarray(xy_j)[v])
    assert np.array_equal(d_t.numpy()[v], np.asarray(d_j)[v])
    for key in ("octave", "ix", "iy", "jx", "jy", "jl"):
        assert np.array_equal(meta_t[key].numpy()[v], np.asarray(meta_j[key])[v])
    for key in ("size", "angle"):
        np.testing.assert_allclose(meta_t[key].numpy()[v],
                                   np.asarray(meta_j[key])[v], rtol=1e-5)
    for key in st_j:
        assert np.array_equal(st_t[key].numpy(), np.asarray(st_j[key])), key


def test_stitch_matches_jax(chain, configs):
    """The synthetic chain through both packages' ``stitch_panorama``:
    equal shifts and pairs, byte-identical panorama."""
    from vfx_image_stitching_tpu.pipeline.stitch import stitch_panorama as jstitch
    from vfx_image_stitching_tpu_torch.pipeline.stitch import (
        stitch_panorama as tstitch,
    )

    jcfg, tcfg = configs
    with jax.disable_jit():
        ref = jstitch(chain, backend="sift", crop_margin=8, cfg=jcfg)
    got = tstitch(chain, backend="sift", crop_margin=8, cfg=tcfg, device="cpu")
    assert len(got.shifts) == N - 1 and all(p is not None for p in got.pairs)
    assert got.shifts == ref.shifts
    assert got.pairs == ref.pairs
    assert got.corrected_shifts == ref.corrected_shifts
    assert got.panorama.shape == ref.panorama.shape
    assert np.array_equal(got.panorama, ref.panorama)
    assert np.array_equal(got.mosaic, ref.mosaic)
    assert (got.capacity_stats is None) == (ref.capacity_stats is None)
