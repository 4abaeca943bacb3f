"""PyTorch port, the Harris backend (``models/harris.py`` and the default
``backend="harris"`` stitch) against the JAX package on the same inputs.

The JAX side runs op by op (``jax.disable_jit()``): XLA's CPU jit
contracts multiply-adds into FMAs, PyTorch never does.  Contracts:
corners (``yy``, ``xx``, ``valid``, the ``-inf`` tail included) equal,
gradients bit-equal, response within 0 ulp; keypoints and validity equal,
descriptors within the reference's 1e-5 on valid rows (the histograms'
summation order differs) with no main-orientation flip; a small chain's
shifts and pairs equal and its panorama byte-identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfx_image_stitching_tpu.models import harris as JH
from vfx_image_stitching_tpu_torch.models import harris as TH
from vfx_image_stitching_tpu_torch.utils.synthetic import make_scene

torch.set_num_threads(1)

# one image shape for the scene, the batch and the chain: the JAX side's
# op-by-op primitives compile once per shape
H, W = 96, 128


def _image(case):
    """(H, W, 3) uint8 BGR test images: a synthetic scene with fewer than
    200 corners (a ``-inf`` tail); a 6-px checkerboard whose corners all
    have one response and outnumber ``max_points`` (so top-k's tie order
    decides which are kept); a scene of odd height and width."""
    if case == "scene":
        return make_scene(H, W, 3)
    if case == "checker":
        cells = (np.add.outer(np.arange(12), np.arange(16)) % 2 * 200 + 20)
        board = np.kron(cells, np.ones((6, 6))).astype(np.uint8)
        return np.repeat(board[..., None], 3, axis=-1)
    return make_scene(97, 131, 5)


@pytest.mark.parametrize("case", ["scene", "checker", "odd"])
def test_harris_corners_match_jax(case):
    img = _image(case)
    with jax.disable_jit():
        jy, jx, jr, jv, (jix, jiy) = map(
            lambda t: t if isinstance(t, tuple) else np.asarray(t),
            JH.harris_corners(jnp.asarray(img)))
    ty, tx, tr, tv, (tix, tiy) = TH.harris_corners(torch.as_tensor(img))
    n_valid = int(jv.sum())
    assert (n_valid == 200) == (case == "checker")
    assert n_valid > 10
    for got, want in ((ty, jy), (tx, jx), (tv, jv)):
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tix.numpy(), np.asarray(jix))
    assert np.array_equal(tiy.numpy(), np.asarray(jiy))
    assert np.array_equal(tr.numpy(), np.asarray(jr))  # 0 ulp, -inf tail too


def _main_orientation_flips(batch, cfg, valid) -> int:
    """Valid keypoints of an (N, H, W, 3) batch whose main-orientation bin
    differs between the two packages (a flip rotates the whole
    descriptor), each side from its own fields, patches, blur, angle bins
    and histogram."""
    from vfx_image_stitching_tpu.ops import gaussian as jg
    from vfx_image_stitching_tpu.ops import gradients as jgr
    from vfx_image_stitching_tpu_torch.ops import gaussian as tg
    from vfx_image_stitching_tpu_torch.ops import gradients as tgr

    pad, size, bins = cfg.patch_size // 2, cfg.patch_size, cfg.desc_bins

    def jax_bins(img):
        yy, xx, _, _, (ix, iy) = JH.harris_corners(img, cfg)
        m, theta = jgr.calc_orientation(ix, iy)
        pm = jg.gaussian_blur(JH._descriptor_patches(m, yy, xx, pad, size),
                              cfg.desc_blur_sigma, cfg.desc_blur_ksize)
        pt = JH._descriptor_patches(theta, yy, xx, pad, size)
        onehot = jax.nn.one_hot(JH._angle_bins(jnp.mod(pt, 360.0), bins), bins,
                                dtype=jnp.float32)
        return jnp.argmax(jnp.einsum("kij,kijb->kb", pm, onehot), axis=-1)

    with jax.disable_jit():
        jb = np.asarray(jax.vmap(jax_bins)(jnp.asarray(batch)))
    yy, xx, _, _, (ix, iy) = TH.harris_corners(torch.as_tensor(batch), cfg)
    m, theta = tgr.calc_orientation(ix, iy)
    pm = tg.gaussian_blur(TH._descriptor_patches(m, yy, xx, pad, size),
                          cfg.desc_blur_sigma, cfg.desc_blur_ksize)
    pt = TH._descriptor_patches(theta, yy, xx, pad, size)
    tb = TH._bin_sums(pm, TH._angle_bins(torch.remainder(pt, 360.0), bins),
                      bins, (-3, -2)).argmax(-1).numpy()
    return int((jb != tb)[valid].sum())


def test_harris_keypoints_and_descriptors_match_jax():
    """One image and a batch (which holds it too): keypoints and validity
    equal, descriptors within 1e-5 on valid rows, main-orientation flips
    in the batch: 0."""
    from vfx_image_stitching_tpu.config import HarrisConfig

    img = _image("scene")
    batch = np.stack([img, make_scene(H, W, 0), make_scene(H, W, 1)])
    with jax.disable_jit():
        single = JH.harris_keypoints_and_descriptors(jnp.asarray(img))
        jbatch = JH.harris_batch(jnp.asarray(batch))
    got = [TH.harris_keypoints_and_descriptors(torch.as_tensor(img)),
           TH.harris_batch(torch.as_tensor(batch))]
    for (jxy, jd, jv), (txy, td, tv) in zip([single, jbatch], got):
        v = np.asarray(jv)
        assert v.sum() > 10
        assert np.array_equal(tv.numpy(), v)
        assert np.array_equal(txy.numpy(), np.asarray(jxy))
        assert np.abs(td.numpy()[v] - np.asarray(jd)[v]).max() < 1e-5
    flips = _main_orientation_flips(batch, HarrisConfig(), np.asarray(jbatch[2]))
    assert flips == 0, f"{flips} main-orientation flips"


def test_harris_stitch_matches_jax(tmp_path):
    """A 3-image synthetic chain through both packages' default
    ``stitch_panorama`` (Harris): equal shifts and pairs, byte-identical
    panorama and mosaic."""
    from vfx_image_stitching_tpu.pipeline.stitch import stitch_panorama as jstitch
    from vfx_image_stitching_tpu_torch.pipeline.stitch import (
        stitch_panorama as tstitch,
    )
    from vfx_image_stitching_tpu_torch.utils.synthetic import synth_chain

    folder = str(tmp_path)
    synth_chain(folder, 3, H, W, seed=4, focal=300.0)
    with jax.disable_jit():
        ref = jstitch(folder, crop_margin=8)
    got = tstitch(folder, crop_margin=8, device="cpu")
    assert all(p is not None for p in got.pairs)
    assert got.shifts == ref.shifts
    assert got.pairs == ref.pairs
    assert got.corrected_shifts == ref.corrected_shifts
    assert got.panorama.shape == ref.panorama.shape
    assert np.array_equal(got.panorama, ref.panorama)
    assert np.array_equal(got.mosaic, ref.mosaic)
    assert got.capacity_stats is None and got.timings["passes"] == 1


def test_config_from_dict_carries_harris_config():
    """``config_from_dict`` rebuilds ``HarrisConfig`` from the JAX
    ``StitchConfig``'s ``asdict``, and the carried configuration finds
    the JAX package's corners."""
    from vfx_image_stitching_tpu import config as jc
    from vfx_image_stitching_tpu_torch import config as tc

    jh = jc.HarrisConfig(max_points=150, k=0.04, thresh_ratio=0.01,
                         border_margin=6, desc_clip=0.25)
    jcfg = jc.StitchConfig(backend="harris", harris=jh)
    tcfg = tc.config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.backend == "harris"
    assert tcfg.harris == tc.HarrisConfig(**dataclasses.asdict(jh))
    assert dataclasses.asdict(tcfg.match()) == dataclasses.asdict(jcfg.match())
    img = _image("checker")
    with jax.disable_jit():
        jy, jx, _, jv, _ = JH.harris_corners(jnp.asarray(img), jh)
    ty, tx, _, tv, _ = TH.harris_corners(torch.as_tensor(img), tcfg.harris)
    assert ty.shape == (150,)
    for got, want in ((ty, jy), (tx, jx), (tv, jv)):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_extract_features_dispatch():
    """``extract_features`` runs Harris on the BGR batch (no meta, no
    stats) and refuses a backend it does not know."""
    from vfx_image_stitching_tpu_torch.config import StitchConfig
    from vfx_image_stitching_tpu_torch.pipeline.stitch import extract_features

    batch = torch.as_tensor(_image("checker")[None])
    xy, descs, valid, meta, stats = extract_features(
        batch, StitchConfig(backend="harris"))
    want = TH.harris_batch(batch)
    assert meta is None and stats is None
    for got, ref in zip((xy, descs, valid), want):
        assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="unknown backend"):
        extract_features(batch, StitchConfig(backend="orb"))
