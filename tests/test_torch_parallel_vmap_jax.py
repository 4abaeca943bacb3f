"""PyTorch port, ``parallel/mesh.py``: the batched multi-panorama steps
against the JAX package's on the same numpy inputs.

The JAX package's ``_multi_pano_full_step`` and ``_multi_pano_step`` are
a vmap over panoramas; the port's extract all P*N images in one batched
pass and match all P*(N-1) pairs in one pair step.  The JAX side runs op
by op (``jax.disable_jit()``; XLA's CPU jit contracts multiply-adds into
FMAs, PyTorch never does).

Harris (P=2, N=4, 64x48): every leaf equal, the candidate distances
within 1e-5, as ``tests/test_torch_parallel_jax.py`` holds them.

SIFT (P=2, N=2, 32x24, ``__graft_entry__._small_sift_config``): the JAX
package's vmap over panoramas is not bit-equal to its own per-panorama
step (ROADMAP Queue 3 (o)): on these inputs it moves ``xy``, ``size``,
``angle`` and the pair step's ``shift``, ``pair_a`` and ``pair_b`` by up
to ``JAX_MODE_GAP``, which this file's ``__main__`` measures (``python -m
tests.test_torch_parallel_vmap_jax`` from the repository root, about
five minutes: both JAX programs op by op).  The port's batched step is
bit-equal to its per-panorama step (tests/test_torch_parallel_vmap.py),
which equals the JAX per-panorama step up to XLA's CPU libm (rtol 1e-5
on ``size`` and ``angle``, Queue 3 (d)).  So the mask, the integer meta,
the stats and the integer and boolean pair leaves are held equal, and
the float leaves within the JAX gap (plus the rtol for ``size`` and
``angle``).

Each JAX SIFT step compiles its operations at their vmapped shapes for
over two minutes cold, so the minimal step has a file of its own,
tests/test_torch_parallel_vmap_min_jax.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parallel import _batch, _chain, _small_sift
from tests.test_torch_parallel_jax import PAIR_LEAVES
from vfx_image_stitching_tpu_torch.config import StitchConfig
from vfx_image_stitching_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)

# The JAX package's gap between its vmap over panoramas and its
# per-panorama steps on ``sift_batch()``: the largest |difference| of each
# float leaf (over the rows valid in both; the pair leaves' the same for
# the full and the minimal step), as measured by ``__main__``: 2^-19 px,
# 1.5 * 2^-20, 2^-15 degrees, 2^-20 px, 2^-19 px, 2^-19 px
JAX_MODE_GAP = {"xy": 1.9073486328125e-06, "size": 1.430511474609375e-06,
                "angle": 3.0517578125e-05, "shift": 9.5367431640625e-07,
                "pair_a": 1.9073486328125e-06, "pair_b": 1.9073486328125e-06}
# the port against the JAX per-panorama step: XLA's CPU exp2/exp
LIBM_RTOL = {"size": 1e-5, "angle": 1e-5}
EXACT_META = ("octave", "ix", "iy", "jx", "jy", "jl")
FLOAT_PAIR_LEAVES = ("shift", "pair_a", "pair_b")


def sift_batch() -> np.ndarray:
    """(2, 2, 32, 24, 3): two chains of two crops, every pair matched."""
    return np.stack([_chain(s, 2, 32, 24) for s in (3, 4)])


def harris_batch() -> np.ndarray:
    return np.stack([_batch(s, (4, 64, 48, 3)) for s in (0, 1)])


def configs(backend: str):
    from vfx_image_stitching_tpu.config import StitchConfig as JCfg

    if backend == "sift":
        return _small_sift()
    return JCfg(backend="harris"), StitchConfig(backend="harris")


def jax_step(name: str, batch: np.ndarray, jcfg):
    """The JAX package's ``parallel.mesh.<name>`` op by op, as numpy."""
    from vfx_image_stitching_tpu.parallel import mesh as JM

    with jax.disable_jit():
        out = getattr(JM, name)(jnp.asarray(batch), jcfg)
    return jax.tree_util.tree_map(np.asarray, out)


def port_step(name: str, batch: np.ndarray, tcfg):
    out = getattr(M, name)(torch.as_tensor(batch), tcfg)
    return M._tree_map(lambda t: t.numpy(), out)


def check_pairs(got, want, backend: str) -> None:
    """The 15 pair leaves: Harris's candidate distances within 1e-5,
    SIFT's float leaves within the JAX gap, every other leaf equal."""
    for name, g, w in zip(PAIR_LEAVES, got, want):
        assert g.shape == w.shape, name
        if backend == "harris" and name == "cand_dist":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
        elif backend == "sift" and name in FLOAT_PAIR_LEAVES:
            assert np.abs(g - w).max() <= JAX_MODE_GAP[name], name
        else:
            assert np.array_equal(g, w), name


def check_features(got, want) -> None:
    """``(xy, valid, meta, stats)`` of the full SIFT step: the mask and
    stats equal, the integer meta equal on the valid rows, ``xy`` within
    the JAX gap, ``size`` and ``angle`` within it plus rtol 1e-5."""
    (xy_g, v_g, m_g, s_g), (xy_w, v_w, m_w, s_w) = got, want
    assert np.array_equal(v_g, v_w)
    assert sorted(s_g) == sorted(s_w)
    for key in s_w:
        assert np.array_equal(s_g[key], s_w[key]), key
    for key in EXACT_META:
        assert np.array_equal(m_g[key][v_w], m_w[key][v_w]), key
    assert (np.abs(xy_g[v_w] - xy_w[v_w]) <= JAX_MODE_GAP["xy"]).all()
    for key, rtol in LIBM_RTOL.items():
        w = m_w[key][v_w]
        bound = JAX_MODE_GAP[key] + rtol * np.abs(w)
        assert (np.abs(m_g[key][v_w] - w) <= bound).all(), key


def check_step(name: str, backend: str) -> None:
    """The port's ``parallel.mesh.<name>`` against the JAX package's on
    the backend's batch, and ``sharded_multi_pano_full(mode="vmap")`` /
    ``sharded_multi_pano_shifts`` over a (2, 2) mesh against it too."""
    jcfg, tcfg = configs(backend)
    batch = sift_batch() if backend == "sift" else harris_batch()
    want, got = jax_step(name, batch, jcfg), port_step(name, batch, tcfg)
    mesh = M.make_mesh_2d(4, devices=["cpu"] * 4)
    if name == "_multi_pano_full_step":
        sharded = M.sharded_multi_pano_full(batch, mesh, tcfg, mode="vmap")
    else:
        sharded = M.sharded_multi_pano_shifts(batch, mesh, tcfg)
    for out in (got, M._tree_map(lambda t: t.numpy(), sharded)):
        pairs, wpairs = out, want
        if name == "_multi_pano_full_step":
            if backend == "sift":
                check_features(out[:4], want[:4])
            else:
                assert out[2] is None and out[3] is None and want[2] is None
                for g, w in zip(out[:2], want[:2]):
                    assert np.array_equal(g, w)
            pairs, wpairs = out[4], want[4]
        assert bool(wpairs[3].all() if backend == "sift" else wpairs[3].any())
        check_pairs(pairs, wpairs, backend)


@pytest.mark.parametrize("backend", ["harris", "sift"])
def test_full_step_matches_jax(backend):
    """``_multi_pano_full_step``: Harris P=2, N=4, 64x48 and SIFT P=2,
    N=2, 32x24 (both pairs matched) against the JAX vmap over
    panoramas."""
    check_step("_multi_pano_full_step", backend)


def mode_gap(vmapped, stacked) -> dict:
    """The largest |difference| of each float leaf between a vmapped and a
    stacked per-panorama full step, over the rows valid in both."""
    v = vmapped[1] & stacked[1]
    gap = {"xy": np.abs(vmapped[0][v] - stacked[0][v]).max()}
    for key in ("size", "angle"):
        gap[key] = np.abs(vmapped[2][key][v] - stacked[2][key][v]).max()
    for name, a, b in zip(PAIR_LEAVES, vmapped[4], stacked[4]):
        if name in FLOAT_PAIR_LEAVES:
            gap[name] = np.abs(a - b).max()
    return {k: float(x) for k, x in gap.items()}


if __name__ == "__main__":
    # the JAX package's own gap between its vmap over panoramas and its
    # per-panorama steps on sift_batch():
    # python -m tests.test_torch_parallel_vmap_jax (from the repository root)
    import time

    jax.config.update("jax_platforms", "cpu")
    jcfg, _ = configs("sift")
    batch = sift_batch()
    t0 = time.time()
    vmapped = jax_step("_multi_pano_full_step", batch, jcfg)
    print(f"jax vmap over panoramas: {time.time() - t0:.1f} s")
    t0 = time.time()
    per = [jax_step("_full_shift_step", b, jcfg) for b in batch]
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *per)
    print(f"jax per-panorama steps: {time.time() - t0:.1f} s")
    assert np.array_equal(vmapped[1], stacked[1])
    for key in vmapped[3]:
        assert np.array_equal(vmapped[3][key], stacked[3][key]), key
    for name, a, b in zip(PAIR_LEAVES, vmapped[4], stacked[4]):
        if name not in FLOAT_PAIR_LEAVES:
            assert np.array_equal(a, b), name
    print("full step: mask, stats and exact pair leaves equal; float gap:",
          mode_gap(vmapped, stacked))
    t0 = time.time()
    vmapped = jax_step("_multi_pano_step", batch, jcfg)
    per = [jax_step("_pairwise_shift_step", b, jcfg) for b in batch]
    print(f"jax minimal steps, both programs: {time.time() - t0:.1f} s")
    gap = {}
    for name, a, *bs in zip(PAIR_LEAVES, vmapped, *per):
        b = np.stack(bs)
        if name in FLOAT_PAIR_LEAVES:
            gap[name] = float(np.abs(a - b).max())
        else:
            assert np.array_equal(a, b), name
    print("minimal step: exact pair leaves equal; float gap:", gap)
