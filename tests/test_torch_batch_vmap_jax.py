"""PyTorch port, the batched SIFT schedule against the JAX package's
``sift_batch_with_stats(batch, cfg, mode="vmap")`` on the same numpy
inputs: two scenes and a nearly blank image between them (its live rows
stay under the batch's, so the batch-max bound of JAX ``vmap`` pads it).

The JAX side runs op by op (``jax.disable_jit()``) and compiles each
operation at its batched shape once, about two and a half minutes cold;
its one-image schedule (``mode="map"``) compiles as long again at other
shapes, so it has a file of its own, tests/test_torch_batch_map_jax.py.

The JAX package's two schedules are not bit-equal: on these inputs its
``vmap`` moves ``xy`` by up to 3.8e-6 px (22 entries), ``size`` by up to
1.9e-6 (22) and ``angle`` by up to 3.1e-5 degrees (2) from its ``map``
on the valid rows (``python -m tests.test_torch_batch_vmap_jax``, from
the repository root, measures that gap again in about five minutes).
Its mask, descriptor, integer meta and stats leaves agree.  The port's
two schedules are bit-equal (tests/test_torch_batch_vmap.py), and its
``map`` is held to the JAX ``map`` (tests/test_torch_batch_map_jax.py:
``xy`` exact, ``size`` and ``angle`` within the rtol 1e-5 of XLA's CPU
``exp2``/``exp``).  So against the JAX ``vmap`` the mask, descriptor,
integer meta and stats leaves are held equal, ``xy`` within the JAX
package's own gap, and ``size`` and ``angle`` within that gap plus the
rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)

# The JAX package's map-to-vmap gap on ``inputs()``: the largest
# |map - vmap| of each float leaf over the valid rows, as measured by
# this file's ``__main__`` (2^-18 px, 2^-19, 2^-15 degrees)
JAX_MODE_GAP = {"xy": 3.814697265625e-06, "size": 1.9073486328125e-06,
                "angle": 3.0517578125e-05}
# the port's map against the JAX map: XLA's CPU exp2/exp (ROADMAP Queue 3)
LIBM_RTOL = {"xy": 0.0, "size": 1e-5, "angle": 1e-5}
EXACT_META = ("octave", "ix", "iy", "jx", "jy", "jl")


def inputs() -> np.ndarray:
    """(3, 48, 64) f32 gray: scene 3, a nearly blank image, scene 4."""
    from vfx_image_stitching_tpu_torch.utils.synthetic import make_scene

    blank = np.full((48, 64), 90, np.uint8)
    blank[21:27, 28:36] = 200
    return np.stack([make_scene(48, 64, 3)[..., 1], blank,
                     make_scene(48, 64, 4)[..., 1]]).astype(np.float32)


def configs():
    """The JAX and port SIFT configurations (the small capacities of
    tests/test_torch_options.py)."""
    from vfx_image_stitching_tpu import config as jc
    from vfx_image_stitching_tpu_torch import config as tc

    def caps(mod):
        return mod.SiftCapacities(
            candidate_caps=(256, 128, 64), localized_caps=(128, 64),
            oriented_caps=(128, 64), max_keypoints=256, max_radius=12,
            max_half_width=24, desc_small_half=14, desc_small_caps=(128, 64),
            desc_big_caps=(64,), desc_chunk=64)

    return (jc.SiftConfig(capacities=caps(jc)),
            tc.SiftConfig(capacities=caps(tc)))


def jax_extract(mode: str):
    """The JAX package's ``sift_batch_with_stats`` on :func:`inputs`, op
    by op, as numpy."""
    from vfx_image_stitching_tpu.models.sift.extract import sift_batch_with_stats

    jcfg, _ = configs()
    with jax.disable_jit():
        out = sift_batch_with_stats(jnp.asarray(inputs()), jcfg, mode)
    return jax.tree_util.tree_map(np.asarray, out)


def port_extract(mode: str):
    from vfx_image_stitching_tpu_torch.models.sift.extract import (
        sift_batch_with_stats,
    )

    _, tcfg = configs()
    out = sift_batch_with_stats(torch.as_tensor(inputs()), tcfg, mode)
    return jax.tree_util.tree_map(lambda t: t.numpy(), out)


def float_leaves(out) -> dict:
    xy, _d, _v, meta, _s = out
    return {"xy": xy, "size": meta["size"], "angle": meta["angle"]}


def check_exact_leaves(got, want) -> None:
    """The valid mask and stats equal; descriptors and the integer meta
    equal on the valid rows."""
    (_, d_g, v_g, m_g, s_g), (_, d_w, v_w, m_w, s_w) = got, want
    assert np.array_equal(v_g, v_w)
    assert np.array_equal(d_g[v_w], d_w[v_w])
    for key in EXACT_META:
        assert np.array_equal(m_g[key][v_w], m_w[key][v_w]), key
    assert sorted(s_g) == sorted(s_w)
    for key in s_w:
        assert np.array_equal(s_g[key], s_w[key]), key


def mode_gap(a, b) -> dict:
    """The largest |a - b| of each float leaf over the rows valid in both
    (the mask is checked equal separately), and the entries that differ."""
    v = a[2] & b[2]
    return {k: (float(np.abs(fa[v] - fb[v]).max()), int((fa[v] != fb[v]).sum()))
            for (k, fa), fb in zip(float_leaves(a).items(),
                                   float_leaves(b).values())}


def test_vmap_matches_jax_vmap():
    """Port ``vmap`` against JAX ``vmap``: mask, stats, descriptors and
    integer meta equal; ``xy`` within the JAX package's own map-to-vmap
    gap, ``size`` and ``angle`` within it plus rtol 1e-5; the port's
    ``vmap`` equal to its ``map`` on every leaf."""
    want = jax_extract("vmap")
    got = port_extract("vmap")
    assert int(want[2].sum()) > 40
    assert want[4]["final_count"][1] < want[4]["final_count"][[0, 2]].min()
    check_exact_leaves(got, want)
    v = want[2]
    for key, g in float_leaves(got).items():
        w = float_leaves(want)[key]
        bound = JAX_MODE_GAP[key] + LIBM_RTOL[key] * np.abs(w[v])
        assert (np.abs(g[v] - w[v]) <= bound).all(), (key, mode_gap(got, want))
    same = port_extract("map")
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(same)):
        assert np.array_equal(a, b)


if __name__ == "__main__":
    # the JAX package's own gap between its two schedules on these inputs:
    # python -m tests.test_torch_batch_vmap_jax (from the repository root)
    import time

    jax.config.update("jax_platforms", "cpu")
    outs = {}
    for mode in ("map", "vmap"):
        t0 = time.time()
        outs[mode] = jax_extract(mode)
        print(f"jax {mode}: {time.time() - t0:.1f} s")
    check_exact_leaves(outs["vmap"], outs["map"])
    print("exact leaves equal; float gap (max |map - vmap|, entries):",
          mode_gap(outs["map"], outs["vmap"]))
