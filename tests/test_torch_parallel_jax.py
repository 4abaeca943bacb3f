"""PyTorch port, ``parallel/mesh.py``: the sharded minimal step against
the JAX package's ``_pairwise_shift_step``, which the JAX tests pin to
its own sharded path (``tests/test_parallel.py``).

The JAX side runs op by op (``jax.disable_jit()``; XLA's CPU jit
contracts multiply-adds into FMAs, PyTorch never does).  SIFT
(``__graft_entry__._small_sift_config``) is equal on every leaf: its
descriptors are integer-valued, so every distance is exact.  Harris's
shifts, pairs, match decisions and indices are equal and its candidate
distances within 1e-5, the Harris descriptor tolerance of
``tests/test_torch_harris.py``.  The JAX SIFT side compiles its
per-operation programs for about 70 s, so it runs on three images, in a
file of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parallel import _batch, _chain, _small_sift
from vfx_image_stitching_tpu_torch.config import StitchConfig
from vfx_image_stitching_tpu_torch.parallel import mesh as M

torch.set_num_threads(1)

# the 15 leaves of the pair step (pipeline.stitch._pair_shift)
PAIR_LEAVES = ("shift", "pair_a", "pair_b", "any_match", "counts", "best_b",
               "cand_idx", "cand_dist", "cand_inm", "matched", "border_flip",
               "border_swap", "material", "n_material", "max_inmargin")


@pytest.mark.parametrize("backend", ["harris", "sift"])
def test_sharded_matches_jax_step(backend):
    """The port's sharded minimal step against the JAX package's
    ``_pairwise_shift_step``: Harris 8x64x48 on 8 slots, SIFT 3x32x24 on 2
    (uneven); SIFT on every leaf, Harris's every leaf but the candidate
    distances exact, those within 1e-5."""
    from vfx_image_stitching_tpu.config import StitchConfig as JCfg
    from vfx_image_stitching_tpu.parallel.mesh import _pairwise_shift_step as jstep

    if backend == "sift":
        batch = _chain(2, 3, 32, 24)
        jcfg, tcfg = _small_sift()
    else:
        batch = _batch(0, (8, 64, 48, 3))
        jcfg, tcfg = JCfg(backend="harris"), StitchConfig(backend="harris")
    mesh = M.make_mesh(devices=["cpu"] * (2 if backend == "sift" else 8))
    got = M.sharded_pairwise_shifts(batch, mesh, tcfg)
    with jax.disable_jit():
        want = jstep(jnp.asarray(batch), jcfg)
    assert bool(np.asarray(want[3]).any())
    for name, g, w in zip(PAIR_LEAVES, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if backend == "harris" and name == "cand_dist":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            assert np.array_equal(g, w), name
