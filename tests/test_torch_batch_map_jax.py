"""PyTorch port, both SIFT schedules against the JAX package's one-image
schedule, ``sift_batch_with_stats(batch, cfg, mode="map")``, on the
inputs of tests/test_torch_batch_vmap_jax.py (which holds the port's
batched schedule to the JAX ``vmap``; each JAX schedule compiles its
operations for over two minutes, so each has a file).

Op by op (``jax.disable_jit()``): the mask, stats, descriptors, ``xy``
and the integer meta equal; ``size`` and ``angle`` carry the ulp gaps of
XLA's CPU ``exp2``/``exp`` (rtol 1e-5, as tests/test_torch_slice.py).
"""

import jax
import numpy as np
import torch

from tests.test_torch_batch_vmap_jax import (
    check_exact_leaves,
    jax_extract,
    port_extract,
)

torch.set_num_threads(1)


def test_map_and_vmap_match_jax_map():
    """Port ``map`` and ``vmap`` against JAX ``map`` on every leaf."""
    want = jax_extract("map")
    v = want[2]
    assert int(v.sum()) > 40
    for mode in ("map", "vmap"):
        got = port_extract(mode)
        check_exact_leaves(got, want)
        assert np.array_equal(got[0][v], want[0][v]), mode
        for key in ("size", "angle"):
            np.testing.assert_allclose(got[3][key][v], want[3][key][v],
                                       rtol=1e-5, err_msg=f"{mode} {key}")
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(port_extract("map")),
        jax.tree_util.tree_leaves(got)))
