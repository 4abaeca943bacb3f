"""PyTorch port, ``parallel/mesh.py``: the batched minimal multi-panorama
step (``_multi_pano_step``, behind ``sharded_multi_pano_shifts``) with
Harris and SIFT against the JAX package's vmap over panoramas, on the inputs and
with the tolerances of tests/test_torch_parallel_vmap_jax.py.

The JAX SIFT step compiles its operations at their vmapped shapes for
over two minutes cold; the full step's file would pass two and a half
minutes with it, so this step has a file of its own.
"""

import pytest
import torch

from tests.test_torch_parallel_vmap_jax import check_step

torch.set_num_threads(1)


@pytest.mark.parametrize("backend", ["harris", "sift"])
def test_min_step_matches_jax(backend):
    """``_multi_pano_step`` (and ``sharded_multi_pano_shifts`` over a
    (2, 2) mesh): Harris P=2, N=4, 64x48 and SIFT P=2, N=2, 32x24 against
    the JAX vmap over panoramas."""
    check_step("_multi_pano_step", backend)
