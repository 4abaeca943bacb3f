"""PyTorch port: the matcher's Lowe ratio test
(``match_descriptors(..., lowe_ratio=r)``) held against the JAX package on
the same inputs, and the ``mode`` keyword of ``sift_batch`` /
``sift_batch_with_stats``.

The matcher runs jitted on the JAX side, as in tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RATIOS = (0.6, 0.8, 1.0)


# ---------------------------------------------------------------------------
# the Lowe ratio test
# ---------------------------------------------------------------------------

def _match_sets(kind: str, n_b: int, seed: int):
    """Two pairs of (A, B) descriptor sets with their validity masks.

    A rows: random rows, their noisy copies in B (some inside the
    threshold, some outside), and three rows built so that the best and
    second distances sit exactly on a ratio's boundary: 9 / 25 = 0.6^2,
    16 / 25 = 0.8^2, and a row whose two nearest B rows are equal (a tie,
    1.0^2).  ``kind="sift"``: integers 0..255 against 25000;
    ``kind="harris"``: the same integers / 64 against 1.0 — float
    descriptors whose every distance sum is exact in f32 whatever the
    order of the sum, so both packages decide on the same values (the
    order is the one freedom the port takes).  B keeps its first ``n_b``
    rows."""
    rng = np.random.default_rng(seed)
    k_a, pairs = 40, 2
    a = rng.integers(0, 40, (pairs, k_a, 128))
    b = rng.integers(0, 40, (pairs, k_a + 6, 128))
    perm = rng.permutation(k_a)
    for i in range(0, k_a, 2):                      # noisy copies
        noisy = a[:, i].copy()
        m = int(rng.integers(0, 24))
        noisy[:, :m] += rng.integers(-9, 10, (pairs, m))
        b[:, 6 + perm[i]] = np.clip(noisy, 0, 255)
    # boundary rows: A rows 1, 3, 5; B rows 0-5 (inside every n_b >= 6)
    base = np.zeros(128, np.int64)
    for row, (c1, c2), off in ((1, (3, 5), 100), (3, (4, 5), 200)):
        a[:, row] = base
        a[:, row, 9] = off
        b[:, row - 1] = a[:, row]
        b[:, row - 1, 0] += c1
        b[:, row] = a[:, row]
        b[:, row, 1] += c2
    a[:, 5] = 0
    a[:, 5, 20] = 150
    b[:, 4] = a[:, 5]
    b[:, 4, 2] += 2
    b[:, 5] = b[:, 4]                               # exact tie
    va = rng.random((pairs, k_a)) > 0.1
    va[:, [1, 3, 5]] = True
    vb = rng.random((pairs, k_a + 6)) > 0.1
    vb[:, :6] = True
    b, vb = b[:, :n_b], vb[:, :n_b]
    if kind == "sift":
        return a.astype(np.float32), va, b.astype(np.float32), vb, 25000.0
    return ((a / 64).astype(np.float32), va, (b / 64).astype(np.float32), vb,
            1.0)


MATCH_CASES = {
    "full": dict(n_b=46),
    "one_valid_b": dict(n_b=46, one_valid=True),
    "k_b_5": dict(n_b=5),                           # refine 8 > K_B
    "k_b_1": dict(n_b=1),                           # refine 8 -> 1
}


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
@pytest.mark.parametrize("refine", [1, 8])
@pytest.mark.parametrize("kind", ["sift", "harris"])
def test_match_descriptors_lowe_ratio_matches_jax(kind, refine, case):
    """``best_idx``, ``matched`` and every ``return_dist`` output equal
    the JAX package's exactly, for each ratio, over a leading pair axis
    and without one; the ``return_dist`` outputs do not move with the
    ratio; a lower ratio keeps a subset of a higher one's matches."""
    from vfx_image_stitching_tpu.match.nn import match_descriptors as jmatch
    from vfx_image_stitching_tpu_torch.match.nn import match_descriptors as tmatch

    spec = MATCH_CASES[case]
    da, va, db, vb, thresh = _match_sets(kind, spec["n_b"], seed=refine + 7)
    if spec.get("one_valid"):
        vb = np.zeros_like(vb)
        vb[0, 3] = vb[1, 17] = True
    t_in = [torch.as_tensor(x) for x in (da, va, db, vb)]
    plain = tmatch(*t_in, thresh, refine=refine, return_dist=True, margin=0.5)
    kept = []
    for ratio in RATIOS:
        for return_dist in (False, True):
            got = tmatch(*t_in, thresh, refine=refine, lowe_ratio=ratio,
                         return_dist=return_dist, margin=0.5)
            one = tmatch(*(x[0] for x in t_in), thresh, refine, ratio,
                         return_dist, 0.5)
            assert len(got) == (7 if return_dist else 2)
            for p in range(2):
                ref = jmatch(jnp.asarray(da[p]), jnp.asarray(va[p]),
                             jnp.asarray(db[p]), jnp.asarray(vb[p]), thresh,
                             refine=refine, lowe_ratio=ratio,
                             return_dist=return_dist, margin=0.5)
                for i, (g, r) in enumerate(zip(got, ref)):
                    assert np.array_equal(g[p].numpy(), np.asarray(r)), (
                        ratio, return_dist, p, i)
            for g, o in zip(got, one):
                assert torch.equal(g[0], o)
            if return_dist:
                for i in (0, 2, 3, 4, 5, 6):
                    assert torch.equal(got[i], plain[i])
        kept.append(got[1])
        assert not (got[1] & ~plain[1]).any()
    assert not (kept[0] & ~kept[1]).any() and not (kept[1] & ~kept[2]).any()
    if case == "full":
        # the boundary rows decide as the JAX package does, and the set
        # exercises both outcomes of every ratio
        assert all(0 < int(k.sum()) < int(plain[1].sum()) for k in kept[:2])
        assert not kept[2][:, 5].any() and plain[1][:, 5].all()


# ---------------------------------------------------------------------------
# sift_batch(mode=...)
# ---------------------------------------------------------------------------

def test_sift_batch_modes_agree():
    """``mode="map"`` (the default) and ``mode="vmap"`` give equal
    outputs, in both batch functions."""
    from vfx_image_stitching_tpu_torch.config import SiftCapacities, SiftConfig
    from vfx_image_stitching_tpu_torch.models.sift import extract as te
    from vfx_image_stitching_tpu_torch.utils.synthetic import make_scene

    cfg = SiftConfig(capacities=SiftCapacities(
        candidate_caps=(256, 128, 64), localized_caps=(128, 64),
        oriented_caps=(128, 64), max_keypoints=256, max_radius=12,
        max_half_width=24, desc_small_half=14, desc_small_caps=(128, 64),
        desc_big_caps=(64,), desc_chunk=64))
    batch = torch.as_tensor(np.stack(
        [make_scene(48, 64, s)[..., 1] for s in (3, 4)]).astype(np.float32))
    outs = {}
    for mode in ("map", "vmap"):
        outs[mode] = (te.sift_batch(batch, cfg, mode=mode),
                      te.sift_batch_with_stats(batch, cfg, mode))
    default = (te.sift_batch(batch, cfg), te.sift_batch_with_stats(batch, cfg))
    flat = {m: jax.tree_util.tree_leaves(o) for m, o in outs.items()}
    assert len(flat["map"]) == len(flat["vmap"]) > 10
    for a, b, c in zip(flat["map"], flat["vmap"],
                       jax.tree_util.tree_leaves(default)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert int(outs["map"][0][2].sum()) > 0
