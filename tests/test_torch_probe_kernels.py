"""PyTorch port: the probe entry points (``vfx_image_stitching_tpu_torch/
probes/``) and their kernels' plain versions, against the probe scripts'
Pallas kernels (TPU interpret mode) and their own checks.  The scripts are
loaded by file path; the CUDA kernels themselves are held against these
plain versions in tests/test_torch_cuda.py, on a GPU.

Contracts: P1 (the tensor-core descriptor histogram) within 1e-5 of the
maximum against the JAX kernel and the float64 oracle; P2 and P3 (stack
and cube sums) bit for bit against the kernel bodies' arithmetic and the
probe's checks (P2 and P3 are closures of ``feas1()`` / ``feas2()``,
which write into ``docs/``, so they are not called); P4 (the Newton
kernel with float lanes): integer lanes, mask and cells exact against the
JAX kernel, float fields within 1e-6 relative (the interpreted JAX kernel
does not divide by 255 correctly rounded), and every field bit-exact
against the port's own plain chunked path; on the GPU tests' walk cases
(long moves, edges, 4 and 6 layers) its integer lanes exact against the
JAX kernel's; its wrapper refuses a stack with too few layers.
"""

import importlib.util
import json
import os
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "scripts")


def _load_script(name: str):
    """A probe script loaded by path under a private module name; the
    environment it touches at import is restored."""
    key = "_probe_" + name
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(SCRIPTS, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        with mock.patch.dict(os.environ):
            spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


# ---------------------------------------------------------------------------
# P1: desc_scratch_dot
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def p1_case():
    """``make_inputs`` (seed 7) at K=8 on 3x96x128, and the probe's
    float64 oracle of them."""
    from vfx_image_stitching_tpu_torch.probes import desc_scratch_dot as DS

    probe = _load_script("probe_desc_scratch_dot")
    args = DS.make_inputs(np.random.default_rng(DS.SEED), 8, 3, 96, 128)
    return probe, args, probe.oracle(*args, img_h=96, img_w=128)


def test_desc_scratch_dot_plain_matches_pallas_and_oracle(p1_case):
    from vfx_image_stitching_tpu_torch.probes import desc_scratch_dot as DS

    probe, args, want = p1_case
    ref = np.asarray(probe.desc_scratch_dot(
        *map(jnp.asarray, args), img_h=96, img_w=128, interpret=True))
    got = DS.desc_scratch_dot(*DS.to_torch(args, "cpu"), 96, 128).numpy()
    assert got.shape == (8, 16, 8)
    scale = np.abs(want).max()
    assert np.abs(got - ref).max() <= 1e-5 * scale
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert not got[-2:].any() and (got[:-2].max(axis=(1, 2)) > 0).all()


def test_desc_scratch_dot_oracle_copy_matches_probe(p1_case):
    from vfx_image_stitching_tpu_torch.probes import desc_scratch_dot as DS

    _probe, args, want = p1_case
    assert np.array_equal(DS.oracle(*args, img_h=96, img_w=128), want)


def test_desc_scratch_dot_cli_cpu(capsys):
    from vfx_image_stitching_tpu_torch.probes import desc_scratch_dot as DS

    assert DS.main(["cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["mode"] == "cpu" and res["k"] == 24 and res["max_rel_err"] < 1e-5


# ---------------------------------------------------------------------------
# P2 / P3: feas1 / feas2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["arange", "random"])
def test_feas1_stack_sum_plain_matches_kernel_arithmetic(case):
    """The kernel body ``acc = acc + dog_ref[l, :8, :128]`` in f32, and
    the probe's check (totals within 1e-5)."""
    from vfx_image_stitching_tpu_torch.probes import kernels as PK

    shape = (5, 16, 160) if case == "arange" else (3, 8, 128)
    n = int(np.prod(shape))
    dog = (np.arange(n, dtype=np.float32).reshape(shape) * np.float32(1e-4)
           if case == "arange"
           else np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    acc = np.zeros((8, 128), np.float32)
    for plane in dog:
        acc = acc + plane[:8, :128]
    got = PK.feas1_stack_sum(torch.as_tensor(dog)).numpy()
    assert np.array_equal(got, acc)
    expect = float(jnp.sum(jnp.asarray(dog)[:, :8, :128]))
    assert abs(expect - float(got.sum())) / max(abs(expect), 1) < 1e-5


@pytest.mark.parametrize("case", ["arange", "random"])
def test_feas2_cube_sums_plain_matches_probe_check(case):
    """The probe's ``expect += dn[l+dl, y+dy, x+dx]`` (the kernel body's
    (dl, dy, dx) order from 0), bit for bit."""
    from vfx_image_stitching_tpu_torch.probes import kernels as PK
    from vfx_image_stitching_tpu_torch.probes.localize_resident_r4 import (
        feas2_expect,
    )

    shape, k = (5, 24, 40), 64
    rng = np.random.default_rng(0)
    idx = [rng.integers(lo, hi, k).astype(np.int32)
           for lo, hi in ((1, 4), (1, shape[1] - 1), (1, shape[2] - 1))]
    n = int(np.prod(shape))
    dog = (np.arange(n, dtype=np.float32).reshape(shape) * np.float32(1e-6)
           if case == "arange"
           else rng.standard_normal(shape).astype(np.float32))
    args = [torch.as_tensor(a) for a in (dog, *idx)]
    got = PK.feas2_cube_sums(*args).numpy()
    assert np.array_equal(got, feas2_expect(*args))


@pytest.mark.parametrize("phase", ["feas1", "feas2"])
def test_localize_probe_cli_cpu(phase, capsys):
    """The entry point at the probe's sizes, on the CPU."""
    from vfx_image_stitching_tpu_torch.probes import localize_resident_r4 as R

    assert R.main([phase, "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["phase"] == phase and res["ok"] and res["device"] == "cpu"
    assert "ms" not in res     # no device time from a CPU run


def test_probe_kernel_wrappers_check_inputs():
    from vfx_image_stitching_tpu_torch.probes import kernels as PK

    with pytest.raises(ValueError):
        PK.feas1_stack_sum(torch.zeros((2, 4, 128)))
    with pytest.raises(TypeError):
        PK.feas2_cube_sums(torch.zeros((3, 4, 4)), *(torch.zeros(2, dtype=torch.int64),) * 3)
    with pytest.raises(ValueError):
        PK.localize_resident_r4_lanes(
            torch.zeros((3, 8, 8)), *(torch.zeros(2, dtype=torch.int32),) * 3,
            torch.zeros(3, dtype=torch.bool), 1, 1, 5)


@pytest.mark.parametrize("kernel", ["descriptor_histograms", "desc_scratch_dot"])
def test_descriptor_kernel_wrappers_check_inputs(kernel):
    """K5 and P1 on the CPU: the plain version's result, bit for bit; a
    per-keypoint array of another length, or of another type, raises, and
    so does a K5 histogram of more than 128 bins."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.probes import desc_scratch_dot as DS
    from vfx_image_stitching_tpu_torch.probes import kernels as PK

    targs = DS.to_torch(DS.make_inputs(np.random.default_rng(3), 6, 3, 60, 80), "cpu")
    if kernel == "descriptor_histograms":
        def call(*a, **kw):
            return K.descriptor_histograms(*a, PK.P1_HALF, **kw)
        want = K.descriptor_histograms_plain(*targs, PK.P1_HALF)
        with pytest.raises(ValueError, match="128"):
            call(*targs, num_bins=9)
    else:
        def call(*a, **kw):
            return PK.desc_scratch_dot(*a, 60, 80, **kw)
        want = PK.desc_scratch_dot_plain(*targs, 60, 80)
    assert want.abs().max() > 0
    assert torch.equal(call(*targs), want)
    short = [t[:-1] if i == 8 else t for i, t in enumerate(targs)]
    with pytest.raises(ValueError):
        call(*short)
    wrong = [t.double() if i == 6 else t for i, t in enumerate(targs)]
    with pytest.raises(TypeError):
        call(*wrong)


# ---------------------------------------------------------------------------
# P4: _localize_resident
# ---------------------------------------------------------------------------

def _ulp(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


@pytest.mark.parametrize("case", ["random", "scene"])
def test_localize_resident_r4_matches_pallas_interpret(case, monkeypatch):
    """The port's P4 + finalize against the probe's ``_localize_resident``
    under ``force_tpu_interpret_mode`` on a (5, 32, 256) random DoG and
    one octave of a synthetic scene.  The JAX kernel's lanes are read at
    its finalization.  Integer lanes exact on every row; valid mask and
    the integer fields exact on every row (``octave_packed`` on the valid
    rows: its ``rint`` of the update is a knife edge); float fields within
    1e-6 relative on the valid rows.  The interpreted JAX kernel's cube
    values (value / 255) come out up to 1 ulp from the correctly rounded
    quotient (its ``center`` lane), and the differences and the solve
    amplify that in the other float lanes.  Then against the port's plain
    chunked path: every field bit-exact on the valid rows."""
    from jax.experimental.pallas import tpu as pltpu
    from test_torch_kernels import _octave_dog

    from vfx_image_stitching_tpu.config import SiftConfig as JCfg
    from vfx_image_stitching_tpu.models.sift import extrema as je
    from vfx_image_stitching_tpu.models.sift import localize as jl
    from vfx_image_stitching_tpu_torch.config import SiftConfig as TCfg
    from vfx_image_stitching_tpu_torch.models.sift.localize import (
        localize_candidates_chunked,
    )
    from vfx_image_stitching_tpu_torch.probes import kernels as PK
    from vfx_image_stitching_tpu_torch.probes import localize_resident_r4 as R

    probe = _load_script("probe_localize_resident_r4")
    if case == "random":
        dog = np.random.default_rng(2).integers(-80, 80, (5, 32, 256)).astype(np.float32)
        cand = [np.array(a) for a in je.extract_candidates(
            jnp.asarray(dog), 5, je.extrema_threshold(0.04, 3), 64)]
    else:
        _, dog, cand = _octave_dog(64, 96)
    lanes = {}
    finalize = jl._finalize_localized

    def spy(st, *a, **kw):
        lanes.update({n: np.asarray(v) for n, v in st.items()})
        return finalize(st, *a, **kw)

    monkeypatch.setattr(jl, "_finalize_localized", spy)
    with pltpu.force_tpu_interpret_mode():
        ref = probe._localize_resident(jnp.asarray(dog),
                                       *(jnp.asarray(a) for a in cand), 0, JCfg())
    tcand = [torch.as_tensor(a) for a in cand]
    got = R.localize_resident_r4(torch.as_tensor(dog), *tcand, 0, TCfg())

    _f, outi = PK.localize_resident_r4_lanes(torch.as_tensor(dog), *tcand, 5, 3, 5)
    for j, name in enumerate(PK.INT_LANES):
        assert np.array_equal(lanes[name].astype(np.int32), outi[:, j].numpy()), name
    assert _ulp(lanes["center"], _f[:, PK.FLOAT_LANES.index("center")]).max() <= 1

    v = np.asarray(ref.valid)
    assert np.array_equal(got.valid.numpy(), v) and v.sum() >= 8
    for name in ("x", "y", "layer", "jx", "jy", "jl"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name))), name
    assert np.array_equal(got.octave_packed.numpy()[v], np.asarray(ref.octave_packed)[v])
    for name in ("pt_x", "pt_y", "size", "response"):
        np.testing.assert_allclose(getattr(got, name).numpy()[v],
                                   np.asarray(getattr(ref, name))[v], rtol=1e-6,
                                   atol=0, err_msg=name)

    plain = localize_candidates_chunked(torch.as_tensor(dog), *tcand, 0, TCfg())
    assert torch.equal(plain.valid, got.valid)
    for name in plain._fields:
        assert torch.equal(getattr(plain, name)[plain.valid],
                           getattr(got, name)[plain.valid]), name


@pytest.mark.parametrize("case", ["reload", "edges", "layers4", "layers6"])
def test_localize_resident_r4_walk_cases_match_pallas_interpret(case, monkeypatch):
    """The GPU tests' P4 walk cases (``test_torch_cuda.P4_WALK_CASES``:
    walks that move more than one row or column; candidates next to every
    edge with border 0; 4 and 6 layers) through the port's P4 on the CPU and the probe's
    ``_localize_resident`` under ``force_tpu_interpret_mode``: integer
    lanes exact on every row, ``center`` within 1 ulp (the module
    docstring says why not bit for bit).  The probe's TPU slab needs
    h >= 16, so the GPU tests' 3x4 stack is not among these."""
    from jax.experimental.pallas import tpu as pltpu
    from test_torch_cuda import p4_walk_case

    from vfx_image_stitching_tpu.config import SiftConfig as JCfg
    from vfx_image_stitching_tpu.models.sift import localize as jl
    from vfx_image_stitching_tpu_torch.probes import kernels as PK

    probe = _load_script("probe_localize_resident_r4")
    dog, cand, border, num_intervals = p4_walk_case(case)
    lanes = {}
    finalize = jl._finalize_localized

    def spy(st, *a, **kw):
        lanes.update({n: np.asarray(v) for n, v in st.items()})
        return finalize(st, *a, **kw)

    monkeypatch.setattr(jl, "_finalize_localized", spy)
    with pltpu.force_tpu_interpret_mode():
        probe._localize_resident(
            jnp.asarray(dog), *(jnp.asarray(a) for a in cand), 0,
            JCfg(num_intervals=num_intervals, image_border_width=border))
    tcand = [torch.as_tensor(a) for a in cand]
    outf, outi = PK.localize_resident_r4_lanes(torch.as_tensor(dog), *tcand, border,
                                               num_intervals, 5)
    for j, name in enumerate(PK.INT_LANES):
        assert np.array_equal(lanes[name].astype(np.int32), outi[:, j].numpy()), name
    assert _ulp(lanes["center"], outf[:, PK.FLOAT_LANES.index("center")]).max() <= 1
    far = ((outi[:, 3] - tcand[2]).abs() > 1) | ((outi[:, 4] - tcand[1]).abs() > 1)
    assert int(far[tcand[3]].sum()) >= 10


@pytest.mark.parametrize("n_l,num_intervals", [(4, 3), (4, 2), (7, 4)])
def test_localize_resident_r4_needs_the_walks_layers(n_l, num_intervals):
    """P4's wrapper, and K1's, take a stack of at least
    ``num_intervals + 2`` layers, every layer a walk's cube can reach, on
    either device (the plain version's result there); they raise on
    fewer."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.probes import kernels as PK

    rng = np.random.default_rng(n_l)
    dog = torch.as_tensor(rng.integers(-80, 80, (n_l, 24, 32)).astype(np.float32))
    cand = [torch.full((4,), v, dtype=torch.int32) for v in (1, 10, 12)]
    args = (dog, *cand, torch.ones(4, dtype=torch.bool), 1, num_intervals, 5)
    pairs = ((PK.localize_resident_r4_lanes, PK.localize_resident_r4_lanes_plain),
             (K.localize_newton_resident, K.localize_newton_plain))
    for wrapper, plain in pairs:
        if n_l >= num_intervals + 2:
            got, want = wrapper(*args), plain(*args)
            assert all(torch.equal(g, r) for g, r in zip(got, want))
        else:
            with pytest.raises(ValueError, match="layers"):
                wrapper(*args)


def test_newton_on_small_chain_cpu():
    """The ``newton`` phase on every octave of a 3-image 96x128 chain's
    image 0, on the CPU: P4 + finalize equals the plain chunked path and
    its integer lanes K1's (the plain versions here)."""
    from vfx_image_stitching_tpu_torch.probes import localize_resident_r4 as R

    res = R.newton("cpu", chain=dict(n=3, h=96, w=128, seed=4, focal=300.0))
    assert res["ok"] and res["total_valid_rows"] > 20
    assert len(res["per_octave"]) >= 5 and "ms_octave0" not in res
    for row in res["per_octave"]:
        assert row["float_lanes_rows_not_exact"] == 0
        assert all(v == 0 for v in row["float_rows_not_exact"].values())


def test_fused_on_small_chain_cpu():
    """The ``fused`` phase on a 2-image group of a 3-image 96x128 chain,
    on the CPU: ``plain`` and ``resident`` give equal valid masks and
    equal fields on every valid row of every octave, and the result
    carries the JAX probe's ``fused_ab`` keys."""
    from vfx_image_stitching_tpu_torch.probes import localize_resident_r4 as R

    res = R.fused("cpu", chain=dict(n=3, h=96, w=128, seed=4, focal=300.0),
                  group=2, reps=1, rounds=2)
    eq = res["plain_vs_resident"]
    assert res["ok"] and eq["images"] == 2 and eq["valid_rows"] > 40
    assert eq["octaves"] >= 10 and eq["mask_mismatches"] == eq["field_mismatches"] == 0
    assert set(res["summary_ms_per_img"]) == set(R.FUSED_MODES)
    assert all(len(v) == 2 for v in res["rounds_ms_per_img"].values())
    assert set(res["derived"]) == {"loc_cum_plain", "loc_cum_resident",
                                   "resident_saving_ms_per_img"}
    assert res["source"] == "synthetic chain" and res["shape"] == [96, 128]
