"""Probe ladder of the resident Newton localization kernel.

Counterpart of ``scripts/probe_localize_resident_r4.py``.  Run from the
repository root::

    python -m vfx_image_stitching_tpu_torch.probes.localize_resident_r4 feas1|feas2|newton|fused [--device cpu]

``feas1``: the layers' sum of the (8, 128) corner of a (5, 768, 1024)
stack (P2), bit-exact against its plain version; on the card, the stack's
MB beside the L2's (the H100's answer to the TPU's "does the whole stack
fit in VMEM").  ``feas2``: the 3x3x3 cube sums of 2048 candidates (P3),
bit-exact against the plain version and the probe's own check.
``newton``: every octave of the synthetic chain's image 0
(``utils.synthetic``) localized by the probe's Newton kernel (P4)
followed by the stock finalization, against the plain chunked path on
the valid rows, K1's lanes against the plain walk's and P4's against
K1's.  ``fused``: the extraction prefix (base image through localize)
of a group of the chain's images (of the reference ``parrington`` set
when ``VFX_REFERENCE_DIR`` holds it) in three modes, in interleaved
rounds (``extrema``; ``plain``, the chunked walk; ``resident``, K1),
host ms per image with the device synchronized around each timing, and
the plain and resident localized fields equal on every octave.  On the
card the other phases also report device times
(``utils.timing.cuda_ms``).
JSON lines on stdout; nothing is written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from vfx_image_stitching_tpu_torch.config import SiftConfig, StitchConfig
from vfx_image_stitching_tpu_torch.models.sift.localize import (
    Localized,
    _finalize_localized,
    localize_candidates_chunked,
    localize_candidates_resident,
    state_from_lanes,
)
from vfx_image_stitching_tpu_torch.probes import kernels as PK

FEAS_SHAPE = (5, 768, 1024)
FEAS2_K = 2048
# the probe's own acceptance limit for feas1's total
FEAS1_RTOL = 1e-5
INT_FIELDS = ("x", "y", "layer", "octave_packed", "valid", "jx", "jy", "jl")
FLOAT_FIELDS = ("pt_x", "pt_y", "size", "response")


def _device_info(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-element distance in units in the last place of two f32 tensors."""
    return (a.view(torch.int32).to(torch.int64)
            - b.view(torch.int32).to(torch.int64)).abs()


# ---------------------------------------------------------------------------
# feas1 / feas2
# ---------------------------------------------------------------------------

def feas1_input(dev) -> torch.Tensor:
    n = FEAS_SHAPE[0] * FEAS_SHAPE[1] * FEAS_SHAPE[2]
    return torch.arange(n, dtype=torch.float32, device=dev).reshape(FEAS_SHAPE) * 1e-4


def feas1(dev, timer=None) -> dict:
    """P2 on the probe's stack: bit-exact against the plain version, and
    the probe's check (its total within 1e-5 of the stack corner's sum)."""
    dev = torch.device(dev)
    dog = feas1_input(dev)
    out = PK.feas1_stack_sum(dog)
    want = PK.feas1_stack_sum_plain(dog)
    expect = float(dog[:, :8, :128].sum())
    got = float(out.sum())
    res = dict(phase="feas1", device=_device_info(dev),
               bit_exact=bool(torch.equal(out, want)),
               probe_check=abs(expect - got) / max(abs(expect), 1.0) < FEAS1_RTOL,
               stack_mb=dog.numel() * 4 / 2**20)
    if dev.type == "cuda":
        res["l2_mb"] = torch.cuda.get_device_properties(dev).L2_cache_size / 2**20
        res["stack_fits_l2"] = res["stack_mb"] <= res["l2_mb"]
    if timer is not None:
        res["ms"] = timer(lambda: PK.feas1_stack_sum(dog))
    res["ok"] = res["bit_exact"] and res["probe_check"]
    return res


def feas2_inputs(dev):
    """The probe's stack and candidates (seed 0): ``dog, layer, y, x``."""
    n_l, h, w = FEAS_SHAPE
    rng = np.random.default_rng(0)
    idx = [torch.as_tensor(rng.integers(lo, hi, FEAS2_K).astype(np.int32), device=dev)
           for lo, hi in ((1, 4), (1, h - 1), (1, w - 1))]
    dog = torch.arange(n_l * h * w, dtype=torch.float32, device=dev).reshape(
        FEAS_SHAPE) * 1e-6
    return (dog, *idx)


def feas2_expect(dog, layer, y, x) -> np.ndarray:
    """The probe's own check: ``expect += dn[l+dl, y+dy, x+dx]`` in f32."""
    dn = dog.cpu().numpy()
    ln, yn, xn = (t.cpu().numpy() for t in (layer, y, x))
    expect = np.zeros(ln.shape[0], np.float32)
    for dl in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                expect += dn[ln + dl, yn + dy, xn + dx]
    return expect


def feas2(dev, timer=None) -> dict:
    """P3 on the probe's 2048 candidates: bit-exact against the plain
    version and against the probe's check."""
    dev = torch.device(dev)
    args = feas2_inputs(dev)
    out = PK.feas2_cube_sums(*args)
    want = PK.feas2_cube_sums_plain(*args)
    expect = feas2_expect(*args)
    got = out.cpu().numpy()
    res = dict(phase="feas2", device=_device_info(dev), k=FEAS2_K,
               bit_exact=bool(torch.equal(out, want)),
               equals_probe_check=bool(np.array_equal(got, expect)),
               max_err=float(np.abs(got - expect).max()))
    if timer is not None:
        ms = timer(lambda: PK.feas2_cube_sums(*args))
        res["ms"] = ms
        res["us_per_candidate"] = ms / FEAS2_K * 1e3
    res["ok"] = res["bit_exact"] and res["equals_probe_check"]
    return res


# ---------------------------------------------------------------------------
# newton
# ---------------------------------------------------------------------------

def finalize_lanes(outf: torch.Tensor, outi: torch.Tensor,
                   cand_valid: torch.Tensor, octave: int,
                   cfg: SiftConfig) -> Localized:
    """The stock finalization on the kernel's own lanes: no cube is
    gathered again and no float recomputed."""
    return _finalize_localized(state_from_lanes(outi, outf), cand_valid,
                               octave, cfg)


def localize_resident_r4(dog: torch.Tensor, layer: torch.Tensor,
                         y: torch.Tensor, x: torch.Tensor,
                         cand_valid: torch.Tensor, octave: int,
                         cfg: SiftConfig) -> Localized:
    """One octave's candidates localized by the Newton kernel that writes
    its float lanes (P4), finalized on those lanes (the probe's
    ``_localize_resident``).  Every row is finalized; invalid rows carry
    zero lanes, as the TPU kernel gives them."""
    outf, outi = PK.localize_resident_r4_lanes(
        dog, layer, y, x, cand_valid, cfg.image_border_width,
        cfg.num_intervals, cfg.max_localize_iters)
    return finalize_lanes(outf, outi, cand_valid, octave, cfg)


def read_images(folder: str, count: int):
    """The first ``count`` images (BGR uint8) of a dataset folder and their
    focals, as the probe reads its photos."""
    from vfx_image_stitching_tpu_torch.io import (
        load_bgr,
        read_pano_data,
        resolve_image_path,
    )

    paths, focals = read_pano_data(os.path.join(folder, "pano.txt"))
    return ([load_bgr(resolve_image_path(p, folder)) for p in paths[:count]],
            [float(f) for f in focals[:count]])


def chain_images(count: int, n: int, h: int, w: int, seed: int,
                 focal: float, **scene):
    """The first ``count`` images (BGR uint8) and focals, read back from an
    ``n``-image synthetic chain."""
    from vfx_image_stitching_tpu_torch.utils.synthetic import synth_chain

    with tempfile.TemporaryDirectory() as folder:
        synth_chain(folder, n, h, w, seed, focal, **scene)
        return read_images(folder, count)


def chain_image0(**chain):
    """Image 0 (BGR uint8) and its focal, read back from a synthetic
    chain (:func:`default_chain`'s keys) as the probe reads its first
    photo."""
    imgs, focals = chain_images(1, **chain)
    return imgs[0], focals[0]


def default_chain() -> dict:
    """The chip run's 18-image 384x512 chain."""
    from vfx_image_stitching_tpu_torch.utils import synthetic as syn

    return dict(n=syn.N_IMAGES, h=syn.IMG_H, w=syn.IMG_W, seed=syn.SEED,
                focal=syn.FOCAL, **syn.SCENE)


def octave_inputs(dev, chain: dict = None):
    """Every octave's DoG stack and candidates of the chain's image 0, as
    the SIFT extraction makes them: ``(cfg, [(octave, dog, (layer, y, x,
    cand_valid)), ...])``."""
    from vfx_image_stitching_tpu_torch.geometry.cylindrical import (
        cylindrical_project,
    )
    from vfx_image_stitching_tpu_torch.models.sift.extrema import (
        extract_candidates,
        extrema_threshold,
    )
    from vfx_image_stitching_tpu_torch.models.sift.pyramid import (
        compute_number_of_octaves,
        generate_base_image,
        generate_dog_images,
        generate_gaussian_images,
        generate_gaussian_kernels,
    )
    from vfx_image_stitching_tpu_torch.ops.color import bgr_to_gray_f32

    img, focal = chain_image0(**(chain or default_chain()))
    cfg = StitchConfig(backend="sift").sift
    gray = bgr_to_gray_f32(cylindrical_project(torch.as_tensor(img, device=dev), focal))
    base = generate_base_image(gray, cfg.sigma, cfg.assumed_blur)
    pyramid = generate_gaussian_images(
        base, compute_number_of_octaves(base.shape),
        generate_gaussian_kernels(cfg.sigma, cfg.num_intervals))
    thresh = extrema_threshold(cfg.contrast_threshold, cfg.num_intervals)
    octaves = []
    for o, dog in enumerate(generate_dog_images(pyramid)):
        h_o, w_o = dog.shape[-2:]
        cap = min(cfg.capacities.scaled_candidates(o), 3 * h_o * w_o)
        octaves.append((o, dog, extract_candidates(
            dog, cfg.image_border_width, thresh, cap)))
    return cfg, octaves


def compare_octave(dog, cand, octave: int, cfg: SiftConfig) -> dict:
    """P4 + finalize against the plain chunked path on its valid rows
    (integer fields exact; float fields: rows not bit-exact and the
    largest ulp), P4's lanes against the plain version's, K1's integer
    and float lanes against the plain version's, and P4's against K1's."""
    from vfx_image_stitching_tpu_torch.models.sift.kernels import (
        localize_newton_resident,
    )

    walk = (cfg.image_border_width, cfg.num_intervals, cfg.max_localize_iters)
    outf, outi = PK.localize_resident_r4_lanes(dog, *cand, *walk)
    res = finalize_lanes(outf, outi, cand[3], octave, cfg)
    plain = localize_candidates_chunked(dog, *cand, octave, cfg)
    plain_f, plain_i = PK.localize_resident_r4_lanes_plain(dog, *cand, *walk)
    k1_i, k1_f = localize_newton_resident(dog, *cand, *walk)
    v = plain.valid
    out = dict(octave=octave, dog=list(dog.shape), candidates=int(cand[3].sum()),
               rows=int(v.sum()),
               valid_mask_equal=bool(torch.equal(res.valid, v)),
               int_lanes_equal_k1=bool(torch.equal(outi, k1_i)),
               float_lanes_equal_k1=bool(torch.equal(outf, k1_f)),
               k1_lanes_equal_plain=bool(torch.equal(k1_i, plain_i)
                                         and torch.equal(k1_f, plain_f)),
               int_lanes_equal_plain=bool(torch.equal(outi, plain_i)),
               float_lanes_rows_not_exact=int((outf != plain_f).any(1).sum()),
               float_lanes_max_ulp=int(ulp_diff(outf, plain_f).max()) if outf.numel() else 0,
               float_lanes_max_abs_err=float((outf - plain_f).abs().max()) if outf.numel() else 0.0,
               int_mismatches={}, float_rows_not_exact={}, float_max_ulp={})
    for name in INT_FIELDS:
        bad = int((getattr(res, name)[v] != getattr(plain, name)[v]).sum())
        if bad:
            out["int_mismatches"][name] = bad
    for name in FLOAT_FIELDS:
        a, b = getattr(res, name)[v], getattr(plain, name)[v]
        out["float_rows_not_exact"][name] = int((a != b).sum())
        out["float_max_ulp"][name] = int(ulp_diff(a, b).max()) if a.numel() else 0
    # tests/test_sift.py:328-396: all bit-exact but response (<= 4 ulp)
    out["ok"] = (out["valid_mask_equal"] and out["int_lanes_equal_k1"]
                 and out["float_lanes_equal_k1"] and out["k1_lanes_equal_plain"]
                 and not out["int_mismatches"]
                 and all(out["float_rows_not_exact"][n] == 0
                         for n in ("pt_x", "pt_y", "size"))
                 and out["float_max_ulp"]["response"] <= 4)
    return out


def newton(dev, chain: dict = None, timer=None, inputs=None) -> dict:
    """Every octave of the chain's image 0 (:func:`compare_octave`; or
    ``inputs``, :func:`octave_inputs`' result); with ``timer`` (``fn ->
    ms``), device ms on octave 0 of P4 + finalize, of K1's float lanes +
    finalize (the stitch's ``localize_candidates_resident``) and of the
    plain chunked path."""
    dev = torch.device(dev)
    cfg, octaves = inputs or octave_inputs(dev, chain)
    per_octave = [compare_octave(dog, cand, o, cfg) for o, dog, cand in octaves]
    res = dict(phase="newton", device=_device_info(dev), per_octave=per_octave,
               total_valid_rows=sum(r["rows"] for r in per_octave),
               ok=all(r["ok"] for r in per_octave))
    if timer is not None:
        o, dog, cand = octaves[0]
        res["ms_octave0"] = dict(
            resident_r4=timer(lambda: localize_resident_r4(dog, *cand, o, cfg)),
            resident_k1=timer(lambda: localize_candidates_resident(dog, *cand, o, cfg)),
            plain=timer(lambda: localize_candidates_chunked(dog, *cand, o, cfg)))
    return res


# ---------------------------------------------------------------------------
# fused
# ---------------------------------------------------------------------------

FUSED_MODES = ("extrema", "plain", "resident")


def fused_inputs(dev, chain: dict = None, group: int = 6):
    """Gray cylindrical images of the group on ``dev``: an (G, H, W) f32
    tensor, and where they came from.  The images are the first ``group``
    of ``chain`` when one is given, else of the reference ``parrington``
    set when ``VFX_REFERENCE_DIR`` holds it, else of
    :func:`default_chain`."""
    from vfx_image_stitching_tpu_torch.geometry.cylindrical import (
        cylindrical_project_batch,
    )
    from vfx_image_stitching_tpu_torch.ops.color import bgr_to_gray_f32

    ref = os.path.join(os.environ.get("VFX_REFERENCE_DIR", ""), "parrington")
    if chain is None and os.environ.get("VFX_REFERENCE_DIR") and os.path.isdir(ref):
        imgs, focals = read_images(ref, group)
        source = ref
    else:
        imgs, focals = chain_images(group, **(chain or default_chain()))
        source = "synthetic chain"
    batch = torch.as_tensor(np.stack(imgs)).to(dev)
    return bgr_to_gray_f32(cylindrical_project_batch(batch, focals)), source


def fused_prefix(gray: torch.Tensor, mode: str, cfg: SiftConfig) -> list:
    """The extraction prefix of one gray image, base image through
    localize: per octave the candidates (``extrema``) or the localized
    fields (``plain``: the chunked walk; ``resident``: K1)."""
    from vfx_image_stitching_tpu_torch.models.sift.extrema import (
        extract_candidates,
        extrema_threshold,
    )
    from vfx_image_stitching_tpu_torch.models.sift.pyramid import (
        compute_number_of_octaves,
        generate_base_image,
        generate_dog_images,
        generate_gaussian_images,
        generate_gaussian_kernels,
    )

    base = generate_base_image(gray, cfg.sigma, cfg.assumed_blur)
    pyramid = generate_gaussian_images(
        base, compute_number_of_octaves(base.shape),
        generate_gaussian_kernels(cfg.sigma, cfg.num_intervals))
    thresh = extrema_threshold(cfg.contrast_threshold, cfg.num_intervals)
    loc_fn = dict(plain=localize_candidates_chunked,
                  resident=localize_candidates_resident).get(mode)
    out = []
    for o, dog in enumerate(generate_dog_images(pyramid)):
        h_o, w_o = dog.shape[-2:]
        cap = min(cfg.capacities.scaled_candidates(o), 3 * h_o * w_o)
        cand = extract_candidates(dog, cfg.image_border_width, thresh, cap)
        out.append(cand if loc_fn is None else loc_fn(dog, *cand, o, cfg))
    return out


def fused_compare(plain: list, resident: list) -> dict:
    """``plain`` against ``resident`` (:func:`fused_prefix` of one image):
    equal valid masks, and every field equal on the valid rows."""
    out = dict(octaves=len(plain), valid_rows=0, mask_mismatches=0,
               field_mismatches={})
    for p, r in zip(plain, resident):
        v = p.valid
        out["valid_rows"] += int(v.sum())
        out["mask_mismatches"] += int((p.valid != r.valid).sum())
        for name in Localized._fields:
            bad = int((getattr(p, name)[v] != getattr(r, name)[v]).sum())
            if bad:
                out["field_mismatches"][name] = out["field_mismatches"].get(name, 0) + bad
    return out


def fused(dev="cuda", chain: dict = None, group: int = 6, reps: int = 8,
          rounds: int = 5, inputs=None) -> dict:
    """The fused-regime A/B of the JAX probe's ``fused`` phase: the
    extraction prefix (:func:`fused_prefix`) of a ``group`` of images in
    the three :data:`FUSED_MODES`, in ``rounds`` interleaved rounds of one
    untimed pass and ``reps`` timed passes each; host ms per image with
    the device synchronized before and after each timing (the median over
    rounds in ``summary_ms_per_img``), the localization's share
    (``derived``), and ``plain`` against ``resident`` on every octave of
    every image (:func:`fused_compare`).  ``inputs`` is
    :func:`fused_inputs`' result."""
    import statistics
    import time

    from vfx_image_stitching_tpu_torch.pipeline.stitch import resolve_device

    dev = resolve_device(dev)
    grays, source = inputs or fused_inputs(dev, chain, group)
    cfg = StitchConfig(backend="sift").sift

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(mode):
        return [fused_prefix(g, mode, cfg) for g in grays]

    checks = [fused_compare(p, r) for p, r in zip(run("plain"), run("resident"))]
    rounds_ms = {m: [] for m in FUSED_MODES}
    for _ in range(rounds):
        for mode in FUSED_MODES:
            run(mode)
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                run(mode)
            sync()
            rounds_ms[mode].append(
                (time.perf_counter() - t0) / reps / len(grays) * 1e3)
    summary = {m: statistics.median(v) for m, v in rounds_ms.items()}
    equal = dict(
        images=len(checks), octaves=sum(c["octaves"] for c in checks),
        valid_rows=sum(c["valid_rows"] for c in checks),
        mask_mismatches=sum(c["mask_mismatches"] for c in checks),
        field_mismatches=sum(sum(c["field_mismatches"].values()) for c in checks))
    return dict(
        phase="fused", device=_device_info(dev), source=source,
        group=len(grays), shape=list(grays.shape[1:]), reps=reps,
        n_rounds=rounds, summary_ms_per_img=summary,
        derived=dict(
            loc_cum_plain=summary["plain"] - summary["extrema"],
            loc_cum_resident=summary["resident"] - summary["extrema"],
            resident_saving_ms_per_img=summary["plain"] - summary["resident"]),
        rounds_ms_per_img=rounds_ms, plain_vs_resident=equal,
        ok=equal["valid_rows"] > 0 and equal["mask_mismatches"] == 0
        and equal["field_mismatches"] == 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vfx_image_stitching_tpu_torch.probes.localize_resident_r4")
    ap.add_argument("phase", choices=("feas1", "feas2", "newton", "fused"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--group", type=int, default=6, help="fused: images")
    ap.add_argument("--reps", type=int, default=8, help="fused: timed passes a round")
    ap.add_argument("--rounds", type=int, default=5, help="fused: rounds")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    timer = None
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("localize_resident_r4: CUDA is not available", file=sys.stderr)
            return 1
        from vfx_image_stitching_tpu_torch.utils.timing import cuda_ms as timer
    if args.phase == "fused":
        res = fused(dev, group=args.group, reps=args.reps, rounds=args.rounds)
    else:
        res = {"feas1": feas1, "feas2": feas2, "newton": newton}[args.phase](
            dev, timer=timer)
    for row in res.get("per_octave", ()):
        print(json.dumps(dict(phase="newton_octave", **row)))
    print(json.dumps({k: v for k, v in res.items() if k != "per_octave"}))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
