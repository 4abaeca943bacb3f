"""Chip smoke run of the PyTorch port: the SIFT and Harris stitches and the
rest of the stitch surface on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each: card identity; kernel build; the SIFT
extraction of an 18-image 384x512 synthetic chain with its per-octave
stage counts beside the capacities and the audited maxima; each CUDA
kernel against its plain PyTorch version on the inputs that extraction
gave it at octave 0 of the first image (the Newton kernel's integer and
float lanes; the two orientation kernels, K2 staged and K4 unstaged, on
the default one's inputs at 36 and 128 bins and against each other; the
window gather on both buckets, with the load stage each took, and its
direct stage at S = 119 and 161 on the big bucket's rows; the
descriptor-histogram kernel through its route,
``compute_descriptors_histogram``, on the descriptor stage's keypoints,
also held against the stitch's GEMM route, on its small- and big-bucket
rows apart); the histogram
route on every octave of the first image (``descriptor_octaves``); the
descriptor kernels' arithmetic against the library's on every float
(``kernel_arith``); the two descriptor routes side by side
(``descriptor_ab``); the two probe entry points of
``vfx_image_stitching_tpu_torch/probes/`` (``probe_localize``: the stack
sum, cube sums and float-lane Newton kernels, P2-P4, each timed as one
device kernel beside ``floor_ms``, the device time of a one-element
``fill_``, a launch that does no work, and ``latency_ms``, a one-element
copy out of the kernel's stack, a launch that reads once from L2 and
writes once; P4 beside K1 on the same slots;
``probe_desc``: the tensor-core descriptor histogram, P1, also against K5
on the chain's small-bucket rows); then the end-to-end stitch of the chain (one
warm-up, timed runs, launch counts, a profiled run, the whole chain on
the CPU against the card's first run, shifts, pairs, escalation counts
and bytes; the first four images on the card and the CPU, and those four
again with ``VFX_ORIENT_V2=0``); then ``batch_vmap``, the batched SIFT
schedule (``mode="vmap"``, ``VFX_SIFT_BATCH_MODE=vmap``: every stage of
every octave once over all 18 images) against the one-image schedule:
every leaf of the chain's extraction equal, K1-K4 on the batched inputs
it gave them, launches counted from 0 (once an octave, not once an
image), the stitch in both schedules in turns (shifts, pairs,
escalation counts, bytes; median walls, host syncs, peak memory), one
profiled vmap stitch (device time, device kernels, idle share), the
first four images' vmap stitch and extraction on the card against the
CPU; then the chain stitched with the
Harris backend, the reference's default (``harris_stitch``: every pair
matched, repeats identical, wall median, device time and kernels of a
profiled run, idle share, the CPU's shifts, pairs and bytes equal).  Each
path's run must launch its kernels and no other (``PATHS``; the Harris
stitch none of the SIFT library's), the SIFT and Harris stitches the
fold kernel once for the occupancy and once a step
(``check_fold_launches``), the Harris stitch the response kernel once
over all its images (``check_harris_launches``), and each kernel row
reports the launches of its path's run.  Then the rest of the stitch surface on the chain:
``compose_routes`` (both backends' stitches, whose compose is the
device fold, with and without the step capture, against the host fold
on the same plan: equal bytes, 17 steps, each route's compose time, the
device fold's device time and kernels), ``pano18_fold`` (at the
benchmark's shape the fold kernel's and the plain fold's device time
and kernels beside the byte bound; the kernel row ``compose_fold``),
``harris_response`` (at the same shape the Harris response kernel
bit-equal to its plain version, its ms a launch beside the plain
version's device time and kernels and the bound of
``bench_port/harness/roofline.py``; the kernel row ``harris_response``),
``stage_api``
(``compute_pairwise_shifts`` + ``finalize_to_panorama`` against
``stitch_panorama``, a saved ``.png``),
``multi`` (``stitch_many`` over folders shaped like BASELINE's
wind/out/parrington/grail run against the loop of ``stitch_panorama``,
both backends, timed in turns), ``api_surface`` (the compat shifts, the
capacity audit against ``chain_counts``, the SIFT stage functions on the
card against the CPU) and ``cli`` (the CLI in a subprocess on the
chain's first 4 images, with step files and a profiler trace).  Then the last modules of the port:
``mesh`` (``stitch_many`` over the ``multi`` folders on a pano mesh of
the visible cards and on a (2, 2) mesh of four logical slots of
``cuda:0``, equal to ``multi``'s unsharded run, and
``sharded_pairwise_shifts`` on 3 logical slots equal to the unsharded
step on every leaf), ``mesh_vmap`` (``sharded_multi_pano_full`` on the
``multi`` folders' 2 x 18 x 384x512 group over the same two meshes in
three schedules, in turns: ``shard_map`` in the map and in the batched
SIFT schedule, and ``mode="vmap"``, which extracts all of a slot's
panoramas in one batched pass and matches all their pairs in one pair
step: every SIFT and Harris leaf equal across them, walls, launches,
host syncs, peak memory, one profiled call each on the pano mesh;
``sharded_multi_pano_shifts`` equal to the per-panorama minimal step;
K1-K4 on the inputs the 36-image batch gave them), ``viz`` (both headless renderers on the chain's
first two images, their panel inputs against a CPU run) and
``probe_fused`` (the localize probe's ``fused`` phase: plain against
resident localization on every octave of a 6-image group, ms per image
per mode).  Then ``ratio_match``: ``match_descriptors`` with the Lowe
ratio test at 0.7 and 0.8 on the chain's 17 SIFT and 17 Harris pairs,
the card against the CPU bit for bit, the matches kept per ratio.  The
run's seconds come on a line of their
own; the line before the last is the kernel
table; the last line is ``{"ok": true, "device": {...}}``.  Any failed
check raises, and the script then exits non-zero; without CUDA it exits
non-zero at once.

The synthetic chain (``vfx_image_stitching_tpu_torch/utils/synthetic.py``)
and the device timer (``utils/timing.py``) are the port's.
"""

from __future__ import annotations

import os

import numpy as np

from vfx_image_stitching_tpu_torch.utils.synthetic import (
    FOCAL,
    IMG_H,
    IMG_W,
    N_IMAGES,
    SCENE,
    SEED,
    synth_chain,
)
from vfx_image_stitching_tpu_torch.utils.timing import (
    cuda_events_ms,
    cuda_ms,
    device_events,
    device_profile,
    one_kernel_ms,
)

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12    # f32 outside the tensor cores
H100_TF32_FLOP_PER_S = 495e12  # TF32 on the tensor cores, dense
# per-octave maxima of the capacity audit over the four reference photo
# sets (config.SiftCapacities), octaves 0-3, and the final keypoints
AUDITED = dict(cand=(2435, 738, 211, 67), loc=(1478, 430, 122, 50),
               oriented=(1790, 466, 154, 67), desc_big=(518, 148, 53, 20),
               final=1900)
KERNEL_SITES = (
    # (module that calls the function, function name)
    ("vfx_image_stitching_tpu_torch.models.sift.kernels",
     "localize_newton_resident"),
    ("vfx_image_stitching_tpu_torch.models.sift.orientation",
     "orientation_histograms"),
    ("vfx_image_stitching_tpu_torch.models.sift.descriptor",
     "pair_window_gather"),
    # the descriptor stage's inputs, for the histogram route (K5)
    ("vfx_image_stitching_tpu_torch.models.sift.extract",
     "compute_descriptors_bucketed"),
)
# The kernels each path must launch; every other kernel must not launch
# in that path's run.  Each kernel row reports its launches from the run
# of the first path listed here that launches it (KERNEL_PATH).
PATHS = {
    "stitch": ("localize_newton_resident", "orientation_histograms",
               "pair_window_gather"),
    "orient_v1": ("localize_newton_resident", "orientation_histograms_v1",
                  "pair_window_gather"),
    "descriptor_histogram": ("descriptor_histograms",),
    # the probe entry points (vfx_image_stitching_tpu_torch/probes/)
    "probe_localize": ("feas1_stack_sum", "feas2_cube_sums",
                       "localize_resident_r4"),
    # K5 here only for the A/B against P1 on the same rows
    "probe_desc": ("desc_scratch_dot", "descriptor_histograms"),
    # the Harris stitch launches none of these (its fold's kernels count
    # in compose/blend.py's LAUNCHES, its response kernel in
    # models/harris.py's: check_fold_launches, check_harris_launches)
    "harris": (),
    # find_scale_space_extrema + generate_descriptors on one image
    "stages": ("localize_newton_resident", "orientation_histograms",
               "pair_window_gather"),
    # stitch_many and sharded_pairwise_shifts over meshes (parallel/mesh.py)
    "mesh": ("localize_newton_resident", "orientation_histograms",
             "pair_window_gather"),
    # render_sift_report + render_harris_demo (viz/)
    "viz": ("localize_newton_resident", "orientation_histograms",
            "pair_window_gather"),
    # the localize probe's fused phase: only its resident mode has a kernel
    "probe_fused": ("localize_newton_resident",),
    # the chain's SIFT and Harris features for the Lowe ratio test
    "ratio_match": ("localize_newton_resident", "orientation_histograms",
                    "pair_window_gather"),
    # the SIFT stitch in the batched schedule (VFX_SIFT_BATCH_MODE=vmap)
    "batch_vmap": ("localize_newton_resident", "orientation_histograms",
                   "pair_window_gather"),
    # sharded_multi_pano_full over meshes in its three schedules
    "mesh_vmap": ("localize_newton_resident", "orientation_histograms",
                  "pair_window_gather"),
}
KERNEL_PATH = {k: p for p, ks in reversed(PATHS.items()) for k in ks}
# float operations of the descriptor-histogram kernel per masked sample:
# rotation 6, two divisions, two offsets, weight 6 (exp counted once),
# orientation bin 3, three floors, three fractions, four interpolation
# weights, 12 products and 8 sums into the bins
K5_OPS_PER_SAMPLE = 49
# float operations of P1 per masked sample outside the tensor cores:
# rotation 6, two divisions, two offsets, weight 6, row split 2,
# orientation bin 3, three floors, three fractions, two complements and
# the 16 spatial products of its A operand
P1_OPS_PER_SAMPLE = 45
# float operations of K2 and K4 per masked sample: the squared distance
# (two products, a sum, a conversion), the weight (a product and exp,
# counted once), its product with the magnitude, the bin (a product and
# a rounding) and the add into the bin
ORIENT_OPS_PER_SAMPLE = 10
# P1's tensor-core work per masked sample: its column of the (16 cells,
# 8 bins) product, once per TF32 pass (the TPU kernel's 64-wide padding
# of each window row is a BlockSpec workaround the kernel does not have)
P1_MMA_FLOPS_PER_SAMPLE = 2 * 16 * 8


def emit(obj) -> None:
    import json

    print(json.dumps(obj), flush=True)


def check_launches(path: str, launches: dict) -> None:
    """Every kernel of ``path`` launched in its run, and no other."""
    want = PATHS[path]
    if any(launches[n] <= 0 for n in want) or any(
            v != 0 for n, v in launches.items() if n not in want):
        raise AssertionError(f"{path}: launches {launches}, expected only {want}")


def check_fold_launches(path: str, res, launches: dict) -> None:
    """One stitch of the chain on the card folded by the fold kernel
    (``compose/blend.py``'s ``LAUNCHES``, counted from 0 before it): one
    occupancy launch and one step launch for each of its 17 fold steps,
    and ``n_fold_kernel_steps`` equal to ``n_fold_steps``."""
    steps = res.timings["n_fold_steps"]
    want = {"compose_column_occupancy": 1, "compose_fold_step": N_IMAGES - 1}
    if (launches != want or steps != N_IMAGES - 1
            or res.timings["n_fold_kernel_steps"] != steps):
        raise AssertionError(
            f"{path}: fold launches {launches}, n_fold_steps {steps}, "
            f"n_fold_kernel_steps {res.timings['n_fold_kernel_steps']}; "
            f"expected {want}")


def check_harris_launches(path: str, res, launches: dict) -> None:
    """One Harris stitch of the chain on the card computed its response by
    the kernel (``models/harris.py``'s ``LAUNCHES``, counted from 0 before
    it): one launch over all its images (``n_harris_kernel_images``)."""
    if (launches != {"harris_response": 1}
            or res.timings["n_harris_kernel_images"] != N_IMAGES):
        raise AssertionError(
            f"{path}: response launches {launches}, n_harris_kernel_images "
            f"{res.timings['n_harris_kernel_images']}; expected one launch "
            f"over {N_IMAGES} images")


def bound_ms(n_bytes: float, n_flops: float, tf32_flops: float = 0.0):
    """The larger of the bytes' time at the HBM rate and the operations'
    time (f32 at the f32 rate, TF32 tensor-core products at theirs)."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = max(n_flops / H100_F32_FLOP_PER_S,
                tf32_flops / H100_TF32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def distinct_pixels(stack_shape, layer, rows, cols, mask) -> int:
    """Distinct (layer, row, col) pixels of an (L, H, W) stack that the
    (K, S, S) sample masks of windows at ``rows`` x ``cols`` (K, S) reach:
    what a kernel must read once, however often windows overlap."""
    import torch

    _n_l, h, w = stack_shape
    hit = torch.zeros(tuple(stack_shape), dtype=torch.bool, device=mask.device)
    idx = torch.broadcast_tensors(
        layer.long()[:, None, None], rows.long()[:, :, None],
        cols.long()[:, None, :])
    hit[tuple(i[mask] for i in idx)] = True
    return int(hit.sum())


def chain_gray(folder: str, dev):
    """The chain's images as the stitch feeds SIFT: decoded, projected
    onto the cylinder on ``dev``, gray."""
    import torch

    from vfx_image_stitching_tpu_torch.geometry.cylindrical import (
        cylindrical_project_batch,
    )
    from vfx_image_stitching_tpu_torch.io import load_dataset, stack_dataset
    from vfx_image_stitching_tpu_torch.ops.color import bgr_to_gray_f32

    images, focals, _paths = load_dataset(folder)
    batch, _valid = stack_dataset(images)
    return bgr_to_gray_f32(cylindrical_project_batch(
        torch.as_tensor(batch).to(dev), [float(f) for f in focals]))


def recorded_extraction(gray, cfg, mode: str = "map"):
    """``sift_batch_with_stats(gray, cfg, mode)``, recording the arguments
    of the first octave-0 call of each kernel wrapper (of each window
    size for the window gather) and of the descriptor stage of every
    octave of image 0.  Returns the outputs and the recorded calls."""
    import importlib

    from vfx_image_stitching_tpu_torch.models.sift.extract import (
        sift_batch_with_stats,
    )

    octave0 = (2 * gray.shape[-2], 2 * gray.shape[-1])
    calls = {}
    saved = [(importlib.import_module(m), n) for m, n in KERNEL_SITES]
    saved = [(mod, n, getattr(mod, n)) for mod, n in saved]

    def recorder(name, fn):
        def call(*args, **kwargs):
            key = (name, args[5]) if name == "pair_window_gather" else name
            if key not in calls and tuple(args[0].shape[-2:]) == octave0:
                calls[key] = (args, kwargs)
            # the descriptor stage of every octave of image 0 (the first
            # image's octaves come before any other image's)
            if name == "compute_descriptors_bucketed":
                calls.setdefault(("descriptor_octave", args[3]), (args, kwargs))
            return fn(*args, **kwargs)
        return call

    try:
        for mod, n, fn in saved:
            setattr(mod, n, recorder(n, fn))
        out = sift_batch_with_stats(gray, cfg, mode)
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
    return out, calls


def path_inputs(folder: str, dev) -> dict:
    """Extract every image of the chain as the stitch does (decode,
    cylindrical projection, gray, SIFT), recording the arguments of the
    first octave-0 call of each kernel wrapper, and of the descriptor
    stage (of every octave, too), on image 0: the kernels are then checked
    and timed on exactly the tensors the path gives them (live-chunk rows,
    invalid ones included).  Also returns the chain's per-octave stage
    counts."""
    import torch

    from vfx_image_stitching_tpu_torch.config import StitchConfig

    gray = chain_gray(folder, dev)
    cfg = StitchConfig().sift
    (_xy, _d, _v, _meta, stats), calls = recorded_extraction(gray, cfg)
    torch.cuda.synchronize()

    counts = {}
    for stage in ("cand", "loc", "oriented", "desc_big"):
        c = stats[f"{stage}_counts"].cpu().numpy()
        counts[stage] = dict(
            max=c.max(0).tolist(), median=np.median(c, 0).tolist(),
            caps=stats[f"{stage}_caps"][0].cpu().tolist(),
            audited=list(AUDITED[stage]))
    fin = stats["final_count"].cpu().numpy()
    counts["final"] = dict(max=int(fin.max()), median=float(np.median(fin)),
                           cap=cfg.capacities.max_keypoints,
                           audited=AUDITED["final"])
    emit(dict(phase="chain_counts", images=int(gray.shape[0]), **counts))
    return dict(cfg=cfg, calls=calls, counts=counts)


def newton_iterations(dog, layer, y, x, cv, cfg, img=None):
    """Newton steps this run's candidates take (each reads one 3x3x3
    cube), and the distinct DoG values those cubes cover (``img``: each
    row's image of an (N, L, H, W) batch of stacks)."""
    import torch

    from vfx_image_stitching_tpu_torch.models.sift.localize import (
        _init_state, newton_step,
    )

    st = _init_state(layer, y, x)
    st["rejected"] = ~cv
    total = 0
    n_l = dog.shape[-3]
    hit = torch.zeros(dog.reshape(-1, *dog.shape[-2:]).shape, dtype=torch.bool,
                      device=dog.device)
    base = img * n_l if img is not None else torch.zeros_like(layer)
    for _ in range(cfg.max_localize_iters):
        active = ~(st["converged"] | st["rejected"])
        total += int(active.sum())
        mark_cubes(hit, base[active] + st["l"][active], st["y"][active],
                   st["x"][active])
        st = newton_step(dog, st, cfg, img)
    return total, int(hit.sum())


def mark_cubes(hit, layer, y, x) -> None:
    """Set the 3x3x3 cubes around (layer, y, x) in the boolean stack
    ``hit``."""
    import torch

    d = torch.arange(-1, 2, device=hit.device)
    lc, yc, xc = (t.long() for t in (layer, y, x))
    hit[lc[:, None, None, None] + d[:, None, None],
        yc[:, None, None, None] + d[:, None],
        xc[:, None, None, None] + d] = True


def orientation_bound(k2_args):
    """K2's (and K4's) bound on these arguments: the distinct masked
    pixels of both stacks read once, 4 int32 + 1 f32 + the validity byte
    per row, the histograms written; ``ORIENT_OPS_PER_SAMPLE`` a masked
    sample.  Returns ``(bound_ms, bound_by, masked samples, distinct
    pixels)``."""
    import torch

    mag, ang, lyr, cy, cx, radius, wf, valid, half, nb = k2_args
    h, w = mag.shape[-2:]
    s = 2 * half + 1
    rows_w = torch.arange(s, device=mag.device)
    sy = (cy - half).clamp(0, max(h, s) - s)
    sx = (cx - half).clamp(0, max(w, s) - s)
    rr = sy[:, None] + rows_w
    cc = sx[:, None] + rows_w
    in_y = ((rr - cy[:, None]).abs() <= radius[:, None]) & (rr >= 1) & (rr <= h - 2)
    in_x = ((cc - cx[:, None]).abs() <= radius[:, None]) & (cc >= 1) & (cc <= w - 2)
    mask = in_y[:, :, None] & in_x[:, None, :] & valid[:, None, None]
    samples = int(mask.sum())
    distinct = distinct_pixels(mag.shape, lyr, rr, cc, mask)
    n_k = lyr.shape[0]
    b, by = bound_ms(distinct * 8 + n_k * (5 * 4 + 1) + n_k * nb * 4,
                     samples * ORIENT_OPS_PER_SAMPLE)
    return b, by, samples, distinct


def window_bytes(args, want) -> int:
    """K3's bytes on these arguments: the distinct pixels its windows
    cover in both stacks read once, both windows written once, 3 int32
    a row read (``want``: the plain version's outputs)."""
    import torch

    mag, _ang, wl = args[:3]
    s = want[0].shape[-1]
    r_idx = (want[2][:, None] + torch.arange(s, device=mag.device)).long()
    c_idx = (want[3][:, None] + torch.arange(s, device=mag.device)).long()
    inside = ((r_idx < mag.shape[-2])[:, :, None]
              & (c_idx < mag.shape[-1])[:, None, :])
    distinct = distinct_pixels(mag.shape, wl, r_idx, c_idx, inside)
    return distinct * 8 + 2 * int(wl.shape[0]) * s * s * 4 + int(wl.shape[0]) * 3 * 4


def check_kernels(inp: dict):
    """Each kernel against its plain version on the card, with times, on
    the inputs the path gave it at octave 0 of image 0 (K4 on K2's, also
    against K2, both also at 128 bins; K3's direct stage on its big
    bucket's rows at S = 119 and 161; K5 on the histogram route's inputs
    for the descriptor stage's keypoints).
    Returns the kernel rows and the launches of the histogram route's run."""
    import torch

    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    cfg, calls = inp["cfg"], inp["calls"]
    rows = []

    # K1: integer and float lanes bit-exact, one device kernel per call
    k1_args = calls["localize_newton_resident"][0]
    dog, layer, y, x, cv = k1_args[:5]
    got = K.localize_newton_resident(*k1_args)
    want = K.localize_newton_plain(*k1_args)
    torch.cuda.synchronize()
    for lanes, g, r in zip(("integer", "float"), got, want):
        if not torch.equal(g, r):
            raise AssertionError(
                f"K1 {lanes} lanes differ on {int((g != r).any(1).sum())} rows")
    n_k = layer.shape[0]
    iters, cube_values = newton_iterations(dog, layer, y, x, cv, cfg)
    # reads: layer, y, x (i32) and the validity bytes, the cubes' distinct
    # values; writes: 8 int32 and 13 f32 lanes per row
    b, by = bound_ms(n_k * (3 * 4 + 1) + cube_values * 4 + n_k * (8 + 13) * 4,
                     iters * 122)
    ms = one_kernel_ms(lambda: K.localize_newton_resident(*k1_args),
                       "localize_newton_resident")
    rows.append(dict(
        name="localize_newton_resident", route="cuda",
        source="vfx_image_stitching_tpu_torch/csrc/sift_kernels.cu",
        replaces="vfx_image_stitching_tpu/models/sift/pallas_kernels.py:863",
        launches=0, max_abs_err=0.0, ms=ms,
        plain_ms=cuda_ms(lambda: K.localize_newton_plain(*k1_args), reps=5),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=dict(dog=list(dog.shape), live_rows=n_k,
                   valid=int(cv.sum()), newton_steps=iters,
                   distinct_dog_values=cube_values),
    ))
    emit(dict(phase="kernel", **rows[-1]))

    # K2 and K4 (the same function, staged and unstaged) on K2's inputs
    k2_args = calls["orientation_histograms"][0]
    mag, ang, lyr, cy, cx, radius, wf, valid, half, nb = k2_args
    s = 2 * half + 1
    n_k = lyr.shape[0]
    b, by, samples, distinct = orientation_bound(k2_args)
    want = K.orientation_histograms_plain(*k2_args)
    want128 = K.orientation_histograms_plain(*k2_args[:-1], 128)
    plain_ms = cuda_ms(lambda: K.orientation_histograms_plain(*k2_args), reps=5)
    orient = {}
    for name, fn, tag in (("orientation_histograms", K.orientation_histograms, "K2"),
                          ("orientation_histograms_v1", K.orientation_histograms_v1,
                           "K4")):
        got = fn(*k2_args)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-3)
        if not torch.equal(got, fn(*k2_args)):
            raise AssertionError(f"{tag}: repeated launches differ")
        got128 = fn(*k2_args[:-1], 128)
        torch.testing.assert_close(got128, want128, rtol=2e-5, atol=2e-3)
        orient[tag] = got
        rows.append(dict(
            name=name, route="cuda",
            source="vfx_image_stitching_tpu_torch/csrc/sift_kernels.cu",
            replaces=("vfx_image_stitching_tpu/models/sift/pallas_kernels.py:"
                      + ("227" if tag == "K2" else "313")),
            launches=0, max_abs_err=float((got - want).abs().max()),
            load=(K.orientation_load(mag, ang, half, nb) if tag == "K2"
                  else "direct"),
            ms=one_kernel_ms(lambda: fn(*k2_args), name),
            plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
            shape=dict(stack=list(mag.shape), rows=n_k, valid=int(valid.sum()),
                       window=s, num_bins=nb, masked_samples=samples,
                       distinct_pixels=distinct,
                       max_abs_err_128_bins=float((got128 - want128).abs().max()),
                       ms_128_bins=one_kernel_ms(lambda: fn(*k2_args[:-1], 128), name)),
        ))
    torch.testing.assert_close(orient["K2"], orient["K4"], rtol=2e-5, atol=2e-3)
    rows[-2]["shape"]["vs_k4_max_abs_err"] = float(
        (orient["K2"] - orient["K4"]).abs().max())
    sweep = orientation_sweep(mag, ang, half, nb)
    for row, tag in zip(rows[-2:], ("K2", "K4")):
        row["shape"]["radius_sweep"] = sweep[tag]
    emit(dict(phase="kernel", **rows[-2]))
    emit(dict(phase="kernel", **rows[-1]))

    # K3: bit-exact, both window sizes, summed
    k3 = {}
    for (_name, half_cap), (args, _kw) in sorted(
            (k, v) for k, v in calls.items() if k[0] == "pair_window_gather"):
        mag, ang, wl = args[:3]
        got = K.pair_window_gather(*args)
        want = K.pair_window_gather_plain(*args)
        for g, r in zip(got, want):
            if not torch.equal(g, r):
                raise AssertionError(f"K3 half {half_cap}: window gather differs")
        s = 2 * half_cap + 1
        ma = torch.stack([mag, ang], dim=-1)
        r_idx = (want[2][:, None] + torch.arange(s, device=mag.device)).long()
        c_idx = (want[3][:, None] + torch.arange(s, device=mag.device)).long()
        l_idx = wl.long()[:, None, None]
        ms = one_kernel_ms(lambda: K.pair_window_gather(*args), "pair_window_gather")
        # the cp.async load stage on the same inputs, moved 4 bytes off
        # 16-byte alignment
        shifted = [torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape)
                   for t in (mag, ang)]
        for src, dst in zip((mag, ang), shifted):
            dst.copy_(src)
        s_args = (*shifted, *args[2:])
        if K.pair_window_load(*shifted, s) != "cp.async" or not all(
                torch.equal(g, r) for g, r in zip(K.pair_window_gather(*s_args), want)):
            raise AssertionError(f"K3 half {half_cap}: cp.async stage differs")
        n_bytes = window_bytes(args, want)
        k3[f"{s}x{s}"] = dict(
            rows=int(wl.shape[0]),
            load=K.pair_window_load(mag.contiguous(), ang.contiguous(), s), ms=ms,
            cp_async_ms=cuda_ms(lambda: K.pair_window_gather(*s_args)),
            plain_ms=cuda_ms(lambda: K.pair_window_gather_plain(*args), reps=5),
            library_ms=cuda_ms(lambda: ma[l_idx, r_idx[:, :, None],
                                          c_idx[:, None, :]]),
            bytes=n_bytes,
        )
    if len(k3) != 2:
        raise AssertionError(f"K3 ran for {sorted(k3)} windows, not both buckets")
    b, by = bound_ms(sum(v["bytes"] for v in k3.values()), 0.0)
    # the direct stage (S past the staged limit of 117) on the big
    # bucket's rows: bit-exact, one device kernel per call
    big_half = max(k[1] for k in calls if k[0] == "pair_window_gather")
    big_args = calls[("pair_window_gather", big_half)][0]
    direct = {}
    for half_cap in (59, 80):
        d_args = (*big_args[:5], half_cap)
        s = 2 * half_cap + 1
        if K.pair_window_load(*big_args[:2], s) != "direct" or not all(
                torch.equal(g, r) for g, r in zip(K.pair_window_gather(*d_args),
                                                  K.pair_window_gather_plain(*d_args))):
            raise AssertionError(f"K3 S {s}: direct stage differs")
        direct[f"{s}x{s}"] = dict(
            load="direct", rows=int(big_args[2].shape[0]),
            ms=one_kernel_ms(lambda: K.pair_window_gather(*d_args),
                             "pair_window_gather"),
            written_bytes=2 * int(big_args[2].shape[0]) * s * s * 4)
    rows.append(dict(
        name="pair_window_gather", route="cuda",
        source="vfx_image_stitching_tpu_torch/csrc/sift_kernels.cu",
        replaces="vfx_image_stitching_tpu/models/sift/pallas_kernels.py:635",
        launches=0, max_abs_err=0.0,
        load={n: v["load"] for n, v in (*k3.items(), *direct.items())},
        ms=sum(v["ms"] for v in k3.values()),
        plain_ms=sum(v["plain_ms"] for v in k3.values()),
        bound_ms=b, bound_by=by,
        library_ms=sum(v["library_ms"] for v in k3.values()),
        shape=dict(buckets=k3, stack=list(mag.shape), direct_big_rows=direct),
    ))
    emit(dict(phase="kernel", **rows[-1]))

    row, k5_launches = check_descriptor_histograms(calls)
    rows.append(row)
    emit(dict(phase="kernel", **row))
    return rows, k5_launches


def orientation_sweep(mag, ang, half: int, nb: int, seed: int = 7) -> dict:
    """K2's and K4's device ms on the path's fields with every keypoint
    valid and at one radius, 0 or 17 (the audited maximum), for 132
    keypoints (about one warp a scheduler: a keypoint's latency) and
    1536 (the path's rows), and what a lane's sample costs: the time
    between the two radii over the 35^2 / 32 samples a lane walks at
    radius 17."""
    import torch

    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    rng = np.random.default_rng(seed)
    h, w = mag.shape[-2:]
    out = {"K2": {}, "K4": {}}
    for k in (132, 1536):
        idx = [torch.as_tensor(rng.integers(lo, hi, k).astype(np.int32),
                               device=mag.device)
               for lo, hi in ((0, mag.shape[0]), (half, h - half), (half, w - half))]
        wf = torch.full((k,), -0.5 / 6.0 ** 2, device=mag.device)
        valid = torch.ones(k, dtype=torch.bool, device=mag.device)
        for r in (0, 17):
            rad = torch.full((k,), r, dtype=torch.int32, device=mag.device)
            args = (mag, ang, *idx, rad, wf, valid, half, nb)
            want = K.orientation_histograms_plain(*args)
            for tag, fn in (("K2", K.orientation_histograms),
                            ("K4", K.orientation_histograms_v1)):
                torch.testing.assert_close(fn(*args), want, rtol=2e-5, atol=2e-3)
                out[tag][f"k{k}_r{r}_ms"] = cuda_ms(lambda: fn(*args))
    for v in out.values():
        v["us_per_lane_sample_k132"] = (
            (v["k132_r17_ms"] - v["k132_r0_ms"]) * 1e3 / (35 * 35 / 32))
    return out


def histogram_route(args, kw) -> dict:
    """The descriptor-histogram route (K5) on one octave's descriptor-stage
    inputs: its run with the launch counts at 0, the raw histograms
    against the plain version (rtol 1e-5, atol 1e-3), repeated launches
    bit-identical, and the final descriptors within 1 LSB of the bucketed
    GEMM route's on under 2% of valid entries.  Returns the checks, the
    run's launches and K5's arguments."""
    import torch

    from vfx_image_stitching_tpu_torch.models.sift import descriptor as D
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    mag, ang, kps, octave, dcfg = args
    K.reset_launch_counts()
    desc = D.compute_descriptors_histogram(mag, ang, kps, octave, dcfg,
                                           layer_base=kw["layer_base"])
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    k5_args = D.histogram_inputs(mag, ang, kps, dcfg, kw["layer_base"])
    out = dict(octave=int(octave), rows=int(k5_args[2].shape[0]),
               valid=int(kps.valid.sum()), launches=launches["descriptor_histograms"])
    if out["rows"]:
        check_launches("descriptor_histogram", launches)
        got = K.descriptor_histograms(*k5_args)
        want = K.descriptor_histograms_plain(*k5_args)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
        if not torch.equal(got, K.descriptor_histograms(*k5_args)):
            raise AssertionError(f"K5 octave {octave}: repeated launches differ")
        out.update(max_abs_err=float((got - want).abs().max()),
                   ms=one_kernel_ms(lambda: K.descriptor_histograms(*k5_args),
                                     "descriptor_histograms"))
    elif any(launches.values()):
        raise AssertionError(f"octave {octave} has no rows but launched {launches}")
    gemm = D.compute_descriptors_bucketed(*args, **kw)[0]
    v = kps.valid
    diff = (desc[v] - gemm[v]).abs()
    out["vs_gemm_max_lsb"] = float(diff.max()) if diff.numel() else 0.0
    out["vs_gemm_lsb_share"] = float((diff > 0).float().mean()) if diff.numel() else 0.0
    if out["vs_gemm_max_lsb"] > 1.0 or out["vs_gemm_lsb_share"] >= 0.02:
        raise AssertionError(f"K5 route vs GEMM, octave {octave}: {out}")
    return dict(check=out, launches=launches, k5_args=k5_args)


def check_descriptor_histograms(calls: dict):
    """K5 on the descriptor stage's octave-0 keypoints of image 0: the
    histogram route (``histogram_route``) once with the launch counts at 0
    (its path run); K5's time on all rows, on the small-bucket and the
    big-bucket rows apart (is the tail the largest boxes?).  Returns the
    kernel row and the launches of the path run."""
    import torch

    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    args, kw = calls["compute_descriptors_bucketed"]
    route = histogram_route(args, kw)
    launches, k5_args, chk = route["launches"], route["k5_args"], route["check"]

    (mag_s, ang_s, lyr, py, px, half_w, cos_a, sin_a, hist_w, angle, valid,
     half_cap, nb, ww) = k5_args
    h, w = mag_s.shape[-2:]
    windows = K.pair_window_gather_plain(mag_s, ang_s, lyr, py, px, half_cap)
    _hist, mask = K.trilinear_histograms(
        *windows, py, px, half_w, cos_a, sin_a, hist_w, angle, valid, h, w,
        nb, ww, fused_offset=True)
    samples = int(mask.sum())
    rng = torch.arange(2 * half_cap + 1, device=mag_s.device)
    distinct = distinct_pixels(mag_s.shape, lyr, windows[2][:, None] + rng,
                               windows[3][:, None] + rng, mask)
    n_k = lyr.shape[0]
    b, by = bound_ms(distinct * 8 + n_k * 9 * 4 + n_k * ww * ww * nb * 4,
                     samples * K5_OPS_PER_SAMPLE)
    small = half_w <= calls["compute_descriptors_bucketed"][0][4].capacities.desc_small_half
    buckets = {}
    for name, sel in (("small", small), ("big", ~small)):
        idx = sel.nonzero()[:, 0]
        sub = [a[idx] if torch.is_tensor(a) and a.ndim == 1 else a for a in k5_args]
        buckets[name] = dict(rows=int(idx.numel()), ms=one_kernel_ms(
            lambda: K.descriptor_histograms(*sub), "descriptor_histograms")
            if idx.numel() else 0.0)
    return dict(
        name="descriptor_histograms", route="cuda",
        source="vfx_image_stitching_tpu_torch/csrc/sift_kernels.cu",
        replaces="vfx_image_stitching_tpu/models/sift/pallas_kernels.py:527",
        launches=0, max_abs_err=chk["max_abs_err"],
        ms=chk["ms"],
        plain_ms=cuda_ms(lambda: K.descriptor_histograms_plain(*k5_args), reps=5),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=dict(stack=list(mag_s.shape), rows=n_k, valid=int(valid.sum()),
                   half_cap=half_cap, masked_samples=samples,
                   distinct_pixels=distinct, buckets=buckets,
                   vs_gemm_max_lsb=chk["vs_gemm_max_lsb"],
                   vs_gemm_lsb_share=chk["vs_gemm_lsb_share"]),
    ), launches


def descriptor_octaves(calls: dict) -> dict:
    """The histogram route on every octave of image 0 (``histogram_route``
    at each), with K5's launches and device ms per octave."""
    octaves = sorted(k[1] for k in calls if isinstance(k, tuple) and k[0] == "descriptor_octave")
    per = [histogram_route(*calls[("descriptor_octave", o)])["check"]
           for o in octaves]
    return dict(phase="descriptor_octaves", per_octave=per)


def kernel_arith(calls: dict) -> dict:
    """The descriptor kernels' arithmetic against the library's on the
    card: remainder, orientation bins, floors and conversions on every
    float, and the division by 64 quantiles of the path's octave-0 bin
    widths, bit for bit (``kernels.descriptor_arith_mismatches``)."""
    import torch

    from vfx_image_stitching_tpu_torch.models.sift import descriptor as D
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    args, kw = calls["compute_descriptors_bucketed"]
    mag, ang, kps, _octave, dcfg = args
    k5_args = D.histogram_inputs(mag, ang, kps, dcfg, kw["layer_base"])
    widths = k5_args[8][k5_args[10]]
    widths = torch.quantile(widths, torch.linspace(0, 1, 64, device=widths.device))
    bad = K.descriptor_arith_mismatches(dcfg.desc_bins, widths)
    out = dict(phase="kernel_arith", num_bins=dcfg.desc_bins,
               bin_widths=[float(widths.min()), float(widths.max())],
               mismatches=dict(remainder_bins_floor=bad[0], division=bad[1]))
    if bad != (0, 0):
        raise AssertionError(f"descriptor kernels' arithmetic differs: {out}")
    return out


def descriptor_ab(calls: dict, reps: int = 10) -> dict:
    """The descriptor stage's two routes on the same octave-0 keypoints:
    the histogram route (K5) and the bucketed window gather + GEMM route
    the stitch runs.  Device ms and device kernels per call (profiler),
    host wall ms per call (median, the two routes in turns), launches of
    the repository's kernels per call."""
    import time

    import torch

    from vfx_image_stitching_tpu_torch.models.sift import descriptor as D
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    args, kw = calls["compute_descriptors_bucketed"]
    mag, ang, kps, octave, dcfg = args
    routes = {
        "histogram": lambda: D.compute_descriptors_histogram(
            mag, ang, kps, octave, dcfg, layer_base=kw["layer_base"]),
        "bucketed_gemm": lambda: D.compute_descriptors_bucketed(*args, **kw),
    }
    out = {}
    for name, fn in routes.items():
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        ms, kernels = device_profile(fn, reps=5)
        out[name] = dict(device_ms=ms, device_kernels=kernels,
                         launches=launches, wall_ms=[])
    for i in range(reps):
        for name in (("histogram", "bucketed_gemm") if i % 2 == 0
                     else ("bucketed_gemm", "histogram")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            routes[name]()
            torch.cuda.synchronize()
            out[name]["wall_ms"].append((time.perf_counter() - t0) * 1e3)
    for r in out.values():
        r["wall_ms_median"] = float(np.median(r["wall_ms"]))
    return dict(phase="descriptor_ab", keypoints=int(kps.valid.sum()),
                rows=int(kps.capacity), **out)


def probe_localize(dev):
    """The localize probe's path (``probes/localize_resident_r4.py``): its
    run with the launch counts at 0 (``feas1``, ``feas2``, and P4 +
    finalize on every octave of the chain's image 0), then each phase's
    checks and device times, and the rows of P2, P3 and P4 (P4 on octave
    0's candidate slots, beside K1 on the same slots), each timed as one
    device kernel per call beside ``floor_ms``, the device time of a
    launch that does no work, and ``latency_ms``, of a one-element copy
    out of the same stack.  Returns the rows and the path run's
    launches."""
    import torch

    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.probes import kernels as PK
    from vfx_image_stitching_tpu_torch.probes import localize_resident_r4 as R

    cfg, octaves = inputs = R.octave_inputs(dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    R.feas1(dev)
    R.feas2(dev)
    for o, dog, cand in octaves:
        R.localize_resident_r4(dog, *cand, o, cfg)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check_launches("probe_localize", launches)

    phases = [R.feas1(dev, timer=cuda_ms), R.feas2(dev, timer=cuda_ms),
              R.newton(dev, timer=cuda_ms, inputs=inputs)]
    for ph in phases:
        emit(ph)
        if not ph["ok"]:
            raise AssertionError(f"probe {ph['phase']} failed")
    f1, f2, nw = phases
    src = "vfx_image_stitching_tpu_torch/csrc/probe_kernels.cu"
    script = "scripts/probe_localize_resident_r4.py"
    one = torch.zeros(1, device=dev)
    floor = cuda_ms(lambda: one.fill_(0.0))

    def latency(stack):
        """Device ms of one copy of a single element of ``stack`` into a
        one-element tensor: a launch that reads its input once from L2
        and writes once."""
        return cuda_ms(lambda: one.copy_(stack[0, 0, :1]))

    rows = []

    dog1 = R.feas1_input(dev)
    n_l = dog1.shape[0]
    b, by = bound_ms(n_l * 8 * 128 * 4 + 8 * 128 * 4, n_l * 8 * 128)
    rows.append(dict(
        name="feas1_stack_sum", route="cuda", source=src,
        replaces=f"{script}:77", launches=0, max_abs_err=0.0,
        ms=one_kernel_ms(lambda: PK.feas1_stack_sum(dog1), "feas1_stack_sum"),
        plain_ms=cuda_ms(lambda: PK.feas1_stack_sum_plain(dog1), reps=5),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(lambda: dog1[:, :8, :128].sum(0)), floor_ms=floor,
        latency_ms=latency(dog1),
        shape=dict(stack=list(dog1.shape), stack_mb=f1["stack_mb"],
                   l2_mb=f1.get("l2_mb"))))

    args2 = R.feas2_inputs(dev)
    k2 = args2[1].shape[0]
    hit = torch.zeros(args2[0].shape, dtype=torch.bool, device=dev)
    mark_cubes(hit, *args2[1:])
    distinct = int(hit.sum())
    b, by = bound_ms(distinct * 4 + k2 * 3 * 4 + k2 * 4, k2 * 27)
    ms = one_kernel_ms(lambda: PK.feas2_cube_sums(*args2), "feas2_cube_sums")
    rows.append(dict(
        name="feas2_cube_sums", route="cuda", source=src,
        replaces=f"{script}:170", launches=0, max_abs_err=f2["max_err"],
        ms=ms, plain_ms=cuda_ms(lambda: PK.feas2_cube_sums_plain(*args2), reps=5),
        bound_ms=b, bound_by=by, library_ms=None, floor_ms=floor,
        latency_ms=latency(args2[0]),
        shape=dict(stack=list(args2[0].shape), candidates=k2,
                   distinct_values=distinct, us_per_candidate=ms / k2 * 1e3)))

    o, dog, cand = octaves[0]
    walk = (cfg.image_border_width, cfg.num_intervals, cfg.max_localize_iters)
    n_k = cand[0].shape[0]
    iters, cube_values = newton_iterations(dog, *cand, cfg)
    # layer, y, x (i32) and the validity bytes, the cubes read, 8 + 13
    # lanes written
    b, by = bound_ms(n_k * (3 * 4 + 1) + cube_values * 4 + n_k * (8 + 13) * 4,
                     iters * 122)
    rows.append(dict(
        name="localize_resident_r4", route="cuda", source=src,
        replaces=f"{script}:424", launches=0,
        max_abs_err=nw["per_octave"][0]["float_lanes_max_abs_err"],
        ms=one_kernel_ms(lambda: PK.localize_resident_r4_lanes(dog, *cand, *walk),
                         "localize_resident_r4"),
        plain_ms=cuda_ms(lambda: PK.localize_resident_r4_lanes_plain(dog, *cand, *walk),
                         reps=5),
        bound_ms=b, bound_by=by, library_ms=None, floor_ms=floor,
        latency_ms=latency(dog),
        shape=dict(dog=list(dog.shape), candidates=n_k,
                   valid=int(cand[3].sum()), newton_steps=iters,
                   distinct_dog_values=cube_values,
                   # K1's entry on these slots: the same kernel body
                   k1_ms=one_kernel_ms(
                       lambda: K.localize_newton_resident(dog, *cand, *walk),
                       "localize_newton_resident"),
                   ms_octave0=nw["ms_octave0"])))
    for row in rows:
        emit(dict(phase="kernel", **row))
    return rows, launches


def chain_small_rows(calls: dict):
    """P1's and K5's arguments for the descriptor stage's octave-0
    keypoints of image 0 whose half-width is in the small bucket."""
    from vfx_image_stitching_tpu_torch.models.sift import descriptor as D
    from vfx_image_stitching_tpu_torch.probes import kernels as PK

    args, kw = calls["compute_descriptors_bucketed"]
    mag, ang, kps, _octave, dcfg = args
    if dcfg.capacities.desc_small_half != PK.P1_HALF:
        raise AssertionError("the small bucket's half is not P1's")
    (mag_s, ang_s, lyr, py, px, half_w, cos_a, sin_a, hist_w, angle, valid,
     _cap, nb, ww) = D.histogram_inputs(mag, ang, kps, dcfg, kw["layer_base"])
    keep = (valid & (half_w <= PK.P1_HALF)).nonzero()[:, 0]
    rows = [t[keep] for t in (lyr, py, px, half_w, cos_a, sin_a, hist_w,
                              angle, valid)]
    h, w = mag_s.shape[-2:]
    return (mag_s, ang_s, *rows, h, w), (mag_s, ang_s, *rows, PK.P1_HALF, nb, ww)


def p1_bound(p1_args, tensor_passes: int):
    """P1's bound on these arguments: distinct window bytes plus per-row
    I/O, the tensor-core products, and the per-sample f32 operations."""
    from vfx_image_stitching_tpu_torch.models.sift.kernels import _window_coords
    from vfx_image_stitching_tpu_torch.probes import kernels as PK

    mag, _ang, layer, py, px = p1_args[:5]
    _lhs, _rhs, mask = PK.scratch_dot_operands(*p1_args)
    rows, cols = _window_coords(py, px, PK.P1_HALF, *mag.shape[-2:])
    distinct = distinct_pixels(mag.shape, layer, rows, cols, mask)
    n_k = layer.shape[0]
    samples = int(mask.sum())
    valid = int(p1_args[10].sum())
    b, by = bound_ms(distinct * 8 + n_k * 9 * 4 + n_k * 128 * 4,
                     samples * P1_OPS_PER_SAMPLE,
                     samples * P1_MMA_FLOPS_PER_SAMPLE * tensor_passes)
    return b, by, dict(rows=n_k, valid=valid, masked_samples=samples,
                       distinct_pixels=distinct)


def probe_desc(calls: dict, dev):
    """The descriptor probe's path (``probes/desc_scratch_dot.py``): its
    run with the launch counts at 0 (P1 in both precisions on the probe's
    chip inputs and on the chain's small-bucket rows, and K5 on those
    rows), then the probe's checks and times on both inputs, P1 against
    K5 on the chain's rows, and P1's row (the probe's inputs, default
    precision).  Returns the row and the path run's launches."""
    import torch

    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.probes import desc_scratch_dot as DS
    from vfx_image_stitching_tpu_torch.probes import kernels as PK

    k, n_l, hs, ws = DS.CHIP_SHAPE
    synth = DS.to_torch(DS.make_inputs(np.random.default_rng(DS.SEED), k, n_l, hs, ws),
                        dev)
    chain_p1, chain_k5 = chain_small_rows(calls)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for highest in (False, True):
        PK.desc_scratch_dot(*synth, hs, ws, highest=highest)
        PK.desc_scratch_dot(*chain_p1, highest=highest)
    K.descriptor_histograms(*chain_k5)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check_launches("probe_desc", launches)

    def p1_timer(fn):
        return one_kernel_ms(fn, "desc_scratch_dot")

    probe = DS.check_kernel(synth, hs, ws, timer=p1_timer)
    chain = DS.check_kernel(chain_p1[:-2], *chain_p1[-2:], timer=p1_timer)
    k5 = K.descriptor_histograms(*chain_k5)
    scale = float(k5.abs().max()) or 1.0
    n = k5.shape[0]
    for name, highest in (("default", False), ("highest", True)):
        p1 = PK.desc_scratch_dot(*chain_p1, highest=highest).reshape(n, -1)
        chain[f"{name}_vs_k5_max_rel"] = float((p1 - k5).abs().max()) / scale
    chain["k5_ms"] = one_kernel_ms(lambda: K.descriptor_histograms(*chain_k5),
                                     "descriptor_histograms")
    emit(dict(phase="probe_desc", probe_inputs=probe, chain_small_rows=chain))
    if chain["highest_vs_k5_max_rel"] > 1e-5 or chain["default_vs_k5_max_rel"] > 2e-3:
        raise AssertionError(f"P1 and K5 disagree: {chain}")

    b, by, shape = p1_bound((*synth, hs, ws), tensor_passes=1)
    hb, hby, _ = p1_bound((*synth, hs, ws), tensor_passes=3)
    row = dict(
        name="desc_scratch_dot", route="cuda",
        source="vfx_image_stitching_tpu_torch/csrc/probe_kernels.cu",
        replaces="scripts/probe_desc_scratch_dot.py:214", launches=0,
        max_abs_err=probe["default_max_abs_err"], ms=probe["default_ms"],
        plain_ms=cuda_ms(lambda: PK.desc_scratch_dot_plain(*synth, hs, ws), reps=5),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=dict(stack=[n_l, hs, ws], highest_ms=probe["highest_ms"],
                   highest_bound_ms=hb, highest_bound_by=hby, **shape))
    emit(dict(phase="kernel", **row))
    return row, launches


def run_stitch(folder: str, device: str, backend: str = "sift", **kw):
    from vfx_image_stitching_tpu_torch.pipeline.stitch import stitch_panorama

    kw.setdefault("crop_margin", 15)
    return stitch_panorama(folder, backend=backend, device=device, **kw)


def check_result(res, n: int) -> None:
    pano = res.panorama
    if pano.dtype != np.uint8 or pano.ndim != 3 or pano.shape[2] != 3 or (
            min(pano.shape[:2]) < 1):
        raise AssertionError(f"bad panorama {pano.dtype} {pano.shape}")
    if len(res.shifts) != n - 1 or any(p is None for p in res.pairs):
        raise AssertionError(f"unmatched pairs: {res.pairs}")
    if not all(np.isfinite(v) for s in res.shifts for v in s):
        raise AssertionError(f"non-finite shifts: {res.shifts}")
    if res.capacity_stats is not None:
        raise AssertionError("a SIFT stage still overflowed its capacity")


def profile_stitch(folder: str, median_s: float, backend: str = "sift") -> dict:
    """One stitch under ``torch.profiler``: the device's busy time, its
    idle share of the unprofiled median wall (the profiler slows the host
    side, so its own wall is reported beside it), and the kernels that
    take most of the busy time."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run_stitch(folder, "cuda", backend)
        wall_s = time.time() - t0
    events = device_events(prof)
    if not events:
        raise AssertionError("the profiler recorded no device kernel")
    busy_s = sum(us for _n, us in events) / 1e6
    by_name = {}
    for name, us in events:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return dict(
        phase="profile", backend=backend, device_busy_s=busy_s,
        unprofiled_median_s=median_s,
        device_idle_share=1 - busy_s / median_s,
        profiled_wall_s=wall_s,
        device_idle_share_of_profiled_wall=1 - busy_s / wall_s,
        device_kernels=len(events),
        top=[dict(name=name[:80], ms=t / 1e3, count=n) for name, (n, t) in top],
    )


def end_to_end(work: str, folder: str, timed_runs: int = 3) -> dict:
    import time

    from vfx_image_stitching_tpu_torch.compose import blend
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    K.reset_launch_counts()
    blend.reset_launch_counts()
    t0 = time.time()
    res = run_stitch(folder, "cuda")
    first_s = time.time() - t0
    launches = dict(K.LAUNCHES)
    fold_launches = dict(blend.LAUNCHES)
    check_result(res, N_IMAGES)
    check_launches("stitch", launches)
    check_fold_launches("stitch", res, fold_launches)

    runs = []
    for _ in range(timed_runs):
        t0 = time.time()
        r = run_stitch(folder, "cuda")
        runs.append((time.time() - t0, r))
        check_result(r, N_IMAGES)
        if r.shifts != res.shifts or not np.array_equal(r.panorama, res.panorama):
            raise AssertionError("repeated runs disagree")
    walls = sorted(w for w, _ in runs)
    median_run = sorted(runs, key=lambda t: t[0])[len(runs) // 2][1]
    out = dict(
        phase="end_to_end", images=N_IMAGES, shape=[IMG_H, IMG_W],
        first_run_s=first_s, median_s=float(np.median(walls)), runs_s=walls,
        phases_s={k: v for k, v in median_run.timings.items()
                  if isinstance(v, float)},
        escalated_pairs=int(res.timings["esc_n_pairs"]),
        escalated_rows=int(res.timings["esc_n_rows"]),
        passes=int(res.timings["passes"]),
        launches=launches, fold_launches=fold_launches,
        panorama=list(res.panorama.shape), shifts=res.shifts,
    )
    emit(out)

    out["profile"] = profile_stitch(folder, out["median_s"])
    emit(out["profile"])

    # the whole chain on the CPU against the card's first run: equal
    # shifts, pairs, escalation counts and panorama bytes
    t0 = time.time()
    cpu = run_stitch(folder, "cpu")
    cpu_s = time.time() - t0
    esc = ("esc_n_pairs", "esc_n_rows")
    same = (res.shifts == cpu.shifts and res.pairs == cpu.pairs
            and all(res.timings[k] == cpu.timings[k] for k in esc)
            and np.array_equal(res.panorama, cpu.panorama))
    emit(dict(phase="cuda_vs_cpu_chain", images=N_IMAGES, equal=same, cpu_s=cpu_s,
              escalated={d: {k: int(r.timings[k]) for k in esc}
                         for d, r in (("cuda", res), ("cpu", cpu))},
              cuda_shifts=res.shifts, cpu_shifts=cpu.shifts))
    if not same:
        raise AssertionError("CUDA and CPU runs of the whole chain differ")

    # first four images on the card and on the CPU: equal shifts, same bytes
    sub = os.path.join(work, "chain4")
    os.makedirs(sub)
    with open(os.path.join(folder, "pano.txt")) as f:
        lines = f.read().split("\n")[:8]
    for name in lines[0::2]:
        os.link(os.path.join(folder, name), os.path.join(sub, name))
    with open(os.path.join(sub, "pano.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    t0 = time.time()
    gpu = run_stitch(sub, "cuda")
    t1 = time.time()
    cpu = run_stitch(sub, "cpu")
    t2 = time.time()
    same = (gpu.shifts == cpu.shifts and gpu.pairs == cpu.pairs
            and np.array_equal(gpu.panorama, cpu.panorama))
    emit(dict(phase="cuda_vs_cpu", images=4, equal=same, cuda_s=t1 - t0,
              cpu_s=t2 - t1, cuda_shifts=gpu.shifts, cpu_shifts=cpu.shifts))
    if not same:
        raise AssertionError("CUDA and CPU runs of the first 4 images differ")
    out["orient_v1"] = orient_v1(sub, gpu)
    # the CLI and batch_vmap phases run on these four images against this
    # stitch; batch_vmap holds its stitches to the chain's first run
    out["chain4"] = (sub, gpu)
    out["reference"] = res
    return out


def host_syncs(fn) -> int:
    """The synchronizing CUDA operations of a call of ``fn`` (reads of a
    device value on the host, blocking copies), counted through
    ``torch.cuda.set_sync_debug_mode``'s warnings."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in seen)


def batch_kernels(calls: dict, cfg) -> dict:
    """K1-K4 on the batched inputs the batched schedule gave them at
    octave 0 (every image's live rows in one launch): K1 and K3 bit for
    bit against their plain versions, K2 and K4 within the orientation
    contract (rtol 2e-5, atol 2e-3) and bit for bit against launches of
    the same kernel on each image's rows alone; one device kernel a call;
    times beside the plain versions', K3's beside one advanced-indexing
    call giving both windows (``library_ms``), and the bounds.  Each row's
    ``timed_by`` says whether its times came from the profiler or, where
    the profiler had stopped recording device time, from CUDA events."""
    import torch

    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    profiler_ok = [True]

    def timed_ms(fn, how: set, counter: str = "", reps: int = 20) -> float:
        # one_kernel_ms (a kernel's counter given) or cuda_ms; where deep
        # into a run the profiler records the launches but no device time
        # even after its retries, cuda_events_ms for this and every later
        # timing of the call, a counter's launches checked to rise by one
        # a call; ``how`` gets "profiler" or "cuda_events"
        if profiler_ok[0]:
            try:
                ms = (one_kernel_ms(fn, counter, reps) if counter
                      else cuda_ms(fn, reps=reps))
                how.add("profiler")
                return ms
            except RuntimeError as err:
                if "no device time" not in str(err):
                    raise
                profiler_ok[0] = False
        n0 = K.LAUNCHES[counter] if counter else 0
        ms = cuda_events_ms(fn, reps=reps, warmup=3)
        if counter and K.LAUNCHES[counter] - n0 != reps + 3:
            raise AssertionError(f"{counter}: {K.LAUNCHES[counter] - n0} launches "
                                 f"in {reps + 3} calls")
        how.add("cuda_events")
        return ms

    out = {}
    args, kw = calls["localize_newton_resident"]
    dog, layer, y, x, cv = args[:5]
    img = kw["img"]
    got = K.localize_newton_resident(*args, **kw)
    want = K.localize_newton_plain(*args, **kw)
    if not all(torch.equal(g, r) for g, r in zip(got, want)):
        raise AssertionError("K1 differs from its plain version on the batch")
    iters, cube_values = newton_iterations(dog, layer, y, x, cv, cfg, img)
    n_k = layer.shape[0]
    b, by = bound_ms(n_k * (4 * 4 + 1) + cube_values * 4 + n_k * (8 + 13) * 4,
                     iters * 122)
    how = set()
    out["localize_newton_resident"] = dict(
        rows=n_k, images=int(dog.shape[0]), valid=int(cv.sum()),
        newton_steps=iters, max_abs_err=0.0,
        ms=timed_ms(lambda: K.localize_newton_resident(*args, **kw), how,
                    "localize_newton_resident"),
        plain_ms=timed_ms(lambda: K.localize_newton_plain(*args, **kw), how, reps=5),
        bound_ms=b, bound_by=by, timed_by=sorted(how))

    k2_args = calls["orientation_histograms"][0]
    mag, ang, lyr = k2_args[:3]
    n_img = int(dog.shape[0])
    n_l = 3
    per = k2_args[2].shape[0] // n_img
    b, by, samples, distinct = orientation_bound(k2_args)
    want = K.orientation_histograms_plain(*k2_args)
    plain_how = set()
    plain_ms = timed_ms(lambda: K.orientation_histograms_plain(*k2_args), plain_how,
                        reps=5)
    stacks = (mag.view(n_img, n_l, *mag.shape[-2:]),
              ang.view(n_img, n_l, *ang.shape[-2:]))
    for name, fn in (("orientation_histograms", K.orientation_histograms),
                     ("orientation_histograms_v1", K.orientation_histograms_v1)):
        got = fn(*k2_args)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-3)
        for i in range(n_img):
            rows = slice(i * per, (i + 1) * per)
            alone = fn(stacks[0][i], stacks[1][i], k2_args[2][rows] - i * n_l,
                       *(t[rows] for t in k2_args[3:8]), *k2_args[8:])
            if not torch.equal(got[rows], alone):
                raise AssertionError(f"{name}: the batch's rows differ from image {i}'s")
        how = set(plain_how)
        ms = timed_ms(lambda: fn(*k2_args), how, name)
        out[name] = dict(
            rows=int(lyr.shape[0]), images=n_img, valid=int(k2_args[7].sum()),
            masked_samples=samples, distinct_pixels=distinct,
            max_abs_err=float((got - want).abs().max()),
            ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, timed_by=sorted(how))

    k3, n_bytes, how = {}, 0, set()
    for (_n, half_cap), (args3, _kw) in sorted(
            (k, v) for k, v in calls.items() if k[0] == "pair_window_gather"):
        got = K.pair_window_gather(*args3)
        want = K.pair_window_gather_plain(*args3)
        if not all(torch.equal(g, r) for g, r in zip(got, want)):
            raise AssertionError(f"K3 half {half_cap}: differs on the batch")
        s = 2 * half_cap + 1
        n_bytes += window_bytes(args3, want)
        # one advanced-indexing call giving both windows, as in
        # check_kernels
        ma = torch.stack(args3[:2], dim=-1)
        r_idx = (want[2][:, None] + torch.arange(s, device=ma.device)).long()
        c_idx = (want[3][:, None] + torch.arange(s, device=ma.device)).long()
        l_idx = args3[2].long()[:, None, None]
        k3[f"{s}x{s}"] = dict(
            rows=int(args3[2].shape[0]),
            load=K.pair_window_load(args3[0].contiguous(), args3[1].contiguous(), s),
            ms=timed_ms(lambda: K.pair_window_gather(*args3), how,
                        "pair_window_gather"),
            plain_ms=timed_ms(lambda: K.pair_window_gather_plain(*args3), how, reps=5),
            library_ms=timed_ms(lambda: ma[l_idx, r_idx[:, :, None],
                                           c_idx[:, None, :]], how, reps=5))
        del ma
    if len(k3) != 2:
        raise AssertionError(f"K3 ran for {sorted(k3)} windows, not both buckets")
    b, by = bound_ms(n_bytes, 0.0)
    out["pair_window_gather"] = dict(
        rows=sum(v["rows"] for v in k3.values()), images=n_img, max_abs_err=0.0,
        ms=sum(v["ms"] for v in k3.values()),
        plain_ms=sum(v["plain_ms"] for v in k3.values()),
        library_ms=sum(v["library_ms"] for v in k3.values()),
        bound_ms=b, bound_by=by, buckets=k3, timed_by=sorted(how))
    return out


def batch_vmap(folder: str, e2e: dict, timed_runs: int = 3) -> dict:
    """The batched SIFT schedule (``mode="vmap"``, every stage once over
    all N images) on the card against the one-image schedule: every leaf
    of the chain's extraction equal, K1-K4 on the batched inputs
    (``batch_kernels``), the launches of a vmap extraction and of a vmap
    stitch counted from 0 (K1-K3 once an octave, K3 once a bucket, not
    once an image), the stitch in both schedules in turns (a warm-up, then
    ``timed_runs`` each: equal shifts, pairs, escalation counts, bytes),
    one profiled vmap stitch (device time, device kernels, idle share;
    the map stitch's from ``end_to_end``), host syncs and peak memory of
    each schedule's stitch, and the first four images' vmap stitch and
    extraction on the card against the CPU."""
    import time
    from unittest import mock

    import torch

    from vfx_image_stitching_tpu_torch.config import StitchConfig
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.models.sift.extract import (
        sift_batch_with_stats,
    )

    t_phase = time.time()
    cfg = StitchConfig().sift
    gray = chain_gray(folder, "cuda")
    out = dict(phase="batch_vmap", images=int(gray.shape[0]),
               shape=list(gray.shape[-2:]))

    # the extraction: launches from 0 per schedule, every leaf equal
    ext = {}
    for mode in ("map", "vmap"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        K.reset_launch_counts()
        t0 = time.time()
        res = sift_batch_with_stats(gray, cfg, mode)
        torch.cuda.synchronize()
        ext[mode] = dict(seconds=time.time() - t0,
                         launches={k: v for k, v in K.LAUNCHES.items() if v},
                         peak_mb=(torch.cuda.max_memory_allocated() - base) / 2**20,
                         out=res)
    leaves = {}
    for name, a, b in _leaf_pairs(ext["map"].pop("out"), ext["vmap"]["out"]):
        leaves[name] = bool(torch.equal(a, b))
    out["extraction"] = dict(ext, leaves_equal=all(leaves.values()))
    out["extraction"]["vmap"].pop("out")
    if not all(leaves.values()):
        raise AssertionError(
            f"vmap extraction differs from map: {[k for k, v in leaves.items() if not v]}")
    vl = ext["vmap"]["launches"]
    _res, calls = recorded_extraction(gray, cfg, "vmap")
    out["kernels"] = batch_kernels(calls, cfg)

    # the stitch in both schedules, in turns
    def stitch(mode):
        with mock.patch.dict(os.environ, VFX_SIFT_BATCH_MODE=mode):
            return run_stitch(folder, "cuda")

    K.reset_launch_counts()
    t0 = time.time()
    first = stitch("vmap")
    first_s = time.time() - t0
    launches = dict(K.LAUNCHES)
    check_result(first, N_IMAGES)
    check_launches("batch_vmap", launches)
    ref = e2e["reference"]
    walls = {"map": [], "vmap": []}
    timings = {"map": [], "vmap": []}
    for _ in range(timed_runs):
        for mode in ("map", "vmap"):
            t0 = time.time()
            r = stitch(mode)
            walls[mode].append(time.time() - t0)
            timings[mode].append(r.timings)
            same = (r.shifts == ref.shifts and r.pairs == ref.pairs
                    and all(r.timings[k] == ref.timings[k]
                            for k in ("esc_n_pairs", "esc_n_rows"))
                    and np.array_equal(r.panorama, ref.panorama))
            if not same:
                raise AssertionError(f"the {mode} stitch differs from the map stitch")
    median = {m: _median(w) for m, w in walls.items()}
    # the phases of each schedule's median run
    phases = {m: {k: v for k, v in timings[m][int(np.argsort(w)[len(w) // 2])].items()
                  if isinstance(v, float)}
              for m, w in walls.items()}
    peak, syncs = {}, {}
    for mode in ("map", "vmap"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        syncs[mode] = host_syncs(lambda: stitch(mode))
        peak[mode] = (torch.cuda.max_memory_allocated() - base) / 2**20
    with mock.patch.dict(os.environ, VFX_SIFT_BATCH_MODE="vmap"):
        prof = profile_stitch(folder, median["vmap"])
    mprof = e2e["profile"]
    out["stitch"] = dict(
        first_run_s=first_s, runs_s=walls, median_s=median, phases_s=phases,
        launches={"vmap": {k: v for k, v in launches.items() if v},
                  "map": {k: v for k, v in e2e["launches"].items() if v}},
        escalated_pairs=int(first.timings["esc_n_pairs"]),
        escalated_rows=int(first.timings["esc_n_rows"]),
        equal_to_map=True, host_syncs=syncs, peak_mb=peak,
        device_busy_s={"vmap": prof["device_busy_s"], "map": mprof["device_busy_s"]},
        device_kernels={"vmap": prof["device_kernels"],
                        "map": mprof["device_kernels"]},
        device_idle_share={"vmap": prof["device_idle_share"],
                           "map": mprof["device_idle_share"]},
        profiled_wall_s={"vmap": prof["profiled_wall_s"],
                         "map": mprof["profiled_wall_s"]},
        top_vmap=prof["top"])
    # once an octave (K3 once a bucket) for the batch: at most one launch
    # an octave of each, where map launches once an image and octave
    n_octaves = sum(1 for k in calls if k[0] == "descriptor_octave")
    per_stitch = {k: launches[k] for k in PATHS["batch_vmap"]}
    out["stitch"]["octaves"] = n_octaves
    if (per_stitch["localize_newton_resident"] > n_octaves
            or per_stitch["orientation_histograms"] > n_octaves
            or per_stitch["pair_window_gather"] > 2 * n_octaves
            or any(vl.get(k, 0) != v for k, v in per_stitch.items())):
        raise AssertionError(f"vmap launches {per_stitch} for {n_octaves} octaves")

    # the first four images: the vmap stitch and extraction on the card
    # against the CPU
    sub, gpu4 = e2e["chain4"]
    with mock.patch.dict(os.environ, VFX_SIFT_BATCH_MODE="vmap"):
        g4 = run_stitch(sub, "cuda")
        c4 = run_stitch(sub, "cpu")
    same4 = (g4.shifts == c4.shifts == gpu4.shifts and g4.pairs == c4.pairs
             and np.array_equal(g4.panorama, c4.panorama))
    g = sift_batch_with_stats(gray[:4], cfg, "vmap")
    c = sift_batch_with_stats(gray[:4].cpu(), cfg, "vmap")
    out["chain4"] = dict(stitch_equal=same4,
                         extraction=extraction_contract(g, c))
    out["seconds"] = time.time() - t_phase
    emit(out)
    if not (same4 and out["chain4"]["extraction"]["ok"]):
        raise AssertionError("the first four images' vmap runs differ card to CPU")
    return out


def _leaf_pairs(a, b):
    """(name, leaf of a, leaf of b) over two ``sift_batch_with_stats``
    outputs."""
    names = ("xy", "desc", "valid")
    for name, x, y in zip(names, a[:3], b[:3]):
        yield name, x, y
    for part, pa, pb in (("meta", a[3], b[3]), ("stats", a[4], b[4])):
        if sorted(pa) != sorted(pb):
            raise AssertionError(f"{part} keys differ")
        for key in sorted(pa):
            yield f"{part}.{key}", pa[key], pb[key]


def extraction_contract(gpu, cpu) -> dict:
    """The card's extraction against the CPU's, on the rows valid on the
    CPU, held to the stage contract of ``api_surface`` and ``viz``: the
    mask, stats, xy and integer meta equal; size within rtol 1e-5 (K1 is
    bit-exact); the angle within 2e-5 of a full turn (K2's reduction
    order moves the histogram peak, and the angle is 360 minus it, so
    its rounding is a fraction of 360 degrees, whatever its size; the
    angle's own relative gap is reported beside it); descriptors 1 LSB
    on under 2% of entries."""
    import torch

    g = [t.cpu() if torch.is_tensor(t) else {k: v.cpu() for k, v in t.items()}
         for t in gpu]
    v = cpu[2]
    ints = ("octave", "ix", "iy", "jx", "jy", "jl")
    d = (g[1][v] - cpu[1][v]).abs()
    rel = {k: float(((g[3][k] - cpu[3][k])[v].abs()
                     / cpu[3][k][v].abs().clamp_min(1e-6)).max())
           for k in ("size", "angle")}
    da = (g[3]["angle"] - cpu[3]["angle"])[v].double()
    turn = float(((da + 180.0) % 360.0 - 180.0).abs().max() / 360.0)
    out = dict(
        keypoints=int(v.sum()),
        mask_stats_equal=bool(torch.equal(g[2], v)) and all(
            torch.equal(g[4][k], cpu[4][k]) for k in cpu[4]),
        xy_ints_equal=bool(torch.equal(g[0][v], cpu[0][v])) and all(
            torch.equal(g[3][k][v], cpu[3][k][v]) for k in ints),
        max_rel=rel, angle_of_turn=turn, desc_max_lsb=float(d.max()),
        desc_lsb_share=float((d > 0).float().mean()))
    out["ok"] = (out["mask_stats_equal"] and out["xy_ints_equal"]
                 and rel["size"] <= 1e-5 and turn <= 2e-5
                 and out["desc_max_lsb"] <= 1.0 and out["desc_lsb_share"] < 0.02)
    return out


def harris_stitch(folder: str, card: str, timed_runs: int = 3) -> dict:
    """The chain stitched with the Harris backend (the reference's
    default, ``max_points`` = 200) on the card: one warm-up run with the
    launch counts at 0 (no SIFT kernel may launch, the fold kernel's
    launches are one a step and one for the occupancy, the response
    kernel's one), all 17 pairs
    matched, ``timed_runs`` timed runs identical to it, one
    profiled stitch (device time, device kernels, idle share), and the
    chain on the CPU with equal shifts and pairs and the same bytes."""
    import time

    from vfx_image_stitching_tpu_torch.compose import blend
    from vfx_image_stitching_tpu_torch.models import harris as TH
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    K.reset_launch_counts()
    blend.reset_launch_counts()
    TH.reset_launch_counts()
    t0 = time.time()
    res = run_stitch(folder, "cuda", "harris")
    first_s = time.time() - t0
    launches = dict(K.LAUNCHES)
    fold_launches = dict(blend.LAUNCHES)
    harris_launches = dict(TH.LAUNCHES)
    check_result(res, N_IMAGES)
    check_launches("harris", launches)
    check_fold_launches("harris", res, fold_launches)
    check_harris_launches("harris", res, harris_launches)
    runs = []
    for _ in range(timed_runs):
        t0 = time.time()
        r = run_stitch(folder, "cuda", "harris")
        runs.append((time.time() - t0, r))
        if (r.shifts != res.shifts or r.pairs != res.pairs
                or not np.array_equal(r.panorama, res.panorama)):
            raise AssertionError("repeated Harris runs disagree")
    walls = sorted(w for w, _ in runs)
    median_run = sorted(runs, key=lambda t: t[0])[len(runs) // 2][1]
    median_s = float(np.median(walls))
    prof = profile_stitch(folder, median_s, "harris")
    t0 = time.time()
    cpu = run_stitch(folder, "cpu", "harris")
    cpu_s = time.time() - t0
    same = (res.shifts == cpu.shifts and res.pairs == cpu.pairs
            and np.array_equal(res.panorama, cpu.panorama))
    out = dict(
        phase="harris_stitch", card=card, images=N_IMAGES,
        shape=[IMG_H, IMG_W], first_run_s=first_s, median_s=median_s,
        runs_s=walls,
        phases_s={k: v for k, v in median_run.timings.items()
                  if isinstance(v, float)},
        device_busy_s=prof["device_busy_s"],
        device_kernels=prof["device_kernels"],
        device_idle_share=prof["device_idle_share"],
        profiled_wall_s=prof["profiled_wall_s"], top=prof["top"],
        launches=launches, fold_launches=fold_launches,
        harris_launches=harris_launches,
        panorama=list(res.panorama.shape), cpu_equal=same, cpu_s=cpu_s, shifts=res.shifts, cpu_shifts=cpu.shifts)
    emit(out)
    if not same:
        raise AssertionError("CUDA and CPU Harris runs of the chain differ")
    return out


def orient_v1(folder: str, default) -> dict:
    """The stitch of ``folder`` on the card with ``VFX_ORIENT_V2=0`` (the
    v1 orientation kernel, K4): every pair matched, K4 and not K2
    launched, shifts within 1 px of the ``default`` run's."""
    import time
    from unittest import mock

    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    with mock.patch.dict(os.environ, VFX_ORIENT_V2="0"):
        K.reset_launch_counts()
        t0 = time.time()
        res = run_stitch(folder, "cuda")
        wall = time.time() - t0
        launches = dict(K.LAUNCHES)
    n = len(default.shifts) + 1
    check_result(res, n)
    check_launches("orient_v1", launches)
    diff = max(abs(a - b) for s, t in zip(res.shifts, default.shifts)
               for a, b in zip(s, t))
    out = dict(phase="orient_v1", images=n, seconds=wall, launches=launches,
               max_shift_diff_px=diff, shifts=res.shifts,
               default_shifts=default.shifts, pairs_equal=res.pairs == default.pairs)
    emit(out)
    if diff > 1.0:
        raise AssertionError(f"v1 shifts differ from the default's by {diff} px")
    return out


def _median(xs) -> float:
    return float(np.median(xs))


def pano18_fold(reps: int = 20) -> dict:
    """The fold at the benchmark's ``pano18`` shape
    (``utils/synthetic.pano18_fold_inputs``: 18 images of 512x384, 17
    swapped steps): the kernel fold (``compose_mosaic`` on the card)
    equal to the host fold byte for byte; its device ms, device kernels
    and ms a launch of each of its kernels; the plain fold
    (``fold_plain`` on the card, the ops the kernel replaced) on the same
    plan, its device ms and kernels; the byte bound: every image read
    once and the canvas written once, at the HBM rate."""
    import torch

    from vfx_image_stitching_tpu_torch.compose import blend
    from vfx_image_stitching_tpu_torch.compose.host import compose_mosaic_host
    from vfx_image_stitching_tpu_torch.utils.synthetic import (
        pano18_fold_inputs,
    )
    from vfx_image_stitching_tpu_torch.utils.timing import kernel_profile

    images, plan = pano18_fold_inputs()
    cyl = torch.as_tensor(images).cuda()
    host = compose_mosaic_host(list(images), plan)
    kernel = blend.compose_mosaic(cyl, plan).cpu().numpy()
    plain = blend.fold_plain(cyl, plan)[0].cpu().numpy()
    if not (np.array_equal(kernel, host) and np.array_equal(plain, host)):
        raise AssertionError("pano18 fold: the kernel or plain fold differs "
                             "from the host fold")
    by_name = kernel_profile(lambda: blend.compose_mosaic(cyl, plan), reps)
    per_launch = {}
    for entry in ("column_occupancy", "fold_step"):
        n, us = [(n, us) for name, (n, us) in by_name.items()
                 if entry in name][0]
        per_launch[entry] = dict(ms=us / n / 1e3, launches=n / reps)
    kernel_ms, kernel_n = device_profile(
        lambda: blend.compose_mosaic(cyl, plan), reps)
    plain_ms, plain_n = device_profile(lambda: blend.fold_plain(cyl, plan), 5)
    bound, bound_by = bound_ms(images.nbytes + plan.height * plan.width * 3, 0)
    return dict(images=list(images.shape), canvas=[plan.height, plan.width],
                steps=len(plan.steps), equal=True,
                kernel_fold_device_ms=kernel_ms,
                kernel_fold_device_kernels=kernel_n, kernels=per_launch,
                plain_fold_device_ms=plain_ms,
                plain_fold_device_kernels=plain_n,
                bound_ms=bound, bound_by=bound_by)


def fold_row(harris: dict, fold: dict) -> dict:
    """The kernel row of F1, the fold kernel (two entry points): its
    launches from the Harris stitch's run (:func:`harris_stitch`), its
    device ms a fold and a launch at the ``pano18`` shape beside the plain
    fold's and the byte bound (:func:`pano18_fold`).  It replaces no TPU
    kernel: the JAX package's fold is XLA ops."""
    return dict(
        name="compose_fold", route="cuda",
        source="vfx_image_stitching_tpu_torch/csrc/compose_fold.cu",
        replaces=None, launches=harris["fold_launches"], max_abs_err=0.0,
        ms=fold["kernel_fold_device_ms"], per_launch=fold["kernels"],
        plain_ms=fold["plain_fold_device_ms"], bound_ms=fold["bound_ms"],
        bound_by=fold["bound_by"], library_ms=None)


def harris_ops_per_pixel(ntaps: int) -> int:
    """f32 operations of the Harris response per pixel, each counted once
    as the plain version runs it: the two gradients (two products and a
    sum each), the three structure products, two blur passes of each
    (``ntaps`` products and ``ntaps - 1`` sums a pass), and the response
    (four products, a difference, a sum, a difference)."""
    return 6 + 3 + 3 * 2 * (2 * ntaps - 1) + 7


def pano18_harris_response(reps: int = 20) -> dict:
    """The Harris response at the benchmark's ``pano18`` shape (the 18
    images of 512x384 of ``utils/synthetic.pano18_fold_inputs``) at the
    default config: the kernel bit-equal to the plain version on the same
    CUDA batch; the kernel's device ms a launch (one device kernel a
    call) beside the plain version's device ms and kernels; the bound of
    ``bench_port/harness/roofline.py``: the BGR bytes read once and ix,
    iy and r written once, or the plain version's f32 operations
    (:func:`harris_ops_per_pixel`), the larger."""
    import torch

    from bench_port.harness.roofline import bound_ms as roofline_bound_ms
    from vfx_image_stitching_tpu_torch.config import HarrisConfig
    from vfx_image_stitching_tpu_torch.models import harris as TH
    from vfx_image_stitching_tpu_torch.utils.synthetic import (
        pano18_fold_inputs,
    )

    cfg = HarrisConfig()
    images = torch.as_tensor(pano18_fold_inputs()[0]).cuda()
    n, h, w = images.shape[:3]
    kernel = TH.harris_response_kernel(images, cfg)
    plain = TH.harris_response_plain(images, cfg)
    if not all(torch.equal(a, b.reshape(a.shape))
               for a, b in zip(kernel, plain)):
        raise AssertionError("pano18 Harris response: the kernel differs "
                             "from the plain version")
    ms = one_kernel_ms(lambda: TH.harris_response_kernel(images, cfg),
                       "harris_response", reps, launches=TH.LAUNCHES)
    plain_ms, plain_n = device_profile(
        lambda: TH.harris_response_plain(images, cfg), 5)
    ops = n * h * w * harris_ops_per_pixel(len(TH._structure_taps(cfg)))
    n_bytes = images.numel() + 3 * n * h * w * 4
    bound, bound_by = roofline_bound_ms(n_bytes, ops)
    return dict(images=list(images.shape), equal=True, kernel_ms=ms,
                plain_ms=plain_ms, plain_device_kernels=plain_n,
                bytes=n_bytes, flops=ops, bound_ms=bound, bound_by=bound_by)


def harris_response_row(harris: dict, resp: dict) -> dict:
    """The kernel row of H1, the Harris response kernel: its launches from
    the Harris stitch's run (:func:`harris_stitch`), its ms a launch at the
    ``pano18`` shape beside the plain version's and the bound
    (:func:`pano18_harris_response`).  It replaces no TPU kernel: the JAX
    package's Harris is XLA ops."""
    return dict(
        name="harris_response", route="cuda",
        source="vfx_image_stitching_tpu_torch/csrc/harris_response.cu",
        replaces=None, launches=harris["harris_launches"], max_abs_err=0.0,
        ms=resp["kernel_ms"], plain_ms=resp["plain_ms"],
        bound_ms=resp["bound_ms"], bound_by=resp["bound_by"], library_ms=None)


def compose_routes(folder: str, reps: int = 3) -> dict:
    """The chain stitched by both backends, whose compose is the device
    fold (``compose/blend.py``: the fold kernel), with and without the
    step capture (``return_steps=True``), ``reps`` times each in turns,
    and the host fold (``compose/host.py``, the tests' reference) on the
    same cylindrical batch and plan, ``reps`` times.  Checks: equal
    shifts, pairs, panorama and mosaic bytes across the three; 17 steps,
    the last equal to the mosaic's crop to its local canvas.  Reports
    each route's compose time (median and all; the stitch's ``compose``
    phase, and plan + fold + content bounds for the host fold, whose pull
    of the batch is reported apart), the device fold's device ms and
    device kernels (``compose_mosaic`` + ``mosaic_with_bounds`` on the
    chain's plan, profiled).  Returns the device route's results."""
    import time

    import torch

    from vfx_image_stitching_tpu_torch.compose.blend import compose_mosaic
    from vfx_image_stitching_tpu_torch.compose.crop import (
        apply_crop,
        mosaic_with_bounds,
    )
    from vfx_image_stitching_tpu_torch.compose.host import (
        compose_mosaic_host,
        content_bounds_host,
    )
    from vfx_image_stitching_tpu_torch.compose.plan import plan_compose
    from vfx_image_stitching_tpu_torch.geometry.cylindrical import (
        cylindrical_project_batch,
    )
    from vfx_image_stitching_tpu_torch.io import load_dataset, stack_dataset

    routes = dict(
        device=lambda backend: run_stitch(folder, "cuda", backend),
        steps=lambda backend: run_stitch(folder, "cuda", backend,
                                         return_steps=True))
    images, focals, _ = load_dataset(folder)
    batch, valid = stack_dataset(images)
    cyl = cylindrical_project_batch(torch.as_tensor(batch).cuda(), focals)
    out, refs = dict(phase="compose_routes", images=N_IMAGES), {}
    for backend in ("sift", "harris"):
        first, compose_s, wall_s = {}, {r: [] for r in routes}, {r: [] for r in routes}
        for i in range(reps):
            for r in (routes if i % 2 == 0 else reversed(list(routes))):
                t0 = time.time()
                res = routes[r](backend)
                wall_s[r].append(time.time() - t0)
                compose_s[r].append(res.timings["compose"])
                first.setdefault(r, res)
        ref = refs[backend] = first["device"]
        check_result(ref, N_IMAGES)
        pull_s, host_s = [], []
        for _ in range(reps):
            t0 = time.time()
            src = cyl.cpu().numpy()
            t1 = time.time()
            plan = plan_compose(IMG_H, IMG_W, N_IMAGES, list(valid),
                                ref.corrected_shifts, ref.pairs)
            host = compose_mosaic_host(
                {i: src[i] for i in range(N_IMAGES) if valid[i]}, plan)
            bounds = content_bounds_host(host, 0)
            host_s.append(time.time() - t1)
            pull_s.append(t1 - t0)
        compose_s["host"] = host_s
        same = (first["steps"].shifts == ref.shifts
                and first["steps"].pairs == ref.pairs
                and np.array_equal(first["steps"].panorama, ref.panorama)
                and np.array_equal(first["steps"].mosaic, ref.mosaic)
                and np.array_equal(host, ref.mosaic)
                and np.array_equal(apply_crop(host, bounds, 15), ref.panorama))
        last = plan.steps[-1]
        captured = first["steps"].steps
        steps_ok = (len(captured) == N_IMAGES - 1 and np.array_equal(
            captured[-1], ref.mosaic[
                last.frame_off_y:last.frame_off_y + last.local_h,
                last.frame_off_x:last.frame_off_x + last.local_w]))
        dev_ms, dev_kernels = device_profile(
            lambda: mosaic_with_bounds(compose_mosaic(cyl, plan), 0), reps=5)
        out[backend] = dict(
            equal=same, steps=len(captured), last_step_equal=steps_ok,
            compose_s_median={r: _median(v) for r, v in compose_s.items()},
            compose_s=compose_s, host_pull_s_median=_median(pull_s),
            wall_s_median={r: _median(v) for r, v in wall_s.items()},
            device_fold_device_ms=dev_ms, device_fold_device_kernels=dev_kernels,
            mosaic=list(ref.mosaic.shape))
        if not (same and steps_ok):
            raise AssertionError(f"compose routes disagree ({backend}): {out[backend]}")
    emit(out)
    return refs


def stage_api(folder: str, work: str, refs: dict) -> dict:
    """``compute_pairwise_shifts`` and ``finalize_to_panorama`` on the
    card against ``stitch_panorama`` (``refs``) for both
    backends: equal shifts, pairs and bytes; and a stitch with a ``.png``
    ``save_path`` that reads back equal to its panorama."""
    import torch

    from vfx_image_stitching_tpu_torch.config import StitchConfig
    from vfx_image_stitching_tpu_torch.geometry.cylindrical import (
        cylindrical_project_batch,
    )
    from vfx_image_stitching_tpu_torch.io import (
        load_bgr,
        load_dataset,
        stack_dataset,
    )
    from vfx_image_stitching_tpu_torch.pipeline.stitch import (
        compute_pairwise_shifts,
        dispatch_pair_step,
        extract_features,
        finalize_to_panorama,
    )

    out = dict(phase="stage_api")
    images, focals, _ = load_dataset(folder)
    batch, valid = stack_dataset(images)
    for backend in ("sift", "harris"):
        ref = refs[backend]
        cfg = StitchConfig(backend=backend)
        cyl = cylindrical_project_batch(torch.as_tensor(batch).cuda(), focals)
        shifts, pairs, _counts = compute_pairwise_shifts(cyl, valid, cfg)
        xy, descs, valid_kp, meta, stats = extract_features(cyl, cfg)
        pair_out = dispatch_pair_step(xy, descs, valid_kp, cfg)
        fin = finalize_to_panorama(cyl, xy, valid_kp, meta, stats, pair_out,
                                   list(valid), cfg, IMG_H, IMG_W, 15)
        png = os.path.join(work, f"saved_{backend}.png")
        saved = run_stitch(folder, "cuda", backend, save_path=png)
        out[backend] = dict(
            shifts_equal=shifts == ref.shifts and fin.shifts == ref.shifts,
            pairs_equal=pairs == ref.pairs and fin.pairs == ref.pairs,
            bytes_equal=bool(np.array_equal(fin.panorama, ref.panorama)),
            saved_png_equal=bool(
                np.array_equal(saved.panorama, ref.panorama)
                and np.array_equal(load_bgr(png), ref.panorama)))
        if not all(out[backend].values()):
            raise AssertionError(f"stage API differs ({backend}): {out[backend]}")
    emit(out)
    return out


MULTI_SETS = (
    # BASELINE's multi-panorama run (wind/out/parrington/grail): name,
    # images, seed; wind's pano.txt has an image with no focal length
    ("wind", 2, 5), ("out", 2, 13), ("parrington", 18, SEED), ("grail", 18, 11),
)


def multi_folders(work: str, chain: str) -> list:
    """The four synthetic folders of the ``multi`` phase (parrington is
    the chain itself, linked)."""
    folders = []
    for name, n, seed in MULTI_SETS:
        folder = os.path.join(work, "multi", name)
        os.makedirs(folder)
        if seed == SEED and n == N_IMAGES:
            for fn in os.listdir(chain):
                os.link(os.path.join(chain, fn), os.path.join(folder, fn))
        else:
            synth_chain(folder, n, IMG_H, IMG_W, seed, FOCAL, **SCENE)
        if name == "wind":  # drop the first image's focal length
            pano = os.path.join(folder, "pano.txt")
            with open(pano) as f:
                lines = f.read().split("\n")
            with open(pano, "w") as f:
                f.write("\n".join([lines[0], lines[2], lines[3]]) + "\n")
        folders.append(folder)
    return folders


def multi(work: str, chain: str, reps: int = 2) -> dict:
    """``stitch_many`` over the four folders, SIFT then Harris, against
    the loop of ``stitch_panorama`` (each folder at its golden margin):
    equal shifts, pairs and bytes; the SIFT run launches K1-K3 (counted
    from 0 just before it) and the Harris run no kernel.  The two are
    timed ``reps`` times each, in turns.  Returns the phase's line, the
    folders and the first SIFT ``stitch_many`` results."""
    import time

    from vfx_image_stitching_tpu_torch.config import DEFAULT_CROP_MARGINS
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.pipeline.multi import stitch_many

    folders = multi_folders(work, chain)
    names = [os.path.basename(f) for f in folders]
    out = dict(phase="multi", folders={n: k for n, k, _s in MULTI_SETS})
    for backend in ("sift", "harris"):
        def many():
            return stitch_many(folders, backend=backend, device="cuda")

        def loop():
            return {n: run_stitch(f, "cuda", backend,
                                  crop_margin=DEFAULT_CROP_MARGINS[n])
                    for n, f in zip(names, folders)}

        walls = dict(stitch_many=[], loop=[])
        for i in range(reps):
            for name, fn in ((("stitch_many", many), ("loop", loop)) if i % 2 == 0
                             else (("loop", loop), ("stitch_many", many))):
                if i == 0 and name == "stitch_many":
                    K.reset_launch_counts()
                t0 = time.time()
                res = fn()
                walls[name].append(time.time() - t0)
                if i == 0 and name == "stitch_many":
                    got, launches = res, dict(K.LAUNCHES)
                elif i == 0:
                    want = res
        check_launches("stitch" if backend == "sift" else "harris", launches)
        equal = list(got) == names and all(
            got[n].shifts == want[n].shifts and got[n].pairs == want[n].pairs
            and np.array_equal(got[n].panorama, want[n].panorama)
            for n in names)
        out[backend] = dict(
            equal=equal, launches={k: v for k, v in launches.items() if v},
            wall_s_median={k: _median(v) for k, v in walls.items()},
            wall_s=walls,
            panoramas={n: list(got[n].panorama.shape) for n in names},
            pairs_matched={n: sum(p is not None for p in got[n].pairs)
                           for n in names})
        if not equal or got["wind"].shifts != []:
            raise AssertionError(f"stitch_many differs ({backend}): {out[backend]}")
        if backend == "sift":
            sift_runs = got
    emit(out)
    return out, folders, sift_runs


def mesh(folder: str, multi_out: dict, folders: list, unsharded: dict) -> dict:
    """The mesh layer (``parallel/mesh.py``) on the card.  ``stitch_many``
    with SIFT over the four ``multi`` folders on ``make_mesh_pano()`` (one
    slot per visible card) and on a (2, 2) mesh of four logical slots of
    ``cuda:0`` (a stream each), each run with the launch counts at 0: K1-K3
    and no other kernel launch, shifts, pairs and panorama bytes equal to
    ``multi``'s unsharded ``stitch_many`` (``unsharded``), walls beside
    that run's.  Then ``sharded_pairwise_shifts`` over the chain's first
    17 images on 3 logical slots (6, 6 and 5 images) against the unsharded
    ``_pairwise_shift_step``: every leaf equal."""
    import time

    import torch

    from vfx_image_stitching_tpu_torch.config import StitchConfig
    from vfx_image_stitching_tpu_torch.geometry.cylindrical import (
        cylindrical_project_batch,
    )
    from vfx_image_stitching_tpu_torch.io import load_dataset, stack_dataset
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.parallel import mesh as M
    from vfx_image_stitching_tpu_torch.pipeline.multi import stitch_many

    out = dict(phase="mesh", cards=torch.cuda.device_count(),
               unsharded_wall_s=multi_out["sift"]["wall_s"]["stitch_many"],
               unsharded_wall_s_median=multi_out["sift"]["wall_s_median"]["stitch_many"])
    cuda0 = torch.device("cuda", 0)
    for name, grid in (("pano_cards", M.make_mesh_pano()),
                       ("logical_2x2", M.make_mesh_2d(devices=[cuda0] * 4))):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.time()
        res = stitch_many(folders, backend="sift", mesh=grid)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(K.LAUNCHES)
        check_launches("mesh", launches)
        equal = list(res) == list(unsharded) and all(
            res[n].shifts == unsharded[n].shifts and res[n].pairs == unsharded[n].pairs
            and np.array_equal(res[n].panorama, unsharded[n].panorama)
            for n in unsharded)
        out[name] = dict(shape=list(grid.devices.shape), wall_s=wall, equal=equal,
                         launches={k: v for k, v in launches.items() if v},
                         shift_stage_s={n: r.timings["shift_stage"] for n, r in res.items()})
        if not equal:
            raise AssertionError(f"mesh {name}: stitch_many differs from unsharded")

    images, focals, _ = load_dataset(folder)
    batch, _valid = stack_dataset(images)
    cyl = cylindrical_project_batch(torch.as_tensor(batch[:17]).cuda(), focals[:17])
    cfg = StitchConfig(backend="sift")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.time()
    got = M.sharded_pairwise_shifts(cyl, M.make_mesh(devices=[cuda0] * 3), cfg)
    torch.cuda.synchronize()
    sharded_s = time.time() - t0
    launches = dict(K.LAUNCHES)
    check_launches("mesh", launches)
    t0 = time.time()
    want = M._pairwise_shift_step(cyl, cfg)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    leaves_equal = [bool(torch.equal(g, w)) for g, w in zip(got, want)]
    out["pairwise_3_slots"] = dict(
        images=17, shards=[6, 6, 5], leaves_equal=all(leaves_equal),
        pairs_matched=int(want[3].sum()), sharded_s=sharded_s, unsharded_s=plain_s,
        launches={k: v for k, v in launches.items() if v})
    emit(out)
    if not (all(leaves_equal) and len(leaves_equal) == 15):
        raise AssertionError(f"sharded_pairwise_shifts differs: {leaves_equal}")
    return out


# the mesh_vmap phase's three schedules of sharded_multi_pano_full:
# (mode, VFX_SIFT_BATCH_MODE)
MESH_SCHEDULES = {"shard_map": ("shard_map", "map"),
                  "shard_map_env_vmap": ("shard_map", "vmap"),
                  "vmap": ("vmap", "map")}


def mesh_vmap(folders: list, timed_runs: int = 2) -> dict:
    """The batched multi-panorama steps (``parallel/mesh.py``) on the card,
    on the ``multi`` folders' same-shape group (parrington and grail, 2 x
    18 x 384x512), over ``make_mesh_pano()`` (one slot per visible card)
    and a (2, 2) mesh of four logical slots of ``cuda:0``.  Three
    schedules of ``sharded_multi_pano_full`` (``MESH_SCHEDULES``) on each
    mesh, in turns: a warm-up (its host syncs and peak memory), then
    ``timed_runs`` each (the first with the launch counts at 0: K1-K3 and
    no other kernel; ``mode="vmap"`` at most once an octave for each
    slot's batch, K3 once a bucket).  Every SIFT leaf equal across the
    three schedules and both meshes, every Harris leaf too (no kernel
    launched); ``sharded_multi_pano_shifts`` equal to the per-panorama
    ``_pairwise_shift_step`` for both backends; K1-K4 on the inputs the
    36-image batched extraction gave them (``batch_kernels``; that
    extraction's ``xy`` equal to the mesh's); one profiled call of each
    schedule on the pano mesh (device time and kernels, idle share of the
    median wall).  The phase's line is printed even when a check fails."""
    import time
    from unittest import mock

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vfx_image_stitching_tpu_torch.config import StitchConfig
    from vfx_image_stitching_tpu_torch.geometry.cylindrical import (
        cylindrical_project_batch,
    )
    from vfx_image_stitching_tpu_torch.io import load_dataset, stack_dataset
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.ops.color import bgr_to_gray_f32
    from vfx_image_stitching_tpu_torch.parallel import mesh as M

    t_phase = time.time()
    cyls = []
    for f in folders:
        if os.path.basename(f) in ("parrington", "grail"):
            images, focals, _ = load_dataset(f)
            batch, _valid = stack_dataset(images)
            cyls.append(cylindrical_project_batch(
                torch.as_tensor(batch).cuda(), [float(x) for x in focals]))
    batch = torch.stack(cyls)
    cuda0 = torch.device("cuda", 0)
    meshes = {"pano_cards": M.make_mesh_pano(),
              "logical_2x2": M.make_mesh_2d(devices=[cuda0] * 4)}
    sift, harris = StitchConfig(backend="sift"), StitchConfig(backend="harris")
    out = dict(phase="mesh_vmap", batch=list(batch.shape[:4]), part_s={})

    def leaves(tree):
        found = []
        M._tree_map(found.append, tree)
        return found

    def differing(a, b):
        la, lb = leaves(a), leaves(b)
        if len(la) != len(lb):
            return ["leaf count"]
        return [i for i, (x, y) in enumerate(zip(la, lb)) if not torch.equal(x, y)]

    def run(grid, schedule, cfg):
        mode, env = MESH_SCHEDULES[schedule]
        with mock.patch.dict(os.environ, VFX_SIFT_BATCH_MODE=env):
            res = M.sharded_multi_pano_full(batch, grid, cfg, mode=mode)
        torch.cuda.synchronize()
        return res

    def part(name, t0):
        out["part_s"][name] = time.time() - t0

    try:
        first = None
        for name, grid in meshes.items():
            t0 = time.time()
            slots = len(grid.slots)
            rec = {s: dict(runs_s=[]) for s in MESH_SCHEDULES}
            outs = {}
            for i in range(1 + timed_runs):
                order = list(MESH_SCHEDULES)
                for s in (order if i % 2 == 0 else order[::-1]):
                    if i == 0:
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                        base = torch.cuda.memory_allocated()
                        t1 = time.time()
                        rec[s]["host_syncs"] = host_syncs(
                            lambda: outs.__setitem__(s, run(grid, s, sift)))
                        rec[s]["warm_up_s"] = time.time() - t1
                        rec[s]["peak_mb"] = (
                            torch.cuda.max_memory_allocated() - base) / 2**20
                        continue
                    if i == 1:
                        K.reset_launch_counts()
                    t1 = time.time()
                    run(grid, s, sift)
                    rec[s]["runs_s"].append(time.time() - t1)
                    if i == 1:
                        launches = dict(K.LAUNCHES)
                        rec[s]["launches"] = {k: v for k, v in launches.items() if v}
                        check_launches("mesh_vmap", launches)
            if first is None:
                first = outs["shard_map"]
            octaves = int(outs["vmap"][3]["cand_caps"].shape[-1])
            for s in MESH_SCHEDULES:
                rec[s]["median_s"] = _median(rec[s]["runs_s"])
                rec[s]["differs_from_shard_map"] = differing(outs[s], outs["shard_map"])
                rec[s]["differs_from_pano_cards"] = differing(outs[s], first)
            vl = rec["vmap"]["launches"]
            once = (vl.get("localize_newton_resident", 0) <= slots * octaves
                    and vl.get("orientation_histograms", 0) <= slots * octaves
                    and vl.get("pair_window_gather", 0) <= 2 * slots * octaves)
            del outs
            # Harris: plain tensor ops, no kernel
            h_outs = {}
            for s in MESH_SCHEDULES:
                K.reset_launch_counts()
                h_outs[s] = run(grid, s, harris)
                check_launches("harris", dict(K.LAUNCHES))
            h_diff = {s: differing(h_outs[s], h_outs["shard_map"])
                      for s in MESH_SCHEDULES}
            out[name] = dict(shape=list(grid.devices.shape), octaves=octaves,
                             once_an_octave_per_slot=once, sift=rec,
                             harris_differs=h_diff)
            part(name, t0)
            if not once or any(rec[s]["differs_from_shard_map"]
                               or rec[s]["differs_from_pano_cards"]
                               for s in rec) or any(h_diff.values()):
                raise AssertionError(f"mesh_vmap {name}: the schedules differ or "
                                     f"vmap launched per panorama")

        # sharded_multi_pano_shifts against the per-panorama minimal step
        t0 = time.time()
        shifts = {}
        for backend, cfg in (("sift", sift), ("harris", harris)):
            want = M._tree_map(lambda *xs: torch.stack(xs),
                               *(M._pairwise_shift_step(b, cfg) for b in batch))
            for name, grid in meshes.items():
                got = M.sharded_multi_pano_shifts(batch, grid, cfg)
                torch.cuda.synchronize()
                shifts[f"{backend}_{name}"] = differing(got, want)
            shifts[f"{backend}_pairs_matched"] = int(want[3].sum())
        out["multi_pano_shifts_differ"] = shifts
        part("multi_pano_shifts", t0)
        if any(v for k, v in shifts.items() if not k.endswith("matched")):
            raise AssertionError(f"sharded_multi_pano_shifts differs: {shifts}")

        # K1-K4 on the inputs the 36-image batched extraction gave them
        t0 = time.time()
        (xy36, *_rest), calls = recorded_extraction(
            bgr_to_gray_f32(batch.flatten(0, 1)), sift.sift, "vmap")
        del _rest
        if differing(xy36, first[0].flatten(0, 1)):
            raise AssertionError("the recorded extraction differs from the mesh's")
        out["kernels"] = batch_kernels(calls, sift.sift)
        del calls
        part("kernels", t0)

        # one profiled call of each schedule on the pano mesh (device
        # events only); a trace is complete when it holds every K1-K3
        # launch the call counted
        t0 = time.time()
        grid = meshes["pano_cards"]
        prof = {}
        for s in MESH_SCHEDULES:
            K.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CUDA]) as session:
                run(grid, s, sift)
            events = device_events(session)
            ours = sum(1 for name, _us in events
                       if any(k in name for k in ("localize_newton_kernel",
                                                  "orientation_kernel", "pair_gather")))
            busy = sum(us for _n, us in events) / 1e6
            median = out["pano_cards"]["sift"][s]["median_s"]
            prof[s] = dict(device_busy_s=busy, device_idle_share=1 - busy / median,
                           device_kernels=len(events),
                           complete=ours == sum(K.LAUNCHES[k] for k in PATHS["mesh_vmap"]))
        out["profile_pano_cards"] = prof
        part("profile", t0)
    finally:
        out["seconds"] = time.time() - t_phase
        emit(out)
    return out


VIZ_PANELS = ("1_base_image.png", "2_gaussian_pyramid.png", "3_dog_pyramid.png",
              "4_keypoints.png", "5_descriptor.png", "6_matching.png")


def pyplot_stand_in() -> dict:
    """``sys.modules`` entries for a recording stand-in of matplotlib's
    ``pyplot`` (the card's machine has no matplotlib): each axis counts
    its drawing calls by name, and ``savefig`` writes the figure's counts
    as JSON under the panel's file name."""
    import json
    import types

    class Axis:
        def __init__(self):
            self.calls = {}

        def __getattr__(self, name):
            if name.startswith("__"):
                raise AttributeError(name)

            def record(*_args, **_kwargs):
                self.calls[name] = self.calls.get(name, 0) + 1
            return record

    class Figure:
        def __init__(self, axes):
            self.axes = axes

        def savefig(self, path, **_kwargs):
            with open(path, "w") as f:
                json.dump([ax.calls for ax in self.axes], f)

    def subplots(nrows=1, ncols=1, **_kwargs):
        axes = [Axis() for _ in range(nrows * ncols)]
        grid = np.empty(len(axes), dtype=object)
        grid[:] = axes
        return Figure(axes), axes[0] if len(axes) == 1 else grid.reshape(nrows, ncols)

    plt = types.ModuleType("matplotlib.pyplot")
    plt.subplots = subplots
    plt.close = lambda _fig: None
    mpl = types.ModuleType("matplotlib")
    mpl.use = lambda _backend: None
    mpl.pyplot = plt
    return {"matplotlib": mpl, "matplotlib.pyplot": plt}


def viz(folder: str, work: str) -> dict:
    """The visualizers (``viz/``) on the chain's first two images, on the
    card: ``render_sift_report`` (with the matching panel) and
    ``render_harris_demo``, run with the launch counts at 0 (K1-K3 and no
    other kernel), writing the JAX renderers' six panel files and the
    demo file (through a recording stand-in of pyplot where matplotlib is
    absent).  Then the panels' inputs on the card against a
    ``device="cpu"`` run: ``compute_stages`` of image 0 (base and pyramids
    bit-equal, keypoint positions and octaves equal, size and response
    within rtol 1e-5, angles within 2e-5 of a full turn, descriptors 1 LSB
    on under 2% of entries), image 1's keypoints and descriptors (the
    matching panel's) to the same contract, and ``harris_match_pair``'s
    keypoints and matches equal."""
    import importlib.util
    import sys
    import time

    import torch

    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.models.sift.extract import (
        compute_keypoints_and_descriptors,
    )
    from vfx_image_stitching_tpu_torch.viz import render_harris_demo, render_sift_report
    from vfx_image_stitching_tpu_torch.viz.harris_demo import harris_match_pair
    from vfx_image_stitching_tpu_torch.viz.sift_visualizer import _gray_f32, compute_stages
    from vfx_image_stitching_tpu_torch.io import load_bgr

    paths = [os.path.join(folder, f"im0{i}.png.ppm") for i in range(2)]
    out_dir = os.path.join(work, "viz")
    matplotlib = importlib.util.find_spec("matplotlib") is not None
    stand_in = {} if matplotlib else pyplot_stand_in()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.time()
    # only the stand-in's entries come and go: restoring all of
    # sys.modules would drop the modules the renderers import meanwhile
    sys.modules.update(stand_in)
    try:
        written = render_sift_report(paths[0], out_dir, match_path=paths[1],
                                     device="cuda")
        demo = render_harris_demo(*paths, os.path.join(out_dir, "demo.png"),
                                  device="cuda")
    finally:
        for name in stand_in:
            del sys.modules[name]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(K.LAUNCHES)
    check_launches("viz", launches)
    names = sorted(os.path.basename(p) for p in written)

    def compare_records(got, want, dg, dw) -> dict:
        """Keypoint records and descriptors of the card's run against the
        CPU's: positions and octaves equal, size and response within rtol
        1e-5, angles within 2e-5 of a full turn (the angle is 360 minus
        the histogram peak's position, so its rounding is a fraction of
        360 degrees, whatever its size), descriptors 1 LSB on under 2% of
        entries."""
        out = dict(keypoints=len(got), same_points=[(r.pt, r.octave) for r in got]
                   == [(r.pt, r.octave) for r in want])
        if not out["same_points"]:
            out["close"] = False
            return out
        close = True
        for key, rtol in (("size", 1e-5), ("response", 1e-5), ("angle", 2e-5)):
            a = np.array([getattr(r, key) for r in got], dtype=np.float64)
            b = np.array([getattr(r, key) for r in want], dtype=np.float64)
            if key == "angle":
                rel = np.abs((a - b + 180.0) % 360.0 - 180.0) / 360.0
            else:
                rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-6)
            worst = int(np.argmax(rel)) if rel.size else 0
            out[key] = dict(max_rel=float(rel.max()) if rel.size else 0.0,
                            worst=[float(a[worst]), float(b[worst])] if rel.size else [])
            close = close and out[key]["max_rel"] <= rtol
        d = np.abs(dg - dw)
        out["desc_max_lsb"] = float(d.max()) if d.size else 0.0
        out["desc_lsb_share"] = float((d > 0).mean()) if d.size else 0.0
        out["close"] = bool(close and out["desc_max_lsb"] <= 1.0
                            and out["desc_lsb_share"] < 0.02)
        return out

    gray = _gray_f32(paths[0])
    cuda_st = compute_stages(gray, device="cuda")
    cpu_st = compute_stages(gray, device="cpu")
    stacks_equal = all(torch.equal(a.cpu(), b) for a, b in zip(
        [cuda_st[0], *cuda_st[1], *cuda_st[2]], [cpu_st[0], *cpu_st[1], *cpu_st[2]]))
    g1 = _gray_f32(paths[1]).astype(np.uint8)
    kp1 = [compute_keypoints_and_descriptors(g1, device=d) for d in ("cuda", "cpu")]
    imgs = [load_bgr(p) for p in paths]
    harris = [harris_match_pair(*imgs, device=d) for d in ("cuda", "cpu")]
    res = dict(
        phase="viz", matplotlib=matplotlib, wall_s=wall,
        launches={k: v for k, v in launches.items() if v},
        panels=names, demo=os.path.basename(demo),
        panels_as_expected=names == sorted(VIZ_PANELS) and all(
            os.path.getsize(p) > 0 for p in [*written, demo]),
        keypoints=len(cuda_st[3]), stacks_equal=stacks_equal,
        image0=compare_records(cuda_st[3], cpu_st[3], cuda_st[4], cpu_st[4]),
        image1=compare_records(kp1[0][0], kp1[1][0], kp1[0][1], kp1[1][1]),
        harris_keypoints=[len(harris[0][0]), len(harris[0][1])],
        harris_matches=len(harris[0][2]), harris_equal=harris[0] == harris[1])
    emit(res)
    if not (all(res[k] for k in ("panels_as_expected", "stacks_equal", "harris_equal"))
            and res["image0"]["close"] and res["image1"]["close"]
            and res["keypoints"] > 0):
        raise AssertionError(f"viz: {res}")
    return res


def probe_fused(dev, reps: int = 2, rounds: int = 3) -> dict:
    """The localize probe's ``fused`` phase (``probes/localize_resident_r4.
    fused``) on the chain's first 6 images: its three modes once each with
    the launch counts at 0 (K1 and no other kernel), then ``rounds``
    interleaved rounds of ``reps`` timed passes, host ms per image, and
    ``plain`` against ``resident`` on every octave of every image."""
    import torch

    from vfx_image_stitching_tpu_torch.config import StitchConfig
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.probes import localize_resident_r4 as R

    inputs = R.fused_inputs(dev, group=6)
    cfg = StitchConfig(backend="sift").sift
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for mode in R.FUSED_MODES:
        for gray in inputs[0]:
            R.fused_prefix(gray, mode, cfg)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check_launches("probe_fused", launches)
    res = R.fused(dev, inputs=inputs, reps=reps, rounds=rounds)
    res["launches"] = {k: v for k, v in launches.items() if v}
    emit(dict(res, phase="probe_fused"))
    if not res["ok"]:
        raise AssertionError(f"fused: plain and resident differ: {res['plain_vs_resident']}")
    return res


def api_surface(folder: str, refs: dict, counts: dict) -> dict:
    """``compat.compute_shift_sift`` / ``compute_shift_harris`` on the
    chain's cylindrical images 0-1 against the stitch's first shift;
    ``audit_sift_capacities`` over the chain against the ``chain_counts``
    maxima; ``find_scale_space_extrema`` + ``generate_descriptors`` on
    image 0 (launches counted from 0; K1-K3 and no other) against the
    same stages on the CPU."""
    import torch

    from vfx_image_stitching_tpu_torch import compat
    from vfx_image_stitching_tpu_torch.config import SiftConfig
    from vfx_image_stitching_tpu_torch.io import load_dataset
    from vfx_image_stitching_tpu_torch.models import sift as S
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.ops.color import bgr_to_gray_u8_np
    from vfx_image_stitching_tpu_torch.utils.capacity import (
        audit_sift_capacities,
    )

    images, focals, _ = load_dataset(folder)
    cyl = [compat.cylindrical_projection(im, f, device="cuda")
           for im, f in zip(images, focals)]
    out = dict(phase="api_surface")
    for backend, fn in (("sift", compat.compute_shift_sift),
                        ("harris", compat.compute_shift_harris)):
        move, pair = fn(cyl[0], cyl[1], device="cuda")
        out[f"compute_shift_{backend}"] = dict(
            move=move, stitch_shift=refs[backend].shifts[0],
            equal=tuple(move) == refs[backend].shifts[0]
            and tuple(map(tuple, pair)) == refs[backend].pairs[0])

    audit = audit_sift_capacities(cyl, device="cuda")
    out["audit"] = {
        stage: dict(max=audit[f"{stage}_counts"].tolist(),
                    caps=audit[f"{stage}_caps"].tolist(),
                    equal=audit[f"{stage}_counts"].tolist() == counts[stage]["max"])
        for stage in ("cand", "loc", "oriented", "desc_big")}
    out["audit"]["final"] = dict(max=int(audit["final_counts"].max()),
                                 equal=int(audit["final_counts"].max())
                                 == counts["final"]["max"])

    cfg = SiftConfig()
    gray = bgr_to_gray_u8_np(cyl[0]).astype(np.float32)

    def stages(dev):
        base = S.generate_base_image(torch.as_tensor(gray, device=dev),
                                     cfg.sigma, cfg.assumed_blur)
        pyr = S.generate_gaussian_images(
            base, S.compute_number_of_octaves(base.shape),
            S.generate_gaussian_kernels(cfg.sigma, cfg.num_intervals))
        kps = S.find_scale_space_extrema(pyr, S.generate_DoG_images(pyr), cfg=cfg)
        kps = S.convert_keypoints_to_input_image_size(kps)
        desc = S.generate_descriptors(kps, pyr, cfg=cfg)
        return S.Keypoints(*[f.cpu() for f in kps]), desc.cpu()

    K.reset_launch_counts()
    kps_g, desc_g = stages("cuda")
    launches = dict(K.LAUNCHES)
    check_launches("stages", launches)
    kps_c, desc_c = stages("cpu")
    v = kps_c.valid
    d = (desc_g[v] - desc_c[v]).abs()
    out["stages"] = dict(
        launches={k: n for k, n in launches.items() if n},
        keypoints=int(v.sum()),
        ints_equal=all(torch.equal(getattr(kps_g, f)[v], getattr(kps_c, f)[v])
                       for f in ("x", "y", "octave")) and torch.equal(kps_g.valid, v),
        max_rel={f: float(((getattr(kps_g, f) - getattr(kps_c, f))[v].abs()
                           / getattr(kps_c, f)[v].abs().clamp_min(1e-6)).max())
                 for f in ("size", "angle", "response")},
        desc_max_lsb=float(d.max()), desc_lsb_share=float((d > 0).float().mean()))
    emit(out)
    st = out["stages"]
    # size and response come from K1, bit-exact against the plain walk;
    # the angle from K2's histograms, held to the orientation contract
    # (rtol 2e-5); descriptors to the descriptor contract (1 LSB on
    # under 2% of entries)
    ok = (all(out[f"compute_shift_{b}"]["equal"] for b in ("sift", "harris"))
          and all(v["equal"] for v in out["audit"].values())
          and st["ints_equal"] and st["max_rel"]["size"] <= 1e-5
          and st["max_rel"]["response"] <= 1e-5 and st["max_rel"]["angle"] <= 2e-5
          and st["desc_max_lsb"] <= 1.0 and st["desc_lsb_share"] < 0.02)
    if not ok:
        raise AssertionError("api_surface: a check failed")
    return out


def cli(folder: str, work: str, ref) -> dict:
    """The CLI in a subprocess on ``folder`` (``--backend sift --out
    <dir>/pano.png --save-steps --profile-dir <dir>/trace``, on the
    card): exit 0, the panorama equal to ``stitch_panorama``'s (``ref``),
    one step file per pair, a trace written.  Run on the chain's first 4
    images (the 18-image run wrote a 482 MB trace in 45-57 s)."""
    import subprocess
    import sys
    import time

    from vfx_image_stitching_tpu_torch.io import load_bgr

    out_dir = os.path.join(work, "cli")
    os.makedirs(out_dir)
    png = os.path.join(out_dir, "pano.png")
    trace = os.path.join(out_dir, "trace")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "vfx_image_stitching_tpu_torch.pipeline.cli",
         folder, "--backend", "sift", "--out", png, "--save-steps",
         "--profile-dir", trace],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    wall = time.time() - t0
    step_files = sorted(f for f in os.listdir(out_dir)
                        if f.startswith("pano") and f.endswith(".jpg"))
    traces = os.listdir(trace) if os.path.isdir(trace) else []
    out = dict(phase="cli", rc=proc.returncode, seconds=wall,
               steps=len(step_files), traces=len(traces),
               trace_mb=sum(os.path.getsize(os.path.join(trace, t))
                            for t in traces) / 2**20,
               panorama_equal=proc.returncode == 0 and os.path.exists(png)
               and bool(np.array_equal(load_bgr(png), ref.panorama)),
               stderr_tail=proc.stderr[-400:])
    emit(out)
    if not (proc.returncode == 0 and out["panorama_equal"]
            and out["steps"] == len(ref.shifts) and out["traces"] >= 1
            and out["trace_mb"] > 0):
        raise AssertionError(f"cli: {out}")
    return out


def ratio_match(folder: str) -> dict:
    """``match_descriptors`` with the Lowe ratio test on the chain's 17
    adjacent pairs, features extracted on the card as the stitch does
    (launch counts from 0: K1-K3 for SIFT, none for Harris): SIFT at
    ``refine`` 1 and Harris at ``refine`` 8 with each backend's threshold,
    at ratios 0.7 and 0.8 and without one.  ``best_idx`` and ``matched``
    on the card equal the CPU's bit for bit on the same features; the
    matches kept per ratio, a lower ratio's a subset of a higher one's and
    those without a ratio, and some kept at 0.7."""
    import torch

    from vfx_image_stitching_tpu_torch.config import StitchConfig
    from vfx_image_stitching_tpu_torch.geometry.cylindrical import (
        cylindrical_project_batch,
    )
    from vfx_image_stitching_tpu_torch.io import load_dataset, stack_dataset
    from vfx_image_stitching_tpu_torch.match.nn import match_descriptors
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.pipeline.stitch import extract_features

    images, focals, _paths = load_dataset(folder)
    batch, _valid = stack_dataset(images)
    cyl = cylindrical_project_batch(torch.as_tensor(batch).to("cuda"),
                                    [float(f) for f in focals])
    K.reset_launch_counts()
    feats = {b: extract_features(cyl, StitchConfig(backend=b))[1:3]
             for b in ("sift", "harris")}
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check_launches("ratio_match", launches)
    out = dict(phase="ratio_match", pairs=int(cyl.shape[0]) - 1,
               launches={k: n for k, n in launches.items() if n})
    ok = True
    for backend, (descs, valid) in feats.items():
        mcfg = StitchConfig(backend=backend).match()
        args = (descs[:-1], valid[:-1], descs[1:], valid[1:], mcfg.desc_thresh)
        host = tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
        row = dict(refine=mcfg.refine, desc_thresh=mcfg.desc_thresh,
                   valid_rows=int(valid[:-1].sum()))
        kept = []
        for ratio in (None, 0.7, 0.8):
            got = match_descriptors(*args, refine=mcfg.refine, lowe_ratio=ratio)
            want = match_descriptors(*host, refine=mcfg.refine, lowe_ratio=ratio)
            equal = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
            kept.append(got[1].cpu())
            row[f"ratio_{ratio}"] = dict(
                kept=int(got[1].sum()), kept_per_pair=got[1].sum(-1).tolist(),
                cuda_equals_cpu=equal)
            ok &= equal
        nested = (not (kept[1] & ~kept[2]).any()) and not (kept[2] & ~kept[0]).any()
        row["subsets"] = nested
        ok &= nested and int(kept[1].sum()) > 0
        out[backend] = row
    emit(out)
    if not ok:
        raise AssertionError(f"ratio_match: {out}")
    return out


def main() -> int:
    import sys

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import subprocess
    import tempfile
    import time

    from vfx_image_stitching_tpu_torch.compose import blend
    from vfx_image_stitching_tpu_torch.models import harris as TH
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K
    from vfx_image_stitching_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    def importable(mod):
        try:
            __import__(mod)
            return True
        except ImportError:
            return False

    # the knife-edge escalation grays with cv2.cvtColor; the port's gray is
    # OpenCV 5's 15-bit fixed point — do they agree on this machine?
    cv2_gray = None
    if importable("cv2"):
        import cv2

        from vfx_image_stitching_tpu_torch.ops.color import bgr_to_gray_u8_np

        bgr = np.random.default_rng(0).integers(0, 256, (256, 256, 3)).astype(np.uint8)
        cv2_gray = bool(np.array_equal(cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY),
                                       bgr_to_gray_u8_np(bgr)))
    emit(dict(phase="identity", card=smi, torch=torch.__version__,
              cuda=torch.version.cuda, cv2=importable("cv2"),
              PIL=importable("PIL"), cv2_gray_matches_port=cv2_gray))

    t0 = time.time()
    K._library()
    blend.LIBRARY.load()
    TH.LIBRARY.load()
    emit(dict(phase="build", seconds=time.time() - t0,
              ptxas=[ln for log in cuda_build.BUILD_LOGS.values()
                     for ln in log.splitlines() if "Used" in ln]))

    dev = torch.device("cuda")
    t_start = time.time()
    with tempfile.TemporaryDirectory() as work:
        folder = os.path.join(work, "chain18")
        os.makedirs(folder)
        synth_chain(folder, N_IMAGES, IMG_H, IMG_W, SEED, FOCAL, **SCENE)
        inp = path_inputs(folder, dev)
        rows, k5_launches = check_kernels(inp)
        emit(descriptor_octaves(inp["calls"]))
        emit(kernel_arith(inp["calls"]))
        emit(descriptor_ab(inp["calls"]))
        p_rows, p_loc_launches = probe_localize(dev)
        p1_row, p_desc_launches = probe_desc(inp["calls"], dev)
        rows += [p1_row, *p_rows]
        e2e = end_to_end(work, folder)
        batch = batch_vmap(folder, e2e)
        harris = harris_stitch(folder, smi)
        refs = compose_routes(folder)
        fold = pano18_fold()
        emit(dict(phase="pano18_fold", **fold))
        resp = pano18_harris_response()
        emit(dict(phase="harris_response", **resp))
        stage_api(folder, work, refs)
        multi_out, folders, sift_many = multi(work, folder)
        mesh(folder, multi_out, folders, sift_many)
        mvmap = mesh_vmap(folders)
        api_surface(folder, refs, inp["counts"])
        chain4, chain4_ref = e2e.pop("chain4")
        cli(chain4, work, chain4_ref)
        viz(folder, work)
        probe_fused(dev)
        ratio_match(folder)
    by_path = dict(stitch=e2e["launches"], orient_v1=e2e["orient_v1"]["launches"],
                   harris=harris["launches"],
                   descriptor_histogram=k5_launches,
                   probe_localize=p_loc_launches, probe_desc=p_desc_launches)
    for row in rows:
        row["launches"] = by_path[KERNEL_PATH[row["name"]]][row["name"]]
        row.pop("shape")
        if row["name"] in batch["kernels"]:
            # the batched schedule's launch: every image's rows at once
            row["batch"] = dict(
                {k: v for k, v in batch["kernels"][row["name"]].items()
                 if k in ("rows", "images", "ms", "timed_by", "plain_ms",
                          "bound_ms", "bound_by", "library_ms", "max_abs_err")},
                launches=batch["stitch"]["launches"]["vmap"].get(row["name"], 0))
        if row["name"] in mvmap["kernels"]:
            # the same on the 36 images of two panoramas (mesh_vmap)
            row["batch_36"] = {
                k: v for k, v in mvmap["kernels"][row["name"]].items()
                if k in ("rows", "images", "ms", "timed_by", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "max_abs_err")}
    rows.append(fold_row(harris, fold))
    rows.append(harris_response_row(harris, resp))
    emit(dict(phase="total", seconds=time.time() - t_start))
    print(smi)
    emit(dict(kernels=rows))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
