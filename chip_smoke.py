"""Chip smoke run of the PyTorch port: the SIFT panorama stitch on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each: card identity; kernel build; the SIFT
extraction of an 18-image 384x512 synthetic chain with its per-octave
stage counts beside the capacities and the audited maxima; each CUDA
kernel against its plain PyTorch version on the inputs that extraction
gave it at octave 0 of the first image; then the end-to-end stitch of the
chain (one warm-up, timed runs, launch counts, a profiled run, a
CUDA-vs-CPU check on the first four images).  The line before the last is
the kernel table; the last line is ``{"ok": true, "device": {...}}``.  Any
failed check raises, and the script then exits non-zero; without CUDA it
exits non-zero at once.

The synthetic chain helpers (:func:`make_scene`, :func:`synth_chain`) are
numpy-only and also feed the CPU tests.
"""

from __future__ import annotations

import os

import numpy as np


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel-center bilinear resize of an (h, w, c) uint8 image."""
    def axis(n_out, n_in):
        c = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        c = np.clip(c, 0, n_in - 1)
        i0 = np.floor(c).astype(np.int64)
        i1 = np.minimum(i0 + 1, n_in - 1)
        return i0, i1, c - i0

    y0, y1, fy = axis(out_h, img.shape[0])
    x0, x1, fx = axis(out_w, img.shape[1])
    f = img.astype(np.float64)
    rows = f[y0] * (1 - fy)[:, None, None] + f[y1] * fy[:, None, None]
    out = rows[:, x0] * (1 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]
    return np.rint(out).astype(np.uint8)


def make_scene(h: int, total_w: int, seed: int, block_px: int = 250,
               block_size: tuple = (4, 12)) -> np.ndarray:
    """Photo-like BGR scene: smooth background + high-contrast blocks.

    Coarse noise on a 16-pixel grid, bilinear-upsampled, gives the
    shading; one sprinkled rectangle per ``block_px`` pixels, its sides
    drawn from ``block_size`` (low inclusive, high exclusive), gives the
    corners and blobs SIFT finds.  Small blocks feed octave 0, larger
    ones octaves 1 and 2.
    """
    rng = np.random.default_rng(seed)
    coarse = rng.integers(
        30, 226, ((h + 15) // 16 + 1, (total_w + 15) // 16 + 1, 3)
    ).astype(np.uint8)
    scene = _bilinear_resize(coarse, h, total_w)
    for _ in range(max(20, h * total_w // block_px)):
        y0 = int(rng.integers(0, h - 12))
        x0 = int(rng.integers(0, total_w - 12))
        hh = int(rng.integers(*block_size))
        ww = int(rng.integers(*block_size))
        scene[y0:y0 + hh, x0:x0 + ww] = rng.integers(0, 256, (3,)).astype(np.uint8)
    return scene


def write_ppm(path: str, bgr: np.ndarray) -> None:
    """Binary PPM (P6) of a BGR uint8 image."""
    h, w = bgr.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(bgr[..., ::-1]).tobytes())


def synth_chain(folder: str, n: int, h: int, w: int, seed: int,
                focal: float, overlap_frac: float = 0.65,
                **scene_kw) -> None:
    """Write an n-image chain of (h, w) crops of one scene + pano.txt.

    Crops run right-to-left so pairwise dx is negative, the pan direction
    of the reference datasets.  The images are binary PPM; their names end
    in ``.png.ppm`` because the reference pano.txt parser only takes lines
    naming ``.jpg``/``.png`` files, and every decoder reads the format from
    the file's content.
    """
    step = w - int(w * overlap_frac)
    scene = make_scene(h, w + (n - 1) * step + 8, seed, **scene_kw)
    lines = []
    for i in range(n):
        x0 = (n - 1 - i) * step
        fn = f"im{i:02d}.png.ppm"
        write_ppm(os.path.join(folder, fn), scene[:, x0:x0 + w])
        lines += [fn, f"{focal + i * 0.37:.3f}"]
    with open(os.path.join(folder, "pano.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# the run on the card
# ---------------------------------------------------------------------------

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12    # f32 outside the tensor cores
N_IMAGES, IMG_H, IMG_W, FOCAL, SEED = 18, 384, 512, 700.0, 7
# one small block per 45 px: octave-0 density at the audited level
SCENE = dict(block_px=45, block_size=(2, 5))
# per-octave maxima of the capacity audit over the four reference photo
# sets (config.SiftCapacities), octaves 0-3, and the final keypoints
AUDITED = dict(cand=(2435, 738, 211, 67), loc=(1478, 430, 122, 50),
               oriented=(1790, 466, 154, 67), desc_big=(518, 148, 53, 20),
               final=1900)
KERNEL_SITES = (
    # (module that calls the wrapper, wrapper name)
    ("vfx_image_stitching_tpu_torch.models.sift.kernels",
     "localize_newton_resident"),
    ("vfx_image_stitching_tpu_torch.models.sift.orientation",
     "orientation_histograms"),
    ("vfx_image_stitching_tpu_torch.models.sift.descriptor",
     "pair_window_gather"),
)


def emit(obj) -> None:
    import json

    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the CUDA kernels it launches,
    summed from ``torch.profiler`` over ``reps`` calls.  (CUDA events
    around a call would also count the wrapper's host work, which at
    these sizes is longer than the kernels.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / reps / 1e3


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / H100_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def path_inputs(folder: str, dev) -> dict:
    """Extract every image of the chain as the stitch does (decode,
    cylindrical projection, gray, SIFT), recording the arguments of the
    first octave-0 call of each kernel wrapper on image 0: the kernels
    are then checked and timed on exactly the tensors the path gives them
    (live-chunk rows, invalid ones included).  Also returns the chain's
    per-octave stage counts."""
    import importlib

    import torch

    from vfx_image_stitching_tpu_torch.config import StitchConfig
    from vfx_image_stitching_tpu_torch.geometry.cylindrical import (
        cylindrical_project_batch,
    )
    from vfx_image_stitching_tpu_torch.io import load_dataset, stack_dataset
    from vfx_image_stitching_tpu_torch.models.sift.extract import (
        sift_batch_with_stats,
    )
    from vfx_image_stitching_tpu_torch.ops.color import bgr_to_gray_f32

    images, focals, _paths = load_dataset(folder)
    batch, _valid = stack_dataset(images)
    gray = bgr_to_gray_f32(cylindrical_project_batch(
        torch.as_tensor(batch).to(dev), [float(f) for f in focals]))
    octave0 = (2 * gray.shape[-2], 2 * gray.shape[-1])
    cfg = StitchConfig().sift
    calls = {}
    saved = [(importlib.import_module(m), n) for m, n in KERNEL_SITES]
    saved = [(mod, n, getattr(mod, n)) for mod, n in saved]

    def recorder(name, fn):
        def call(*args):
            key = (name, args[5]) if name == "pair_window_gather" else name
            if key not in calls and tuple(args[0].shape[-2:]) == octave0:
                calls[key] = args
            return fn(*args)
        return call

    try:
        for mod, n, fn in saved:
            setattr(mod, n, recorder(n, fn))
        _xy, _d, _v, _meta, stats = sift_batch_with_stats(gray, cfg)
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
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
    return dict(cfg=cfg, calls=calls)


def newton_iterations(dog, layer, y, x, cv, cfg) -> int:
    """Newton steps this run's candidates take (each reads one cube)."""
    from vfx_image_stitching_tpu_torch.models.sift.localize import (
        _init_state, newton_step,
    )

    st = _init_state(layer, y, x)
    st["rejected"] = ~cv
    total = 0
    for _ in range(cfg.max_localize_iters):
        total += int((~(st["converged"] | st["rejected"])).sum())
        st = newton_step(dog, st, cfg)
    return total


def check_kernels(inp: dict) -> list:
    """Each kernel against its plain version on the card, with times, on
    the inputs the path gave it at octave 0 of image 0."""
    import torch

    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    cfg, calls = inp["cfg"], inp["calls"]
    rows = []

    # K1: integer lanes bit-exact
    k1_args = calls["localize_newton_resident"]
    dog, layer, y, x, cv = k1_args[:5]
    got = K.localize_newton_resident(*k1_args)
    want = K.localize_newton_plain(*k1_args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            f"K1 integer lanes differ on {int((got != want).any(1).sum())} rows")
    n_k = layer.shape[0]
    iters = newton_iterations(dog, layer, y, x, cv, cfg)
    b, by = bound_ms(n_k * 4 * 4 + n_k * 8 * 4 + iters * 27 * 4, iters * 122)
    rows.append(dict(
        name="localize_newton_resident", route="cuda",
        source="vfx_image_stitching_tpu_torch/csrc/sift_kernels.cu",
        replaces="vfx_image_stitching_tpu/models/sift/pallas_kernels.py:814",
        launches=0, max_abs_err=0.0,
        ms=cuda_ms(lambda: K.localize_newton_resident(*k1_args)),
        plain_ms=cuda_ms(lambda: K.localize_newton_plain(*k1_args), reps=5),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=dict(dog=list(dog.shape), candidates=n_k,
                   valid=int(cv.sum()), newton_steps=iters),
    ))
    emit(dict(phase="kernel", **rows[-1]))

    # K2: rtol 2e-5, atol 2e-3
    k2_args = calls["orientation_histograms"]
    mag, ang, lyr, cy, cx, radius, wf, valid, half, nb = k2_args
    got = K.orientation_histograms(*k2_args)
    want = K.orientation_histograms_plain(*k2_args)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-3)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    h, w = mag.shape[-2:]
    s = 2 * half + 1
    rows_w = torch.arange(s, device=mag.device)
    sy = (cy - half).clamp(0, max(h, s) - s)
    sx = (cx - half).clamp(0, max(w, s) - s)
    rr = sy[:, None] + rows_w
    cc = sx[:, None] + rows_w
    in_y = ((rr - cy[:, None]).abs() <= radius[:, None]) & (rr >= 1) & (rr <= h - 2)
    in_x = ((cc - cx[:, None]).abs() <= radius[:, None]) & (cc >= 1) & (cc <= w - 2)
    pixels = int((in_y.sum(1) * in_x.sum(1) * valid).sum())
    n_k = lyr.shape[0]
    b, by = bound_ms(pixels * 8 + n_k * 6 * 4 + n_k * nb * 4, pixels * 10)
    rows.append(dict(
        name="orientation_histograms", route="cuda",
        source="vfx_image_stitching_tpu_torch/csrc/sift_kernels.cu",
        replaces="vfx_image_stitching_tpu/models/sift/pallas_kernels.py:161",
        launches=0, max_abs_err=err,
        ms=cuda_ms(lambda: K.orientation_histograms(*k2_args)),
        plain_ms=cuda_ms(lambda: K.orientation_histograms_plain(*k2_args), reps=5),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=dict(stack=list(mag.shape), rows=n_k, valid=int(valid.sum()),
                   window=s, masked_pixels=pixels),
    ))
    emit(dict(phase="kernel", **rows[-1]))

    # K3: bit-exact, both window sizes, summed
    k3 = {}
    for (_name, half_cap), args in sorted(
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
        k3[f"{s}x{s}"] = dict(
            rows=int(wl.shape[0]),
            ms=cuda_ms(lambda: K.pair_window_gather(*args)),
            plain_ms=cuda_ms(lambda: K.pair_window_gather_plain(*args), reps=5),
            library_ms=cuda_ms(lambda: ma[l_idx, r_idx[:, :, None],
                                          c_idx[:, None, :]]),
            bytes=4 * int(wl.shape[0]) * s * s * 4 + int(wl.shape[0]) * 3 * 4,
        )
    if len(k3) != 2:
        raise AssertionError(f"K3 ran for {sorted(k3)} windows, not both buckets")
    b, by = bound_ms(sum(v["bytes"] for v in k3.values()), 0.0)
    rows.append(dict(
        name="pair_window_gather", route="cuda",
        source="vfx_image_stitching_tpu_torch/csrc/sift_kernels.cu",
        replaces="vfx_image_stitching_tpu/models/sift/pallas_kernels.py:572",
        launches=0, max_abs_err=0.0,
        ms=sum(v["ms"] for v in k3.values()),
        plain_ms=sum(v["plain_ms"] for v in k3.values()),
        bound_ms=b, bound_by=by,
        library_ms=sum(v["library_ms"] for v in k3.values()),
        shape=dict(buckets=k3, stack=list(mag.shape)),
    ))
    emit(dict(phase="kernel", **rows[-1]))
    return rows


def run_stitch(folder: str, device: str):
    from vfx_image_stitching_tpu_torch.pipeline.stitch import stitch_panorama

    return stitch_panorama(folder, backend="sift", crop_margin=15,
                           device=device)


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


def profile_stitch(folder: str, median_s: float) -> dict:
    """One stitch under ``torch.profiler``: the device's busy time, its
    idle share of the unprofiled median wall (the profiler slows the host
    side, so its own wall is reported beside it), and the kernels that
    take most of the busy time."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run_stitch(folder, "cuda")
        wall_s = time.time() - t0
    dev_events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    if not dev_events:
        raise AssertionError("the profiler recorded no device kernel")
    busy_s = sum(e.self_device_time_total for e in dev_events) / 1e6
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]
    return dict(
        phase="profile", device_busy_s=busy_s,
        unprofiled_median_s=median_s,
        device_idle_share=1 - busy_s / median_s,
        profiled_wall_s=wall_s,
        device_idle_share_of_profiled_wall=1 - busy_s / wall_s,
        device_kernels=sum(e.count for e in dev_events),
        top=[dict(name=e.key[:80], ms=e.self_device_time_total / 1e3,
                  count=e.count) for e in top],
    )


def end_to_end(work: str, folder: str, timed_runs: int = 3) -> dict:
    import time

    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    K.reset_launch_counts()
    t0 = time.time()
    res = run_stitch(folder, "cuda")
    first_s = time.time() - t0
    launches = dict(K.LAUNCHES)
    check_result(res, N_IMAGES)
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")

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
                  if k not in ("esc_n_pairs", "esc_n_rows", "passes")},
        escalated_pairs=int(res.timings["esc_n_pairs"]),
        escalated_rows=int(res.timings["esc_n_rows"]),
        passes=int(res.timings["passes"]),
        launches=launches, panorama=list(res.panorama.shape),
        shifts=res.shifts,
    )
    emit(out)

    emit(profile_stitch(folder, out["median_s"]))

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

    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

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
    emit(dict(phase="build", seconds=time.time() - t0,
              ptxas=[ln for ln in K.BUILD_LOG.splitlines() if "Used" in ln]))

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as work:
        folder = os.path.join(work, "chain18")
        os.makedirs(folder)
        synth_chain(folder, N_IMAGES, IMG_H, IMG_W, SEED, FOCAL, **SCENE)
        rows = check_kernels(path_inputs(folder, dev))
        e2e = end_to_end(work, folder)
    for row in rows:
        row["launches"] = e2e["launches"][row["name"]]
        row.pop("shape")
    print(smi)
    emit(dict(kernels=rows))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
