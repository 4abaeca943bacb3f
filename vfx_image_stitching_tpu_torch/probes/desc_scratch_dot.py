"""Probe: the small bucket's descriptor histogram as two-hot matrix products
on the tensor cores (P1), against its plain version and a float64 oracle.

Counterpart of ``scripts/probe_desc_scratch_dot.py``.  Run from the
repository root::

    python -m vfx_image_stitching_tpu_torch.probes.desc_scratch_dot cpu
    python -m vfx_image_stitching_tpu_torch.probes.desc_scratch_dot chip

``cpu``: the plain version on K=24 keypoints of 3x200x256 fields against
the oracle.  ``chip`` (needs a CUDA card): the kernel on K=512 keypoints of
3x768x1024 fields in both precisions, against the plain version (maximum
error relative to the plain maximum), repeated launches bit-identical,
device ms per call and us per keypoint (``utils.timing.cuda_ms``).
One JSON line; nothing is written.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from vfx_image_stitching_tpu_torch.probes.kernels import (
    P1_HALF as HALF,
    P1_NB as NB,
    P1_S as S,
    P1_WW as WW,
    desc_scratch_dot,
    desc_scratch_dot_plain,
)

CHIP_SHAPE = (512, 3, 768, 1024)   # k, n_l, hs, ws: the probe's chip size
CPU_SHAPE = (24, 3, 200, 256)      # the probe's cpu size
SEED = 7
# the probe's acceptance limit (scripts/probe_desc_scratch_dot.py:310);
# 3xTF32 is held to 1e-5
TOL = {False: 2e-3, True: 1e-5}


def oracle(mag, ang, layer, py, px, half_w, cos_a, sin_a, hw, angle, valid,
           img_h, img_w):
    """Plain-NumPy trilinear histograms, the same formulas with float64
    intermediates (a copy of the probe's ``oracle``).  (K, 16, 8)."""
    k = layer.shape[0]
    out = np.zeros((k, 2 * NB, NB), np.float64)
    hs, ws = mag.shape[-2:]
    for i in range(k):
        if not valid[i]:
            continue
        sy = int(np.clip(py[i] - HALF, 0, max(hs, S) - S))
        sx = int(np.clip(px[i] - HALF, 0, max(ws, S) - S))
        for rr in range(S):
            for cc in range(S):
                r_abs, c_abs = sy + rr, sx + cc
                if not (0 < r_abs < img_h - 1 and 0 < c_abs < img_w - 1):
                    continue
                ysv, xsv = r_abs - py[i], c_abs - px[i]
                if abs(ysv) > half_w[i] or abs(xsv) > half_w[i]:
                    continue
                rro = xsv * sin_a[i] + ysv * cos_a[i]
                cro = xsv * cos_a[i] - ysv * sin_a[i]
                rb = rro / hw[i] + 1.5
                cb = cro / hw[i] + 1.5
                if not (-1.0 < rb < WW and -1.0 < cb < WW):
                    continue
                if r_abs >= hs or c_abs >= ws:
                    continue
                wgt = np.exp(-0.125 * ((rro / hw[i]) ** 2 + (cro / hw[i]) ** 2))
                wmv = wgt * mag[layer[i], r_abs, c_abs]
                ob = np.mod((ang[layer[i], r_abs, c_abs] - angle[i])
                            * (NB / 360.0), NB)
                r0b, c0b, o0b = np.floor(rb), np.floor(cb), np.floor(ob)
                rfv, cfv, ofv = rb - r0b, cb - c0b, ob - o0b
                c1v = wmv * rfv
                rav = int(np.clip(r0b + 1, 0, WW + 1))
                cav = int(np.clip(c0b + 1, 0, WW + 1))
                for prow, wr in ((rav, wmv - c1v), (rav + 1, c1v)):
                    if not 1 <= prow <= WW:
                        continue
                    for pcol, wc in ((cav, 1.0 - cfv), (cav + 1, cfv)):
                        if not 1 <= pcol <= WW:
                            continue
                        cell = (prow - 1) * WW + (pcol - 1)
                        out[i, cell, int(o0b) % NB] += wr * wc * (1.0 - ofv)
                        out[i, cell, (int(o0b) + 1) % NB] += wr * wc * ofv
    return out


def make_inputs(rng, k, n_l, hs, ws):
    """The probe's random fields and keypoints (numpy); the last two rows
    are invalid."""
    mag = rng.random((n_l, hs, ws), np.float32) * 100.0
    ang = rng.random((n_l, hs, ws), np.float32) * 360.0
    layer = rng.integers(0, n_l, k)
    py = rng.integers(5, hs - 5, k)
    px = rng.integers(5, ws - 5, k)
    half_w = rng.integers(19, HALF + 1, k)
    theta = rng.random(k) * 2 * np.pi
    hw = (half_w / (np.sqrt(2) * 2.5)).astype(np.float32)
    angle = (rng.random(k) * 360.0).astype(np.float32)
    valid = np.ones(k, np.int64)
    valid[-2:] = 0
    return (mag, ang, layer, py, px, half_w,
            np.cos(theta).astype(np.float32), np.sin(theta).astype(np.float32),
            hw, angle, valid)


def to_torch(args, device):
    """``make_inputs``' arrays as the wrapper's tensors: int32 indices,
    f32 fields and geometry, a bool mask."""
    import torch

    mag, ang, layer, py, px, half_w, cos_a, sin_a, hw, angle, valid = args
    ints = [torch.as_tensor(np.asarray(a, np.int32), device=device)
            for a in (layer, py, px, half_w)]
    floats = [torch.as_tensor(np.asarray(a, np.float32), device=device)
              for a in (mag, ang, cos_a, sin_a, hw, angle)]
    return (floats[0], floats[1], *ints, *floats[2:],
            torch.as_tensor(np.asarray(valid) != 0, device=device))


def check_kernel(targs, img_h: int, img_w: int, timer=None) -> dict:
    """The kernel in both precisions on CUDA tensors ``targs``: maximum
    error against the plain version, absolute and relative to the plain
    maximum (held to :data:`TOL`), repeated launches bit-identical, and
    with ``timer`` (``fn -> ms``) the device ms per call and us per
    keypoint."""
    import torch

    want = desc_scratch_dot_plain(*targs, img_h, img_w)
    scale = float(want.abs().max()) or 1.0
    k = targs[2].shape[0]
    out = dict(k=k, valid=int(targs[-1].sum()), plain_max=scale)
    for name, highest in (("default", False), ("highest", True)):
        got = desc_scratch_dot(*targs, img_h, img_w, highest=highest)
        again = desc_scratch_dot(*targs, img_h, img_w, highest=highest)
        torch.cuda.synchronize()
        abs_err = float((got - want).abs().max())
        err = abs_err / scale
        out[f"{name}_max_abs_err"] = abs_err
        out[f"{name}_max_rel_err"] = err
        out[f"{name}_repeat_bit_identical"] = bool(torch.equal(got, again))
        if err > TOL[highest] or not torch.equal(got, again):
            raise AssertionError(f"desc_scratch_dot ({name}): {out}")
        if timer is not None:
            ms = timer(lambda: desc_scratch_dot(*targs, img_h, img_w, highest=highest))
            out[f"{name}_ms"] = ms
            out[f"{name}_us_per_kp"] = ms / k * 1e3
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "chip"
    rng = np.random.default_rng(SEED)
    if mode == "cpu":
        import torch

        k, n_l, hs, ws = CPU_SHAPE
        args = make_inputs(rng, k, n_l, hs, ws)
        got = desc_scratch_dot(*to_torch(args, "cpu"), hs, ws).numpy()
        want = oracle(*args, img_h=hs, img_w=ws)
        err = float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))
        print(json.dumps({"mode": "cpu", "device": "cpu", "k": k,
                          "torch": torch.__version__, "max_rel_err": err}))
        return 0 if err < TOL[False] else 1
    if mode != "chip":
        raise SystemExit(f"usage: desc_scratch_dot [cpu|chip], got {mode!r}")
    import torch

    from vfx_image_stitching_tpu_torch.utils.timing import cuda_ms

    if not torch.cuda.is_available():
        raise SystemExit("desc_scratch_dot chip: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    k, n_l, hs, ws = CHIP_SHAPE
    res = check_kernel(to_torch(make_inputs(rng, k, n_l, hs, ws), "cuda"),
                       hs, ws, timer=cuda_ms)
    print(json.dumps({"mode": "chip", "device": torch.cuda.get_device_name(0),
                      **res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
