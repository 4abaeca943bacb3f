"""Batched subpixel localization via masked Newton iterations.

Parity with ``localize_extremum_via_quadratic_fit`` (sift_impl.py:169-211)
including its quirks:
  * at most 5 iterations; convergence = all |update| < 0.5 *before* moving;
  * a candidate that exhausts the iterations without converging is still
    accepted, with (x, y, layer) from its *last move* but cube/grad/update
    from the last *compute*;
  * moves are banker's-rounded; a move out of bounds rejects the point;
  * contrast then 2x2-Hessian edge tests on the stored state;
  * ``kp.octave`` packs octave + layer<<8 + round((offset+0.5)*255)<<16.

Every lane is a separate (K,) tensor and the cube is (27, K), as in the
JAX package, so each float is produced by the same sequence of single
IEEE operations (no fused multiply-adds) on every device.

The reference solves with ``np.linalg.lstsq``; here a closed-form
adjugate solve (a zero-determinant candidate gets update=0 and dies in
the contrast test).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vfx_image_stitching_tpu_torch.config import SiftConfig
from vfx_image_stitching_tpu_torch.models.sift.chunking import (
    batch_rows,
    chunk_size,
    finish_rows,
    live_rows,
)
from vfx_image_stitching_tpu_torch.utils.profiling import count_h2d


class Localized(NamedTuple):
    x: torch.Tensor          # i32 final column
    y: torch.Tensor          # i32 final row
    layer: torch.Tensor      # i32 final layer in [1, num_intervals]
    pt_x: torch.Tensor       # f32 keypoint coords at base-image scale
    pt_y: torch.Tensor
    size: torch.Tensor       # f32
    response: torch.Tensor   # f32
    octave_packed: torch.Tensor  # i32
    valid: torch.Tensor      # bool
    # last-COMPUTE cell of the Newton loop: where the final cube/grad/
    # Hessian were evaluated (differs from (x, y, layer) for the
    # reference's accepted-non-converged quirk); the strict host
    # re-derivation (models/sift/strict.py) needs both.
    jx: torch.Tensor         # i32
    jy: torch.Tensor         # i32
    jl: torch.Tensor         # i32


# float lanes of one Newton compute, in the TPU kernel's lane order
FLOAT_LANES = ("ux", "uy", "us", "gx", "gy", "gs", "center",
               "dxx", "dyy", "dss", "dxy", "dxs", "dys")
# integer lanes: final cell, last-compute cell, converged, rejected
INT_LANES = ("x", "y", "l", "cx", "cy", "cl", "converged", "rejected")


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device.

    PyTorch's CUDA kernels divide by a Python number by multiplying with
    its reciprocal, which can differ from the division in the last bit;
    dividing by a 0-dim tensor on the same device divides.
    """
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _cube_offsets(h: int, w: int, device) -> torch.Tensor:
    hw = h * w
    offs = np.array(
        [dl * hw + dy * w + dx
         for dl in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
        dtype=np.int64,
    )
    count_h2d(offs.nbytes)
    return torch.as_tensor(offs, device=device)


def _cube_gather(dog: torch.Tensor, l: torch.Tensor, y: torch.Tensor,
                 x: torch.Tensor, img: torch.Tensor | None = None) -> torch.Tensor:
    """(27, K) cube around (l, y, x) from the (L, H, W) DoG, scaled /255;
    from an (N, L, H, W) batch of stacks, image ``img`` of each row.

    Filler rows (``valid=False``) may point outside the stack; their
    indices are clamped (their values are never consumed).
    """
    h, w = dog.shape[-2:]
    flat = dog.reshape(-1)
    plane = l.to(torch.int64)
    if img is not None:
        plane = plane + img.to(torch.int64) * dog.shape[-3]
    center = (plane * h + y) * w + x
    idx = (center[None, :] + _cube_offsets(h, w, dog.device)[:, None])
    cube = flat[idx.clamp_(0, flat.shape[0] - 1)]
    return _div(cube.to(torch.float32), 255.0)


def _derivatives(cube: torch.Tensor):
    """Gradient (3 lanes) and Hessian (6 unique lanes) from a (27, K) cube.

    Cube index order is (dl, dy, dx) row-major: flat = (dl+1)*9 + (dy+1)*3
    + (dx+1).  Central differences per sift_impl.py:217-240.
    """
    def c(dl, dy, dx):
        return cube[(dl + 1) * 9 + (dy + 1) * 3 + (dx + 1)]

    gx = 0.5 * (c(0, 0, 1) - c(0, 0, -1))
    gy = 0.5 * (c(0, 1, 0) - c(0, -1, 0))
    gs = 0.5 * (c(1, 0, 0) - c(-1, 0, 0))
    v = c(0, 0, 0)
    dxx = c(0, 0, 1) - 2 * v + c(0, 0, -1)
    dyy = c(0, 1, 0) - 2 * v + c(0, -1, 0)
    dss = c(1, 0, 0) - 2 * v + c(-1, 0, 0)
    dxy = 0.25 * (c(0, 1, 1) - c(0, 1, -1) - c(0, -1, 1) + c(0, -1, -1))
    dxs = 0.25 * (c(1, 0, 1) - c(1, 0, -1) - c(-1, 0, 1) + c(-1, 0, -1))
    dys = 0.25 * (c(1, 1, 0) - c(1, -1, 0) - c(-1, 1, 0) + c(-1, -1, 0))
    return (gx, gy, gs), (dxx, dyy, dss, dxy, dxs, dys), v


def _solve3(h, g):
    """Closed-form symmetric 3x3 solve; returns the Newton update
    ``-H^-1 g`` with H = [[dxx, dxy, dxs], [dxy, dyy, dys], [dxs, dys, dss]]."""
    (dxx, dyy, dss, dxy, dxs, dys) = h
    (gx, gy, gs) = g
    c00 = dyy * dss - dys * dys
    c01 = dys * dxs - dxy * dss
    c02 = dxy * dys - dyy * dxs
    det = dxx * c00 + dxy * c01 + dxs * c02
    c11 = dxx * dss - dxs * dxs
    c12 = dxy * dxs - dxx * dys
    c22 = dxx * dyy - dxy * dxy
    ux = c00 * gx + c01 * gy + c02 * gs
    uy = c01 * gx + c11 * gy + c12 * gs
    us = c02 * gx + c12 * gy + c22 * gs
    ok = torch.abs(det) > 1e-30
    safe = torch.where(ok, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    return (
        torch.where(ok, -ux / safe, zero),
        torch.where(ok, -uy / safe, zero),
        torch.where(ok, -us / safe, zero),
    )


def newton_step(dog: torch.Tensor, st: dict, cfg: SiftConfig,
                img: torch.Tensor | None = None) -> dict:
    """One masked Newton iteration (the JAX package's ``_make_newton_body``)
    over a state dict of (K,) lanes: compute -> store -> converge-check ->
    move, for rows not yet converged or rejected.  With an (N, L, H, W)
    batch of stacks, row i walks image ``img[i]``'s stack (its layer
    bounds are that stack's, so no walk leaves its image)."""
    h, w = dog.shape[-2:]
    border = cfg.image_border_width
    active = ~(st["converged"] | st["rejected"])
    cube = _cube_gather(dog, st["l"], st["y"], st["x"], img)
    (gx, gy, gs), hess, center = _derivatives(cube)
    ux, uy, us = _solve3(hess, (gx, gy, gs))
    (dxx, dyy, dss, dxy, dxs, dys) = hess

    out = dict(st)
    for name, new in [
        ("ux", ux), ("uy", uy), ("us", us),
        ("gx", gx), ("gy", gy), ("gs", gs),
        ("dxx", dxx), ("dyy", dyy), ("dss", dss),
        ("dxy", dxy), ("dxs", dxs), ("dys", dys),
        ("center", center),
    ]:
        out[name] = torch.where(active, new, st[name])

    conv_now = (torch.abs(ux) < 0.5) & (torch.abs(uy) < 0.5) & (torch.abs(us) < 0.5)
    out["converged"] = st["converged"] | (active & conv_now)
    out["cx"] = torch.where(active, st["x"], st["cx"])
    out["cy"] = torch.where(active, st["y"], st["cy"])
    out["cl"] = torch.where(active, st["l"], st["cl"])

    moving = active & ~conv_now
    nx = st["x"] + torch.round(ux).to(torch.int32)
    ny = st["y"] + torch.round(uy).to(torch.int32)
    nl = st["l"] + torch.round(us).to(torch.int32)
    oob = (
        (ny < border) | (ny >= h - border)
        | (nx < border) | (nx >= w - border)
        | (nl < 1) | (nl > cfg.num_intervals)
    )
    out["rejected"] = st["rejected"] | (moving & oob)
    out["x"] = torch.where(moving, nx.clamp(1, w - 2), st["x"])
    out["y"] = torch.where(moving, ny.clamp(1, h - 2), st["y"])
    out["l"] = torch.where(moving, nl.clamp(1, cfg.num_intervals), st["l"])
    return out


def _init_state(layer: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> dict:
    """Fresh Newton state (a dict of (K,) lanes) at integer candidates."""
    zeros = torch.zeros(layer.shape, dtype=torch.float32, device=layer.device)
    falses = torch.zeros(layer.shape, dtype=torch.bool, device=layer.device)
    st = dict(x=x, y=y, l=layer, cx=x, cy=y, cl=layer,
              converged=falses, rejected=falses)
    for name in ("ux", "uy", "us", "gx", "gy", "gs", "dxx", "dyy", "dss",
                 "dxy", "dxs", "dys", "center"):
        st[name] = zeros
    return st


def state_from_lanes(outi: torch.Tensor, outf: torch.Tensor) -> dict:
    """A Newton state dict from a walk's (K, 8) int32 and (K, 13) f32
    lanes (:data:`INT_LANES`, :data:`FLOAT_LANES`)."""
    st = {n: outi[:, j] for j, n in enumerate(INT_LANES)}
    st["converged"] = st["converged"] != 0
    st["rejected"] = st["rejected"] != 0
    st.update({n: outf[:, j] for j, n in enumerate(FLOAT_LANES)})
    return st


def _finalize_localized(
    st: dict, cand_valid: torch.Tensor, octave: int, cfg: SiftConfig
) -> Localized:
    """Accept tests + output packing from a finished Newton state."""
    val = st["center"] + 0.5 * (
        st["gx"] * st["ux"] + st["gy"] * st["uy"] + st["gs"] * st["us"]
    )
    contrast_ok = torch.abs(val) * cfg.num_intervals >= cfg.contrast_threshold

    tr = st["dxx"] + st["dyy"]
    det2 = st["dxx"] * st["dyy"] - st["dxy"] * st["dxy"]
    er = cfg.eigen_ratio
    edge_ok = (det2 > 0) & (er * tr * tr < ((er + 1.0) ** 2) * det2)

    valid = cand_valid & ~st["rejected"] & contrast_ok & edge_ok

    xs, ys, ls = st["x"], st["y"], st["l"]
    scale_o = float(2.0**octave)
    pt_x = (xs.to(torch.float32) + st["ux"]) * scale_o
    pt_y = (ys.to(torch.float32) + st["uy"]) * scale_o
    octave_packed = (
        octave
        + ls * 256
        + torch.round((st["us"] + 0.5) * 255.0).to(torch.int32) * 65536
    ).to(torch.int32)
    size = (
        cfg.sigma
        * torch.exp2(_div(ls.to(torch.float32) + st["us"], cfg.num_intervals))
        * (2.0 ** (octave + 1))
    )
    return Localized(
        x=xs, y=ys, layer=ls,
        pt_x=pt_x, pt_y=pt_y, size=size,
        response=torch.abs(val), octave_packed=octave_packed, valid=valid,
        jx=st["cx"], jy=st["cy"], jl=st["cl"],
    )


def localize_candidates_chunked(
    dog: torch.Tensor,
    layer: torch.Tensor,
    y: torch.Tensor,
    x: torch.Tensor,
    cand_valid: torch.Tensor,
    octave: int,
    cfg: SiftConfig,
    chunk: int = 512,
) -> Localized:
    """The masked ``max_localize_iters``-step Newton loop over the live
    leading candidate chunks (rows are independent, so all live chunks
    run as one batch); dead chunks come out as zero rows.  An (N, 5, H,
    W) batch of stacks takes (N, K) candidates and gives (N, K) rows."""
    k = layer.shape[-1]
    n_rows, own = live_rows(cand_valid, chunk_size(k, chunk))
    live = cand_valid[..., :n_rows]
    (l, yy, xx), img = batch_rows(dog, layer[..., :n_rows], y[..., :n_rows],
                                  x[..., :n_rows])
    st = _init_state(l, yy, xx)
    for _ in range(cfg.max_localize_iters):
        st = newton_step(dog, st, cfg, img)
    st = {name: v.reshape(live.shape) for name, v in st.items()}
    loc = _finalize_localized(st, live, octave, cfg)
    return finish_rows(loc, own, k)


def compact_localized(loc: Localized, out_capacity: int) -> Localized:
    """Keep valid candidates (original order) in ``out_capacity`` slots.

    Relative order of valid rows is preserved, so the downstream
    tie-break order matches the reference.
    """
    from vfx_image_stitching_tpu_torch.models.sift.keypoints import (
        _compact_order,
    )

    order = _compact_order(loc.valid)[..., :out_capacity]
    return Localized(*[torch.take_along_dim(f, order, -1) for f in loc])


def localize_candidates_resident(
    dog: torch.Tensor,
    layer: torch.Tensor,
    y: torch.Tensor,
    x: torch.Tensor,
    cand_valid: torch.Tensor,
    octave: int,
    cfg: SiftConfig,
    chunk: int = 256,
) -> Localized:
    """Per-candidate Newton localization on the resident-stack kernel.

    The kernel (:func:`kernels.localize_newton_resident`) runs the whole
    Newton walk of each candidate of the live leading chunks with its own
    early exit, and returns its integer lanes (final cell, last-compute
    cell, converged/rejected) and the float lanes of its last compute,
    which are finalized as they are: no cube is gathered again.  The JAX
    package re-derives the floats at the last-compute cell instead,
    because the TPU kernel's floats drift; the card's walk is bit-exact
    against the plain walk, which is what CPU tensors run, so both
    devices give the re-derivation's values on every valid row.  Rows of
    dead chunks come out as zero, ``valid=False`` rows.  Octaves with
    h < 16 (which carry no candidates at border width 5) take the plain
    path, as in the JAX package.

    An (N, 5, H, W) batch of stacks takes (N, K) candidates: one launch
    walks the live rows of every image (to the batch's bound), each row
    in its own image's stack, and gives (N, K) rows.
    """
    if dog.shape[-2] < 16:
        return localize_candidates_chunked(
            dog, layer, y, x, cand_valid, octave, cfg
        )
    from vfx_image_stitching_tpu_torch.models.sift.kernels import (
        localize_newton_resident,
    )

    k = layer.shape[-1]
    n_rows, own = live_rows(cand_valid, chunk_size(k, chunk))
    live = cand_valid[..., :n_rows]
    (l, yy, xx, v), img = batch_rows(
        dog, layer[..., :n_rows], y[..., :n_rows], x[..., :n_rows], live)
    outi, outf = localize_newton_resident(
        dog, l, yy, xx, v, cfg.image_border_width, cfg.num_intervals,
        cfg.max_localize_iters, img=img,
    )
    st = {name: f.reshape(live.shape)
          for name, f in state_from_lanes(outi, outf).items()}
    loc = _finalize_localized(st, live, octave, cfg)
    return finish_rows(loc, own, k)
