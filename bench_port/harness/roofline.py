"""The least time the chip could take for a kernel call: the table of
peaks and the functions that count a call's operations and bytes from
its inputs, whatever implements it.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit.  A
call's bound is the larger of its bytes at the HBM rate and its
operations at the f32 rate outside the tensor cores.  Bytes count each
distinct input pixel once and each output once, however often the
kernel reads them.
"""

from __future__ import annotations

from typing import Tuple

H100_BYTES_PER_S = 3.35e12     # HBM3
H100_F32_FLOP_PER_S = 67e12    # f32 outside the tensor cores
# f32 operations of one Newton step of the localization walk (gradient,
# Hessian, the 3x3 solve, the update and its tests)
NEWTON_OPS_PER_STEP = 122
# f32 operations of the orientation histogram per masked sample: the
# squared distance (two products, a sum, a conversion), the weight (a
# product and exp, counted once), its product with the magnitude, the
# bin (a product and a rounding) and the add into the bin
ORIENT_OPS_PER_SAMPLE = 10


def bound_ms(n_bytes: float, n_flops: float) -> Tuple[float, str]:
    """The larger of the bytes' time and the operations' time, in ms, and
    which of the two it is."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / H100_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def distinct_pixels(stack_shape, layer, rows, cols, mask) -> int:
    """Distinct (layer, row, col) pixels of an (L, H, W) stack that the
    (K, S, S) sample masks of windows at ``rows`` x ``cols`` (K, S) reach."""
    import torch

    hit = torch.zeros(tuple(stack_shape), dtype=torch.bool, device=mask.device)
    idx = torch.broadcast_tensors(
        layer.long()[:, None, None], rows.long()[:, :, None],
        cols.long()[:, None, :])
    hit[tuple(i[mask] for i in idx)] = True
    return int(hit.sum())


def _mark_cubes(hit, layer, y, x) -> None:
    import torch

    d = torch.arange(-1, 2, device=hit.device)
    lc, yc, xc = (t.long() for t in (layer, y, x))
    hit[lc[:, None, None, None] + d[:, None, None],
        yc[:, None, None, None] + d[:, None],
        xc[:, None, None, None] + d] = True


def _newton_walk_step(dog, st: dict, border: int, intervals: int, img) -> dict:
    """One Newton step of every row still walking (the localization's
    step: the 3x3x3 cube /255, central differences, the 3x3 solve, stop
    under 0.5, else move by the rounded update and reject a move out of
    the border or the layer range)."""
    import torch

    h, w = dog.shape[-2:]
    plane = st["l"].long()
    if img is not None:
        plane = plane + img.long() * dog.shape[-3]
    d = torch.arange(-1, 2, device=dog.device)
    offs = (d[:, None, None] * h * w + d[None, :, None] * w + d[None, None, :]).reshape(-1)
    centre = (plane * h + st["y"].long()) * w + st["x"].long()
    flat = dog.reshape(-1)
    cube = flat[(centre[None, :] + offs[:, None]).clamp(0, flat.numel() - 1)] / 255.0

    def c(dl, dy, dx):
        return cube[(dl + 1) * 9 + (dy + 1) * 3 + (dx + 1)]

    g = (0.5 * (c(0, 0, 1) - c(0, 0, -1)), 0.5 * (c(0, 1, 0) - c(0, -1, 0)),
         0.5 * (c(1, 0, 0) - c(-1, 0, 0)))
    v = c(0, 0, 0)
    hxx = c(0, 0, 1) - 2 * v + c(0, 0, -1)
    hyy = c(0, 1, 0) - 2 * v + c(0, -1, 0)
    hss = c(1, 0, 0) - 2 * v + c(-1, 0, 0)
    hxy = 0.25 * (c(0, 1, 1) - c(0, 1, -1) - c(0, -1, 1) + c(0, -1, -1))
    hxs = 0.25 * (c(1, 0, 1) - c(1, 0, -1) - c(-1, 0, 1) + c(-1, 0, -1))
    hys = 0.25 * (c(1, 1, 0) - c(1, -1, 0) - c(-1, 1, 0) + c(-1, -1, 0))
    hess = torch.stack([torch.stack([hxx, hxy, hxs], -1), torch.stack([hxy, hyy, hys], -1),
                        torch.stack([hxs, hys, hss], -1)], -2).double()
    grad = torch.stack(g, -1).double()
    ok = torch.linalg.det(hess).abs() > 1e-30
    safe = torch.where(ok[:, None, None], hess, torch.eye(3, dtype=hess.dtype,
                                                          device=hess.device))
    u = torch.where(ok[:, None], -torch.linalg.solve(safe, grad),
                    torch.zeros_like(grad)).float()
    active = ~(st["converged"] | st["rejected"])
    conv = (u.abs() < 0.5).all(-1)
    moving = active & ~conv
    step = torch.round(u).to(torch.int64)
    nx, ny, nl = st["x"] + step[:, 0], st["y"] + step[:, 1], st["l"] + step[:, 2]
    oob = (ny < border) | (ny >= h - border) | (nx < border) | (nx >= w - border) \
        | (nl < 1) | (nl > intervals)
    return dict(
        converged=st["converged"] | (active & conv),
        rejected=st["rejected"] | (moving & oob),
        x=torch.where(moving, nx.clamp(1, w - 2), st["x"]),
        y=torch.where(moving, ny.clamp(1, h - 2), st["y"]),
        l=torch.where(moving, nl.clamp(1, intervals), st["l"]))


def newton_work(a: dict) -> Tuple[int, int]:
    """Newton steps the call's candidates take (each reads one 3x3x3
    cube) and the distinct DoG values those cubes cover."""
    import torch

    dog, layer, img = a["dog"], a["layer"], a.get("img")
    border, intervals = int(a["border"]), int(a["num_intervals"])
    falses = torch.zeros(layer.shape, dtype=torch.bool, device=layer.device)
    st = dict(x=a["x"].long(), y=a["y"].long(), l=layer.long(),
              converged=falses, rejected=~a["cand_valid"])
    n_l = dog.shape[-3]
    hit = torch.zeros(dog.reshape(-1, *dog.shape[-2:]).shape, dtype=torch.bool,
                      device=dog.device)
    base = img.long() * n_l if img is not None else torch.zeros_like(st["l"])
    steps = 0
    for _ in range(int(a["max_iters"])):
        active = ~(st["converged"] | st["rejected"])
        steps += int(active.sum())
        _mark_cubes(hit, base[active] + st["l"][active], st["y"][active],
                    st["x"][active])
        st = _newton_walk_step(dog, st, border, intervals, img)
    return steps, int(hit.sum())


def localize_bound(a: dict) -> Tuple[float, str]:
    """K1: reads layer, y, x (int32), the image index where batched, and
    the validity byte of each row, and the distinct DoG values its cubes
    cover; writes 8 int32 and 13 f32 lanes a row; 122 operations a step."""
    steps, values = newton_work(a)
    n_k = int(a["layer"].shape[0])
    per_row_in = 3 * 4 + 1 + (4 if a.get("img") is not None else 0)
    return bound_ms(n_k * per_row_in + values * 4 + n_k * (8 + 13) * 4,
                    steps * NEWTON_OPS_PER_STEP)


def orientation_bound(a: dict) -> Tuple[float, str]:
    """K2: the distinct masked pixels of both stacks read once, 4 int32 +
    1 f32 + the validity byte a row, the histograms written;
    ``ORIENT_OPS_PER_SAMPLE`` a masked sample."""
    import torch

    mag = a["mag_stack"]
    cy, cx, radius, half = a["cy"], a["cx"], a["radius"], int(a["half"])
    h, w = mag.shape[-2:]
    s = 2 * half + 1
    rng = torch.arange(s, device=mag.device)
    rr = (cy - half).clamp(0, max(h, s) - s)[:, None] + rng
    cc = (cx - half).clamp(0, max(w, s) - s)[:, None] + rng
    in_y = ((rr - cy[:, None]).abs() <= radius[:, None]) & (rr >= 1) & (rr <= h - 2)
    in_x = ((cc - cx[:, None]).abs() <= radius[:, None]) & (cc >= 1) & (cc <= w - 2)
    mask = in_y[:, :, None] & in_x[:, None, :] & a["valid"][:, None, None]
    samples = int(mask.sum())
    distinct = distinct_pixels(mag.shape, a["layer"], rr, cc, mask)
    n_k = int(a["layer"].shape[0])
    return bound_ms(distinct * 8 + n_k * (5 * 4 + 1) + n_k * int(a["num_bins"]) * 4,
                    samples * ORIENT_OPS_PER_SAMPLE)


def window_bound(a: dict) -> Tuple[float, str]:
    """K3: the distinct pixels its windows cover in both stacks read once,
    both windows written once, 3 int32 a row read."""
    import torch

    mag = a["mag_stack"]
    half = int(a["half_cap"])
    s = 2 * half + 1
    h, w = mag.shape[-2:]
    rng = torch.arange(s, dtype=torch.int32, device=mag.device)
    # each window starts at clip(c - half, 0, max(dim, S) - S)
    rows = (a["cy"] - half).clamp(0, max(h, s) - s)[:, None] + rng
    cols = (a["cx"] - half).clamp(0, max(w, s) - s)[:, None] + rng
    inside = ((rows < mag.shape[-2])[:, :, None]
              & (cols < mag.shape[-1])[:, None, :])
    distinct = distinct_pixels(mag.shape, a["layer"], rows, cols, inside)
    n_k = int(a["layer"].shape[0])
    return bound_ms(distinct * 8 + 2 * n_k * s * s * 4 + n_k * 3 * 4, 0.0)
