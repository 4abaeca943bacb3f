"""The probe entry points' four hand-written CUDA kernels and their plain
versions.

Counterparts of the Pallas kernels of ``scripts/probe_localize_resident_r4.py``
(P2 ``feas1``, P3 ``feas2``, P4 ``_localize_resident``) and
``scripts/probe_desc_scratch_dot.py`` (P1 ``desc_scratch_dot``).  The
kernels are in ``csrc/probe_kernels.cu``, built into the SIFT path's
library (``models/sift/kernels.py``), and each wrapper launches through
``kernels._launch``, which counts into ``kernels.LAUNCHES``.  On CPU
tensors a wrapper runs the plain PyTorch version defined beside it; on
CUDA tensors it launches its kernel and raises if the launch is refused.
The TPU kernels' (., 128) lane rows become compact outputs: P3 gives (K,),
P4 (K, 13) f32 and (K, 8) i32.

Kernel notes (what each replaces, what bounds it on an H100, what the
design does about it):

``desc_scratch_dot`` (P1) replaces ``desc_scratch_dot`` (TPU kernel
    ``_kernel``): the trilinear 4x4x8 descriptor histogram of the small
    bucket (57x57 windows, ``half_w <= 28``) as two-hot matrix products,
    per keypoint a (16, S^2) spatial operand times an (S^2, 8) orientation
    operand.  The (16 cells x 8 bins) accumulator is exactly one
    ``mma.sync.m16n8k8`` tile, so the kernel runs the contraction on the
    tensor cores in TF32.  It walks and evaluates the samples as K5 does
    (``csrc/descriptor_hist.cuh``: each warp queues the samples of its
    share of the box that can reach the histogram, then evaluates them
    one a lane, the probe's arithmetic and order, IEEE division, no
    contraction: the floors are knife edges).  8 warps per keypoint, so
    the probe's 512 rows fill the card (4 and 16 measured slower); each
    warp writes its 32 samples' operands to shared memory,
    structure of arrays with rows 36 floats apart (no bank conflicts),
    builds the A and B fragments of four mma steps from 8 loads a step,
    and skips a step whose 8 samples all miss.  ``highest=False`` is one
    TF32 product (the probe's ``Precision.DEFAULT``), ``highest=True``
    3xTF32 (its ``HIGHEST``).  The warps' tiles are added in warp order:
    no float atomics.  Its bound is the window's bytes; like K5 it is
    held by each sample's arithmetic and a warp's chain (``PERF.md``).
    A call is one device kernel (the kernel reads the mask's bytes).  The
    TPU's 2x2 tile fetch, 64-padding and in-kernel transpose are
    BlockSpec and layout workarounds with no counterpart here.

``feas1_stack_sum`` (P2) replaces the ``feas1`` kernel: the sum over the
    layers of the stack's (8, 128) corner, which on the TPU tested whether
    a whole 15.7 MB DoG stack fits in VMEM as one block.  On an H100 the
    question's answer is the 50 MB L2, which the stack fits, not shared
    memory (227 KB).  Its byte bound (20 KB in, 4 KB out) is nanoseconds,
    so what a call costs is the launch and one round trip to L2: 8 blocks
    of one warp (one per row, so no SM takes more than a warp), four
    columns a thread read with 16-byte loads where the base and strides
    allow (4-byte loads otherwise, in the same kernel), and every layer
    load of a thread issued before its first add (layer counts 1-8
    compiled in, chunks of 8 beyond).  Each output's layers are added in
    order from 0, as the TPU kernel does, so the result is bit-exact.

``feas2_cube_sums`` (P3) replaces the ``feas2`` kernel: per candidate the
    sum of its 27-value 3x3x3 DoG cube.  Bounded by bytes (the distinct
    cube values), which at the probe's 2048 candidates is nanoseconds: what
    a call costs is the launch and one round of dependent loads.  So the
    loads are spread over lanes and over the whole card: nine lanes per
    candidate, each loading one (dl, dy) row's three consecutive values,
    three candidates a warp, 4 warps a block (171 blocks for 2048
    candidates, so every SM takes part).  One lane per candidate gathers
    its 27 values by shuffles and adds them in (dl, dy, dx) order from 0,
    the order of the probe's own check, so the result is bit-exact (no
    tree, no atomics).  The TPU's aligned slab loads and rolls are VMEM
    alignment workarounds.

``localize_resident_r4_lanes`` (P4) replaces ``_newton_resident_kernel``:
    K1's function, the Newton walk with its integer lanes and the 13
    float lanes of the last compute, over every slot.  Bounded by the
    latency of its dependent steps, not by bytes or operations
    (``PERF.md``).  Its kernel is K1's body behind P4's own entry and
    count (``csrc/newton_step.cuh`` ``localize_rows``: one warp per
    candidate, 8 a block; lane j < 27 loads and divides cube value j,
    every lane runs the same step on the broadcast values), so the two
    cannot drift apart; built with ``-fmad=false`` and
    correctly rounded division, the float lanes follow the plain version's
    operations one by one.  The TPU kernel keeps the whole DoG stack
    resident in VMEM; the H100's counterpart would be each walk's
    neighbourhood resident in shared memory, but a halo of every layer x
    5 x 5 values loaded at the first step measured slower than this walk,
    whose later cubes overlap its first, most likely served by the SM's L1
    (``PERF.md``).  Lane c of the warp writes value c of the row's 8 + 13
    lanes; invalid rows are zero.  The kernel reads the bool mask's bytes,
    so a call is one device kernel.  The wrapper makes K1's checks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vfx_image_stitching_tpu_torch.models.sift.kernels import (
    _gather_windows,
    _launch,
    _ptr,
    _require,
    _same_device,
    _window_coords,
    check_newton_inputs,
    localize_newton_plain,
)
from vfx_image_stitching_tpu_torch.models.sift.localize import (  # noqa: F401
    FLOAT_LANES,
    INT_LANES,
)

P1_HALF = 28              # the small bucket's half_cap (config.desc_small_half)
P1_S = 2 * P1_HALF + 1
P1_WW = 4                 # spatial cells per axis
P1_NB = 8                 # orientation bins


def _ints(ts, name):
    for t in ts:
        _require(t, torch.int32, 1, name)
    if any(t.shape[0] != ts[0].shape[0] for t in ts):
        raise ValueError(f"{name}: per-row arrays differ in length")


# ---------------------------------------------------------------------------
# P2: the layers' sum of the stack's (8, 128) corner
# ---------------------------------------------------------------------------

def feas1_stack_sum_plain(dog: torch.Tensor) -> torch.Tensor:
    """Plain version: ``acc = 0; acc = acc + dog[l, :8, :128]`` for each
    layer in order.  (8, 128) f32."""
    acc = torch.zeros((8, 128), dtype=torch.float32, device=dog.device)
    for plane in dog[:, :8, :128]:
        acc = acc + plane
    return acc


def feas1_stack_sum(dog: torch.Tensor) -> torch.Tensor:
    """(8, 128) sum over the layers of an (L, H, W) f32 stack's corner,
    H >= 8, W >= 128 (see :func:`feas1_stack_sum_plain`); bit-exact.  The
    kernel takes the stack's layer and row strides, so a view into a
    wider stack is read in place (one device kernel)."""
    name = "feas1_stack_sum"
    dev = _same_device((dog,), name)
    _require(dog, torch.float32, 3, name)
    n_l, h, w = dog.shape
    if h < 8 or w < 128:
        raise ValueError(f"{name}: needs H >= 8 and W >= 128, got {tuple(dog.shape)}")
    if dev.type == "cpu":
        return feas1_stack_sum_plain(dog)
    if dog.stride(2) != 1:
        dog = dog.contiguous()
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    _launch(name, dev, "probe_feas1_stack_sum", _ptr(dog), n_l, h, w,
            dog.stride(0), dog.stride(1), _ptr(out))
    return out


# ---------------------------------------------------------------------------
# P3: per-candidate 3x3x3 cube sums
# ---------------------------------------------------------------------------

def feas2_cube_sums_plain(dog: torch.Tensor, layer: torch.Tensor,
                          y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``s = 0; s = s + dog[l+dl, y+dy, x+dx]`` over
    (dl, dy, dx) in row-major order, each index clamped into the stack.
    (K,) f32."""
    n_l, h, w = dog.shape
    s = torch.zeros(layer.shape, dtype=torch.float32, device=dog.device)
    for dl in (-1, 0, 1):
        li = (layer + dl).clamp(0, n_l - 1).long()
        for dy in (-1, 0, 1):
            yi = (y + dy).clamp(0, h - 1).long()
            for dx in (-1, 0, 1):
                s = s + dog[li, yi, (x + dx).clamp(0, w - 1).long()]
    return s


def feas2_cube_sums(dog: torch.Tensor, layer: torch.Tensor, y: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """(K,) sum of each candidate's 3x3x3 cube of an (L, H, W) f32 stack
    (see :func:`feas2_cube_sums_plain`); bit-exact."""
    name = "feas2_cube_sums"
    dev = _same_device((dog, layer, y, x), name)
    _require(dog, torch.float32, 3, name)
    _ints((layer, y, x), name)
    if dev.type == "cpu":
        return feas2_cube_sums_plain(dog, layer, y, x)
    dog, layer, y, x = (t.contiguous() for t in (dog, layer, y, x))
    k = layer.shape[0]
    out = torch.empty((k,), dtype=torch.float32, device=dev)
    if k == 0:
        return out
    n_l, h, w = dog.shape
    _launch(name, dev, "probe_feas2_cube_sums", _ptr(dog), n_l, h, w,
            _ptr(layer), _ptr(y), _ptr(x), k, _ptr(out))
    return out


# ---------------------------------------------------------------------------
# P4: the Newton walk with its float lanes
# ---------------------------------------------------------------------------

def localize_resident_r4_lanes_plain(
    dog: torch.Tensor, layer: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
    cand_valid: torch.Tensor, border: int, num_intervals: int, max_iters: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: K1's (``kernels.localize_newton_plain``), lanes in
    the probe's order, ``(K, 13)`` f32 lanes (:data:`FLOAT_LANES`, of
    the last compute) and ``(K, 8)`` int32 lanes
    (:data:`INT_LANES`); invalid candidates give zero rows."""
    outi, outf = localize_newton_plain(dog, layer, y, x, cand_valid, border,
                                       num_intervals, max_iters)
    return outf, outi


def localize_resident_r4_lanes(
    dog: torch.Tensor, layer: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
    cand_valid: torch.Tensor, border: int, num_intervals: int, max_iters: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final Newton state of each candidate of one octave's (L, H, W) f32
    DoG stack (0..255-scale values), float and integer lanes (see
    :func:`localize_resident_r4_lanes_plain`).  Valid candidates must lie
    inside the stack's interior (as ``extract_candidates`` guarantees);
    K1's checks (``kernels.check_newton_inputs``), on either device."""
    name = "localize_resident_r4"
    dev = check_newton_inputs(dog, layer, y, x, cand_valid, num_intervals, name)
    if dev.type == "cpu":
        return localize_resident_r4_lanes_plain(
            dog, layer, y, x, cand_valid, border, num_intervals, max_iters)
    dog, layer, y, x, cand_valid = (
        t.contiguous() for t in (dog, layer, y, x, cand_valid))
    k = layer.shape[0]
    outf = torch.empty((k, len(FLOAT_LANES)), dtype=torch.float32, device=dev)
    outi = torch.empty((k, len(INT_LANES)), dtype=torch.int32, device=dev)
    if k == 0:
        return outf, outi
    _, h, w = dog.shape
    _launch(name, dev, "probe_localize_resident_r4",
            _ptr(dog), h, w, _ptr(layer), _ptr(y), _ptr(x), _ptr(cand_valid), k,
            border, num_intervals, max_iters, _ptr(outf), _ptr(outi))
    return outf, outi


# ---------------------------------------------------------------------------
# P1: the small bucket's descriptor histogram as two-hot matrix products
# ---------------------------------------------------------------------------

def scratch_dot_operands(
    mag: torch.Tensor, ang: torch.Tensor, layer: torch.Tensor,
    py: torch.Tensor, px: torch.Tensor, half_w: torch.Tensor,
    cos_a: torch.Tensor, sin_a: torch.Tensor, hist_width: torch.Tensor,
    angle: torch.Tensor, valid: torch.Tensor, img_h: int, img_w: int,
):
    """The probe kernel's operands over each keypoint's clamped 57x57
    window (the probe's 64-padded window adds nothing for ``half_w <=
    28``): the (K, S^2, 16) spatial two-hot products, the (K, S^2, 8)
    orientation two-hots, and the (K, S, S) mask of the samples that
    reach the histogram.  Per sample, the probe's arithmetic in its
    order (``scripts/probe_desc_scratch_dot.py:93-155``); a dropped
    sample's operands are zero."""
    k = layer.shape[0]
    hs, ws = mag.shape[-2:]
    rows, cols = _window_coords(py, px, P1_HALF, hs, ws)
    magw = _gather_windows(mag, layer, rows, cols)
    angw = _gather_windows(ang, layer, rows, cols)
    ys = rows - py[:, None]
    xs = cols - px[:, None]
    in_win = ((torch.abs(ys) <= half_w[:, None])[:, :, None]
              & (torch.abs(xs) <= half_w[:, None])[:, None, :])
    in_bounds = (((rows > 0) & (rows < img_h - 1))[:, :, None]
                 & ((cols > 0) & (cols < img_w - 1))[:, None, :])
    ysf = ys.to(torch.float32)[:, :, None]
    xsf = xs.to(torch.float32)[:, None, :]
    r_rot = xsf * sin_a[:, None, None] + ysf * cos_a[:, None, None]
    c_rot = xsf * cos_a[:, None, None] - ysf * sin_a[:, None, None]
    hw = hist_width[:, None, None]
    rq = r_rot / hw
    cq = c_rot / hw
    r_bin = rq + (0.5 * P1_WW - 0.5)
    c_bin = cq + (0.5 * P1_WW - 0.5)
    in_bin = (r_bin > -1.0) & (r_bin < P1_WW) & (c_bin > -1.0) & (c_bin < P1_WW)
    mask = in_win & in_bounds & in_bin & valid[:, None, None]
    zero = torch.zeros((), dtype=torch.float32, device=mag.device)
    weight_mul = -0.5 / ((0.5 * P1_WW) ** 2)
    wm = torch.where(mask, torch.exp(weight_mul * (rq * rq + cq * cq)) * magw, zero)
    r_bin = torch.where(mask, r_bin, zero)
    c_bin = torch.where(mask, c_bin, zero)
    r0b = torch.floor(r_bin)
    c0b = torch.floor(c_bin)
    rf = r_bin - r0b
    cf = c_bin - c0b
    c1 = wm * rf
    c0w = wm - c1
    ra = torch.clamp(r0b + 1.0, 0.0, P1_WW + 1.0)[..., None]
    ca = torch.clamp(c0b + 1.0, 0.0, P1_WW + 1.0)[..., None]
    # a dropped sample's orientation two-hot is zeroed too, so that no
    # non-finite angle meets its zero spatial weights
    ob = torch.where(mask, torch.remainder(
        (angw - angle[:, None, None]) * (P1_NB / 360.0), float(P1_NB)), zero)
    o0 = torch.floor(ob)
    of = ob - o0
    o1 = torch.remainder(o0 + 1.0, float(P1_NB))
    slots = torch.arange(1, P1_WW + 1, dtype=torch.float32, device=mag.device)
    rv = (torch.where(slots == ra, c0w[..., None], zero)
          + torch.where(slots == ra + 1.0, c1[..., None], zero))
    cv = (torch.where(slots == ca, (1.0 - cf)[..., None], zero)
          + torch.where(slots == ca + 1.0, cf[..., None], zero))
    lhs = (rv[..., :, None] * cv[..., None, :]).reshape(k, P1_S * P1_S, P1_WW * P1_WW)
    bins = torch.arange(P1_NB, dtype=torch.float32, device=mag.device)
    rhs = (torch.where(bins == o0[..., None], (1.0 - of)[..., None], zero)
           + torch.where(bins == o1[..., None], of[..., None], zero))
    rhs = torch.where(mask[..., None], rhs, zero).reshape(k, P1_S * P1_S, P1_NB)
    return lhs, rhs, mask


def desc_scratch_dot_plain(
    mag: torch.Tensor, ang: torch.Tensor, layer: torch.Tensor,
    py: torch.Tensor, px: torch.Tensor, half_w: torch.Tensor,
    cos_a: torch.Tensor, sin_a: torch.Tensor, hist_width: torch.Tensor,
    angle: torch.Tensor, valid: torch.Tensor, img_h: int, img_w: int,
) -> torch.Tensor:
    """Plain version: one f32 batched product of the operands of
    :func:`scratch_dot_operands` (PyTorch's default, with TF32 matmuls
    off).  (K, 16, 8)."""
    lhs, rhs, _mask = scratch_dot_operands(
        mag, ang, layer, py, px, half_w, cos_a, sin_a, hist_width, angle,
        valid, img_h, img_w)
    return torch.bmm(lhs.transpose(1, 2), rhs)


def desc_scratch_dot(
    mag: torch.Tensor, ang: torch.Tensor, layer: torch.Tensor,
    py: torch.Tensor, px: torch.Tensor, half_w: torch.Tensor,
    cos_a: torch.Tensor, sin_a: torch.Tensor, hist_width: torch.Tensor,
    angle: torch.Tensor, valid: torch.Tensor, img_h: int, img_w: int,
    highest: bool = False,
) -> torch.Tensor:
    """(K, 16, 8) raw trilinear histograms (inner 4x4 cells x 8 bins,
    before normalisation) of the small bucket over (L, H, W) f32 gradient
    fields: keypoint (``py``, ``px``) in plane ``layer``, sampling
    half-width ``half_w <= 28``, rotation ``cos_a``/``sin_a``, bin width
    ``hist_width`` (> 0 on valid rows), reference angle ``angle``, inside
    ``1..img_h-2 x 1..img_w-2`` (see :func:`scratch_dot_operands`).
    Invalid rows are zero.  On the card, TF32 products: within 2e-3 of
    the plain version's maximum, 1e-5 with ``highest``; repeated launches
    give the same bits.  On the CPU ``highest`` has no effect."""
    name = "desc_scratch_dot"
    dev = _same_device((mag, ang, layer, py, px, half_w, cos_a, sin_a,
                        hist_width, angle, valid), name)
    _require(mag, torch.float32, 3, name)
    _require(ang, torch.float32, 3, name)
    if mag.shape != ang.shape:
        raise ValueError(f"{name}: mag and ang stacks differ in shape")
    ints = (layer, py, px, half_w)
    floats = (cos_a, sin_a, hist_width, angle)
    _ints(ints, name)
    for t in floats:
        _require(t, torch.float32, 1, name)
    _require(valid, torch.bool, 1, name)
    k = layer.shape[0]
    if any(t.shape[0] != k for t in (*floats, valid)):
        raise ValueError(f"{name}: per-keypoint arrays differ in length")
    if dev.type == "cpu":
        return desc_scratch_dot_plain(mag, ang, layer, py, px, half_w, cos_a,
                                      sin_a, hist_width, angle, valid, img_h,
                                      img_w)
    args = [t.contiguous() for t in (mag, ang, *ints, *floats, valid)]
    out = torch.empty((k, P1_WW * P1_WW, P1_NB), dtype=torch.float32, device=dev)
    if k == 0:
        return out
    n_l, hs, ws = mag.shape
    _launch(name, dev, "probe_desc_scratch_dot",
            _ptr(args[0]), _ptr(args[1]), hs, ws, *(_ptr(t) for t in args[2:]),
            k, img_h, img_w, int(highest), _ptr(out))
    return out
