"""Meshes of devices and the sharded shift stage: the counterpart of
``vfx_image_stitching_tpu/parallel/mesh.py``.

The JAX ``Mesh`` is single-controller, and so is this one: one process
drives a grid of slots, each slot a torch device with a CUDA stream of its
own, and a step runs one worker thread per slot under
``torch.cuda.device(slot)`` on that stream.  A device may fill several
slots (logical slots, each with its own stream): torch has one CPU device,
and a one-card machine checks the multi-slot logic that way.

Images axis (:func:`sharded_pairwise_shifts`): each slot extracts the
features of a contiguous shard of the (N, H, W, 3) batch; the halo
exchange copies the first image's keypoints, descriptors and validity of
shard k+1 to slot k (XLA's collective-permute); each slot matches its
local pairs, the boundary pair included; the pair outputs are gathered to
the first slot's device.  XLA needs equal shards, so the reference pads
the batch with blank images and trims the pairs that read them; here the
shards differ by at most one image (slots past the N-th get none), which
gives the same outputs without extracting blank images.

Pano axis (:func:`sharded_multi_pano_full`): whole panoramas per slot of
the first mesh axis; on a 2-D mesh each panorama's images are sharded
over that slot's row as above.  ``mode="shard_map"`` (the default) runs
a slot's panoramas one after another; ``mode="vmap"``, and always
:func:`sharded_multi_pano_shifts`, runs them as one batch: each slot of
the row extracts its shard of every panorama in one pass, takes the
first image of each panorama's next shard in one halo, and matches all
their local pairs in one pair step.  The reference pads P to the pano
axis with blank panoramas whose outputs it trims; here those are never
computed.

Tensors cross slots only through :func:`_handoff`: the consumer's stream
waits for the producer's, and a tensor read on another stream of its own
device is recorded on that stream, so the caching allocator cannot reuse
its memory while the read is in flight.  Every function returns tensors
on the first slot's device, ready on the calling thread's current stream.

Sharded and batched outputs equal the unsharded per-panorama step's bit
for bit: extraction is per image in either SIFT schedule, and the pair
step is per pair, with the matcher's
distances exact for SIFT's integer descriptors and re-checked exactly for
Harris's (``refine``).  Which layout pays on TPUs the JAX module's
docstring records; no scaling figure is claimed here.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from vfx_image_stitching_tpu_torch.config import StitchConfig
from vfx_image_stitching_tpu_torch.ops.color import bgr_to_gray_f32
from vfx_image_stitching_tpu_torch.pipeline.stitch import (
    _pair_shift,
    extract_features,
    resolve_device,
)


class _Slot(NamedTuple):
    device: torch.device
    stream: Optional[torch.cuda.Stream]  # None on the CPU


class Mesh:
    """A grid of slots: the port's ``jax.sharding.Mesh``.

    ``devices`` is a numpy object array of ``torch.device`` (``.ndim``,
    ``.shape``) whose axes ``axis_names`` names.  A device may repeat:
    each slot has a CUDA stream of its own (``slots``, row-major).  The
    slots are all CUDA devices or all the CPU.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.size == 0 or grid.ndim != len(axis_names):
            raise ValueError(
                f"a mesh needs one axis name per axis of a non-empty device "
                f"grid: grid {grid.shape}, names {axis_names}")
        flat = [_resolve(d) for d in grid.ravel()]
        if len({d.type for d in flat}) != 1:
            raise ValueError("a mesh's slots are all CUDA devices or all the CPU")
        self.devices = np.empty(grid.shape, dtype=object)
        for i, d in enumerate(flat):
            self.devices.flat[i] = d
        self.axis_names = axis_names
        self.slots = tuple(
            _Slot(d, torch.cuda.Stream(device=d) if d.type == "cuda" else None)
            for d in flat)

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.devices.shape))}, "
                f"{[str(d) for d in self.devices.flat]})")


def _resolve(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _device_list(n_devices: Optional[int], devices) -> list:
    """``devices``, by default every visible card, cut to ``n_devices``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=[...], for example "
                "['cpu'] * 8 for eight logical slots on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    return devices if n_devices is None else devices[:n_devices]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "images",
              devices=None) -> Mesh:
    """1-D mesh over ``devices`` (default: every visible card)."""
    return Mesh(_device_list(n_devices, devices), (axis_name,))


def make_mesh_pano(n_devices: Optional[int] = None, axis_name: str = "pano",
                   devices=None) -> Mesh:
    """1-D pano-only mesh: each slot runs whole panoramas."""
    return Mesh(_device_list(n_devices, devices), (axis_name,))


def make_mesh_2d(n_devices: Optional[int] = None,
                 axes: Sequence[str] = ("pano", "images"),
                 devices=None) -> Mesh:
    """2-D mesh for the multi-panorama throughput config: 2 rows when the
    slot count is even, else 1."""
    devs = _device_list(n_devices, devices)
    n = len(devs)
    d0 = 2 if n % 2 == 0 and n > 1 else 1
    cols = n // d0
    return Mesh([devs[r * cols:(r + 1) * cols] for r in range(d0)], tuple(axes))


def _bounds(n: int, parts: int) -> List[int]:
    """Contiguous split of ``n`` items into ``parts`` whose sizes differ by
    at most one (the larger first), as cumulative bounds."""
    sizes = [n // parts + (i < n % parts) for i in range(parts)]
    return [int(b) for b in np.cumsum([0] + sizes)]


def shard_batch(batch, mesh: Mesh, axis_name: str = "images") -> List[torch.Tensor]:
    """An (N, ...) batch split along its leading axis into one contiguous
    shard per slot (sizes differ by at most one), each on its slot's
    device, ready on the calling thread's current streams."""
    _check_axis(mesh, axis_name)
    return _shards(torch.as_tensor(batch), mesh.slots)


def _shards(batch: torch.Tensor, slots) -> List[torch.Tensor]:
    b = _bounds(batch.shape[0], len(slots))
    return [batch[b[k]:b[k + 1]].to(s.device) for k, s in enumerate(slots)]


def _check_axis(mesh: Mesh, axis_name: str) -> None:
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no {axis_name!r}")


def _current(device: torch.device) -> _Slot:
    """The calling thread's current stream on ``device``, as a slot."""
    if device.type != "cuda":
        return _Slot(device, None)
    return _Slot(device, torch.cuda.current_stream(device))


@contextlib.contextmanager
def _on(slot: _Slot):
    """Run under ``slot``'s device and stream."""
    if slot.stream is None:
        yield
        return
    with torch.cuda.device(slot.device), torch.cuda.stream(slot.stream):
        yield


def _run_slots(slots, fn) -> list:
    """``fn(i)`` for each slot ``i``, one thread per slot, under the slot's
    device and stream; the results in slot order."""
    def work(i):
        with _on(slots[i]):
            return fn(i)

    if len(slots) == 1:
        return [work(0)]
    with cf.ThreadPoolExecutor(max_workers=len(slots)) as pool:
        return list(pool.map(work, range(len(slots))))


def _handoff(tensors, src: _Slot, dst: _Slot) -> list:
    """``tensors``, made on ``src``'s stream, on ``dst``'s device and ready
    on ``dst``'s stream, which must be the calling thread's current one.

    On one device ``dst``'s stream waits for ``src``'s, and each tensor is
    recorded on ``dst``'s stream, so its memory outlives the reads queued
    there.  Across devices the copy runs on ``src``'s stream, after the
    work that made the tensors, and ``dst``'s stream waits for the copy
    (the cross-device ``Tensor.to`` copies on the source device's current
    stream and makes the destination's current stream wait).
    """
    if src.stream is None or dst.stream is None:
        return [t.to(dst.device) for t in tensors]
    if src.device == dst.device:
        dst.stream.wait_stream(src.stream)
        for t in tensors:
            t.record_stream(dst.stream)
        return list(tensors)
    with torch.cuda.stream(src.stream):
        return [t.to(dst.device) for t in tensors]


def _tree_map(fn, *trees):
    """``fn`` over the tensors of equally shaped trees of tuples, dicts
    and ``None``."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return tuple(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _move(tree, src: _Slot, dst: _Slot):
    leaves = []
    _tree_map(leaves.append, tree)
    moved = iter(_handoff(leaves, src, dst))
    return _tree_map(lambda _t: next(moved), tree)


def _extract(cyl: torch.Tensor, cfg: StitchConfig, batched: bool):
    """``pipeline.stitch.extract_features`` of a (P, N, H, W, 3) batch in
    one call over its P*N images, every leaf reshaped to (P, N, ...).

    ``batched`` runs SIFT in the batched schedule (``mode="vmap"``)
    whatever ``VFX_SIFT_BATCH_MODE`` says: flattening the panoramas into
    one batch is the port's form of the JAX package's vmap over them, and
    the port's two schedules give the same bits.  Harris takes any
    leading image axis as it is.
    """
    flat = cyl.flatten(0, 1)
    if batched and cfg.backend == "sift":
        from vfx_image_stitching_tpu_torch.models.sift.extract import (
            sift_batch_with_stats,
        )

        feats = sift_batch_with_stats(bgr_to_gray_f32(flat), cfg.sift, "vmap")
    else:
        feats = extract_features(flat, cfg)
    return _tree_map(lambda t: t.unflatten(0, cyl.shape[:2]), feats)


def _pairs(xy, descs, valid, cfg: StitchConfig, margin: float):
    """The pair step over the adjacent pairs of every panorama of (P, N,
    ...) features: all P*(N-1) pairs in one ``_pair_shift`` call, none
    across panoramas; its 15 leaves reshaped to (P, N-1, ...).  The match
    distances are exact only in full f32: TF32 stays off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mcfg = cfg.match()
    feats = (xy, descs, valid)
    out = _pair_shift(
        *(t[:, :-1].flatten(0, 1) for t in feats),
        *(t[:, 1:].flatten(0, 1) for t in feats),
        desc_thresh=mcfg.desc_thresh, ransac_thresh=mcfg.ransac_thresh,
        refine=mcfg.refine, margin=margin,
    )
    p, n = xy.shape[:2]
    return _tree_map(lambda t: t.unflatten(0, (p, n - 1)), out)


def _step(batch: torch.Tensor, cfg: StitchConfig, full: bool, batched: bool):
    """A (P, N, H, W, 3) batch on one device: :func:`_extract`, then the
    pair step over its P*(N-1) adjacent pairs, with ``margin`` 0 (the
    minimal step's 15-tuple) or with ``full`` the live
    ``cfg.match().borderline_margin`` (the full step's leaves); every
    leaf with a leading P axis."""
    xy, descs, valid, meta, stats = _extract(batch, cfg, batched)
    margin = cfg.match().borderline_margin if full else 0.0
    pair_out = _pairs(xy, descs, valid, cfg, margin)
    return (xy, valid, meta, stats, pair_out) if full else pair_out


def _first(tree):
    return _tree_map(lambda t: t[0], tree)


def _pairwise_shift_step(cyl: torch.Tensor, cfg: StitchConfig):
    """Features + adjacent-pair match + voting on one (N, H, W, 3) batch:
    the reference's minimal step, whose pair step runs with ``margin`` 0,
    so the escalation signals (border_flip, border_swap, material,
    max_inmargin) are zero.  Returns ``pipeline.stitch._pair_shift``'s
    15-tuple with a leading pair axis."""
    return _first(_step(cyl[None], cfg, full=False, batched=False))


def _full_shift_step(cyl: torch.Tensor, cfg: StitchConfig):
    """Pipeline-grade step: ``(xy, valid_kp, meta, stats, pair_out)``,
    everything ``pipeline.stitch.finalize_to_panorama`` needs, the pair
    step with the live ``cfg.match().borderline_margin``."""
    return _first(_step(cyl[None], cfg, full=True, batched=False))


def _multi_pano_step(batch: torch.Tensor, cfg: StitchConfig):
    """(P, N, H, W, 3) multi-panorama minimal step, the counterpart of the
    JAX vmap over panoramas: one batched extraction over all P*N images
    and one pair step over all P*(N-1) pairs; every leaf equals the stack
    of the per-panorama :func:`_pairwise_shift_step`."""
    return _step(batch, cfg, full=False, batched=True)


def _multi_pano_full_step(batch: torch.Tensor, cfg: StitchConfig):
    """(P, N, H, W, 3) multi-panorama full step, the counterpart of the
    JAX vmap of ``_full_shift_step`` over panoramas: one batched
    extraction and one pair step for all panoramas, every leaf equal to
    the stack of the per-panorama :func:`_full_shift_step`."""
    return _step(batch, cfg, full=True, batched=True)


def _image_step(images: torch.Tensor, slots, cfg: StitchConfig, full: bool,
                batched: bool):
    """A (P, N, H, W, 3) batch with its image axis sharded over ``slots``:
    each slot extracts its shard of every panorama in one
    :func:`_extract` call, takes the first image of each panorama's shard
    on the next slot in one halo handoff, and runs its local pairs, the
    boundary pairs included, in one pair step.  Returns :func:`_step`'s
    leaves on ``slots[0]``'s device, ready on the calling thread's
    stream."""
    n = images.shape[1]
    b = _bounds(n, len(slots))
    used = [k for k in range(len(slots)) if b[k + 1] > b[k]]
    slots = [slots[k] for k in used]
    shards = [images[:, b[k]:b[k + 1]].to(s.device) for k, s in zip(used, slots)]
    made = {s.device: _current(s.device) for s in slots}
    margin = cfg.match().borderline_margin if full else 0.0

    def extract(i):
        cyl, = _handoff([shards[i]], made[slots[i].device], slots[i])
        return _extract(cyl, cfg, batched)

    feats = _run_slots(slots, extract)

    def pairs(i):
        local = feats[i][:3]
        if i + 1 < len(slots):
            halo = _handoff([f[:, :1] for f in feats[i + 1][:3]], slots[i + 1],
                            slots[i])
            local = [torch.cat([a, h], dim=1) for a, h in zip(local, halo)]
        return _pairs(*local, cfg, margin)

    pair_outs = _run_slots(slots, pairs)
    out = _current(slots[0].device)

    def gather(parts):
        moved = [_move(p, s, out) for p, s in zip(parts, slots)]
        return _tree_map(lambda *xs: torch.cat(xs, dim=1), *moved)

    pair_out = gather(pair_outs)
    if not full:
        return pair_out
    xy, valid, meta, stats = gather([(f[0], f[2], f[3], f[4]) for f in feats])
    return xy, valid, meta, stats, pair_out


def _grid_step(batch, mesh: Mesh, cfg: StitchConfig, full: bool, batched: bool):
    """A (P, N, H, W, 3) batch over the mesh: contiguous panoramas per slot
    of the first axis, each panorama's images over that slot's row; with
    ``batched`` a row runs all of its panoramas in one
    :func:`_image_step`, else one panorama after another."""
    batch = torch.as_tensor(batch)
    n_rows = mesh.devices.shape[0]
    cols = len(mesh.slots) // n_rows
    rows = [mesh.slots[r * cols:(r + 1) * cols] for r in range(n_rows)]
    b = _bounds(batch.shape[0], n_rows)
    used = [k for k in range(n_rows) if b[k + 1] > b[k]]
    made = _current(batch.device)

    def row_step(i):
        k = used[i]
        parts = ([slice(b[k], b[k + 1])] if batched
                 else [slice(q, q + 1) for q in range(b[k], b[k + 1])])
        outs = []
        for q in parts:
            panos, = _handoff([batch[q]], made, rows[k][0])
            outs.append(_image_step(panos, rows[k], cfg, full, batched))
        return _tree_map(lambda *xs: torch.cat(xs), *outs)

    heads = [rows[k][0] for k in used]
    row_outs = _run_slots(heads, row_step)
    out = _current(mesh.slots[0].device)
    moved = [_move(o, h, out) for o, h in zip(row_outs, heads)]
    return _tree_map(lambda *xs: torch.cat(xs), *moved)


def sharded_pairwise_shifts(
    batch,
    mesh: Mesh,
    cfg: Optional[StitchConfig] = None,
    axis_name: str = "images",
):
    """The minimal step (:func:`_pairwise_shift_step`) on an (N, H, W, 3)
    uint8 batch (tensor or NumPy) with the image axis sharded over every
    slot of ``mesh``.

    Returns the 15-tuple of ``pipeline.stitch._pair_shift`` outputs (shifts,
    pair_a, pair_b, any_match, counts, best_b, cand_idx, cand_dist,
    cand_inm, matched, border_flip, border_swap, material, n_material,
    max_inmargin) with a leading pair axis of N-1, on the first slot's
    device.  The escalation signals are zero (``margin`` 0); a caller that
    needs the single-device stitch's semantics uses
    :func:`sharded_multi_pano_full`.
    """
    cfg = cfg or StitchConfig(backend="harris")
    _check_axis(mesh, axis_name)
    return _first(_image_step(torch.as_tensor(batch)[None], mesh.slots, cfg,
                              full=False, batched=False))


def sharded_multi_pano_full(
    batch,
    mesh: Mesh,
    cfg: Optional[StitchConfig] = None,
    mode: str = "shard_map",
):
    """Full shift stage (:func:`_full_shift_step`) for a (P, N, H, W, 3)
    batch on the mesh: whole panoramas per slot of the first mesh axis,
    each panorama's images sharded over that slot's row on a 2-D mesh.
    Returns the ``(xy, valid_kp, meta, stats, pair_out)`` leaves with a
    leading P axis (``meta`` and ``stats`` are ``None`` for Harris), ready
    for ``pipeline.stitch.finalize_to_panorama`` per panorama.

    ``mode`` is ``"shard_map"`` or ``"vmap"``, the reference's two
    programs, bit-equal to each other.  ``"shard_map"`` (the default)
    runs a row's panoramas one after another, each through
    ``extract_features`` (whose schedule ``VFX_SIFT_BATCH_MODE`` picks)
    and a pair step of its own.  ``"vmap"`` runs all of a row's
    panoramas at once: each slot extracts its shard of every one of them
    in one batched pass (SIFT in the batched schedule) and matches all
    their local pairs in one pair step, as :func:`_multi_pano_full_step`
    does on one device.
    """
    cfg = cfg or StitchConfig(backend="sift")
    if mode not in ("shard_map", "vmap"):
        raise ValueError(f"mode {mode!r}: expected 'shard_map' or 'vmap'")
    return _grid_step(batch, mesh, cfg, full=True, batched=mode == "vmap")


def sharded_multi_pano_shifts(
    batch,
    mesh: Mesh,
    cfg: Optional[StitchConfig] = None,
):
    """The minimal step on a (P, N, H, W, 3) batch: data-parallel over
    panoramas on the first mesh axis, image-parallel within each on the
    others, each row's panoramas batched as in
    ``sharded_multi_pano_full(mode="vmap")`` (the JAX step is always a
    vmap over panoramas).  Returns :func:`_multi_pano_step`'s leaves."""
    cfg = cfg or StitchConfig(backend="harris")
    return _grid_step(batch, mesh, cfg, full=False, batched=True)
