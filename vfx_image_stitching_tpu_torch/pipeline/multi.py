"""Multi-panorama throughput: stitch several datasets in one run.

BASELINE config "Batched multi-panorama throughput (wind/out/parrington/
grail in one run)".  Every dataset's decode runs in its own thread; the
calling thread then stitches the datasets in input order through the
per-pass path of ``stitch_panorama`` (``stitch._stitch_inner``) under one
shared configuration, so later decodes overlap earlier datasets' device
work.  One dataset's host tail is not overlapped with the next one's
device stages: a staging thread that did so measured no gain on an H100
(PERF.md), because the SIFT extraction synchronizes once per stage for
its live-chunk bounds and so little device work can queue ahead.

With ``mesh`` (``parallel.make_mesh_pano`` or ``make_mesh_2d``) the
shift stage of same-shape datasets runs over the mesh's slots instead
(``parallel/mesh.py``), and each dataset then takes the same
``finalize_to_panorama`` tail on the mesh's first device.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
from typing import Dict, Optional, Sequence

import torch

from vfx_image_stitching_tpu_torch.config import (
    DEFAULT_CROP_MARGINS,
    StitchConfig,
)
from vfx_image_stitching_tpu_torch.geometry.cylindrical import (
    cylindrical_project_batch,
)
from vfx_image_stitching_tpu_torch.io import (
    load_dataset,
    peek_image_size,
    stack_dataset,
)
from vfx_image_stitching_tpu_torch.pipeline.stitch import (
    StitchResult,
    _autoscale_sift_caps,
    _stitch_inner,
    resolve_device,
    _upload_batch,
)
from vfx_image_stitching_tpu_torch.utils.profiling import request, span


def _autoscale_many(cfg: StitchConfig, folders) -> StitchConfig:
    """Area-scale default SIFT capacities by the LARGEST dataset image.

    One shared config for every dataset; capacities are upper bounds, so
    the max-area choice is pure headroom for the smaller datasets.
    Identity at reference-dataset sizes
    (config.SiftCapacities.scaled_for_area).
    """
    if cfg.backend != "sift":
        return cfg
    best = None
    for f in folders:
        hw = peek_image_size(f)
        if hw and (best is None or hw[0] * hw[1] > best[0] * best[1]):
            best = hw
    if best is None:
        return cfg
    return _autoscale_sift_caps(cfg, best)[0]


def _load(folder: str):
    images, focals, _paths = load_dataset(folder)
    if not images:
        raise ValueError(f"no valid entries in {folder}/pano.txt")
    batch, valid = stack_dataset(images)
    return batch, valid, focals


def stitch_many(
    folders: Sequence[str],
    backend: str = "sift",
    margins: Optional[Dict[str, int]] = None,
    cfg: Optional[StitchConfig] = None,
    verbose: bool = False,
    mesh=None,
    device="cuda",
) -> Dict[str, StitchResult]:
    """Stitch every dataset folder in one run on ``device`` (the card
    unless the caller asks for the CPU), decoding them all in threads.

    Results are keyed by the folder's base name, in input order; the crop
    margin of a dataset is ``margins[name]``, else the author's golden
    margin for that name (``config.DEFAULT_CROP_MARGINS``), else 15.  All
    datasets share one configuration (``backend`` overrides
    ``cfg.backend``; SIFT capacities are area-scaled for the largest
    image), so each result equals ``stitch_panorama`` of its folder under
    that configuration.  A capacity hit is reported in the result's
    ``capacity_stats`` and not recovered: re-run that dataset with
    ``stitch_panorama``, which grows the capacities.  Each result's
    ``timings`` are its pass's, plus ``load_wait`` (seconds spent waiting
    for its decode) and ``cumulative`` (seconds since the call began):
    the call is one request, whose root span (``stitch``) holds each
    dataset's ``load_wait`` span and phases (``utils/profiling.py``).

    With ``mesh`` (a ``parallel.mesh.Mesh``; ``device`` is then unused)
    the datasets run through :func:`_stitch_many_sharded`, with equal
    shifts, pairs and panoramas.
    """
    cfg = cfg or StitchConfig(backend=backend)
    if cfg.backend != backend:
        cfg = dataclasses.replace(cfg, backend=backend)
    cfg = _autoscale_many(cfg, folders)
    margins = margins or {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mesh is not None:
        return _stitch_many_sharded(folders, mesh, margins, cfg, verbose)
    dev = resolve_device(device)
    names = [os.path.basename(os.path.normpath(f)) for f in folders]

    results: Dict[str, StitchResult] = {}
    with request() as trace, \
            cf.ThreadPoolExecutor(max_workers=len(folders)) as pool:
        loads = [pool.submit(_load, f) for f in folders]
        for name, load in zip(names, loads):
            with span("load_wait"):
                batch, valid, focals = load.result()
            margin = margins.get(name, DEFAULT_CROP_MARGINS.get(name, 15))
            # capacity_stats surfaced, not recovered: the datasets share
            # one configuration; stitch_panorama recovers one dataset
            res = _stitch_inner(trace, batch, valid, focals, margin, cfg,
                                dev, verbose=False)
            res.timings["cumulative"] = trace.elapsed()
            results[name] = res
            if verbose:
                print(f"{name}: {res.panorama.shape} in "
                      f"{res.timings['total']:.2f} s (cumulative "
                      f"{res.timings['cumulative']:.2f} s)")
        if verbose:
            print(f"stitched {len(folders)} panoramas in "
                  f"{trace.elapsed():.2f} s")
    return results


def _stitch_many_sharded(
    folders: Sequence[str], mesh, margins: Dict[str, int],
    cfg: StitchConfig, verbose: bool,
) -> Dict[str, StitchResult]:
    """The multi-device path of :func:`stitch_many`, the counterpart of the
    JAX package's ``_stitch_many_sharded``.

    Datasets decode in threads and project on the mesh's first device;
    datasets of one image count and shape form a (P, N, H, W, 3) group,
    whose full shift stage runs over the mesh
    (``parallel.mesh.sharded_multi_pano_full``: on a 1-D mesh
    (``make_mesh_pano``) whole panoramas per slot, on a 2-D
    (``make_mesh_2d``) each panorama's images over its row; the mesh
    layer splits P and N over the axes and returns every leaf at its real
    size).  Then each dataset, in input order, takes the shared
    ``finalize_to_panorama`` tail on that device; a capacity hit is
    reported in ``capacity_stats`` and not recovered.  Each result's
    ``timings``: ``shift_stage`` (its group's sharded stage, seconds),
    ``finalize``, ``compose``, ``crop``, ``total`` (its own tail) and
    ``cumulative`` (since the call began), from the spans of the call's
    request.
    """
    from vfx_image_stitching_tpu_torch.parallel.mesh import (
        Mesh,
        _tree_map,
        sharded_multi_pano_full,
    )
    from vfx_image_stitching_tpu_torch.pipeline.stitch import (
        finalize_to_panorama,
    )

    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh: expected a vfx_image_stitching_tpu_torch.parallel Mesh, "
            f"got {type(mesh).__name__}")
    dev = mesh.devices.flat[0]
    with request() as trace:
        names = [os.path.basename(os.path.normpath(f)) for f in folders]
        with cf.ThreadPoolExecutor(max_workers=max(1, len(folders))) as pool:
            loaded = list(pool.map(_load, folders))

        groups: Dict[tuple, list] = {}
        for k, (batch, _valid, _focals) in enumerate(loaded):
            groups.setdefault(batch.shape, []).append(k)
        staged: Dict[int, tuple] = {}
        for members in groups.values():
            with span("shift_stage") as stage:
                cyls = [
                    cylindrical_project_batch(
                        _upload_batch(loaded[k][0], dev),
                        [float(f) for f in loaded[k][2]])
                    for k in members
                ]
                # (xy, valid_kp, meta, stats, pair_out), each with a
                # leading P axis
                leaves = sharded_multi_pano_full(torch.stack(cyls), mesh, cfg)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            shift_s = stage.seconds
            for q, k in enumerate(members):
                staged[k] = (cyls[q], _tree_map(lambda v: v[q], leaves),
                             shift_s)

        results: Dict[str, StitchResult] = {}
        for k, name in enumerate(names):
            _batch, valid, _focals = loaded[k]
            cyl, leaves, shift_s = staged[k]
            h, w = cyl.shape[1:3]
            margin = margins.get(name, DEFAULT_CROP_MARGINS.get(name, 15))
            fin = finalize_to_panorama(cyl, *leaves, list(valid), cfg, h, w,
                                       margin)
            results[name] = StitchResult(
                panorama=fin.panorama,
                mosaic=fin.mosaic,
                shifts=fin.shifts,
                corrected_shifts=fin.corrected,
                pairs=fin.pairs,
                timings=dict(
                    shift_stage=shift_s, finalize=fin.finalize_s,
                    compose=fin.compose_s, crop=fin.crop_s,
                    total=fin.finalize_s + fin.compose_s + fin.crop_s,
                    cumulative=trace.elapsed(),
                    esc_n_pairs=fin.detail.get("esc_n_pairs", 0),
                    esc_n_rows=fin.detail.get("esc_n_rows", 0)),
                capacity_stats=fin.detail.get("capacity_overflow"),
            )
            if verbose:
                print(f"{name}: {fin.panorama.shape} (cumulative "
                      f"{results[name].timings['cumulative']:.2f} s)")
        if verbose:
            print(f"stitched {len(folders)} panoramas on {mesh} in "
                  f"{trace.elapsed():.2f} s")
        return results
