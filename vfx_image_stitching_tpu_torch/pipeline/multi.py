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

The JAX package's mesh-sharded path (``parallel/mesh.py``) is not
ported yet (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import time
from typing import Dict, Optional, Sequence

import torch

from vfx_image_stitching_tpu_torch.config import (
    DEFAULT_CROP_MARGINS,
    StitchConfig,
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
)


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
    for its decode) and ``cumulative`` (seconds since the call began).
    """
    if mesh is not None:
        raise NotImplementedError(
            "stitch_many(mesh=...): the mesh-sharded path needs "
            "parallel/mesh.py, which is not ported yet (ROADMAP Queue 1 "
            "item 4)")
    dev = resolve_device(device)
    cfg = cfg or StitchConfig(backend=backend)
    if cfg.backend != backend:
        cfg = dataclasses.replace(cfg, backend=backend)
    cfg = _autoscale_many(cfg, folders)
    margins = margins or {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    names = [os.path.basename(os.path.normpath(f)) for f in folders]

    results: Dict[str, StitchResult] = {}
    with cf.ThreadPoolExecutor(max_workers=len(folders)) as pool:
        loads = [pool.submit(_load, f) for f in folders]
        for name, load in zip(names, loads):
            tw = time.time()
            batch, valid, focals = load.result()
            load_wait = time.time() - tw
            margin = margins.get(name, DEFAULT_CROP_MARGINS.get(name, 15))
            # capacity_stats surfaced, not recovered: the datasets share
            # one configuration; stitch_panorama recovers one dataset
            res = _stitch_inner(batch, valid, focals, margin, cfg, dev,
                                verbose=False)
            res.timings["load_wait"] = load_wait
            res.timings["cumulative"] = time.time() - t0
            results[name] = res
            if verbose:
                print(f"{name}: {res.panorama.shape} in "
                      f"{res.timings['total']:.2f} s (cumulative "
                      f"{res.timings['cumulative']:.2f} s)")

    if verbose:
        print(f"stitched {len(folders)} panoramas in {time.time() - t0:.2f} s")
    return results
