"""Capacity auditing for the fixed-capacity SIFT stages.

The reference uses dynamic Python lists everywhere; the pipeline uses
fixed capacities with validity masks (SiftCapacities).
:func:`audit_sift_capacities` runs the extraction over a dataset and
reports per-stage occupancy against capacity, so a capacity regression
(truncation) is caught before it silently drops keypoints;
:func:`capacity_overflow_report` turns a run's stats into warnings (a
copy of the JAX package's).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from vfx_image_stitching_tpu_torch.config import SiftConfig


def audit_sift_capacities(
    images: List[np.ndarray], cfg: SiftConfig = SiftConfig(),
    autogrow: bool = False, *, device="cuda",
) -> Dict[str, np.ndarray]:
    """Max per-stage occupancy across ``images``; raises on truncation.

    Runs :func:`models.sift.extract.sift_keypoints_and_descriptors` on
    ``device`` (the card unless the caller asks for the CPU).  Returns
    {"cand_counts", "cand_caps", "loc_counts", "loc_caps",
    "oriented_counts", "oriented_caps", "desc_big_counts",
    "desc_big_caps", "final_counts", "final_cap"} with counts maxed over
    the dataset (plus the resolved ``SiftCapacities`` under "caps").

    With ``autogrow`` the audit resolves an overflow the way the
    pipeline's recovery loop does (SiftCapacities.grown_to_fit) — grow
    the stage at capacity and re-run — instead of raising; the returned
    "caps" then carry the converged tables for this content.
    """
    from vfx_image_stitching_tpu_torch.models.sift.extract import (
        sift_keypoints_and_descriptors,
    )
    from vfx_image_stitching_tpu_torch.pipeline.stitch import resolve_device

    dev = resolve_device(device)
    tensors = [torch.as_tensor(np.asarray(img)).to(dev) for img in images]
    for _attempt in range(4 if autogrow else 1):
        agg: Dict[str, np.ndarray] = {}
        finals = []
        for img in tensors:
            _, _, stats = sift_keypoints_and_descriptors(img, cfg)
            stats = {k: v.cpu().numpy() for k, v in stats.items()}
            finals.append(int(stats["final_count"]))
            for key in ("cand_counts", "loc_counts", "oriented_counts",
                        "desc_big_counts"):
                agg[key] = (np.maximum(agg[key], stats[key])
                            if key in agg else stats[key])
            agg["cand_caps"] = stats["cand_caps"]
            agg["loc_caps"] = stats["loc_caps"]
            agg["oriented_caps"] = stats["oriented_caps"]
            agg["desc_big_caps"] = stats["desc_big_caps"]
        agg["final_counts"] = np.asarray(finals)
        agg["final_cap"] = np.asarray(int(cfg.capacities.max_keypoints))

        grow_stats = dict(agg)
        grow_stats["final_count"] = agg["final_counts"]
        grown = cfg.capacities.grown_to_fit(grow_stats)
        if grown is cfg.capacities:
            agg["caps"] = cfg.capacities
            return agg
        if not autogrow:
            raise RuntimeError(f"SIFT capacity overflow: {agg}")
        cfg = dataclasses.replace(cfg, capacities=grown)
    raise RuntimeError(
        f"SIFT capacity autogrow did not converge in 4 rounds: {agg}"
    )


def capacity_overflow_report(stats: Dict[str, np.ndarray]) -> List[str]:
    """Human-readable truncation warnings from a pipeline stats dict.

    ``stats`` is the (host) dict from
    :func:`models.sift.extract.sift_batch_with_stats` (leaves carry an
    N-image leading axis) or from a single-image run.  A count that
    *reaches* its capacity means the compaction stages may have dropped
    keypoints silently; re-audit with :func:`audit_sift_capacities`.
    """
    pairs = [
        ("cand_counts", "cand_caps", "raw extrema candidates"),
        ("loc_counts", "loc_caps", "localized candidates"),
        ("oriented_counts", "oriented_caps", "oriented keypoints"),
        ("desc_big_counts", "desc_big_caps", "big-window descriptors"),
        ("final_count", "final_cap", "final keypoints"),
    ]
    msgs: List[str] = []
    for ck, pk, label in pairs:
        if ck not in stats or pk not in stats:
            continue
        counts = np.asarray(stats[ck])
        caps = np.asarray(stats[pk])
        hit = counts >= caps
        if hit.any():
            msgs.append(
                f"{label}: count reached capacity "
                f"(max count {int(counts.max())}, cap {int(caps.max())}); "
                "keypoints may have been truncated — raise SiftCapacities "
                "or run utils.capacity.audit_sift_capacities on this data"
            )
    return msgs
