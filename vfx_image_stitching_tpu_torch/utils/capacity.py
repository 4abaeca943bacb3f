"""Capacity overflow report for the fixed-capacity SIFT stages (copy of
the JAX package's ``capacity_overflow_report``)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def capacity_overflow_report(stats: Dict[str, np.ndarray]) -> List[str]:
    """Human-readable truncation warnings from a pipeline stats dict.

    ``stats`` is the (host) dict from
    :func:`models.sift.extract.sift_batch_with_stats` (leaves carry an
    N-image leading axis) or from a single-image run.  A count that
    *reaches* its capacity means the compaction stages may have dropped
    keypoints silently.
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
                "keypoints may have been truncated — raise SiftCapacities"
            )
    return msgs
