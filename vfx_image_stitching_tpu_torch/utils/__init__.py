"""Utilities: phase timing, profiling hooks, capacity auditing."""

from vfx_image_stitching_tpu_torch.utils.profiling import (
    PhaseTimer,
    profile_trace,
)
from vfx_image_stitching_tpu_torch.utils.capacity import audit_sift_capacities

__all__ = ["PhaseTimer", "profile_trace", "audit_sift_capacities"]
