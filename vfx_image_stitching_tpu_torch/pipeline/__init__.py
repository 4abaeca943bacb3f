"""End-to-end stitching pipelines and CLI of the PyTorch port."""

from vfx_image_stitching_tpu_torch.pipeline.stitch import (
    StitchResult,
    compute_pairwise_shifts,
    stitch_panorama,
)
from vfx_image_stitching_tpu_torch.pipeline.multi import stitch_many

__all__ = [
    "StitchResult", "compute_pairwise_shifts", "stitch_panorama",
    "stitch_many",
]
