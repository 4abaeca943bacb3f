"""Descriptor matching."""

from vfx_image_stitching_tpu_torch.match.nn import (
    match_descriptors,
    pairwise_sqdist,
)

__all__ = ["match_descriptors", "pairwise_sqdist"]
