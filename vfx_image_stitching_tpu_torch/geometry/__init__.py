"""Geometry: cylindrical projection and canvas placement."""

from vfx_image_stitching_tpu_torch.geometry.cylindrical import (
    cylindrical_index_map,
    cylindrical_project,
    cylindrical_project_batch,
)
from vfx_image_stitching_tpu_torch.geometry.canvas import (
    pad_amounts,
    place_on_canvas,
)

__all__ = [
    "cylindrical_index_map",
    "cylindrical_project",
    "cylindrical_project_batch",
    "place_on_canvas",
    "pad_amounts",
]
