"""Alignment + compositing: canvas planning, sequential blend, crop."""

from vfx_image_stitching_tpu_torch.compose.plan import ComposePlan, plan_compose
from vfx_image_stitching_tpu_torch.compose.blend import compose_mosaic
from vfx_image_stitching_tpu_torch.compose.crop import rectangle_crop

__all__ = ["ComposePlan", "plan_compose", "compose_mosaic", "rectangle_crop"]
