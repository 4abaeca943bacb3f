"""Core dense image ops (plain PyTorch), each matched to the JAX package's."""

from vfx_image_stitching_tpu_torch.ops.color import (
    bgr_to_gray_f32,
    bgr_to_gray_u8,
)
from vfx_image_stitching_tpu_torch.ops.gaussian import (
    cv2_auto_ksize,
    gaussian_blur,
    gaussian_kernel1d,
)
from vfx_image_stitching_tpu_torch.ops.gradients import (
    calc_orientation,
    conv2d_edge,
    reference_gradients,
)
from vfx_image_stitching_tpu_torch.ops.resize import (
    downsample2x_nearest,
    upsample2x_linear,
)

__all__ = [
    "bgr_to_gray_u8",
    "bgr_to_gray_f32",
    "cv2_auto_ksize",
    "gaussian_kernel1d",
    "gaussian_blur",
    "conv2d_edge",
    "reference_gradients",
    "calc_orientation",
    "upsample2x_linear",
    "downsample2x_nearest",
]
