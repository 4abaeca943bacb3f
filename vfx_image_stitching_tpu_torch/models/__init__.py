"""Feature backends (the framework's "models"): Harris and SIFT.

Both emit keypoint positions plus L2-comparable 128-d float32
descriptors as fixed-capacity masked tensors.  Importing a backend builds
no kernel: the CUDA library is compiled at the first launch on a card.
"""

from vfx_image_stitching_tpu_torch.models.harris import (
    harris_corners,
    harris_keypoints_and_descriptors,
)

__all__ = [
    "harris_corners",
    "harris_keypoints_and_descriptors",
]
