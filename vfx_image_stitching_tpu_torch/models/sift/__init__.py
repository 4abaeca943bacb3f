"""SIFT backend of the PyTorch port.

The per-stage API mirrors sift_impl's public surface under the JAX
package's names (``vfx_image_stitching_tpu.models.sift.__all__``): the
pyramid stages, the keypoint set helpers, the extractors and the
reference-named stage functions of :mod:`.stages`.
"""

from vfx_image_stitching_tpu_torch.models.sift.pyramid import (
    generate_base_image,
    compute_number_of_octaves,
    generate_gaussian_kernels,
    generate_gaussian_images,
    generate_dog_images,
)
from vfx_image_stitching_tpu_torch.models.sift.keypoints import (
    Keypoints,
    unpack_octave,
    convert_keypoints_to_input_image_size,
    remove_duplicate_keypoints,
)
from vfx_image_stitching_tpu_torch.models.sift.extract import (
    sift_batch_with_stats,
    compute_keypoints_and_descriptors,
    sift_extract,
    sift_batch,
)
from vfx_image_stitching_tpu_torch.models.sift.stages import (
    generate_DoG_images,
    find_scale_space_extrema,
    generate_descriptors,
    is_pixel_an_extremum,
    localize_extremum_via_quadratic_fit,
    compute_keypoints_with_orientations,
    compare_keypoints,
)

__all__ = [
    "generate_base_image",
    "compute_number_of_octaves",
    "generate_gaussian_kernels",
    "generate_gaussian_images",
    "generate_dog_images",
    "Keypoints",
    "unpack_octave",
    "convert_keypoints_to_input_image_size",
    "remove_duplicate_keypoints",
    "compute_keypoints_and_descriptors",
    "sift_extract",
    "sift_batch",
    "generate_DoG_images",
    "find_scale_space_extrema",
    "generate_descriptors",
    "is_pixel_an_extremum",
    "localize_extremum_via_quadratic_fit",
    "compute_keypoints_with_orientations",
    "compare_keypoints",
    "sift_batch_with_stats",
]
