"""PyTorch/CUDA port of the panorama stitcher.

Beside the JAX package ``vfx_image_stitching_tpu`` (the reference), this
package runs the same Harris (the default) and SIFT stitches on an NVIDIA
GPU: dense stages are plain PyTorch on tensors, and the three SIFT stages
the JAX package wrote as Pallas
TPU kernels (Newton localization, orientation histograms, descriptor
window gather) are CUDA C++ kernels in ``csrc/`` built with ``nvcc`` at
first use.  On CPU tensors every kernel wrapper runs its plain PyTorch
version instead, which is what the CPU tests compare against the JAX
package.

Modules sit at the same relative paths as their JAX counterparts.  The
package imports neither ``jax`` nor anything of ``vfx_image_stitching_tpu``;
the numpy-only modules it needs are copies.
"""

__version__ = "0.1.0"


def stitch_panorama(*args, **kwargs):
    """Lazy re-export of :func:`pipeline.stitch.stitch_panorama`."""
    from vfx_image_stitching_tpu_torch.pipeline.stitch import (
        stitch_panorama as fn,
    )

    return fn(*args, **kwargs)
