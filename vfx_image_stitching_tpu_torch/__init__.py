"""PyTorch/CUDA port of the panorama stitcher.

Beside the JAX package ``vfx_image_stitching_tpu`` (the reference), this
package runs the same Harris (the default) and SIFT stitches on an NVIDIA
GPU: dense stages are plain PyTorch on tensors, and each of the nine
Pallas TPU kernels of the repository has a CUDA C++ counterpart in
``csrc/`` built with ``nvcc`` at first use: the SIFT stitch's Newton
localization, orientation histograms and descriptor window gather (K1-K3),
the off-path v1 orientation and descriptor-histogram kernels (K4, K5), and
the probe kernels P1-P4 (``probes/``).  On CPU tensors every kernel
wrapper runs its plain PyTorch version instead, which is what the CPU
tests compare against the JAX package.

Entry points: ``pipeline.stitch_panorama`` and the stage API
(``compute_pairwise_shifts``, ``finalize_to_panorama``), each composing
on its batch's device, with save and profile; ``pipeline.stitch_many``,
on one device or sharded over a ``parallel`` mesh of devices (or of
logical slots on one device); ``compat`` (the reference's function
surface); ``models.sift`` (the ``sift_impl`` stage names);
``utils.capacity.audit_sift_capacities``; the headless visualizers of
``viz``; the CLI ``python -m vfx_image_stitching_tpu_torch.pipeline.cli``.
Each runs on ``device="cuda"`` unless the caller asks for the CPU, and
raises without CUDA rather than falling back.

Modules sit at the same relative paths as their JAX counterparts, and
each package re-exports the names of its counterpart's ``__all__``.  The
package imports neither ``jax`` nor anything of ``vfx_image_stitching_tpu``;
the numpy-only modules it needs are copies.
"""

from vfx_image_stitching_tpu_torch.config import (
    HarrisConfig,
    MatchConfig,
    SiftCapacities,
    SiftConfig,
    StitchConfig,
)
from vfx_image_stitching_tpu_torch.io import load_dataset, read_pano_data

__version__ = "0.1.0"


def stitch_panorama(*args, **kwargs):
    """Lazy re-export of :func:`pipeline.stitch.stitch_panorama`."""
    from vfx_image_stitching_tpu_torch.pipeline.stitch import (
        stitch_panorama as fn,
    )

    return fn(*args, **kwargs)


def stitch_many(*args, **kwargs):
    """Lazy re-export of :func:`pipeline.multi.stitch_many`."""
    from vfx_image_stitching_tpu_torch.pipeline.multi import stitch_many as fn

    return fn(*args, **kwargs)


__all__ = [
    "HarrisConfig",
    "MatchConfig",
    "SiftCapacities",
    "SiftConfig",
    "StitchConfig",
    "read_pano_data",
    "load_dataset",
    "stitch_panorama",
    "stitch_many",
    "__version__",
]
