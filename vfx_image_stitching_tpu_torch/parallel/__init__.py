"""Multi-device scaling over meshes of devices, single-controller.

Per-image stages (projection, features) are independent across images,
the pair step couples adjacent images only, and each panorama's tail
(escalation, drift, compose, crop) is its own; so a panorama's images
shard over slots with a one-image halo exchange, and whole panoramas
spread over the pano axis.  One process drives every slot, one thread and
one CUDA stream per slot (:mod:`.mesh`).
"""

from vfx_image_stitching_tpu_torch.parallel.mesh import (
    make_mesh,
    make_mesh_2d,
    make_mesh_pano,
    sharded_pairwise_shifts,
    sharded_multi_pano_shifts,
    sharded_multi_pano_full,
    shard_batch,
)

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "make_mesh_pano",
    "sharded_pairwise_shifts",
    "sharded_multi_pano_shifts",
    "sharded_multi_pano_full",
    "shard_batch",
]
