"""Counterparts of the JAX package's kernel probe scripts (``scripts/``).

``localize_resident_r4`` and ``desc_scratch_dot`` are entry points
(``python -m vfx_image_stitching_tpu_torch.probes.<name>``, run from the
repository root); their four CUDA kernels and plain versions are in
``probes/kernels.py``.
"""
