"""Visualization front-ends (reference UI parity).

The reference ships two PyQt5 windows: a SIFT stage visualizer
(sift_visualizeUI.py) and a Harris detection+matching demo
(harris_visualizeUI.py).  Here both are thin shells over the port's
backends, run on the card unless the caller asks for the CPU:

* :mod:`vfx_image_stitching_tpu_torch.viz.sift_visualizer` — per-stage
  panels (base image, Gaussian pyramid, DoG pyramid, keypoint overlay,
  first descriptor, FLANN+homography matching);
* :mod:`vfx_image_stitching_tpu_torch.viz.harris_demo` — corner overlay +
  side-by-side match lines.

Each module offers a PyQt5 ``*Window`` class (``None`` without PyQt5) and
a headless ``render_*`` function that writes the same panels as PNGs via
matplotlib.  Importing this package needs neither.
"""

from vfx_image_stitching_tpu_torch.viz.sift_visualizer import render_sift_report
from vfx_image_stitching_tpu_torch.viz.harris_demo import render_harris_demo

__all__ = ["render_sift_report", "render_harris_demo"]
