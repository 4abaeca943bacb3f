"""The plain reference that decides a run's ``correct``.

A straightforward NumPy and cv2 implementation of the reference
stitcher's semantics (sapt36/VFX_Image_Stitching: ``image_stitching_*.py``
and ``sift_impl.py``), written from what those scripts compute and not
from the port's design: no fixed capacities, chunks, compaction,
batching or precision escalation, and no device.  cv2 builds the images
the reference builds with it (the SIFT pyramid, the Harris blurs); the
rest is NumPy, image by image and keypoint by keypoint:

* :mod:`.gray`: OpenCV 5's BGR-to-gray, spelt out;
* :mod:`.cylindrical`: the forward-rounded cylindrical projection;
* :mod:`.harris`: Harris corners and their 128-d patch descriptors, in
  float64 as the reference computes them;
* :mod:`.sift`: Lowe's SIFT (cv2 pyramid, extrema, Newton localization,
  orientations, duplicate removal, descriptors);
* :mod:`.pairs`: nearest-neighbour matching, the exhaustive translation
  vote, drift correction;
* :mod:`.compose`: the sequential pairwise blend and the crop;
* :mod:`.stitch`: one panorama from decoded images.

It imports nothing of the program and takes nothing the program made:
the benchmark hands it the images it decoded itself.  ``precision``
``"bf16"`` is the comparison's control: the same reference with its
float fields stored in bfloat16 (:mod:`.lowp`).
"""
