"""Robust estimation: translation voting RANSAC and drift correction."""

from vfx_image_stitching_tpu_torch.estimate.ransac import translation_ransac
from vfx_image_stitching_tpu_torch.estimate.drift import correct_drift

__all__ = ["translation_ransac", "correct_drift"]
