"""Gaussian and DoG pyramids (sift_impl.py:45-111 parity).

Octave shapes are a pure function of the input shape: a Python loop over
octaves emits one (…, 6, H_o, W_o) stack each.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from vfx_image_stitching_tpu_torch.ops.gaussian import gaussian_blur
from vfx_image_stitching_tpu_torch.ops.resize import (
    downsample2x_nearest,
    upsample2x_linear,
)


def generate_base_image(
    gray: torch.Tensor, sigma: float = 1.6, assumed_blur: float = 0.5
) -> torch.Tensor:
    """2x bilinear upsample + differential blur (sift_impl.py:45-56)."""
    up = upsample2x_linear(gray)
    sigma_diff = math.sqrt(max(sigma**2 - (2.0 * assumed_blur) ** 2, 0.01))
    return gaussian_blur(up, sigma_diff)


def compute_number_of_octaves(shape: Sequence[int]) -> int:
    """``round(log2(min(shape)) - 1)`` (sift_impl.py:59-63)."""
    return int(np.round(np.log(min(shape)) / np.log(2) - 1))


def generate_gaussian_kernels(sigma: float, num_intervals: int) -> np.ndarray:
    """Incremental per-level blur sigmas (sift_impl.py:66-79), host consts."""
    num_images = num_intervals + 3
    k = 2 ** (1.0 / num_intervals)
    kernels = np.zeros(num_images)
    kernels[0] = sigma
    for idx in range(1, num_images):
        sigma_prev = (k ** (idx - 1)) * sigma
        sigma_total = k * sigma_prev
        kernels[idx] = math.sqrt(sigma_total**2 - sigma_prev**2)
    return kernels


def octave_shapes(
    base_shape: Tuple[int, int], num_octaves: int
) -> List[Tuple[int, int]]:
    """Static (H_o, W_o) schedule: each next octave halves level[-3]."""
    shapes = []
    h, w = base_shape
    for _ in range(num_octaves):
        shapes.append((h, w))
        h, w = h // 2, w // 2
    return shapes


def generate_gaussian_images(
    base: torch.Tensor, num_octaves: int, kernels: np.ndarray
) -> List[torch.Tensor]:
    """Per-octave stacks [(…, 6, H_o, W_o)] (sift_impl.py:82-97 parity):
    levels blur incrementally from the previous level; the next octave's
    base is level[-3] downsampled 2x nearest."""
    pyramid = []
    img = base.to(torch.float32)
    for _ in range(num_octaves):
        levels = [img]
        for g in kernels[1:]:
            img = gaussian_blur(img, float(g))
            levels.append(img)
        pyramid.append(torch.stack(levels, dim=-3))
        img = downsample2x_nearest(levels[-3])
    return pyramid


def generate_dog_images(pyramid: List[torch.Tensor]) -> List[torch.Tensor]:
    """Per-octave DoG stacks [(…, 5, H_o, W_o)] (sift_impl.py:100-111)."""
    return [oct[..., 1:, :, :] - oct[..., :-1, :, :] for oct in pyramid]


def gradient_fields(octave_stack: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(magnitude, angle-degrees) fields for every level of an octave.

    Direct-differencing gradients of the orientation and descriptor
    stages (sift_impl.py:265-268, :414-417):
        gx = img[y, x+1] - img[y, x-1];  gy = img[y-1, x] - img[y+1, x]
    Border values are zero; those stages never sample them.
    """
    gx = torch.zeros_like(octave_stack)
    gy = torch.zeros_like(octave_stack)
    gx[..., 1:-1] = octave_stack[..., 2:] - octave_stack[..., :-2]
    gy[..., 1:-1, :] = octave_stack[..., :-2, :] - octave_stack[..., 2:, :]
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.remainder(torch.rad2deg(torch.atan2(gy, gx)), 360.0)
    return mag, ang
