"""Reference 3x3 gradient convolutions and gradient orientation fields.

The reference computes gradients with a generic shifted-add conv2d over an
edge-padded image using the signed kernels ``Hx=[[0,0,0],[1,0,-1],[0,0,0]]``
and ``Hy=[[0,1,0],[0,0,0],[0,-1,0]]``.  These compute ``I(x-1) - I(x+1)``
— a *negated* central difference — and the sign feeds the descriptor
orientation histograms, so it must match exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vfx_image_stitching_tpu_torch.ops.gaussian import edge_pad_axis

HX = np.array([[0, 0, 0], [1, 0, -1], [0, 0, 0]], dtype=np.float32)
HY = np.array([[0, 1, 0], [0, 0, 0], [0, -1, 0]], dtype=np.float32)


def conv2d_edge(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """2-D convolution over trailing (H, W) with edge padding: k^2
    shifted adds of the edge-padded image (zero taps skipped), float32."""
    kernel = np.asarray(kernel, dtype=np.float32)
    m, n = kernel.shape
    h, w = img.shape[-2], img.shape[-1]
    pad = img.to(torch.float32)
    pad = edge_pad_axis(pad, m // 2, pad.ndim - 2)
    pad = edge_pad_axis(pad, n // 2, pad.ndim - 1)
    out = None
    for i in range(m):
        for j in range(n):
            if kernel[i, j] == 0.0:
                continue
            term = pad[..., i : i + h, j : j + w] * float(kernel[i, j])
            out = term if out is None else out + term
    if out is None:
        out = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    return out


def reference_gradients(gray: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Ix, Iy) with the reference's signed kernels."""
    return conv2d_edge(gray, HX), conv2d_edge(gray, HY)


def calc_orientation(ix: torch.Tensor, iy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient magnitude and angle in degrees [0, 360)."""
    m = torch.sqrt(ix * ix + iy * iy)
    theta = torch.atan2(iy, ix) * (180.0 / np.pi)
    theta = torch.remainder(theta + 360.0, 360.0)
    return m, theta
