"""Resize primitives matched to the cv2 calls the reference makes.

* 2x bilinear upsample (``cv2.resize(fx=2, fy=2, INTER_LINEAR)``):
  half-pixel-center sampling with edge clamping.
* 2x nearest downsample (``cv2.resize((w//2, h//2), INTER_NEAREST)``):
  OpenCV picks ``src = floor(dst*2)``, which is the even-index slice
  ``img[::2, ::2]`` cropped to (h//2, w//2).
"""

from __future__ import annotations

import numpy as np
import torch


def _linear_weights(n_out: int, n_in: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2 INTER_LINEAR source indices/weights for a 1-D axis (float64)."""
    coords = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(coords).astype(np.int64)
    frac = coords - i0
    # cv2 clamps: coords below 0 use pixel 0 with weight 1; coords past the
    # last pixel use it with weight 1.
    frac = np.where(i0 < 0, 0.0, frac)
    i0 = np.clip(i0, 0, n_in - 1)
    frac = np.where(i0 >= n_in - 1, 0.0, frac)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, frac.astype(np.float32)


def upsample2x_linear(img: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample of trailing (H, W); cv2 INTER_LINEAR parity."""
    h, w = img.shape[-2], img.shape[-1]
    dev = img.device
    y0, y1, fy = (torch.as_tensor(a, device=dev) for a in _linear_weights(2 * h, h))
    x0, x1, fx = (torch.as_tensor(a, device=dev) for a in _linear_weights(2 * w, w))
    x = img.to(torch.float32)
    fy_b = fy[:, None]
    rows = x.index_select(-2, y0) * (1.0 - fy_b) + x.index_select(-2, y1) * fy_b
    return rows.index_select(-1, x0) * (1.0 - fx) + rows.index_select(-1, x1) * fx


def downsample2x_nearest(img: torch.Tensor) -> torch.Tensor:
    """Nearest 2x downsample of trailing (H, W) to (h//2, w//2)."""
    h, w = img.shape[-2], img.shape[-1]
    return img[..., : (h // 2) * 2 : 2, : (w // 2) * 2 : 2]
