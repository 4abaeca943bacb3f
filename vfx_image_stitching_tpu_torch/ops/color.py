"""Color conversion with cv2 fixed-point parity.

The reference converts BGR uint8 to gray via ``cv2.cvtColor`` before any
float math, so the gray image is quantized to uint8 with OpenCV's
fixed-point weights.  OpenCV >= 5 uses 15-bit fixed point:
``gray = (B*3735 + G*19235 + R*9798 + 2^14) >> 15`` — the same formula as
the JAX package's ``ops/color.py``.
"""

from __future__ import annotations

import numpy as np
import torch

_B2Y = 3735
_G2Y = 19235
_R2Y = 9798
_SHIFT = 15


def bgr_to_gray_u8(img_bgr: torch.Tensor) -> torch.Tensor:
    """BGR uint8 (..., 3) -> gray uint8 (...); an already-gray input
    (no trailing 3-channel axis) passes through."""
    if img_bgr.ndim < 3 or img_bgr.shape[-1] != 3:
        return img_bgr.to(torch.uint8)
    b = img_bgr[..., 0].to(torch.int32)
    g = img_bgr[..., 1].to(torch.int32)
    r = img_bgr[..., 2].to(torch.int32)
    y = (b * _B2Y + g * _G2Y + r * _R2Y + (1 << (_SHIFT - 1))) >> _SHIFT
    return y.to(torch.uint8)


def bgr_to_gray_f32(img_bgr: torch.Tensor) -> torch.Tensor:
    """cvtColor-then-astype(float32), as the reference feature stacks do."""
    return bgr_to_gray_u8(img_bgr).to(torch.float32)


def bgr_to_gray_u8_np(img_bgr: np.ndarray) -> np.ndarray:
    """Host (NumPy) twin of :func:`bgr_to_gray_u8` — same fixed point."""
    b = img_bgr[..., 0].astype(np.int32)
    g = img_bgr[..., 1].astype(np.int32)
    r = img_bgr[..., 2].astype(np.int32)
    y = (b * _B2Y + g * _G2Y + r * _R2Y + (1 << (_SHIFT - 1))) >> _SHIFT
    return y.astype(np.uint8)
