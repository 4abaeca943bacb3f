"""Separable Gaussian blur with cv2.GaussianBlur parity.

cv2 parity rules (the JAX package's ``ops/gaussian.py``):
  * auto kernel size for float images: ``ksize = round(sigma*8 + 1) | 1``;
  * kernel values ``exp(-i^2/(2 sigma^2))`` normalized to sum 1;
  * border handling BORDER_REFLECT_101.

The blur is k shifted multiply-adds per axis in tap order, vertical pass
first — the JAX package's order — not ``conv1d``, whose summation order
differs, so the pyramid stays bit-exact against the JAX package.  It
blurs the SIFT pyramid and Harris's 9x9 descriptor patches everywhere,
and Harris's 21-tap structure products on the CPU only: on the card
those are summed inside the kernel of ``csrc/harris_response.cu``, in
this order and with these reflected borders (``models/harris.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vfx_image_stitching_tpu_torch.utils.profiling import count_h2d


def cv2_auto_ksize(sigma: float) -> int:
    """OpenCV's automatic Gaussian kernel size for float-depth images."""
    return int(round(sigma * 8 + 1)) | 1


@functools.lru_cache(maxsize=None)
def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel parity (float32)."""
    i = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(i**2) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def _pad_axis(x: torch.Tensor, pad: int, axis: int, mode: str) -> torch.Tensor:
    """Pad one axis by gathering source indices (no arithmetic).

    ``np.pad`` of an index ramp gives the source element of every padded
    position, so ``mode="reflect"`` is BORDER_REFLECT_101 (repeating the
    reflection when ``pad`` exceeds the axis) and ``mode="edge"`` is
    BORDER_REPLICATE.
    """
    if pad == 0:
        return x
    idx = np.pad(np.arange(x.shape[axis]), pad, mode=mode)
    count_h2d(idx.nbytes)
    return x.index_select(axis, torch.as_tensor(idx, device=x.device))


def edge_pad_axis(x: torch.Tensor, pad: int, axis: int) -> torch.Tensor:
    """BORDER_REPLICATE pad along one axis."""
    return _pad_axis(x, pad, axis, "edge")


def _conv1d_taps(x: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    """k-tap 1-D convolution along ``axis`` as shifted adds in tap order."""
    k = len(kernel)
    n = x.shape[axis]
    xp = _pad_axis(x, k // 2, axis, "reflect")
    out = None
    for t in range(k):
        term = xp.narrow(axis, t, n) * float(kernel[t])
        out = term if out is None else out + term
    return out


def gaussian_blur(
    img: torch.Tensor, sigma: float, ksize: int | None = None
) -> torch.Tensor:
    """Blur the trailing (H, W) dims of ``img`` (any leading batch dims).

    ``ksize=None`` applies cv2's auto-size rule.  Input is converted to
    float32; border handling is BORDER_REFLECT_101.
    """
    if ksize is None:
        ksize = cv2_auto_ksize(sigma)
    x = img.to(torch.float32)
    if ksize <= 1:
        return x
    kernel = gaussian_kernel1d(ksize, sigma)
    x = _conv1d_taps(x, kernel, axis=x.ndim - 2)  # vertical
    return _conv1d_taps(x, kernel, axis=x.ndim - 1)  # horizontal
