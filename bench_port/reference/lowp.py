"""The control's lower precision: values stored in bfloat16.

``store(x, on)`` rounds a float array to the nearest bfloat16 (ties to
even) and reads it back in its own dtype, where ``on``; otherwise it
returns ``x`` as it is.
"""

from __future__ import annotations

import numpy as np


def bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16 (8 mantissa bits, ties to even), in
    float32."""
    a = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = (a + np.uint32(0x7FFF) + ((a >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return rounded.view(np.float32)


def store(x, on: bool):
    """``x`` through a bfloat16 store where ``on``, in ``x``'s dtype."""
    if not on:
        return x
    arr = np.asarray(x)
    return bf16(arr).astype(arr.dtype)
