"""Live-chunk bound for the fixed-capacity SIFT stages.

Capacities are audited worst-case and compaction packs the valid rows to
the front, so a typical image fills well under half its slots.  The
stages process only the leading chunks that hold a valid row; the rest
come out as all-zero, ``valid=False`` rows, as in the JAX package.

The bound derives from the LAST valid row (not the valid count), so a
caller that passes non-compacted rows still gets every valid row
processed.
"""

from __future__ import annotations

import math

import torch


def live_chunk_bound(valid: torch.Tensor, chunk: int) -> int:
    """Number of leading chunks containing any valid row (host int; this
    reads one scalar back from the device)."""
    k = valid.shape[0]
    if k == 0:
        return 0
    pos = torch.arange(1, k + 1, dtype=torch.int32, device=valid.device)
    last = int(torch.where(valid, pos, torch.zeros_like(pos)).max())
    return (last + chunk - 1) // chunk


def zero_pad_rows(fields, k: int):
    """A NamedTuple of row-major tensors padded with zero rows to ``k``
    rows (the rows of chunks that held no valid row)."""
    n = fields[0].shape[0]
    if n == k:
        return fields
    return type(fields)(*[
        torch.cat([f, f.new_zeros((k - n,) + tuple(f.shape[1:]))]) for f in fields
    ])


def chunk_size(k: int, chunk: int) -> int:
    """The chunk the JAX package uses for ``k`` rows: ``k`` itself when
    it fits in one chunk, else a divisor of ``k``."""
    if k <= chunk:
        return k
    if k % chunk:
        return math.gcd(k, chunk) or k
    return chunk
