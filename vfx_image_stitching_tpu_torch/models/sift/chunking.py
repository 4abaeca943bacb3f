"""Live-chunk bound for the fixed-capacity SIFT stages.

Capacities are audited worst-case and compaction packs the valid rows to
the front, so a typical image fills well under half its slots.  The
stages process only the leading chunks that hold a valid row; the rest
come out as all-zero, ``valid=False`` rows, as in the JAX package.

The bound derives from the LAST valid row (not the valid count), so a
caller that passes non-compacted rows still gets every valid row
processed.

A batch of images ((N, K) rows, the batched schedule) runs one bound for
all of them: the largest image's, as JAX ``vmap`` runs a loop to the
batch's largest trip count.  Each image's rows past its own bound are
computed on dead inputs and then zeroed (:func:`finish_rows`), so they
come out as the rows the one-image schedule pads in.
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


def live_rows(valid: torch.Tensor, chunk: int):
    """Rows a stage processes for a (K,) or (N, K) validity mask:
    ``(n_rows, own)``.  ``n_rows`` is the live leading chunks' rows, for
    a batch the most over its images (a host int: one scalar read back
    from the device either way); ``own`` is None for one image, and for a
    batch each image's own live rows, an (N,) tensor that stays on the
    device."""
    if valid.ndim == 1:
        return live_chunk_bound(valid, chunk) * chunk, None
    k = valid.shape[-1]
    if k == 0:
        return 0, torch.zeros(valid.shape[:-1], dtype=torch.int32,
                              device=valid.device)
    pos = torch.arange(1, k + 1, dtype=torch.int32, device=valid.device)
    last = torch.where(valid, pos, torch.zeros_like(pos)).amax(dim=-1)
    own = torch.div(last + (chunk - 1), chunk, rounding_mode="floor") * chunk
    return int(own.max()), own


def finish_rows(fields, own, k: int):
    """A NamedTuple of a stage's ``n_rows`` output rows, padded with zero
    rows to ``k``.  The row axis is 0 for one image and 1 for a batch,
    whose rows from each image's own bound on (``own``, from
    :func:`live_rows`) are zeroed first; a field may carry per-row axes
    after the row axis."""
    if own is None:
        return zero_pad_rows(fields, k)
    n_rows = fields[0].shape[1]
    keep = torch.arange(n_rows, device=own.device) < own[:, None]
    out = []
    for f in fields:
        m = keep.reshape(keep.shape + (1,) * (f.ndim - 2))
        f = torch.where(m, f, torch.zeros((), dtype=f.dtype, device=f.device))
        if n_rows < k:
            f = torch.cat([f, f.new_zeros((f.shape[0], k - n_rows) + tuple(f.shape[2:]))], 1)
        out.append(f)
    return type(fields)(*out)


def batch_rows(stack: torch.Tensor, *rows: torch.Tensor):
    """Flatten (N, n) per-image rows of an (N, L, H, W) batch of stacks
    to (N*n,) rows, with each row's image index; one image's rows pass
    through with index None."""
    if stack.ndim == 3:
        return rows, None
    n_img, n = rows[0].shape
    img = torch.arange(n_img, dtype=torch.int32, device=stack.device)
    img = img[:, None].expand(n_img, n).reshape(-1)
    return tuple(r.reshape(-1) for r in rows), img


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
