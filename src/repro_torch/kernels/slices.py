"""The slice-major copy of a layer's packed codes that every CUDA kernel reads.

A kernel CTA holds one column slice of a layer's codes in shared memory,
fetched with one bulk async copy.  Bulk copies move multiples of 16 bytes
between 16-byte aligned addresses, and a raw ``(K/2, N)`` pack's row stride
is N bytes (12 or 10 for a last layer), so each pack gets a slice-major copy
built once (the kernels' wrappers and ``ops`` memoize it, never per call):
slice s holds the packed columns ``[s·W, (s+1)·W)``, ``W = ceil(n_end /
n_slices)``, laid out ``(ceil(K/8), W, 4)`` bytes -- one 32-bit word per
column holds four packed rows, so a warp reads consecutive words and
decodes 8 weights of its column -- zero past the pack and padded to 16
bytes.  ``csrc/fantastic4_cluster.cuh::slice_pass`` reads this layout.

The cluster kernels cut each layer into one slice per CTA of the cluster;
the chain and stream kernels into slices of at most ``SLICE_COLS``
columns, so a 512-wide layer covers 32 CTAs.
"""
from __future__ import annotations

import torch

SLICE_ALIGN = 16       # bulk copies move multiples of 16 bytes
SLICE_COLS = 16        # chain and stream: columns per slice at most


def round_up(v: int, mult: int) -> int:
    return -(-max(v, 1) // mult) * mult


def slice_count(n_end: int, cols: int = SLICE_COLS) -> int:
    """Slices of at most ``cols`` columns that cover ``n_end`` columns."""
    return -(-n_end // cols)


def slice_width(n_end: int, slices: int) -> int:
    return -(-n_end // slices)


def slice_bytes(k: int, n_end: int, slices: int) -> int:
    """Bytes of one slice of a layer with K = k (even) rows."""
    return round_up(-(-k // 8) * slice_width(n_end, slices) * 4, SLICE_ALIGN)


def code_slices(packed: torch.Tensor, k: int, n: int, n_end: int,
                slices: int) -> torch.Tensor:
    """(slices, slice_bytes) uint8: slice s of the (k/2, >= n) row-pair
    packed codes, columns [s·W, (s+1)·W) laid out (ceil(k/8), W, 4) and zero
    past the pack."""
    w = slice_width(n_end, slices)
    q = -(-k // 8)
    p = packed[:k // 2, :n]
    p = torch.nn.functional.pad(p, (0, slices * w - n, 0, 4 * q - k // 2))
    p = p.reshape(q, 4, slices, w).permute(2, 0, 3, 1).reshape(slices, -1)
    return torch.nn.functional.pad(
        p, (0, slice_bytes(k, n_end, slices) - p.shape[1])).contiguous()
