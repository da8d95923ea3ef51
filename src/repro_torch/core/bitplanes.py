"""Bit-plane decomposition of 4-bit weight codes (FantastIC4 eq. 1).

A quantized weight tensor is ``codes`` (uint8 cluster ids in [0, 16)) plus
``omega``, the 4 basis centroids; code ``c`` decodes to the subset sum
``v_c = Σ_i ω_i · bit_i(c)``, so ``W = Σ_i ω_i B_i`` and code 0 is an exact
zero.  Packed storage keeps two codes per byte along the contraction axis
(byte r = c[2r] | c[2r+1] << 4), the layout the CUDA kernels read;
:func:`pack_codes` is the reference's flat packing along the last axis,
and :func:`codes_to_bitplanes` the paper's bit-plane view B_i.

Every decode adds the four terms in the same order (i = 0..3, one rounding
per add), so the plain versions, the codebook and the kernels' decode give
bitwise-equal weights.
"""
from __future__ import annotations

import torch

NUM_BASIS = 4
NUM_CODES = 16


def codes_to_bitplanes(codes: torch.Tensor) -> torch.Tensor:
    """uint8 codes (...) -> bool bit-planes (4, ...), LSB first."""
    codes = codes.to(torch.uint8)
    return torch.stack([(codes >> i) & 1 for i in range(NUM_BASIS)]).to(
        torch.bool)


def bitplanes_to_codes(planes: torch.Tensor) -> torch.Tensor:
    """bool bit-planes (4, ...) -> uint8 codes (...)."""
    planes = planes.to(torch.uint8)
    out = torch.zeros(planes.shape[1:], dtype=torch.uint8,
                      device=planes.device)
    for i in range(NUM_BASIS):
        out = out | (planes[i] << i)
    return out


def codebook(omega: torch.Tensor) -> torch.Tensor:
    """All 16 subset sums: omega (*lead, 4) -> (*lead, 16), v_0 == 0."""
    idx = torch.arange(NUM_CODES, device=omega.device)
    out = torch.zeros((*omega.shape[:-1], NUM_CODES), dtype=omega.dtype,
                      device=omega.device)
    for i in range(NUM_BASIS):
        bit = ((idx >> i) & 1).to(omega.dtype)
        out = out + omega[..., i:i + 1] * bit
    return out


def decode(codes: torch.Tensor, omega: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """codes (*lead, R, C) with omega (*lead, 4), or any codes with an
    unbatched (4,) omega -> values of ``dtype``; W = Σ_i ω_i B_i.

    Each value is gathered from its lead index's :func:`codebook` in
    ``dtype``, whose entries add the four terms in the order above, so the
    weights are bitwise those of the term-by-term sum over the bit-planes.
    The only temporary is an int32 index of one lead slice: a stacked
    expert bank decodes one slice at a time into its output."""
    books = codebook(omega.to(dtype)).reshape(-1, NUM_CODES)
    out = torch.empty(codes.shape, dtype=dtype, device=codes.device)
    rows = codes.reshape(books.shape[0], -1)
    flat = out.view(books.shape[0], -1)
    for j in range(books.shape[0]):
        torch.index_select(books[j], 0, rows[j].to(torch.int32), out=flat[j])
    return out


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """uint8 codes (..., K) -> packed uint8 (..., K//2), low nibble first
    along the last axis; K even."""
    if codes.shape[-1] % 2:
        raise ValueError(
            f"trailing dim must be even, got {tuple(codes.shape)}")
    lo = codes[..., 0::2].to(torch.uint8)
    hi = codes[..., 1::2].to(torch.uint8)
    return (lo & 0xF) | (hi << 4)


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: (..., K//2) -> (..., K)."""
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def pack_codes_rows(codes: torch.Tensor) -> torch.Tensor:
    """uint8 codes (*lead, K, N) -> packed uint8 (*lead, K//2, N); K even."""
    if codes.shape[-2] % 2:
        raise ValueError(f"contraction dim must be even, got {tuple(codes.shape)}")
    lo = codes[..., 0::2, :].to(torch.uint8)
    hi = codes[..., 1::2, :].to(torch.uint8)
    return (lo & 0xF) | (hi << 4)


def unpack_codes_rows(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_codes_rows`: (*lead, K//2, N) -> (*lead, K, N)."""
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    out = torch.stack([lo, hi], dim=-2)           # (*lead, K//2, 2, N)
    return out.reshape(*packed.shape[:-2], packed.shape[-2] * 2,
                       packed.shape[-1])


def init_omega_from_weights(w: torch.Tensor) -> torch.Tensor:
    """Symmetric int4-like basis {s, 2s, 4s, -8s} with s = max|w| / 8 over
    the trailing two (matrix) dims: w (*lead, R, C) -> omega (*lead, 4)."""
    return omega_from_amax(w.abs().amax(dim=(-2, -1)), w.dtype)


def omega_from_amax(amax: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """:func:`init_omega_from_weights` from max|w| (*lead,) of each matrix
    (a sharded matrix's: its blocks' maxima reduced)."""
    s = torch.clamp(amax, min=1e-8) / 8.0
    return torch.stack([s, 2 * s, 4 * s, -8 * s], dim=-1).to(dtype)
