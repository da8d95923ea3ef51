"""Plain PyTorch oracles for the FantastIC4 kernels.

``fantastic4_matmul_ref`` decodes the packed 4-bit codes to weights, runs
one fp32 matmul and the fused §V epilogue; ``acm_bitplane_ref`` is the
literal accumulate-then-multiply form of eq. (1).  The kernel modules'
plain versions are built from these expressions, so on the CPU every
schedule computes the same thing term for term.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core import bitplanes

# Activation codes: the wire format of the ws/stream meta operand and of
# the CUDA kernels' layer table.  relu(0) and gelu(0) are exactly 0, so
# zero-padded epilogue columns stay zero under every activation.
ACTIVATION_CODES = {None: 0, "none": 0, "relu": 1, "gelu": 2}


def activation_code(activation: Optional[str]) -> int:
    try:
        return ACTIVATION_CODES[activation]
    except KeyError:
        raise ValueError(f"unsupported activation {activation}") from None


def apply_activation(y: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    """gelu is the tanh approximation, as ``jax.nn.gelu``'s default."""
    if activation == "relu":
        return torch.clamp_min(y, 0.0)
    if activation == "gelu":
        return F.gelu(y, approximate="tanh")
    if activation in (None, "none"):
        return y
    raise ValueError(f"unsupported activation {activation}")


def apply_activation_coded(y: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """Data-coded twin of :func:`apply_activation` (0 none, 1 relu, 2 gelu)."""
    return torch.where(code > 1.5, F.gelu(y, approximate="tanh"),
                       torch.where(code > 0.5, torch.clamp_min(y, 0.0), y))


def quantize_int8(y: torch.Tensor, s) -> torch.Tensor:
    """§VI-C re-quantization: clip(round(y / s), ±127) through int8, back as
    fp32.  ``torch.round`` rounds half to even, as ``jnp.round``.  The
    scale is expanded to y's shape so the division is a true IEEE division
    on every device (a scalar divisor may be taken as a multiply by its
    reciprocal), as the CUDA epilogue's ``__fdiv_rn``."""
    s = torch.as_tensor(s, dtype=torch.float32, device=y.device)
    q = torch.clamp(torch.round(y / s.expand_as(y)), -127.0, 127.0)
    return q.to(torch.int8).to(torch.float32)


def _epilogue(y: torch.Tensor, bias, alpha1, alpha2,
              activation: Optional[str], out_dtype) -> torch.Tensor:
    if alpha1 is not None:
        y = y * alpha1.to(y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    y = apply_activation(y, activation)
    if alpha2 is not None:
        y = y * torch.as_tensor(alpha2, dtype=y.dtype, device=y.device)
    return y.to(out_dtype)


def unpack_rows(packed: torch.Tensor) -> torch.Tensor:
    """(K//2, N) uint8 -> (K, N) uint8 codes; byte r = c[2r] | c[2r+1]<<4."""
    return bitplanes.unpack_codes_rows(packed)


def decode_weights(packed: torch.Tensor, omega: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return bitplanes.decode(unpack_rows(packed), omega, dtype)


def fantastic4_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                          omega: torch.Tensor, bias=None, alpha1=None,
                          alpha2=None, activation: Optional[str] = None,
                          out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or x.dtype
    w = decode_weights(packed, omega, torch.float32)
    y = x.to(torch.float32) @ w
    return _epilogue(y, bias, alpha1, alpha2, activation, out_dtype)


def acm_bitplane_ref(x: torch.Tensor, packed: torch.Tensor,
                     omega: torch.Tensor, bias=None, alpha1=None, alpha2=None,
                     activation: Optional[str] = None,
                     out_dtype=None) -> torch.Tensor:
    """Accumulate per bit-plane first, then 4 multiplies (paper fig. 1)."""
    out_dtype = out_dtype or x.dtype
    codes = unpack_rows(packed).to(torch.int64)
    xf = x.to(torch.float32)
    acc = 0.0
    for i in range(bitplanes.NUM_BASIS):
        plane = ((codes >> i) & 1).to(torch.float32)
        acc = acc + omega[i].to(torch.float32) * (xf @ plane)
    return _epilogue(acc, bias, alpha1, alpha2, activation, out_dtype)


def ecl_quant_ref(w: torch.Tensor, omega: torch.Tensor, penalty: torch.Tensor
                  ) -> tuple:
    """Fused ECL assignment + dequantization oracle; penalty (16,) is
    λ·(-log2 P) already computed.  Returns (codes uint8, ŵ fp32)."""
    book = bitplanes.codebook(omega).to(torch.float32)
    cost = (w.to(torch.float32)[..., None] - book) ** 2 + penalty
    codes = torch.argmin(cost, dim=-1)
    return codes.to(torch.uint8), book[codes]
