"""Kernel 1: the per-layer packed-int4 ACM matmul with fused §V epilogue.

Replaces the JAX package's ``kernels/fantastic4_matmul.py``
``fantastic4_matmul_pallas`` (body ``_kernel``).  Computes

    y = epilogue(x @ W),  W = Σ_i ω_i · bit_i(code)  from (K/2, N) row-pair
    packed codes (low nibble = row 2r),
    epilogue: y·α₁ + b, act ∈ {none, relu, tanh-gelu}, then ×α₂ — or, with
    ``quant_scale``, clip(rint(y / s), ±127) through int8 (the int8 chain).

On the H100 (``csrc/fantastic4.cu`` ``matmul_kernel``) one CTA computes a
32-row × 64-column output tile with K looped inside the block (the TPU
kernel carried its sum across an "arbitrary" K grid instead).  What bounds
it: at serving batches the packed codes it must read (bytes) for a few
rows, FFMA issue for many; each code byte is read once per row tile and
decoded into shared memory through a 16-entry codebook, and fp32 FFMA on
CUDA cores keeps the result inside the fp32 gate.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`fantastic4_matmul_plain`.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build, ref

LAUNCHES = 0


def _check(x: torch.Tensor, packed: torch.Tensor) -> None:
    if x.ndim != 2 or packed.ndim != 2:
        raise ValueError(f"x (M, K) and packed (K/2, N) expected, got "
                         f"{tuple(x.shape)} and {tuple(packed.shape)}")
    if x.shape[1] != 2 * packed.shape[0]:
        raise ValueError(f"K mismatch: x {tuple(x.shape)} vs packed "
                         f"{tuple(packed.shape)}")


def fantastic4_matmul_plain(x, packed, omega, alpha1, bias, alpha2, *,
                            activation: Optional[str] = None,
                            quant_scale: Optional[float] = None
                            ) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 out)."""
    _check(x, packed)
    y = ref.fantastic4_matmul_ref(
        x, packed, omega, bias=bias, alpha1=alpha1,
        alpha2=None if quant_scale is not None else alpha2,
        activation=activation, out_dtype=torch.float32)
    if quant_scale is not None:
        y = ref.quantize_int8(y, quant_scale)
    return y


def fantastic4_matmul_cuda(x, packed, omega, alpha1, bias, alpha2, *,
                           activation: Optional[str] = None,
                           quant_scale: Optional[float] = None
                           ) -> torch.Tensor:
    """Launch kernel 1 on x's device; fp32 (M, N) out."""
    global LAUNCHES
    _check(x, packed)
    dev = x.device
    m, k = x.shape
    n = packed.shape[1]
    xf = x.to(torch.float32).contiguous()
    pk = packed.to(dev, torch.uint8).contiguous()
    om = omega.to(dev, torch.float32).reshape(4).contiguous()
    a1 = (torch.ones(n, device=dev) if alpha1 is None
          else alpha1.to(dev, torch.float32).reshape(n).contiguous())
    b = (torch.zeros(n, device=dev) if bias is None
         else bias.to(dev, torch.float32).reshape(n).contiguous())
    scale_dev, scale = None, 1.0
    if quant_scale is not None:
        scale = float(quant_scale)
    elif isinstance(alpha2, torch.Tensor):
        scale_dev = alpha2.to(dev, torch.float32).reshape(1).contiguous()
    elif alpha2 is not None:
        scale = float(alpha2)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = build.load()
    err = lib.f4_matmul(
        xf.data_ptr(), pk.data_ptr(), om.data_ptr(), a1.data_ptr(),
        b.data_ptr(), None if scale_dev is None else scale_dev.data_ptr(),
        scale, int(quant_scale is not None), ref.activation_code(activation),
        m, k, n, y.data_ptr(), build.stream_handle(dev))
    build.check(err, "fantastic4_matmul kernel")
    LAUNCHES += 1
    return y


def fantastic4_matmul(x, packed, omega, alpha1=None, bias=None, alpha2=None,
                      *, activation: Optional[str] = None,
                      quant_scale: Optional[float] = None) -> torch.Tensor:
    """x (M, K) · packed (K/2, N) -> (M, N) fp32: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return fantastic4_matmul_cuda(x, packed, omega, alpha1, bias, alpha2,
                                      activation=activation,
                                      quant_scale=quant_scale)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return fantastic4_matmul_plain(x, packed, omega, alpha1, bias, alpha2,
                                   activation=activation,
                                   quant_scale=quant_scale)
