"""ACM execution of 4-bit-compact linear layers (paper eq. 1 + §V
epilogue): the JAX package's ``core/acm.py``.

Two execution paths:

* **training / fake-quant** — :func:`linear_qat`: straight-through
  fake-quantized weights (``qat.apply_quant``), a plain matmul
  (differentiable).
* **serving / frozen** — :func:`linear_serving`: packed 4-bit codes (two
  a byte) + 4 basis centroids through kernel 1 (``kernels.ops.
  fantastic4_matmul``: the hand-written CUDA kernel for a CUDA tensor,
  its plain version for a CPU tensor) with the fused epilogue

      y = α₂ · act( α₁ ⊙ (x·W) + b ).

:func:`acm_flop_count` is the paper's operation-count model of ACM
against MAC.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops
from . import bitplanes, ecl, qat


def linear_qat(x: torch.Tensor, node: dict, qstate: dict, lam,
               bias: Optional[torch.Tensor] = None,
               dtype=None) -> torch.Tensor:
    """Training-path quantized linear: x @ fake_quant(W) (+ bias)."""
    w = qat.apply_quant(node, qstate, lam, dtype or x.dtype)
    y = x @ w
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def freeze_linear(node: dict, qstate: dict, lam) -> dict:
    """Quantize a ``{"w", "omega"}`` leaf to its serving form: row-pair
    packed codes, fp32 ω and the (K, N) shape."""
    codes = ecl.assign(node["w"], node["omega"], qstate["probs"], lam)
    if codes.ndim != 2:
        codes = codes.reshape(codes.shape[0], -1)
    return {"packed": bitplanes.pack_codes_rows(codes),
            "omega": node["omega"].to(torch.float32),
            "shape": tuple(codes.shape)}


def linear_serving(x: torch.Tensor, frozen: dict,
                   bias: Optional[torch.Tensor] = None,
                   alpha1: Optional[torch.Tensor] = None,
                   alpha2: Optional[torch.Tensor] = None,
                   activation: Optional[str] = None,
                   use_kernel: bool = True) -> torch.Tensor:
    """Serving-path quantized linear on packed 4-bit codes, through kernel
    1 (``use_kernel=False``: the plain oracle on either device)."""
    k, n = frozen["shape"]
    y = ops.fantastic4_matmul(
        x.reshape(-1, k), frozen["packed"], frozen["omega"], bias=bias,
        alpha1=alpha1, alpha2=alpha2, activation=activation,
        use_kernel=use_kernel)
    return y.reshape(*x.shape[:-1], n)


def acm_flop_count(m: int, k: int, n: int, sparsity: float = 0.0) -> dict:
    """Operation-count model of ACM vs MAC (paper §III-A).

    MAC: k multiplies + k adds per output element.  ACM: additions
    dominated by the non-zero bit-plane pop-count (≈ 2 bit-adds a non-zero
    weight); exactly 4 multiplies per output element for the basis
    combination.
    """
    mac_mul = m * n * k
    mac_add = m * n * k
    dens = 1.0 - sparsity
    acm_add = int(m * n * k * dens * 2)
    acm_mul = m * n * 4
    return {"mac_mul": mac_mul, "mac_add": mac_add,
            "acm_mul": acm_mul, "acm_add": acm_add,
            "mul_reduction": mac_mul / max(acm_mul, 1)}
