"""Minimal functional module system (the JAX package's ``nn/module.py``).

Parameters are nested dicts of tensors; a *quantized* tensor is the dict
``{"w", "omega"}`` and a *frozen* one ``{"packed", "omega"}`` (see
``core.qat``).  Every ``*_apply(p, q, x, ctx)`` consumes the parameter
tree ``p`` and the mirrored quantization-state tree ``q`` (probs at quant
leaves, 0 elsewhere).  ``QuantCtx`` carries the QAT mode, so one model
definition serves the fp32 baseline (``quant=False``), EC4T training
(``quant=True`` with the entropy-penalty strength ``lam``) and frozen
serving.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core import qat
from ..tree import leaves


@dataclasses.dataclass(frozen=True)
class QuantCtx:
    quant: bool = False                      # EC4T fake-quant active?
    lam: float = 0.0                         # entropy-penalty strength λ
    compute_dtype: torch.dtype = torch.bfloat16
    deterministic: bool = True

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype


FP32_CTX = QuantCtx(quant=False, compute_dtype=torch.float32)


def materialize(node: Any, q: Any, ctx: QuantCtx) -> torch.Tensor:
    """Resolve a (possibly quantized or frozen) weight leaf to the compute
    dtype.  A frozen leaf decodes its 4-bit codes on every call
    (W = Σ ω_i B_i); no decoded copy is kept."""
    if qat.is_quant_leaf(node):
        if ctx.quant:
            return qat.apply_quant(node, q, ctx.lam, ctx.dtype)
        return node["w"].to(ctx.dtype)
    if qat.is_frozen_leaf(node):
        return qat.decode_frozen(node, ctx.dtype)
    return node.to(ctx.dtype)


def maybe_quant_param(w: torch.Tensor, quantize: bool) -> Any:
    return qat.make_quant_param(w) if quantize else w


def param_count(tree: Any) -> int:
    """Parameter count over every tensor leaf (masters counted once)."""
    return sum(leaf.numel() for leaf in leaves(tree)
               if isinstance(leaf, torch.Tensor))
