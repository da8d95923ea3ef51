"""The QAT mode one model definition runs in.

Mirrors ``QuantCtx`` of the JAX package's ``nn/module.py``: the same MLP
forward serves the fp32 baseline (``quant=False``) and EC4T training
(``quant=True`` with the entropy-penalty strength ``lam``).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuantCtx:
    quant: bool = False                      # EC4T fake-quant active?
    lam: float = 0.0                         # entropy-penalty strength λ
    compute_dtype: torch.dtype = torch.bfloat16
    deterministic: bool = True

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype
