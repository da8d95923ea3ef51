"""EC4T quantization state for the MLP parameter dict (paper §IV).

Only what freezing a pack needs: a quantized tensor is the dict
``{"w": master weights, "omega": (4,) centroids}`` and its state
``{"probs": (16,) cluster probabilities}``.  The straight-through
``fake_quant`` and the EMA update belong to training, which is ported later.
"""
from __future__ import annotations

from typing import Any

import torch

from . import bitplanes, ecl

QUANT_KEYS = frozenset({"w", "omega"})


def is_quant_leaf(node: Any) -> bool:
    return isinstance(node, dict) and QUANT_KEYS.issubset(node.keys())


def make_quant_param(w: torch.Tensor) -> dict:
    return {"w": w, "omega": bitplanes.init_omega_from_weights(w)}


def init_qstate_leaf(lead: tuple = (), device=None) -> dict:
    return {"probs": torch.full((*lead, ecl.NUM_CODES), 1.0 / ecl.NUM_CODES,
                                dtype=torch.float32, device=device)}


def build_qstate(params: Any) -> Any:
    """Mirror tree with a probs state per quantized leaf; other tensor
    leaves mirror to a uint8 placeholder sharing their leading dim, as the
    JAX package's ``build_qstate`` does."""
    if is_quant_leaf(params):
        w = params["w"]
        return init_qstate_leaf(tuple(w.shape[:-2]), device=w.device)
    if isinstance(params, dict):
        return {k: build_qstate(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(build_qstate(v) for v in params)
    if isinstance(params, torch.Tensor):
        lead = tuple(params.shape[:1]) if params.ndim >= 1 else ()
        return torch.zeros(lead, dtype=torch.uint8, device=params.device)
    return params
