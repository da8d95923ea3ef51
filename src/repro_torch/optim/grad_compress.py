"""int8 error-feedback gradient compression (the JAX package's
``optim/grad_compress.py``).

Each eligible gradient (at least ``min_size`` elements, floating point)
is quantized with its error buffer to int8 on a per-tensor scale
max|g| / 127, dequantized, and the residual carried to the next step
(1-bit-Adam-style error feedback), so the sum of the applied gradients
tracks the sum of the true ones.  Smaller tensors (ω, norms) stay exact.

Only the local round trip is ported (``mesh=None``): the same numerics,
no collective.  The int8 all-reduce over a data-parallel mesh waits for
ROADMAP queue 1 item 6 (scale-out).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from .. import tree


@dataclasses.dataclass(frozen=True)
class GradCompressCfg:
    min_size: int = 65536          # don't compress below this many elements
    data_axes: Tuple[str, ...] = ("data",)


def _eligible(leaf: torch.Tensor, cfg: GradCompressCfg) -> bool:
    return leaf.numel() >= cfg.min_size and leaf.is_floating_point()


def init_error_state(params: Any, cfg: GradCompressCfg) -> Any:
    """fp32 zeros like each eligible leaf, a 0-d zero for the others."""
    return tree.map_(
        lambda p: torch.zeros_like(p, dtype=torch.float32)
        if _eligible(p, cfg)
        else torch.zeros((), dtype=torch.float32, device=p.device), params)


def _quantize(g: torch.Tensor) -> tuple:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads: Any, err: Any, cfg: GradCompressCfg, *,
                   mesh: Optional[Any] = None) -> tuple:
    """Quantize (grad + error) to int8 and back; returns (grads, err)."""
    if mesh is not None:
        raise NotImplementedError(
            "the int8 all-reduce over a mesh is not ported yet (ROADMAP "
            "queue 1 item 6, scale-out); pass mesh=None")

    def one(g, e):
        if e.ndim == 0:            # ineligible leaf: exact
            return g, e
        gf = g.to(torch.float32) + e
        q, s = _quantize(gf)
        deq = q.to(torch.float32) * s
        return deq.to(g.dtype), gf - deq

    out = [one(g, e) for g, e in zip(tree.leaves(grads), tree.leaves(err))]
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(grads, [o[1] for o in out]))
