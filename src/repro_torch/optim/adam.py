"""Adam (paper §IV-E: centroids and masters are updated with Adam).

The JAX package's ``optim/adam.py`` term for term, as plain functions over
the parameter tree: global-norm clip, bias corrections 1 − βᵗ, then
m̂ / (√v̂ + ε).  ``torch.optim.Adam`` orders the bias correction and ε
differently, so it is not used.  The step counter lives on the
parameters' device, so an update needs no host synchronisation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .. import tree


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0


def init(params: Any) -> dict:
    zeros = lambda p: tree.map_(torch.zeros_like, p)
    dev = tree.leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.leaves(grads)))


@torch.no_grad()
def apply(params: Any, grads: Any, state: dict, cfg: AdamConfig,
          lr_scale: float = 1.0):
    """One Adam step.  Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    if cfg.grad_clip is not None:
        scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                            / torch.clamp(gnorm, min=1e-12), max=1.0)
        grads = tree.map_(lambda g: g * scale, grads)

    step = state["step"] + 1
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        m2 = cfg.b1 * m + (1 - cfg.b1) * gf
        v2 = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        mhat = m2 / b1c
        vhat = v2 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m2, v2

    out = tree.map_(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree.map_(lambda _, o: o[i], params, out)
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, \
        {"grad_norm": gnorm}
