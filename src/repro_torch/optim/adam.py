"""Adam (paper §IV-E: centroids and masters are updated with Adam).

The JAX package's ``optim/adam.py`` term for term, as plain functions over
the parameter tree: global-norm clip, bias corrections 1 − βᵗ, then
m̂ / (√v̂ + ε).  ``torch.optim.Adam`` orders the bias correction and ε
differently, so it is not used.  The step counter lives on the
parameters' device, so an update needs no host synchronisation.

ZeRO-1 (the reference's ``opt_specs(zero1=True)``): with ``zero1=(mesh,
specs)`` each rank keeps m and v for its block of each leaf only (``specs``
from ``runtime.sharding.zero1_specs``), updates that block of the
parameter, and the data axes all-gather the new blocks.  Adam is
elementwise, so the result is the replicated update's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .. import tree
from ..runtime.sharding import shard_slice


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0


def init(params: Any, zero1: Optional[tuple] = None) -> dict:
    """Zero moments and step; with ``zero1=(mesh, specs)`` the moments of
    this rank's block of each leaf only."""
    if zero1 is None:
        zeros = lambda p: tree.map_(torch.zeros_like, p)
    else:
        mesh, specs = zero1
        zeros = lambda p: tree.map_(
            lambda t, spec: torch.zeros_like(shard_slice(t, spec, mesh)),
            p, specs)
    dev = tree.leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.leaves(grads)))


@torch.no_grad()
def apply(params: Any, grads: Any, state: dict, cfg: AdamConfig,
          lr_scale: float = 1.0, *, gnorm: Optional[torch.Tensor] = None,
          zero1: Optional[tuple] = None):
    """One Adam step.  Returns (new_params, new_state, metrics).  ``gnorm``
    replaces the local :func:`global_norm` (a mesh's norm of the whole
    model); ``zero1=(mesh, specs)`` as :func:`init` takes it."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip is not None:
        # applied leaf by leaf in the update, not as a scaled copy of the
        # whole gradient tree held beside it
        scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                            / torch.clamp(gnorm, min=1e-12), max=1.0)

    step = state["step"] + 1
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        gf = (g if scale is None else g * scale).to(torch.float32)
        m2 = cfg.b1 * m + (1 - cfg.b1) * gf
        v2 = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        mhat = m2 / b1c
        vhat = v2 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m2, v2

    if zero1 is None:
        out = tree.map_(upd, params, grads, state["m"], state["v"])
    else:
        mesh, specs = zero1
        blocks = []

        def upd_block(p, g, m, v, spec):
            blk = lambda t: shard_slice(t, spec, mesh)
            p2, m2, v2 = upd(blk(p), blk(g), m, v)
            blocks.append((p2, spec))
            return m2, v2
        mv = tree.map_(upd_block, params, grads, state["m"], state["v"],
                       specs)
        whole = iter(gather_blocks(blocks, mesh))
        out = tree.map_(lambda _, o: (next(whole), *o), params, mv)
    pick = lambda i: tree.map_(lambda _, o: o[i], params, out)
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, \
        {"grad_norm": gnorm}


def gather_blocks(blocks: list, mesh) -> list:
    """Each ``(block, spec)``'s whole tensor (ZeRO-1's blocks of the new
    parameters, or of the moments): the blocks of one cut (dim,
    axes, dtype) concatenated flat and all-gathered in one call, then each
    leaf reassembled from the ranks' parts along its dim (data movement
    only: bitwise a gather a leaf)."""
    out = [b for b, _ in blocks]
    groups: dict = {}
    for i, (b, spec) in enumerate(blocks):
        cut = [(d, a) for d, a in enumerate(spec) if a is not None]
        if len(cut) > 1:
            raise ValueError(f"ZeRO-1 spec {spec} cuts more than one dim")
        if cut:
            d, axes = cut[0]
            axes = axes if isinstance(axes, str) else tuple(axes)
            groups.setdefault((d, axes, b.dtype), []).append(i)
    for (d, axes, _), idx in groups.items():
        n = mesh.axis_size(axes)
        sizes = [out[i].numel() for i in idx]
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        parts = [p.split(sizes) for p in
                 mesh.all_gather(flat, axes, dim=0).view(n, -1)]
        for j, i in enumerate(idx):
            shape = out[i].shape
            out[i] = torch.cat([parts[r][j].view(shape) for r in range(n)],
                               dim=d)
    return out
