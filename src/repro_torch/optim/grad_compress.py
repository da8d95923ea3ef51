"""int8 error-feedback gradient compression (the JAX package's
``optim/grad_compress.py``).

Each eligible gradient (at least ``min_size`` elements, floating point)
is quantized with its error buffer to int8 on a per-tensor scale
max|g| / 127, dequantized, and the residual carried to the next step
(1-bit-Adam-style error feedback), so the sum of the applied gradients
tracks the sum of the true ones.  Smaller tensors (ω, norms) stay exact.

Without a mesh the round trip is local: the reference's numerics, no
collective.  Over a mesh (``launch.mesh``) each rank brings its own
gradient, where the reference quantizes gradients that pjit has already
reduced, each device on its own scale (``src/repro/optim/grad_compress.py:
68-74``).  Per-rank gradients need one scale, so each eligible leaf

1. is summed exactly over the axes of its replica group that are not data
   axes (``axes``: the 'model' ranks that hold the same rows);
2. is taken as this data rank's mean-style gradient ``gf = n·h + e``
   (``n`` the data axes' size: the step's gradients are sums, each rank
   seeded with 1 / world);
3. shares ``s = max|gf| / 127 + 1e-12``, the max over the data axes and
   over the axes the leaf is cut over (a tensor-parallel block's or an
   expert share's: the whole tensor's scale, as the reference's max over
   its logical array);
4. is quantized to int8 here, its int32 sum all-reduced exactly (the wire
   is int32, as the reference's psum of ``q.astype(int32)``), and
   dequantized as ``Σq · s / n``; each rank keeps ``gf − q·s`` as its
   error.

With the same rows on every data rank this is the local round trip bit
for bit (``n·h`` and ``Σq·s / n`` are exact for a power-of-two ``n``);
with distinct rows it is within ``s / 2`` of the exact mean of the
``gf``.  Ineligible leaves are summed exactly.
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


def init_error_state(params: Any, cfg: GradCompressCfg, *, mesh=None,
                     specs: Any = None) -> Any:
    """fp32 zeros like each eligible leaf, a 0-d zero for the others.  A
    rank's block of a leaf (``specs``, the layout over ``mesh``) is
    eligible when the whole leaf is."""
    if specs is None:
        return tree.map_(lambda p: _error_leaf(p, _eligible(p, cfg)), params)
    return tree.map_(lambda p, spec: _error_leaf(p, p.is_floating_point()
                                                 and whole_numel(p, spec, mesh)
                                                 >= cfg.min_size),
                     params, specs)


def _error_leaf(p: torch.Tensor, eligible: bool) -> torch.Tensor:
    if eligible:
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros((), dtype=torch.float32, device=p.device)


def whole_numel(t: torch.Tensor, spec: tuple, mesh) -> int:
    """The elements of the whole leaf whose block ``t`` is under
    ``spec``."""
    n = t.numel()
    for axes in spec:
        if axes is not None:
            n *= mesh.axis_size(axes)
    return n


def _quantize(g: torch.Tensor) -> tuple:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads: Any, err: Any, cfg: GradCompressCfg, *,
                   mesh: Optional[Any] = None,
                   axes: Optional[Any] = None) -> tuple:
    """Quantize (grad + error) to int8 and back; returns (grads, err).
    Over ``mesh`` the grads are this rank's, reduced here over each leaf's
    replica axes (``axes``: ``runtime.sharding.replica_axes``; default
    every mesh axis), the data axes of them in int8."""
    if mesh is None:
        def one(g, e, _):
            if e.ndim == 0:        # ineligible leaf: exact
                return g, e
            gf = g.to(torch.float32) + e
            q, s = _quantize(gf)
            deq = q.to(torch.float32) * s
            return deq.to(g.dtype), gf - deq
    else:
        data = mesh_data_axes(mesh, cfg)

        @torch.no_grad()
        def one(g, e, leaf_axes):
            d, other = split_axes(mesh, data, leaf_axes)
            h = mesh.all_reduce(g, other) if other else g
            if e.ndim == 0:        # ineligible leaf: exact
                return (mesh.all_reduce(h, d) if d else h), e
            n = mesh.axis_size(d)
            gf = h.to(torch.float32) * n + e
            amax = torch.max(torch.abs(gf))
            over = d + cut_axes(mesh, leaf_axes)
            if over:
                amax = mesh.all_reduce(amax, over, op="max")
            s = amax / 127.0 + 1e-12
            q = torch.clamp(torch.round(gf / s), -127, 127).to(torch.int8)
            qsum = mesh.all_reduce(q.to(torch.int32), d) if d \
                else q.to(torch.int32)
            deq = qsum.to(torch.float32) * s / n
            return deq.to(g.dtype), gf - q.to(torch.float32) * s

    if axes is None:
        every = frozenset(mesh.axis_names if mesh is not None else ())
        axes = tree.map_(lambda _: every, grads)
    out = tree.map_(one, grads, err, axes)
    return (tree.map_(lambda _, o: o[0], grads, out),
            tree.map_(lambda _, o: o[1], grads, out))


def cut_axes(mesh, leaf_axes) -> tuple:
    """The mesh axes a leaf is cut over (those it is not replicated over):
    the ranks that hold the other blocks of its whole tensor."""
    return tuple(a for a in mesh.axis_names if a not in leaf_axes)


def split_axes(mesh, data: tuple, leaf_axes) -> tuple:
    """A leaf's replica axes split into (the data axes among them, the
    rest), each in mesh order."""
    pick = lambda keep: tuple(a for a in mesh.axis_names
                              if a in leaf_axes and (a in data) == keep)
    return pick(True), pick(False)


def mesh_data_axes(mesh, cfg: GradCompressCfg) -> tuple:
    """``cfg.data_axes`` that ``mesh`` has (the reference's filter); a
    name that is no axis of any mesh the port builds raises."""
    unknown = [a for a in cfg.data_axes
               if a not in ("pod", "data") and a not in mesh.axis_names]
    if unknown:
        raise ValueError(f"GradCompressCfg.data_axes {cfg.data_axes}: mesh "
                         f"has no axes {unknown}: {mesh.axis_names}")
    return tuple(a for a in cfg.data_axes if a in mesh.axis_names)
