"""EC4T — entropy-constrained 4-bit training (paper §IV), as a parameterisation.

A quantized tensor is the dict ``{"w": master weights, "omega": (4,)
centroids}`` in the parameter tree, with the mirrored state ``{"probs":
(16,) EMA cluster probabilities}``.  The forward pass uses
:func:`fake_quant`:

    codes = ECL_assign(w, omega, probs, lam)        # §IV-C, no gradient
    w_hat = Σ_i ω_i · bit_i(codes)                  # eq. (1)

and its backward gives the paper's two update rules (the JAX package gets
them from autodiff of its straight-through decode, ``core/qat.py:57-64``):

    ∂L/∂w   = δW                    (straight-through to the masters, §IV-D)
    ∂L/∂ω_i = Σ_j δW_j · B_i[j]     (centroid fine-tuning, eq. (2))

The assignment and ŵ come from the fused ECL op (``kernels.ops.
ecl_quant``): the hand-written CUDA kernel on the card, its plain version
on the CPU.  :func:`update_qstate` EMA-updates the probabilities from a
fresh assignment once per step; :func:`stats` reports sparsity and
entropy over every quantized tensor.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

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


class FakeQuant(torch.autograd.Function):
    """ŵ from the ECL codes forward; straight-through to w and eq. (2) to ω
    backward.  No gradient reaches the penalty (it is a stop-gradient in
    the reference)."""

    @staticmethod
    def forward(ctx, w, omega, pen):
        codes, w_hat = ecl.quantize(w.detach(), omega.detach(), pen)
        ctx.save_for_backward(codes)
        ctx.batched = omega.ndim > 1
        return w_hat

    @staticmethod
    def backward(ctx, g):
        (codes,) = ctx.saved_tensors
        g = g.to(torch.float32)
        dims = (-2, -1) if ctx.batched else tuple(range(codes.ndim))
        grad_omega = torch.stack(
            [(g * ((codes >> i) & 1).to(torch.float32)).sum(dim=dims)
             for i in range(bitplanes.NUM_BASIS)], dim=-1)
        return g, grad_omega, None


def fake_quant(w: torch.Tensor, omega: torch.Tensor, probs: torch.Tensor,
               lam, dtype=None) -> torch.Tensor:
    """STE fake-quantization with the differentiable centroid path."""
    dtype = dtype or w.dtype
    with torch.no_grad():
        pen = ecl.penalty(w, probs, lam)
    return FakeQuant.apply(w, omega, pen).to(dtype)


def apply_quant(node: dict, qstate: dict, lam, dtype=None) -> torch.Tensor:
    return fake_quant(node["w"], node["omega"], qstate["probs"], lam, dtype)


# --------------------------------------------------------------- tree utils

def _map_quant(fn: Callable, tree: Any, qtree: Any) -> Any:
    """``fn(node, qs)`` at every quantized leaf; other positions keep the
    state tree's value."""
    if is_quant_leaf(tree):
        return fn(tree, qtree)
    if isinstance(tree, dict):
        return {k: _map_quant(fn, v, qtree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_quant(fn, v, q) for v, q in zip(tree, qtree))
    return qtree


def _quant_leaves(tree: Any, qtree: Any) -> Iterator[tuple]:
    """(node, qs) pairs in the reference's leaf order (sorted dict keys)."""
    if is_quant_leaf(tree):
        yield tree, qtree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _quant_leaves(tree[k], qtree[k])
    elif isinstance(tree, (list, tuple)):
        for v, q in zip(tree, qtree):
            yield from _quant_leaves(v, q)


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


@torch.no_grad()
def update_qstate(params: Any, qstate: Any, lam,
                  momentum: float = 0.9) -> Any:
    """One EMA step of the per-tensor cluster probabilities (one ECL
    iteration per training step)."""
    def f(node, qs):
        codes = ecl.assign(node["w"], node["omega"], qs["probs"], lam)
        return {"probs": ecl.update_probs(qs["probs"], codes, momentum)}
    return _map_quant(f, params, qstate)


@torch.no_grad()
def stats(params: Any, qstate: Any, lam) -> dict:
    """Global sparsity / entropy diagnostics over the quantized leaves."""
    total, zeros, bits = 0, [], []
    for node, qs in _quant_leaves(params, qstate):
        codes = ecl.assign(node["w"], node["omega"], qs["probs"], lam)
        lead_nd = node["omega"].ndim - 1
        per_lead = ecl.entropy_bits(ecl.histogram(codes, lead_nd))
        elems_per_lead = codes.shape[-2] * codes.shape[-1] \
            if codes.ndim >= 2 else codes.numel()
        total += codes.numel()
        zeros.append(torch.sum((codes == 0).to(torch.float32)))
        bits.append(torch.sum(per_lead) * elems_per_lead)
    n = total or 1
    return {
        "quant_params": total,
        "sparsity": sum(zeros) / n if zeros else torch.tensor(0.0),
        "entropy_bits_per_weight": sum(bits) / n if bits else torch.tensor(0.0),
    }
