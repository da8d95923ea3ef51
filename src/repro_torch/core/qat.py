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

The assignment and ŵ come from the grouped ECL op (``kernels.ops.
ecl_quant_many``): one launch of the hand-written CUDA kernel for every
tensor on the card, its plain version on the CPU.  :func:`fake_quant_many`
fake-quantizes every layer of a net in one launch (:func:`fake_quant` is
its one-tensor case, :func:`fake_quant_tree` every leaf of a tree);
:func:`update_qstate` EMA-updates the probabilities
from a fresh assignment of every tensor once per step, and :func:`stats`
reports sparsity and entropy over every quantized tensor, each in one
grouped call.  :func:`freeze_tree` turns a trained tree into its serving
form, every leaf assigned in one grouped call.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Sequence

import torch

from . import bitplanes, ecl

QUANT_KEYS = frozenset({"w", "omega"})
FROZEN_KEYS = frozenset({"packed", "omega"})


def is_quant_leaf(node: Any) -> bool:
    return isinstance(node, dict) and QUANT_KEYS.issubset(node.keys())


def is_frozen_leaf(node: Any) -> bool:
    """A dict holding a frozen (row-pair-packed 4-bit) serving tensor."""
    return isinstance(node, dict) and FROZEN_KEYS.issubset(node.keys()) \
        and "w" not in node


def make_quant_param(w: torch.Tensor) -> dict:
    return {"w": w, "omega": bitplanes.init_omega_from_weights(w)}


def init_qstate_leaf(lead: tuple = (), device=None) -> dict:
    return {"probs": torch.full((*lead, ecl.NUM_CODES), 1.0 / ecl.NUM_CODES,
                                dtype=torch.float32, device=device)}


class FakeQuantGroup(torch.autograd.Function):
    """ŵ of every leaf from the ECL codes forward, in one grouped
    quantization; per leaf, straight-through to w and eq. (2) to ω
    backward.  No gradient reaches the penalties (they are a stop-gradient
    in the reference).  A batched leaf ((L, R, C) with ω (L, 4), or an
    (L, E)-stacked expert bank with ω (L, E, 4)) gets one ω gradient per
    lead index, summed over its last two dims.  ``apply(n, *ws, *omegas,
    *pens)`` -> n ŵ."""

    @staticmethod
    def forward(ctx, n, *tensors):
        ws, omegas, pens = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        # forward runs without grad mode: the tensors need no detach
        outs = ecl.quantize_many(ws, omegas, pens)
        ctx.save_for_backward(*(c for c, _ in outs))
        ctx.batched = tuple(o.ndim > 1 for o in omegas)
        return tuple(w_hat for _, w_hat in outs)

    @staticmethod
    def backward(ctx, *gs):
        grad_w, grad_omega = [], []
        for g, codes, batched in zip(gs, ctx.saved_tensors, ctx.batched):
            g = g.to(torch.float32)
            dims = (-2, -1) if batched else tuple(range(codes.ndim))
            grad_w.append(g)
            grad_omega.append(torch.stack(
                [(g * ((codes >> i) & 1).to(torch.float32)).sum(dim=dims)
                 for i in range(bitplanes.NUM_BASIS)], dim=-1))
        return (None, *grad_w, *grad_omega, *(None for _ in gs))


def fake_quant_many(ws: Sequence[torch.Tensor],
                    omegas: Sequence[torch.Tensor],
                    probs: Sequence[torch.Tensor], lam,
                    dtype=None) -> list:
    """STE fake-quantization of every tensor in one grouped launch, with
    the differentiable centroid path; [ŵ] in the order given."""
    if not ws:
        return []
    with torch.no_grad():
        pens = [ecl.penalty(w, p, lam) for w, p in zip(ws, probs)]
    outs = FakeQuantGroup.apply(len(ws), *ws, *omegas, *pens)
    return [o if o.dtype == (dtype or w.dtype) else o.to(dtype or w.dtype)
            for o, w in zip(outs, ws)]


def fake_quant(w: torch.Tensor, omega: torch.Tensor, probs: torch.Tensor,
               lam, dtype=None) -> torch.Tensor:
    """STE fake-quantization with the differentiable centroid path."""
    return fake_quant_many([w], [omega], [probs], lam, dtype)[0]


def apply_quant_many(nodes: Sequence[dict], qstates: Sequence[dict], lam,
                     dtype=None) -> list:
    return fake_quant_many([n["w"] for n in nodes],
                           [n["omega"] for n in nodes],
                           [q["probs"] for q in qstates], lam, dtype)


def apply_quant(node: dict, qstate: dict, lam, dtype=None) -> torch.Tensor:
    return apply_quant_many([node], [qstate], lam, dtype)[0]


def fake_quant_tree(params: Any, qstate: Any, lam, dtype=None) -> Any:
    """``params`` with every quantized leaf replaced by its fake-quantized
    ŵ in ``dtype`` (differentiable as :func:`fake_quant`), every leaf in
    one :func:`apply_quant_many` call; other leaves are kept."""
    return _map_quant_many(
        lambda nodes, qss: apply_quant_many(nodes, qss, lam, dtype),
        params, qstate, keep_params=True)


# --------------------------------------------------------------- tree utils

def _map_quant(fn: Callable, tree: Any, qtree: Any,
               keep_params: bool = False) -> Any:
    """``fn(node, qs)`` at every quantized leaf; other positions keep the
    state tree's value, or the parameter tree's with ``keep_params``."""
    if is_quant_leaf(tree):
        return fn(tree, qtree)
    if isinstance(tree, dict):
        return {k: _map_quant(fn, v, qtree[k], keep_params)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_quant(fn, v, q, keep_params)
                          for v, q in zip(tree, qtree))
    return tree if keep_params else qtree


def _map_quant_many(fn: Callable, tree: Any, qtree: Any,
                    keep_params: bool = False) -> Any:
    """:func:`_map_quant` with ``fn(nodes, qss)`` called once over every
    quantized leaf, returning one value per leaf in the order given."""
    leaves = []
    _map_quant(lambda node, qs: leaves.append((node, qs)), tree, qtree)
    results = iter(fn([n for n, _ in leaves], [q for _, q in leaves]))
    return _map_quant(lambda node, qs: next(results), tree, qtree,
                      keep_params)


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


def _assign_leaves(nodes: Sequence[dict], qss: Sequence[dict], lam) -> list:
    return ecl.assign_many([n["w"] for n in nodes],
                           [n["omega"] for n in nodes],
                           [q["probs"] for q in qss], lam)


@torch.no_grad()
def update_qstate(params: Any, qstate: Any, lam,
                  momentum: float = 0.9) -> Any:
    """One EMA step of the per-tensor cluster probabilities (one ECL
    iteration per training step), every tensor in one grouped call."""
    def f(nodes, qss):
        return [{"probs": ecl.update_probs(q["probs"], c, momentum)}
                for q, c in zip(qss, _assign_leaves(nodes, qss, lam))]
    return _map_quant_many(f, params, qstate)


@torch.no_grad()
def quantize_tree(params: Any, qstate: Any, lam) -> Any:
    """Replace each quantized leaf with ``{"codes", "omega"}`` (every leaf
    assigned in one grouped call); other leaves are kept."""
    def f(nodes, qss):
        return [{"codes": c, "omega": n["omega"]}
                for n, c in zip(nodes, _assign_leaves(nodes, qss, lam))]
    return _map_quant_many(f, params, qstate, keep_params=True)


@torch.no_grad()
def freeze_tree(params: Any, qstate: Any, lam) -> Any:
    """Serving form: every quantized leaf becomes ``{"packed", "omega"}``
    with row-pair-packed uint8 codes (4 bits a weight); other leaves are
    kept.  Every leaf is assigned in one grouped call: an L-stacked leaf
    with ω (L, 4) is L segments of it, so on the card the whole tree takes
    ⌈segments / 32⌉ launches.  Contraction dims must be even."""
    def f(nodes, qss):
        return [{"packed": bitplanes.pack_codes_rows(c),
                 "omega": n["omega"].to(torch.float32)}
                for n, c in zip(nodes, _assign_leaves(nodes, qss, lam))]
    return _map_quant_many(f, params, qstate, keep_params=True)


def decode_frozen(node: dict, dtype=torch.float32) -> torch.Tensor:
    """W = Σ ω_i B_i of a frozen leaf, decoded where its codes lie."""
    codes = bitplanes.unpack_codes_rows(node["packed"])
    return bitplanes.decode(codes, node["omega"], dtype)


@torch.no_grad()
def stats(params: Any, qstate: Any, lam) -> dict:
    """Global sparsity / entropy diagnostics over the quantized leaves."""
    total, zeros, bits = 0, [], []
    leaves = list(_quant_leaves(params, qstate))
    all_codes = _assign_leaves([n for n, _ in leaves],
                               [q for _, q in leaves], lam)
    for (node, _), codes in zip(leaves, all_codes):
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
