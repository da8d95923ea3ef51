"""Mixture-of-Experts on one device (the JAX package's ``nn/moe.py``):
sort-based capacity routing, no (N, E, C) one-hot tensor.

Routing variants:

* ``gate="softmax"`` — grok-1 style: softmax over the top-k logits.
* ``gate="sigmoid"`` — deepseek-v3 style: sigmoid scores, selection by
  score + a bias-correction term, weights = selected scores / their sum,
  scaled by ``routed_scaling``.

A Switch-style load-balance auxiliary loss is returned alongside
(coefficient applied by the caller).  The router stays fp32 and
un-quantized; the expert banks (E, d_in, d_out) are EC4T-quantized, one
ω and one probability state per expert.

Where the two frameworks differ, the port keeps the reference's results:
the top k are the first k of a stable descending sort (``lax.top_k``
takes the lowest index first on ties, ``torch.topk`` promises no order),
and each token's k weighted expert outputs are added in assignment order
from zero, not with atomics, so the card's result does not depend on
scheduling.  The expert products stay ``torch.bmm``, as the reference
leaves them to XLA.

``experts_held=(first, count)`` makes the layer one shard of the
reference's expert-parallel path: the per-shard body of ``moe_apply_ep``
(``local_moe``) without its two all-to-alls.  The router keeps every
expert's output and the capacity is the one ``local_moe`` computes, from
all n·k assignments over all E experts; the layer holds the banks of
experts ``[first, first + count)`` only, runs them on their slice of the
(E, C, d) dispatch, and adds the kept assignments to them (and the shared
expert, once).  The shards' outputs, less all but one shared expert, add
up to the whole layer's.  A shard's own output is not ``local_moe``'s: the
reference's return all-to-all gives each token all k experts' outputs,
the share only those of the experts it holds, so a share's loss and its
non-expert gradients belong to no shard of the deployment.  The collective exchange of ``moe_apply_ep`` and
the expert-TP path ``moe_apply_tp`` need a mesh and wait for ROADMAP queue
1 item 6.

The backward is deterministic on the card: each token enters the
dispatch through an expand (its gradient a sum over its k assignments,
not an accumulating scatter), and an assignment that is dropped or whose
expert is not held reads a zero sink row, so the gather's backward adds
into every expert slot at most once.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from .layers import subtree, swiglu, swiglu_init
from .module import QuantCtx, materialize, maybe_quant_param


# ------------------------------------------------------------------- init

def held_experts(experts_held: Optional[tuple], n_experts: int) -> tuple:
    """(first, count) of the experts a layer holds: every expert for
    None, else ``experts_held`` checked against ``n_experts``."""
    if experts_held is None:
        return 0, n_experts
    first, count = (int(v) for v in experts_held)
    if first < 0 or count < 1 or first + count > n_experts:
        raise ValueError(f"experts_held={tuple(experts_held)} is not a "
                         f"slice of {n_experts} experts")
    return first, count


def moe_init(generator: torch.Generator, d: int, d_ff: int, n_experts: int,
             quantize: bool, n_shared: int = 0,
             shared_ff: Optional[int] = None,
             experts_held: Optional[tuple] = None) -> dict:
    """Stacked expert SwiGLU banks (E, ...) + fp32 router (+ shared
    expert), every draw from ``generator`` on its device.  The banks are
    uniform in ±1/√d, as the reference draws all three.  With
    ``experts_held=(first, count)`` the router stays n_experts wide and
    the banks hold ``count`` experts."""
    dev = generator.device
    scale = d ** -0.5
    _, count = held_experts(experts_held, n_experts)

    def expert_bank(d_in, d_out):
        # in place: a full-width bank is 6.4 GB of fp32
        w = torch.rand((count, d_in, d_out), generator=generator,
                       dtype=torch.float32, device=dev)
        return maybe_quant_param(w.mul_(2 * scale).sub_(scale), quantize)

    p = {
        "router": {
            "w": torch.randn((d, n_experts), generator=generator,
                             dtype=torch.float32, device=dev) * 0.02,
            "bias_correction": torch.zeros((n_experts,), dtype=torch.float32,
                                           device=dev),
        },
        "experts": {
            "gate": expert_bank(d, d_ff),
            "up": expert_bank(d, d_ff),
            "down": expert_bank(d_ff, d),
        },
    }
    if n_shared:
        p["shared"] = swiglu_init(generator, d, (shared_ff or d_ff) * n_shared,
                                  quantize)
    return p


# ---------------------------------------------------------------- routing

def _top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest per row, ties to the lowest index."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][:, :k]


def route(logits: torch.Tensor, bias_correction: torch.Tensor, *,
          top_k: int, gate: str, routed_scaling: float = 1.0) -> tuple:
    """(N, E) logits -> (ids (N, k) int64, weights (N, k) fp32, aux_loss)."""
    n, e = logits.shape
    if gate == "softmax":
        ids = _top_k(logits, top_k)
        w = torch.softmax(torch.gather(logits, 1, ids), dim=-1)
        probs = torch.softmax(logits, dim=-1)
    elif gate == "sigmoid":
        scores = torch.sigmoid(logits)
        ids = _top_k(scores + bias_correction[None, :], top_k)
        sel = torch.gather(scores, 1, ids)
        w = routed_scaling * sel / torch.clamp(sel.sum(-1, keepdim=True),
                                               min=1e-9)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:
        raise ValueError(gate)
    # Switch-style load-balance aux loss: E * Σ_e f_e · p_e.  Every addend
    # of the scatter is the same number, so its atomics on the card add up
    # to the same bits in any order.
    flat = ids.reshape(-1)
    frac = torch.zeros((e,), dtype=torch.float32, device=logits.device)
    frac.index_add_(0, flat, torch.full(flat.shape, 1.0 / (n * top_k),
                                        dtype=torch.float32,
                                        device=logits.device))
    aux = e * torch.sum(frac * probs.mean(0))
    return ids, w.to(torch.float32), aux


def _dispatch_indices(flat_ids: torch.Tensor, n_experts: int,
                      capacity: int) -> tuple:
    """Sort-based slot assignment.  flat_ids: (N*k,) expert of each
    assignment.  Returns (slot (N*k,), keep (N*k,)): slot = e*C + position
    within the expert for kept assignments (earlier tokens win: the
    'drop by position' policy), a valid but unused slot otherwise.  The
    counts are a scatter-add, as the reference's: ``torch.bincount`` on
    the card would read the ids' extremes back to the host, a
    synchronisation inside a train step."""
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    counts = torch.zeros((n_experts,), dtype=torch.int64,
                         device=flat_ids.device).index_add_(
        0, flat_ids, torch.ones_like(flat_ids, dtype=torch.int64))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(flat_ids.numel(), device=flat_ids.device) \
        - starts[sorted_ids]
    keep_sorted = pos_in_e < capacity
    slot_sorted = sorted_ids * capacity + torch.clamp(pos_in_e,
                                                      max=capacity - 1)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return slot_sorted[inv], keep_sorted[inv]


def _expert_ffn(experts: dict, q_state: Any, xs: torch.Tensor,
                ctx: QuantCtx) -> torch.Tensor:
    """xs (E, C, d) -> (E, C, d) through each expert's SwiGLU (batched
    matmuls).  A frozen bank is decoded when its product needs it and
    freed after."""
    def mat(name):
        return materialize(experts[name], subtree(q_state, name), ctx)
    g = torch.bmm(xs, mat("gate"))
    u = torch.bmm(xs, mat("up"))
    h = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(xs.dtype)
    return torch.bmm(h, mat("down"))


def _capacity(n_assign: int, n_experts: int, factor: float) -> int:
    c = int(-(-n_assign * factor // n_experts))           # ceil
    return max(8, -(-c // 8) * 8)                         # pad to 8


# ------------------------------------------------------------ one device

def _bank_experts(experts: dict) -> int:
    """Experts in a bank: a tensor, a quantized ``{"w", ...}`` or a frozen
    ``{"packed", ...}`` leaf, each (E, ...)."""
    bank = experts["gate"]
    if isinstance(bank, dict):
        bank = bank["w"] if "w" in bank else bank["packed"]
    return bank.shape[0]


def moe_apply(p: dict, q_state: Any, x: torch.Tensor, ctx: QuantCtx, *,
              top_k: int, gate: str = "softmax",
              capacity_factor: float = 1.25,
              routed_scaling: float = 1.0,
              experts_held: Optional[tuple] = None) -> tuple:
    """MoE forward on (..., d) tokens; returns (y, aux_loss).  With
    ``experts_held=(first, count)``, this shard's part of the layer."""
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    n = xt.shape[0]
    e = p["router"]["w"].shape[1]
    first, count = held_experts(experts_held, e)
    if _bank_experts(p["experts"]) != count:
        raise ValueError(f"the banks hold {_bank_experts(p['experts'])} "
                         f"experts, experts_held={experts_held} names "
                         f"{count}")

    logits = xt.to(torch.float32) @ p["router"]["w"]
    ids, w, aux = route(logits, p["router"]["bias_correction"].detach(),
                        top_k=top_k, gate=gate,
                        routed_scaling=routed_scaling)
    cap = _capacity(n * top_k, e, capacity_factor)
    slot, keep = _dispatch_indices(ids.reshape(-1), e, cap)
    if experts_held is not None:
        keep = keep & (slot >= first * cap) & (slot < (first + count) * cap)
        slot = slot - first * cap

    # each assignment's held slot, or a sink row past this shard's buffer
    sink = count * cap
    at = torch.where(keep, slot, sink)
    xk = xt.unsqueeze(1).expand(n, top_k, d).reshape(n * top_k, d)
    buf = torch.zeros((sink + 1, d), dtype=ctx.dtype, device=x.device)
    buf[at] = xk.to(ctx.dtype)
    out = _expert_ffn(p["experts"], subtree(q_state, "experts"),
                      buf[:sink].view(count, cap, d), ctx).reshape(sink, d)
    out = torch.cat([out, out.new_zeros((1, d))])

    gathered = (out[at] * (w.reshape(-1, 1) * keep[:, None]).to(ctx.dtype)
                ).view(n, top_k, d)
    y = torch.zeros((n, d), dtype=ctx.dtype, device=x.device)
    for j in range(top_k):
        y = y + gathered[:, j]
    if "shared" in p:
        y = y + swiglu(p["shared"], subtree(q_state, "shared"), xt, ctx)
    return y.reshape(shape), aux


def moe_ffn(p: dict, q_state: Any, x: torch.Tensor, ctx: QuantCtx, *,
            mesh=None, top_k: int, gate: str = "softmax",
            capacity_factor: float = 1.25,
            routed_scaling: float = 1.0,
            experts_held: Optional[tuple] = None) -> tuple:
    """The reference's dispatcher: on one device the sort dispatch of
    :func:`moe_apply` (a shard of it with ``experts_held``).  A mesh
    (expert parallelism, expert TP) is not ported."""
    if mesh is not None:
        raise NotImplementedError(
            "MoE over a mesh (moe_apply_ep, moe_apply_tp) is not ported yet "
            "(ROADMAP queue 1 item 6, scale-out); pass mesh=None")
    return moe_apply(p, q_state, x, ctx, top_k=top_k, gate=gate,
                     capacity_factor=capacity_factor,
                     routed_scaling=routed_scaling, experts_held=experts_held)
