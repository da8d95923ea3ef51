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
non-expert gradients belong to no shard of the deployment.

Over a mesh of ranks (``launch.mesh``) the reference's two exchanges run
on ``torch.distributed``: :func:`moe_apply_ep` (experts over 'model', two
all-to-alls a layer, each token getting all k of its experts' outputs
back) and :func:`moe_apply_tp` (every expert's FFN width over 'model',
one all-reduce of the down-projection), chosen by :func:`moe_ffn` as the
reference chooses.  A rank brings its rows of the batch (the same rows on
every rank of one 'model' slice, as the reference lays a batch over the
data axes) and gets their outputs back.  Both train as well as serve:
each exchange has its adjoint (``launch.mesh``), so under autograd the
return all-to-all carries every token's k outputs' gradients back to the
experts' ranks and the dispatch all-to-all the tokens' gradients home; a
rank's gradient of the router, the shared expert and the upstream tokens
is its part of the whole mesh's, and the train step sums them
(``optim.ec4t``).

The backward is deterministic on the card: each token enters the
dispatch through an expand (its gradient a sum over its k assignments,
not an accumulating scatter), and an assignment that is dropped or whose
expert is not held reads a zero sink row, so the gather's backward adds
into every expert slot at most once.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from .layers import draw, subtree, swiglu, swiglu_init
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
             experts_held: Optional[tuple] = None,
             banks: Optional[Callable[[], dict]] = None) -> dict:
    """Stacked expert SwiGLU banks (E, ...) + fp32 router (+ shared
    expert), every draw from ``generator`` on its device.  The banks are
    uniform in ±1/√d, as the reference draws all three.  With
    ``experts_held=(first, count)`` the router stays n_experts wide and
    the banks hold ``count`` experts.  ``banks()``, when given, makes the
    ``{"gate", "up", "down"}`` banks instead (``nn.transformer`` draws
    each expert from a generator of its own)."""
    dev = generator.device
    scale = d ** -0.5
    _, count = held_experts(experts_held, n_experts)

    def expert_bank(d_in, d_out):
        # in place: a full-width bank is 6.4 GB of fp32
        w = draw(torch.rand, (count, d_in, d_out), generator)
        return maybe_quant_param(w.mul_(2 * scale).sub_(scale), quantize)

    p = {
        "router": {
            "w": draw(torch.randn, (d, n_experts), generator) * 0.02,
            "bias_correction": torch.zeros((n_experts,), dtype=torch.float32,
                                           device=dev),
        },
        "experts": banks() if banks is not None else {
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

def _gate_bank(experts: dict) -> torch.Tensor:
    """The gate bank's (E, d, ff) tensor: itself, a quantized ``{"w",
    ...}`` leaf's ``w`` or a frozen ``{"packed", ...}`` leaf's codes."""
    bank = experts["gate"]
    if isinstance(bank, dict):
        bank = bank["w"] if "w" in bank else bank["packed"]
    return bank


def _bank_experts(experts: dict) -> int:
    """Experts in a bank."""
    return _gate_bank(experts).shape[0]


def _dispatch(xt: torch.Tensor, router: dict, e: int, cap: int, *,
              top_k: int, gate: str, routed_scaling: float, dtype,
              held: tuple) -> tuple:
    """Route ``xt`` (n, d) and scatter its kept assignments to the held
    experts ``held = (first, count)`` into a (count, cap, d) buffer (an
    assignment that is dropped or not held goes to a sink row past it);
    returns (buf, slot, keep, w, aux) with ``slot`` in the buffer."""
    n, d = xt.shape
    first, count = held
    logits = xt.to(torch.float32) @ router["w"]
    ids, w, aux = route(logits, router["bias_correction"].detach(),
                        top_k=top_k, gate=gate, routed_scaling=routed_scaling)
    slot, keep = _dispatch_indices(ids.reshape(-1), e, cap)
    if (first, count) != (0, e):
        keep = keep & (slot >= first * cap) & (slot < (first + count) * cap)
        slot = slot - first * cap
    sink = count * cap
    at = torch.where(keep, slot, sink)
    xk = xt.unsqueeze(1).expand(n, top_k, d).reshape(n * top_k, d)
    buf = torch.zeros((sink + 1, d), dtype=dtype, device=xt.device)
    buf[at] = xk.to(dtype)
    return buf[:sink].view(count, cap, d), slot, keep, w, aux


def _combine(out: torch.Tensor, slot, keep, w, n: int, top_k: int,
             dtype) -> torch.Tensor:
    """Each token's k weighted expert outputs from ``out`` (.., cap, d),
    added in assignment order from zero (a dropped or unheld assignment
    reads a zero row)."""
    d = out.shape[-1]
    out = out.reshape(-1, d)
    sink = out.shape[0]
    out = torch.cat([out, out.new_zeros((1, d))])
    gathered = (out[torch.where(keep, slot, sink)]
                * (w.reshape(-1, 1) * keep[:, None]).to(dtype)
                ).view(n, top_k, d)
    y = torch.zeros((n, d), dtype=dtype, device=out.device)
    for j in range(top_k):
        y = y + gathered[:, j]
    return y


def moe_apply(p: dict, q_state: Any, x: torch.Tensor, ctx: QuantCtx, *,
              top_k: int, gate: str = "softmax",
              capacity_factor: float = 1.25,
              routed_scaling: float = 1.0,
              experts_held: Optional[tuple] = None,
              shared_mesh=None) -> tuple:
    """MoE forward on (..., d) tokens; returns (y, aux_loss).  With
    ``experts_held=(first, count)``, this shard's part of the layer;
    ``shared_mesh`` as :func:`moe_apply_ep` takes it."""
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    n = xt.shape[0]
    e = p["router"]["w"].shape[1]
    held = held_experts(experts_held, e)
    if _bank_experts(p["experts"]) != held[1]:
        raise ValueError(f"the banks hold {_bank_experts(p['experts'])} "
                         f"experts, experts_held={experts_held} names "
                         f"{held[1]}")
    cap = _capacity(n * top_k, e, capacity_factor)
    buf, slot, keep, w, aux = _dispatch(
        xt, p["router"], e, cap, top_k=top_k, gate=gate,
        routed_scaling=routed_scaling, dtype=ctx.dtype, held=held)
    out = _expert_ffn(p["experts"], subtree(q_state, "experts"), buf, ctx)
    y = _combine(out, slot, keep, w, n, top_k, ctx.dtype)
    return _add_shared(y, p, q_state, xt, ctx, shared_mesh).reshape(
        shape), aux


def _add_shared(y: torch.Tensor, p: dict, q_state: Any, xt: torch.Tensor,
                ctx: QuantCtx, mesh=None) -> torch.Tensor:
    """``y`` plus the shared expert's output on ``xt``, once; with
    ``mesh`` its gate / up this rank's columns and its down its rows,
    summed over 'model' (``swiglu(mesh=)``)."""
    if "shared" not in p:
        return y
    return y + swiglu(p["shared"], subtree(q_state, "shared"), xt, ctx, mesh)


# ------------------------------------------------------------ over a mesh

def _axis_slice(node: Any, dim: int, index: int, count: int) -> Any:
    """A bank leaf (a tensor, ``{"w", "omega"}`` or ``{"packed", "omega"}``)
    cut to block ``index`` of ``count`` along ``dim`` of its (E, d_in,
    d_out) bank (a packed bank's d_in is in row pairs: its rows halve)."""
    if isinstance(node, dict):
        out = dict(node)
        key = "w" if "w" in node else "packed"
        if dim == 0:
            out["omega"] = _axis_slice(node["omega"], 0, index, count)
        out[key] = _axis_slice(node[key], dim, index, count)
        return out
    blk = node.shape[dim] // count
    return node.narrow(dim, index * blk, blk)


def _rank_tokens(xt: torch.Tensor, mesh, axes) -> torch.Tensor:
    """This rank's block of the token rows ``xt`` (n, d), padded with zero
    rows to a multiple of the ranks along ``axes`` (a zero row routes
    like any token; its output is cut away)."""
    k = mesh.axis_size(axes)
    pad = (-xt.shape[0]) % k
    if pad:
        xt = torch.cat([xt, xt.new_zeros((pad, xt.shape[1]))])
    blk = xt.shape[0] // k
    return xt.narrow(0, mesh.axis_index(axes) * blk, blk)


def _rank_experts(p: dict, q_state: Any, e: int, ep: int,
                  index: int) -> tuple:
    """(banks, their q-state) of this rank's E/ep experts: whole banks are
    cut; banks that hold the rank's experts (a share, ``experts_held``,
    or the tensor-parallel layout's block) are kept, and an ω or a
    probability state of the whole layer's E experts beside them (the
    layout replicates those) is cut to the rank's."""
    held = _bank_experts(p["experts"])
    if held not in (e, e // ep):
        raise ValueError(f"the banks hold {held} experts; expert parallelism "
                         f"over {ep} ranks needs {e} or {e // ep}")

    def mine(t):
        return t.narrow(0, index * (e // ep), e // ep) if t.shape[0] == e \
            else t
    if held == e:
        banks = {k: _axis_slice(v, 0, index, ep)
                 for k, v in p["experts"].items()}
    else:
        banks = {k: {**v, "omega": mine(v["omega"])}
                 if isinstance(v, dict) else v
                 for k, v in p["experts"].items()}
    eq = subtree(q_state, "experts")
    if isinstance(eq, dict):
        eq = {k: {kk: mine(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else v for k, v in eq.items()}
    return banks, eq


def moe_apply_ep(p: dict, q_state: Any, x: torch.Tensor, ctx: QuantCtx, *,
                 mesh, top_k: int, gate: str = "softmax",
                 capacity_factor: float = 1.25, routed_scaling: float = 1.0,
                 expert_axis: str = "model",
                 experts_held: Optional[tuple] = None,
                 shared_mesh=None) -> tuple:
    """Expert-parallel MoE over ``mesh`` (the reference's
    ``moe_apply_ep``): experts over ``expert_axis``, tokens over every
    axis, two all-to-alls a layer.

    ``x`` (..., d) holds this rank's rows, the same on every rank of its
    ``expert_axis`` slice.  The slice's tokens are padded to its size and
    each rank routes its block (``local_moe``: capacity per rank, from its
    own n·k assignments).  The first all-to-all moves the (E, C, d)
    dispatch to the experts' ranks as (E/ep, ep·C, d); each rank runs its
    experts; the second moves the outputs back, and each token adds its k
    outputs in assignment order.  The blocks are gathered over the slice,
    the shared expert is added after the exchange, and the aux is the mean
    over all ranks.  ``p``'s banks hold every expert, or this rank's E/ep
    (``experts_held``, or the tensor-parallel layout's block beside the
    whole layer's ω).  ``shared_mesh``: the shared expert's gate / up are
    this rank's columns and its down its rows, summed over that mesh's
    'model' axis (the layout's cut); else whole."""
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    e = p["router"]["w"].shape[1]
    ep = mesh.axis_size(expert_axis)
    if e % ep:
        raise ValueError(f"{e} experts over a {ep}-wide {expert_axis!r} axis")
    index = mesh.axis_index(expert_axis)
    if experts_held is not None and tuple(experts_held) != (
            index * (e // ep), e // ep):
        raise ValueError(f"experts_held={tuple(experts_held)} is not rank "
                         f"{index}'s share of {e} experts over {ep}")
    banks, eq = _rank_experts(p, q_state, e, ep, index)

    xl = _rank_tokens(xt, mesh, expert_axis)
    n_l = xl.shape[0]
    cap = _capacity(n_l * top_k, e, capacity_factor)
    buf, slot, keep, w, aux = _dispatch(
        xl, p["router"], e, cap, top_k=top_k, gate=gate,
        routed_scaling=routed_scaling, dtype=ctx.dtype, held=(0, e))
    # (E, C, d) -> (E/ep, ep*C, d): slots travel to their expert's rank
    recv = mesh.all_to_all(buf, expert_axis).view(ep, e // ep, cap, d)
    out = _expert_ffn(banks, eq, recv.transpose(0, 1).reshape(
        e // ep, ep * cap, d), ctx)
    # and back: (E/ep, ep*C, d) -> (E, C, d), each source's slots home
    out = mesh.all_to_all(out.view(e // ep, ep, cap, d).transpose(0, 1)
                          .reshape(e, cap, d), expert_axis)
    y = _combine(out, slot, keep, w, n_l, top_k, ctx.dtype)
    y = mesh.all_gather(y, expert_axis, dim=0)[:xt.shape[0]]
    aux = mesh.all_reduce(aux, mesh.axis_names, op="mean")
    return _add_shared(y, p, q_state, xt, ctx, shared_mesh).reshape(
        shape), aux


def moe_apply_tp(p: dict, q_state: Any, x: torch.Tensor, ctx: QuantCtx, *,
                 mesh, top_k: int, gate: str = "softmax",
                 capacity_factor: float = 1.25, routed_scaling: float = 1.0,
                 expert_axis: str = "model", d_ff: Optional[int] = None,
                 shared_mesh=None) -> tuple:
    """Per-expert tensor parallelism over ``mesh`` (the reference's
    ``moe_apply_tp``, for few experts on a wide axis): each rank of the
    ``expert_axis`` slice holds a 1/tp slice of every expert's FFN width.
    ``x`` holds this rank's rows, the same on every rank of the slice;
    the dispatch is local, each rank contracts its ff slice, and one
    all-reduce over the slice sums the row-split down-projection.  The
    aux is the mean over the data axes.  ``p``'s banks are whole, or (an
    expert's width ``d_ff`` given, and the banks ``d_ff / tp`` wide) this
    rank's FFN columns of every expert, as the tensor-parallel layout
    holds them; ``shared_mesh`` as :func:`moe_apply_ep` takes it."""
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    n = xt.shape[0]
    e = p["router"]["w"].shape[1]
    tp = mesh.axis_size(expert_axis)
    index = mesh.axis_index(expert_axis)
    if _bank_experts(p["experts"]) != e:
        raise ValueError("expert TP holds every expert")
    ff = _gate_bank(p["experts"]).shape[-1]
    if d_ff is not None and ff not in (d_ff, d_ff // tp):
        raise ValueError(f"banks {ff} wide: expert TP over {tp} ranks of "
                         f"a {d_ff}-wide FFN needs {d_ff} or {d_ff // tp}")
    whole = d_ff is None or ff == d_ff
    cap = _capacity(n * top_k, e, capacity_factor)
    buf, slot, keep, w, aux = _dispatch(
        xt, p["router"], e, cap, top_k=top_k, gate=gate,
        routed_scaling=routed_scaling, dtype=ctx.dtype, held=(0, e))
    eq = subtree(q_state, "experts")

    def mat(name, dim):
        bank = p["experts"][name]
        return materialize(_axis_slice(bank, dim, index, tp) if whole
                           else bank, subtree(eq, name), ctx)
    g = torch.bmm(buf, mat("gate", 2))                  # the ff/tp slice
    u = torch.bmm(buf, mat("up", 2))
    h = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(buf.dtype)
    out = mesh.all_reduce(torch.bmm(h, mat("down", 1)), expert_axis)
    y = _combine(out, slot, keep, w, n, top_k, ctx.dtype)
    data_axes = tuple(a for a in mesh.axis_names if a != expert_axis)
    aux = mesh.all_reduce(aux, data_axes, op="mean")
    return _add_shared(y, p, q_state, xt, ctx, shared_mesh).reshape(
        shape), aux


def moe_path(p: dict, mesh, use_ep: bool = True,
             d_ff: Optional[int] = None) -> str:
    """The reference's choice: ``"ep"`` when the experts divide the mesh's
    'model' axis, ``"tp"`` when the FFN width does (an expert's whole
    width ``d_ff``, else the banks'), else ``"local"`` (:func:`moe_apply`
    on this rank's rows)."""
    e = p["router"]["w"].shape[1]
    ff = d_ff or _gate_bank(p["experts"]).shape[-1]
    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    multi = mesh is not None and mesh.size > 1
    if use_ep and multi and e % tp == 0:
        return "ep"
    if use_ep and multi and ff % tp == 0:
        return "tp"
    return "local"


def moe_ffn(p: dict, q_state: Any, x: torch.Tensor, ctx: QuantCtx, *,
            mesh=None, top_k: int, gate: str = "softmax",
            capacity_factor: float = 1.25,
            routed_scaling: float = 1.0, use_ep: bool = True,
            experts_held: Optional[tuple] = None,
            d_ff: Optional[int] = None, shared_mesh=None) -> tuple:
    """The reference's dispatcher (:func:`moe_path`): :func:`moe_apply_ep`,
    :func:`moe_apply_tp`, or the sort dispatch of :func:`moe_apply` (on
    one device a shard of it with ``experts_held``).  Over a mesh,
    ``experts_held`` names this rank's expert-parallel share, and the
    local path's aux is the mean over the data axes.  ``d_ff`` (an
    expert's whole FFN width) lets expert TP take banks cut on it;
    ``shared_mesh`` cuts the shared expert (:func:`moe_apply_ep`).  Banks
    that the tensor-parallel layout cut need their exchange: without
    ``use_ep`` they raise."""
    kw = dict(top_k=top_k, gate=gate, capacity_factor=capacity_factor,
              routed_scaling=routed_scaling, shared_mesh=shared_mesh)
    path = moe_path(p, mesh, use_ep, d_ff)
    if path == "ep":
        return moe_apply_ep(p, q_state, x, ctx, mesh=mesh,
                            experts_held=experts_held, **kw)
    if path == "tp":
        return moe_apply_tp(p, q_state, x, ctx, mesh=mesh, d_ff=d_ff, **kw)
    if d_ff is not None and _gate_bank(p["experts"]).shape[-1] != d_ff:
        raise ValueError(f"banks cut on the FFN width ({d_ff} whole) run "
                         "expert TP (use_ep)")
    y, aux = moe_apply(p, q_state, x, ctx, experts_held=experts_held, **kw)
    if mesh is not None and mesh.size > 1:
        # each rank routed its own rows: the aux of the mesh is the mean
        # over the data axes, as the exchanges' paths report it
        aux = mesh.all_reduce(aux, mesh.data_axes, op="mean")
    return y, aux
