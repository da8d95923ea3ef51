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

Over a mesh whose ranks each hold a block of a leaf (the dense and moe
families' tensor-parallel layout, ``runtime/sharding.py``) these
functions take ``shards`` (:class:`Shards`).  A leaf cut within its
segments (a matrix's columns or rows, or each expert's FFN width) has
each segment's mean(w²) from its blocks' fp64 sums added over the ranks
that hold them, and its 16 code counts summed the same way before the
EMA (the reference's "16-element psum per tensor"), one all-reduce for
all leaves cut alike.  A leaf cut on a leading dim (an expert bank cut
on its experts) holds whole segments: the rank's pass reads ω and the
probabilities of its segments only (the layout replicates the whole
layer's), and its counts enter the whole layer's, zeros elsewhere,
summed over the ranks.  The counts are exact integers, so the
probabilities are bitwise those of one process.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, NamedTuple, Optional, Sequence

import torch

from ..runtime.sharding import spec_axes
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


class Shards(NamedTuple):
    """How a tree's quantized leaves lie over a mesh: ``specs`` the tree's
    layout (``runtime.sharding.layout_specs``, a tree like it: a quantized
    leaf's spec is a dict with ``"w"``), ``mesh`` its ranks."""
    mesh: Any
    specs: Any


def _sum_over(ts: list, axes: list, mesh) -> list:
    """Each tensor of ``ts`` summed over its ``axes``: one all-reduce of a
    flat buffer a group of tensors with the same axes and dtype."""
    out, groups = list(ts), {}
    for i, a in enumerate(axes):
        if a and mesh.axis_size(a) > 1:
            groups.setdefault((a, ts[i].dtype), []).append(i)
    for (a, _), idx in groups.items():
        flat = mesh.all_reduce(torch.cat([ts[i].reshape(-1) for i in idx]), a)
        for i, part in zip(idx, flat.split([ts[i].numel() for i in idx])):
            out[i] = part.view(ts[i].shape)
    return out


@torch.no_grad()
def penalties(ws: Sequence[torch.Tensor], probs: Sequence[torch.Tensor], lam,
              axes: Optional[list] = None, mesh=None) -> list:
    """:func:`ecl.penalty` of every tensor; a tensor cut over ``axes[i]``
    of ``mesh`` takes mean(w²) of its whole segment (the blocks' fp64 sums
    added over those axes)."""
    if axes is None or not any(axes):
        return [ecl.penalty(w, p, lam) for w, p in zip(ws, probs)]
    batched = [p.ndim > 1 for p in probs]
    sums = _sum_over([ecl.square_sum(w, b) for w, b in zip(ws, batched)],
                     axes, mesh)
    out = []
    for w, p, total, b, a in zip(ws, probs, sums, batched, axes):
        n = ecl.segment_size(w, b) * (mesh.axis_size(a) if a else 1)
        out.append(ecl.penalty(w, p, lam, scale=(total / n).to(
            torch.float32)))
    return out


def fake_quant_many(ws: Sequence[torch.Tensor],
                    omegas: Sequence[torch.Tensor],
                    probs: Sequence[torch.Tensor], lam,
                    dtype=None, axes: Optional[list] = None,
                    mesh=None) -> list:
    """STE fake-quantization of every tensor in one grouped launch, with
    the differentiable centroid path; [ŵ] in the order given (``axes``
    and ``mesh`` as :func:`penalties` takes them)."""
    if not ws:
        return []
    pens = penalties(ws, probs, lam, axes, mesh)
    outs = FakeQuantGroup.apply(len(ws), *ws, *omegas, *pens)
    return [o if o.dtype == (dtype or w.dtype) else o.to(dtype or w.dtype)
            for o, w in zip(outs, ws)]


def fake_quant(w: torch.Tensor, omega: torch.Tensor, probs: torch.Tensor,
               lam, dtype=None) -> torch.Tensor:
    """STE fake-quantization with the differentiable centroid path."""
    return fake_quant_many([w], [omega], [probs], lam, dtype)[0]


def apply_quant_many(nodes: Sequence[dict], qstates: Sequence[dict], lam,
                     dtype=None, axes: Optional[list] = None,
                     mesh=None) -> list:
    return fake_quant_many([n["w"] for n in nodes],
                           [n["omega"] for n in nodes],
                           [q["probs"] for q in qstates], lam, dtype, axes,
                           mesh)


def apply_quant(node: dict, qstate: dict, lam, dtype=None) -> torch.Tensor:
    return apply_quant_many([node], [qstate], lam, dtype)[0]


def fake_quant_tree(params: Any, qstate: Any, lam, dtype=None,
                    shards: Optional[Shards] = None) -> Any:
    """``params`` with every quantized leaf replaced by its fake-quantized
    ŵ in ``dtype`` (differentiable as :func:`fake_quant`; the gradient of
    an ω this rank does not read is zero here), every leaf in one
    :func:`apply_quant_many` call; other leaves are kept."""
    cut = _Cut.of(params, shards)

    def f(nodes, qss):
        nodes, qss = cut.held(nodes, qss)
        return apply_quant_many(nodes, qss, lam, dtype, cut.within, cut.mesh)
    return _map_quant_many(f, params, qstate, keep_params=True)


class _Cut(NamedTuple):
    """How each quantized leaf of a tree is cut (in the order
    :func:`_map_quant_many` visits them): ``within`` the axes its segments
    are cut over (their blocks' sums added over them), ``lead`` the
    ``(dim, axes)`` of its leading dims cut (this rank holds those
    segments whole), ``every`` both; all None without shards."""
    mesh: Any = None
    within: Optional[list] = None
    lead: Optional[list] = None
    every: Optional[list] = None

    @classmethod
    def of(cls, params: Any, shards: Optional[Shards]) -> "_Cut":
        if shards is None:
            return cls()
        within, lead, every = [], [], []

        def note(node, spec):
            w = spec["w"]
            n = len(w) - 2
            within.append(spec_axes(w[n:]))
            lead.append(tuple((d, a) for d, a in enumerate(w[:n])
                              if a is not None))
            every.append(spec_axes(w))
        _map_quant(note, params, shards.specs)
        return cls(shards.mesh, within, lead, every)

    def _mine(self, t: torch.Tensor, w: torch.Tensor, i: int):
        """This rank's segments of ``t`` (ω or the probabilities of leaf
        ``i``, whose w is ``w``): cut where ``t`` is the whole layer's."""
        for d, a in self.lead[i]:
            n = w.shape[d]
            if t.shape[d] == n * self.mesh.axis_size(a):
                t = t.narrow(d, self.mesh.axis_index(a) * n, n)
            elif t.shape[d] != n:
                raise ValueError(f"dim {d} of {tuple(t.shape)}: neither "
                                 f"{n} segments nor all of them")
        return t

    def held(self, nodes: Sequence[dict], qss: Sequence[dict]) -> tuple:
        """The leaves as this rank's pass reads them: ω and the
        probabilities of its segments."""
        if self.mesh is None or not any(self.lead):
            return nodes, qss
        return ([{**n, "omega": self._mine(n["omega"], n["w"], i)}
                 for i, n in enumerate(nodes)],
                [{"probs": self._mine(q["probs"], n["w"], i)}
                 for i, (n, q) in enumerate(zip(nodes, qss))])

    def placed(self, counts: list, nodes: Sequence[dict],
               qss: Sequence[dict]) -> list:
        """Each leaf's counts of this rank's segments in a zero tensor of
        the whole layer's probabilities' shape."""
        out = []
        for i, (c, n, q) in enumerate(zip(counts, nodes, qss)):
            if self.lead[i] and q["probs"].shape != c.shape:
                whole = c.new_zeros(q["probs"].shape)
                self._mine(whole, n["w"], i).copy_(c)
                c = whole
            out.append(c)
        return out


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
    """Mirror tree with a probs state per quantized leaf (one per leading
    index of its ω); other tensor leaves mirror to a uint8 placeholder
    sharing their leading dim, as the JAX package's ``build_qstate``
    does."""
    if is_quant_leaf(params):
        # ω's lead: a rank's expert-bank block beside the layer's whole ω
        # gets the layer's whole probabilities, as the layout holds them
        om = params["omega"]
        return init_qstate_leaf(tuple(om.shape[:-1]), device=om.device)
    if isinstance(params, dict):
        return {k: build_qstate(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(build_qstate(v) for v in params)
    if isinstance(params, torch.Tensor):
        lead = tuple(params.shape[:1]) if params.ndim >= 1 else ()
        return torch.zeros(lead, dtype=torch.uint8, device=params.device)
    return params


def _assign_leaves(nodes: Sequence[dict], qss: Sequence[dict], lam,
                   axes: Optional[list] = None, mesh=None) -> list:
    """The codes of every leaf, one grouped pass (``axes`` and ``mesh`` as
    :func:`penalties` takes them)."""
    ws = [n["w"] for n in nodes]
    probs = [q["probs"] for q in qss]
    pens = penalties(ws, probs, lam, axes, mesh)
    with torch.no_grad():
        return [c for c, _ in ecl.quantize_many(
            ws, [n["omega"] for n in nodes], pens)]


@torch.no_grad()
def update_qstate(params: Any, qstate: Any, lam,
                  momentum: float = 0.9,
                  shards: Optional[Shards] = None) -> Any:
    """One EMA step of the per-tensor cluster probabilities (one ECL
    iteration per training step), every tensor in one grouped call; with
    ``shards`` each segment's code counts summed over the ranks that hold
    its blocks first (a rank's whole segments' entering the layer's with
    zeros elsewhere)."""
    cut = _Cut.of(params, shards)

    def f(nodes, qss):
        mine, mine_qs = cut.held(nodes, qss)
        codes = _assign_leaves(mine, mine_qs, lam, cut.within, cut.mesh)
        counts = [ecl.code_counts(c, q["probs"].ndim - 1)
                  for c, q in zip(codes, mine_qs)]
        if cut.mesh is not None:
            counts = _sum_over(cut.placed(counts, nodes, qss), cut.every,
                               cut.mesh)
        return [{"probs": ecl.update_probs(q["probs"], None, momentum, n)}
                for q, n in zip(qss, counts)]
    return _map_quant_many(f, params, qstate)


@torch.no_grad()
def quantize_tree(params: Any, qstate: Any, lam,
                  shards: Optional[Shards] = None) -> Any:
    """Replace each quantized leaf with ``{"codes", "omega"}`` (every leaf
    assigned in one grouped call); other leaves are kept."""
    cut = _Cut.of(params, shards)

    def f(nodes, qss):
        codes = _assign_leaves(*cut.held(nodes, qss), lam, cut.within,
                               cut.mesh)
        return [{"codes": c, "omega": n["omega"]}
                for n, c in zip(nodes, codes)]
    return _map_quant_many(f, params, qstate, keep_params=True)


@torch.no_grad()
def freeze_tree(params: Any, qstate: Any, lam,
                shards: Optional[Shards] = None) -> Any:
    """Serving form: every quantized leaf becomes ``{"packed", "omega"}``
    with row-pair-packed uint8 codes (4 bits a weight); other leaves are
    kept.  Every leaf is assigned in one grouped call: an L-stacked leaf
    with ω (L, 4) is L segments of it, so on the card the whole tree takes
    ⌈segments / 32⌉ launches.  Contraction dims must be even.  A rank's
    blocks (``shards``) give the codes of those blocks of the whole
    tree's freeze (ω as the tree holds it: a rank's bank block keeps the
    whole layer's)."""
    cut = _Cut.of(params, shards)

    def f(nodes, qss):
        codes = _assign_leaves(*cut.held(nodes, qss), lam, cut.within,
                               cut.mesh)
        return [{"packed": bitplanes.pack_codes_rows(c),
                 "omega": n["omega"].to(torch.float32)}
                for n, c in zip(nodes, codes)]
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
