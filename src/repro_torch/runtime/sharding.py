"""Partition rules: the port of the JAX package's ``runtime/sharding.py``.

Mesh axes (``launch/mesh.py``): ``('data', 'model')`` single-pod,
``('pod', 'data', 'model')`` multi-pod.  Batch shards over the data axes
(pod included), weights Megatron-style over ``model``:

* QKV / gate / up / q_up / kv_up: column-sharded (output features);
* O / down / out_proj: row-sharded (contraction dim); the SSM's in_proj
  on its contracted d_model rows (its partial sums all-reduced);
* embedding + LM head: vocab-sharded;
* MoE expert banks: expert-sharded over 'model' when E % tp == 0, else
  per-expert TP on the FFN width;
* everything small or sensitive (norms, biases, router, ω, probs, SSM
  dynamics): replicated.

Every rule is divisibility-guarded: a dim that does not divide by the axis
size is replicated.  The rules read names and shapes only, so they apply
to a tree that was never built (the reference's production meshes through
``launch.mesh.MeshSpec``).  A spec is a plain tuple, one entry per dim:
an axis name, a tuple of axis names, or None (replicated);
:func:`shard_slice` cuts this rank's block of a tensor under one.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..tree import map_

# path-regex -> role; order matters (first match wins)
_RULES: Tuple[Tuple[str, str], ...] = (
    (r"embed//table$", "vocab_rows"),
    (r"lm_head//kernel(//w|//packed)?$", "vocab_cols"),
    (r"(attn|cross)//(q|k|v)//(kernel(//w|//packed)?|bias)$", "attn_qkv"),
    (r"(attn|cross)//o//kernel(//w|//packed)?$", "attn_o"),
    (r"attn//(q_down|kv_down)//kernel(//w|//packed)?$", "col"),
    (r"attn//(q_up|kv_up)//kernel(//w|//packed)?$", "head_col"),
    (r"(mlp|shared)//(gate|up|fc1)//(kernel(//w|//packed)?|bias)$", "col"),
    (r"(mlp|shared)//(down|fc2)//kernel(//w|//packed)?$", "row"),
    (r"(mlp|shared)//(down|fc2)//bias$", "rep"),
    (r"moe//experts//(gate|up)//(w|packed)$", "expert_col"),
    (r"moe//experts//down//(w|packed)$", "expert_row"),
    (r"moe//experts//(gate|up)$", "expert_col"),
    (r"moe//experts//down$", "expert_row"),
    (r"moe//router//", "rep"),
    (r"ssm//in_proj//kernel(//w|//packed)?$", "row_contract"),
    (r"ssm//out_proj//kernel(//w|//packed)?$", "row"),
    (r"//omega$", "rep"),
    (r"//probs$", "rep"),
)

_STACK_MARKERS = ("stacks//", "enc_layers//", "dec_layers//", "layers//")


def path_name(path) -> str:
    """``"a//b//0"`` from a path of keys and indices."""
    return "//".join(str(k) for k in path)


def tree_paths(tree: Any, path: tuple = ()):
    """(path, leaf) pairs of a nested dict / list / tuple tree, dict keys
    sorted (the JAX flattening order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, path + (i,))
    else:
        yield path, tree


def named_specs(tree: Any, specs: Any, path: tuple = ()):
    """(``a//b`` name, leaf, spec) of ``tree`` in :func:`tree_paths`'
    order, ``specs`` a tree like it whose leaves are spec tuples (None:
    every spec None)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_specs(tree[k], None if specs is None
                                   else specs[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_specs(v, None if specs is None else specs[i],
                                   path + (i,))
    else:
        yield path_name(path), tree, specs


def _map_with_path(fn, tree: Any, path: tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _n_lead(name: str, ndim: int, trailing: int) -> int:
    """Leading stacked dims (the layer stack) before the logical dims."""
    for m in _STACK_MARKERS:
        if m in name:
            return max(ndim - trailing, 0)
    return 0


def _div(n: int, d: int) -> bool:
    return d > 0 and n % d == 0


def _rep(n: int) -> tuple:
    return (None,) * n


class Rules:
    """The reference's rules over ``mesh_axes`` of sizes ``mesh_shape``
    (a dict); ``cfg`` supplies head counts."""

    def __init__(self, mesh_axes: Tuple[str, ...], mesh_shape: dict, cfg):
        self.axes = tuple(mesh_axes)
        self.shape = dict(mesh_shape)
        self.cfg = cfg
        self.tp = self.shape.get("model", 1)
        self.dp_axes = tuple(a for a in ("pod", "data") if a in self.axes)
        self.dp = math.prod(self.shape[a] for a in self.dp_axes)

    @classmethod
    def for_mesh(cls, mesh, cfg=None) -> "Rules":
        return cls(tuple(mesh.axis_names), dict(mesh.shape), cfg)

    def _role_spec(self, role: str, shape: Tuple[int, ...]) -> tuple:
        tp, cfg = self.tp, self.cfg
        m = "model"
        if role == "vocab_rows":
            return (m if _div(shape[0], tp) else None, None)
        if role == "vocab_cols":
            return (None, m if _div(shape[1], tp) else None)
        if role == "attn_qkv":
            heads_ok = (_div(getattr(cfg, "n_heads", 0), tp)
                        and _div(getattr(cfg, "n_kv", 0), tp))
            if len(shape) == 1:      # qkv bias
                return (m if heads_ok and _div(shape[0], tp) else None,)
            return (None, m if heads_ok and _div(shape[1], tp) else None)
        if role == "head_col":       # MLA up-projections: per-head columns
            heads_ok = _div(getattr(cfg, "n_heads", 0), tp)
            return (None, m if heads_ok and _div(shape[1], tp) else None)
        if role == "attn_o":
            heads_ok = _div(getattr(cfg, "n_heads", 0), tp)
            return (m if heads_ok and _div(shape[0], tp) else None, None)
        if role == "col":
            if len(shape) == 1:
                return (m if _div(shape[0], tp) else None,)
            return (None, m if _div(shape[1], tp) else None)
        if role in ("row", "row_contract"):
            return (m if _div(shape[0], tp) else None, None)
        if role == "expert_col":
            if _div(shape[0], tp):
                return (m, None, None)
            return (None, None, m if _div(shape[2], tp) else None)
        if role == "expert_row":
            if _div(shape[0], tp):
                return (m, None, None)
            return (None, m if _div(shape[1], tp) else None, None)
        return _rep(len(shape))

    def spec_for(self, name: str, shape: Tuple[int, ...]) -> tuple:
        shape = tuple(shape)
        for pattern, role in _RULES:
            if re.search(pattern, name):
                if role == "rep":
                    return _rep(len(shape))
                arity = 3 if role.startswith("expert") else 2
                if name.endswith("bias"):
                    arity = 1
                lead = _n_lead(name, len(shape), arity)
                logical = shape[lead:]
                if len(logical) != arity:
                    return _rep(len(shape))
                return _rep(lead) + self._role_spec(role, logical)
        return _rep(len(shape))

    # ------------------------------------------------------ tree mappers

    def param_specs(self, params: Any) -> Any:
        return _map_with_path(
            lambda p, leaf: self.spec_for(path_name(p), _shape(leaf)), params)

    def zero1_spec(self, spec: tuple, shape: Tuple[int, ...]) -> tuple:
        """Shard the first replicated, divisible dim over the data axes."""
        if not self.dp_axes or self.dp == 1:
            return spec
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for i, (s, dim) in enumerate(zip(parts, shape)):
            if s is None and _div(dim, self.dp):
                parts[i] = self.dp_axes if len(self.dp_axes) > 1 \
                    else self.dp_axes[0]
                return tuple(parts)
        return spec

    def opt_specs(self, params: Any, zero1: bool = True) -> Any:
        """Specs for one params-shaped moment tree (m or v)."""
        def f(path, leaf):
            spec = self.spec_for(path_name(path), _shape(leaf))
            return self.zero1_spec(spec, _shape(leaf)) if zero1 else spec
        return _map_with_path(f, params)

    def qstate_specs(self, qstate: Any) -> Any:
        return _map_with_path(lambda p, leaf: _rep(len(_shape(leaf))), qstate)

    def _data_axis(self):
        if not self.dp_axes:
            return None
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    def batch_spec(self, ndim: int, batch_dim: Optional[int] = None) -> tuple:
        """Batch over the data axes; replicated when it does not divide."""
        if batch_dim is not None and not _div(batch_dim, self.dp):
            return _rep(ndim)
        return (self._data_axis(),) + _rep(ndim - 1)

    def batch_specs(self, batch: Any) -> Any:
        def f(path, leaf):
            shape = _shape(leaf)
            return self.batch_spec(len(shape), shape[0] if shape else None)
        return _map_with_path(f, batch)

    def cache_specs(self, cache: Any) -> Any:
        """KV / SSM caches: batch over the data axes, heads over 'model'
        when they divide; the leading (L,) stack dim replicated."""
        tp = self.tp

        def f(path, leaf):
            name = path_name(path)
            shape = _shape(leaf)
            nd = len(shape)
            if nd <= 1 or name.endswith("len") or name.endswith("pos"):
                return _rep(nd)
            bx = self._data_axis() if _div(shape[1], self.dp) else None
            if name.endswith(("//k", "//v")) and nd == 5:
                return (None, bx, None,
                        "model" if _div(shape[3], tp) else None, None)
            if name.endswith("//ssm") and nd == 5:
                return (None, bx, "model" if _div(shape[2], tp) else None,
                        None, None)
            return (None, bx) + _rep(nd - 2)
        return _map_with_path(f, cache)


def serving_pack_specs(layers, rules: Rules) -> list:
    """Specs of a frozen serving pack's layer tensors: each layer's
    ``packed`` (⌈K/2⌉, N) under the ``//packed`` column rule (split over
    the output features when N divides the model axis), α₁ and b with
    their layer's split, ω and α₂ replicated.  One dict a layer with keys
    ``packed / omega / alpha1 / bias / alpha2``."""
    specs = []
    for i, layer in enumerate(layers):
        packed = rules.spec_for(f"layers//{i}//mlp//fc1//kernel//packed",
                                _shape(layer["packed"]))
        col_ok = len(packed) == 2 and packed[1] is not None
        vec = ("model",) if col_ok else (None,)
        specs.append({
            "packed": packed,
            "omega": rules.spec_for(f"layers//{i}//omega",
                                    _shape(layer["omega"])),
            "alpha1": vec,
            "bias": vec,
            "alpha2": (),
        })
    return specs


# ------------------------------------------------- the port's own layout
#
# Every family over a mesh whose 'model' axis holds more than one rank
# takes the reference's layout: each leaf as ``Rules.param_specs`` gives
# it (QKV and their biases, self and cross, MLA's down-projections, gate /
# up / fc1 and fc1's bias and the shared expert's column-sharded, MLA's
# up-projections by heads, O, down / fc2 and the SSM's out_proj
# row-sharded, the SSM's in_proj on its contracted d_model rows, the
# expert banks on their expert dim or each expert's FFN width, the
# embedding and the head over the vocabulary, every other leaf
# replicated: norms, fc2's bias, whisper's learned decoder positions, the
# SSM dynamics), each rank holding its block of a sharded leaf and no
# whole copy.  Where a family's heads do not divide the axis (whisper's 8
# at 16) its attention stays whole on each rank and the FFN and the
# vocabulary are still cut.  Any family over model = 1 keeps each
# non-expert weight whole on each rank: a leaf is replicated over the
# whole mesh, except an expert-parallel share's banks (``experts_held``:
# fewer experts than its router scores), which the ranks of one 'model'
# index hold alike, replicated over the data axes.

TP_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def tensor_parallel(cfg, mesh) -> bool:
    """True when ``cfg`` takes the reference's tensor-parallel layout over
    ``mesh``: an arch of a family in :data:`TP_FAMILIES` (every family)
    and a 'model' axis of more than one rank.  A config that names
    its own expert share (``experts_held``) raises there: the layout
    decides which experts a rank holds."""
    on = (cfg is not None and mesh is not None
          and getattr(cfg, "family", None) in TP_FAMILIES
          and mesh.shape.get("model", 1) > 1)
    if on and getattr(cfg, "experts_held", None) is not None:
        raise ValueError(f"{cfg.name}: experts_held={cfg.experts_held} over "
                         f"a tensor-parallel mesh {dict(mesh.shape)}: the "
                         "layout decides which experts a rank holds")
    return on


@dataclasses.dataclass(frozen=True)
class ModelTP:
    """What each rank of a stack holds under the tensor-parallel layout,
    role by role (``Rules.spec_for`` of the logical shapes): ``heads`` its
    ``n_heads / tp`` heads (GQA's q / k / v and their biases column-
    sharded, ``n_kv / tp`` KV heads; MLA's q_up / kv_up by heads),
    ``o_rows`` o row-sharded (the rows of ``n_heads / tp`` heads),
    ``q_down`` / ``kv_down`` MLA's down-projections column-sharded,
    ``mlp`` a dense layer's gate / up (fc1) column- and down (fc2)
    row-sharded, ``shared`` the shared expert's the same way, ``experts``
    the routed banks cut on their expert dim (``"ep"``), on each expert's
    FFN width (``"tp"``) or whole (None), ``vocab`` the embedding's rows
    and the head's columns split over the vocabulary; an SSM block's
    ``ssm_in`` in_proj's d_model rows and ``ssm_out`` out_proj's d_inner
    rows cut, ``ssm_heads`` its recurrent state cut on its heads
    (``Rules.cache_specs``' test: the heads divide 'model'), so that the
    rank scans its ``H / tp`` heads, whose d_inner columns are its rows of
    out_proj.  An attention-free arch has no attention or FFN cut."""
    mesh: Any
    tp: int
    heads: bool
    o_rows: bool
    mlp: bool
    vocab: bool
    shared: bool = False
    q_down: bool = False
    kv_down: bool = False
    experts: Optional[str] = None
    ssm_in: bool = False
    ssm_out: bool = False
    ssm_heads: bool = False


def model_tp(cfg, mesh) -> Optional[ModelTP]:
    """:class:`ModelTP` of ``cfg`` over ``mesh``, or None when the layout
    is not tensor-parallel (:func:`tensor_parallel`)."""
    if not tensor_parallel(cfg, mesh):
        return None
    tp = mesh.shape["model"]
    return ModelTP(mesh, tp, **_cuts(cfg, tuple(mesh.axis_names),
                                     tuple(mesh.shape.values())))


@functools.lru_cache(maxsize=None)
def _cuts(cfg, axes: tuple, sizes: tuple) -> dict:
    """The fields of :class:`ModelTP` but the mesh, by the rules."""
    rules = Rules(axes, dict(zip(axes, sizes)), cfg)
    d, h = cfg.d_model, cfg.n_heads
    ff = cfg.dense_ff or cfg.d_ff

    def cut(name, shape, dim):
        return rules.spec_for(f"stacks//x//{name}//kernel//w", (1,) + shape
                              )[1 + dim] is not None
    out = {"vocab": rules.spec_for("embed//table", (cfg.padded_vocab, d))[0]
           is not None}
    if cfg.family in ("ssm", "hybrid"):
        out.update(_ssm_cuts(cfg, rules, cut))
    if cfg.attention_free:
        return {**out, "heads": False, "o_rows": False, "mlp": False}
    out["mlp"] = cut("mlp//up", (d, ff), 1)
    if cfg.mla is not None:
        m = cfg.mla
        out.update(heads=cut("attn//q_up", (m.q_lora_rank, h * (
            m.qk_nope_dim + m.qk_rope_dim)), 1),
            o_rows=cut("attn//o", (h * m.v_head_dim, d), 0),
            q_down=cut("attn//q_down", (d, m.q_lora_rank), 1),
            kv_down=cut("attn//kv_down", (d, m.kv_lora_rank
                                          + m.qk_rope_dim), 1))
        if cut("attn//kv_up", (m.kv_lora_rank, h * (
                m.qk_nope_dim + m.v_head_dim)), 1) != out["heads"]:
            raise ValueError(f"{cfg.name}: q_up and kv_up split unlike")
    else:
        hd = cfg.resolved_head_dim
        out.update(heads=cut("attn//q", (d, h * hd), 1),
                   o_rows=cut("attn//o", (h * hd, d), 0))
    if cfg.n_experts:
        out["shared"] = bool(cfg.n_shared_experts) and cut(
            "moe//shared//up", (d, cfg.d_ff * cfg.n_shared_experts), 1)
        bank = rules.spec_for("stacks//moe//moe//experts//gate//w",
                              (1, cfg.n_experts, d, cfg.d_ff))
        out["experts"] = "ep" if bank[1] else "tp" if bank[3] else None
    return out


def _ssm_cuts(cfg, rules: Rules, cut) -> dict:
    """An SSM block's cuts: in_proj's and out_proj's rows by their rules,
    the state's heads by ``Rules.cache_specs``.  Raises where the heads are
    cut but out_proj's rows are not, or its groups do not split with the
    heads (no published arch does either)."""
    h, di = cfg.ssm_heads, cfg.d_inner
    width = 2 * di + 2 * cfg.ssm_groups * cfg.ssm_state + h
    state = torch.empty((1, 1, h, di // h, cfg.ssm_state), device="meta")
    out = {"ssm_in": cut("ssm//in_proj", (cfg.d_model, width), 0),
           "ssm_out": cut("ssm//out_proj", (di, cfg.d_model), 0),
           "ssm_heads": rules.cache_specs({"x": {"ssm": state}})["x"]["ssm"][2]
           is not None}
    if out["ssm_heads"] and not out["ssm_out"]:
        raise ValueError(f"{cfg.name}: the SSM state is cut on its {h} heads "
                         "but out_proj's rows are not")
    g = cfg.ssm_groups
    if out["ssm_heads"] and g > 1 and g % rules.tp:
        raise ValueError(f"{cfg.name}: {g} SSM groups do not split with "
                         f"the heads over 'model' ({rules.tp})")
    return out


def layout_specs(params: Any, cfg, mesh) -> Any:
    """The port's layout of a whole parameter tree (real, abstract or
    frozen) over ``mesh``: ``Rules.param_specs`` under
    :func:`tensor_parallel`, else each leaf replicated but a share's expert
    banks (``cfg.experts_held``), split over 'model' on their expert dim
    (dim 1 of the (L, E, ...) stack).  A frozen leaf's row-pair-packed
    codes must split as its weights would (raises where K / 2 and K divide
    the axis differently)."""
    if tensor_parallel(cfg, mesh):
        rules = Rules.for_mesh(mesh, cfg)
        for path, leaf in tree_paths(params):
            name = path_name(path)
            if name.endswith("//packed"):
                shape = _shape(leaf)
                logical = shape[:-2] + (2 * shape[-2], shape[-1])
                if rules.spec_for(name[:-6] + "w", logical) != \
                        rules.spec_for(name, shape):
                    raise ValueError(f"{name}: the packed codes {shape} "
                                     "split unlike their weights")
        return rules.param_specs(params)

    def walk(node, banks):
        if isinstance(node, dict):
            return {k: walk(v, banks or k == "experts")
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, banks) for v in node)
        out = [None] * len(_shape(node))
        if banks and len(out) >= 2:
            out[1] = "model"
        return tuple(out)
    if getattr(cfg, "experts_held", None) is not None:
        return walk(params, False)
    return _whole(params)


def _whole(params: Any) -> Any:
    return _map_with_path(lambda _, t: _rep(len(_shape(t))), params)


def qstate_layout(qstate: Any, specs: Any) -> Any:
    """The layout of a rank's ECL state (``core.qat.build_qstate`` of its
    params) over the whole tree, from its params' ``specs``: a quantized
    leaf's probabilities replicated (the reference's
    ``Rules.qstate_specs``), and every other leaf's placeholder, which
    shares its param's leading dim, cut as that dim is (a rank's
    placeholder of its vocabulary block of the embedding is that block's
    length)."""
    if isinstance(qstate, dict):
        if set(qstate) == {"probs"} and isinstance(specs, dict) \
                and "w" in specs:
            return {"probs": _rep(qstate["probs"].ndim)}
        return {k: qstate_layout(v, specs[k]) for k, v in qstate.items()}
    if isinstance(qstate, (list, tuple)):
        return type(qstate)(qstate_layout(v, sp)
                            for v, sp in zip(qstate, specs))
    return tuple(specs[:1]) if _shape(qstate) else ()


def spec_axes(spec: tuple) -> frozenset:
    """The mesh axes a spec cuts over."""
    out = set()
    for a in spec:
        if a is not None:
            out.update((a,) if isinstance(a, str) else a)
    return frozenset(out)


def _share_banks(node: dict) -> bool:
    """A MoE layer's dict whose banks hold fewer experts than its router
    scores (an expert-parallel share)."""
    gate = node["experts"]["gate"]
    w = gate["w"] if isinstance(gate, dict) else gate
    return w.shape[-3] < node["router"]["w"].shape[-1]


def replica_axes(params: Any, mesh, specs: Any = None) -> Any:
    """The mesh axes each leaf of ``params`` is replicated over: the ranks
    whose gradients of that leaf add up to its gradient (a tree like
    ``params`` of frozensets of axis names, which the tree functions take
    as leaves; empty for a leaf no other rank holds).  With ``specs`` (the
    layout, :func:`layout_specs`) every axis a leaf is not cut over; else
    the layout read off the tree (whole leaves, a share's banks)."""
    every, data = frozenset(mesh.axis_names), frozenset(mesh.data_axes)
    if specs is not None:
        return map_(lambda _, s: every - spec_axes(s), params, specs)

    def walk(node, axes):
        if isinstance(node, dict):
            moe = "router" in node and "experts" in node and _share_banks(node)
            return {k: walk(v, data if moe and k == "experts" else axes)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, axes) for v in node)
        return axes
    return walk(params, every)


def opt_specs(params: Any, mesh, specs: Any = None) -> Any:
    """ZeRO-1's spec of each leaf's Adam moments over the whole mesh: the
    layout spec (``specs``; every dim whole without) with the first dim it
    leaves whole that divides over the data axes cut over them, the
    reference's :meth:`Rules.zero1_spec`.  A row-sharded (K, N) leaf is
    then cut on N."""
    rules = Rules.for_mesh(mesh)
    return map_(lambda t, s: rules.zero1_spec(s, _shape(t)), params,
                _whole(params) if specs is None else specs)


def zero1_specs(params: Any, mesh, specs: Any = None) -> Any:
    """The cut of this rank's parameter leaves that gives its ZeRO-1
    moment blocks: :func:`opt_specs` over the data axes only (the 'model'
    cut is the leaf's own), for :func:`shard_slice` of the rank's leaf; a
    leaf with no such dim keeps whole moments."""
    specs = _whole(params) if specs is None else specs
    return map_(lambda _, spec, z: tuple(a if s is None else None
                                         for s, a in zip(spec, z)),
                params, specs, opt_specs(params, mesh, specs))


class NamedSpec(NamedTuple):
    """A spec on a mesh, the reference's ``NamedSharding``: what a
    checkpoint restore's ``sharding_fn`` gives for a leaf, whose block
    :func:`shard_slice` cuts."""
    mesh: Any
    spec: tuple


def shard_slice(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` on ``mesh`` (a view: each
    named dim cut into equal blocks in mesh order)."""
    if len(spec) > t.ndim:
        raise ValueError(f"spec {spec} has more dims than {tuple(t.shape)}")
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        n = mesh.axis_size(axes)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                             f"over {axes} ({n})")
        blk = t.shape[d] // n
        t = t.narrow(d, mesh.axis_index(axes) * blk, blk)
    return t


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """This rank's block of every leaf of ``tree`` under ``specs`` (a tree
    like it), each cut leaf a tensor of its own (a copy, so that the whole
    one can be freed)."""
    def cut(t, spec):
        if not isinstance(t, torch.Tensor) or not spec_axes(spec):
            return t
        return shard_slice(t, spec, mesh).clone()
    return map_(cut, tree, specs)


@torch.no_grad()
def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """The whole of every leaf of ``tree`` (this rank's blocks under
    ``specs``): each cut dim all-gathered over its axes in mesh order, the
    inverse of :func:`shard_tree`."""
    def whole(t, spec):
        for d, axes in enumerate(spec):
            if axes is not None:
                t = mesh.all_gather(t, axes, dim=d)
        return t
    return map_(whole, tree, specs)
