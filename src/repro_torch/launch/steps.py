"""Step functions (train / prefill / decode) and their layouts: the port
of the JAX package's ``launch/steps.py``.

:func:`build_step` returns a :class:`StepBundle` for one (arch × shape ×
mesh) cell: this rank's step ``fn``, the layout of its inputs and outputs
(``in_specs`` / ``out_specs``, ``runtime/sharding.py`` spec tuples), this
rank's abstract arguments (meta tensors, ``launch/specs.py``; these three
built on first read) and the arguments it consumes (``donate``).  The reference hands its bundle to
``jax.jit``; here ``fn`` runs eagerly, on the abstract arguments under
``launch/op_analysis.py`` (the dry run, ``launch/dryrun.py``) or on real
tensors of the same shapes (the card, the tests).

The port's layout (``runtime/sharding.py``): an arch of any family over
a 'model' axis of more than one rank takes the reference's
(``Rules.param_specs``: QKV (self and cross), MLA's down-projections,
gate / up / fc1 and the shared expert's column-sharded, MLA's
up-projections by heads, O, down / fc2 and the SSM's out_proj
row-sharded, its in_proj on the contracted rows, the expert banks on
their experts or each expert's FFN width, the embedding and the head
over the vocabulary, the KV cache, whisper's cross K/V and the SSM state
over heads where they divide), and the bundle's specs and arguments are
a rank's blocks (``describe()`` names how the banks are cut); over
model = 1 each weight stays whole on each rank, and a config that names
its share of the experts (``experts_held``) holds those banks.  The
batch is split over the data axes (every row on each rank when it does
not divide, the reference's rule).  :func:`layout_name` names the layout a bundle took.
Serving steps run on the frozen tree (row-pair-packed 4-bit codes and ω,
decoded where they are used) or, with ``serve_dtype="bf16"``, on plain
bf16 weights, the reference's comparison point.

``_loss_fn`` is ``lm_forward_loss``, or ``whisper_forward_loss`` for the
audio family, under a ``QuantCtx`` that fake-quantizes every quantized
leaf when the arch quantizes, in the reference's bf16 compute dtype
unless the caller names another, with the layer body rematerialised as
``remat`` says (``none``, ``full`` or ``dots``; whisper's forward ignores
it, as the reference's does).  Over a ``mesh`` each rank runs its rows
through the MoE exchanges and the loss is the whole batch's on every
rank.  :func:`build_train_step`'s bundle also carries ``init_state``,
which builds a rank's train state from its parameters (ZeRO-1's moment
blocks with ``zero1``, the error feedback with ``compress``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from ..configs.base import ArchConfig
from ..core import qat
from ..models import lm as lm_model
from ..models import whisper as W
from ..nn import transformer as T
from ..nn.module import QuantCtx
from ..nn.transformer import check_remat, check_supported
from ..optim import adam, ec4t
from ..optim.grad_compress import GradCompressCfg
from ..runtime import sharding
from ..runtime.sharding import Rules
from ..tree import map_
from . import specs as specs_mod


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """A step and its layout.  ``layout()`` returns ``(in_specs,
    out_specs, args)`` and runs on the first read of any of them, so a
    caller that only runs ``fn`` on real tensors never builds the abstract
    tree."""
    name: str
    fn: Callable
    layout: Callable = dataclasses.field(repr=False)
    donate: tuple = ()
    init_state: Optional[Callable] = None     # train: params -> state
    kind: str = "replicated"                  # the layout, layout_name's
    experts: Optional[str] = None             # the banks' cut: ep, tp

    def describe(self) -> dict:
        out = {"step": self.name, "layout": self.kind,
               "donate": list(self.donate)}
        if self.experts is not None:
            out["experts"] = self.experts
        return out

    @functools.cached_property
    def _layout(self) -> tuple:
        return self.layout()

    @property
    def in_specs(self) -> Any:
        return self._layout[0]

    @property
    def out_specs(self) -> Any:
        return self._layout[1]

    @property
    def args(self) -> tuple:
        """This rank's abstract arguments (meta tensors)."""
        return self._layout[2]


def make_rules(cfg: ArchConfig, mesh) -> Rules:
    return Rules.for_mesh(mesh, cfg)


def _ctx(cfg: ArchConfig, *, quant: bool, dtype=torch.bfloat16) -> QuantCtx:
    return QuantCtx(quant=quant, lam=cfg.lam, compute_dtype=dtype)


# cache leaves with no batch dim: the slots' positions and the length
_UNBATCHED = ("pos", "len")


def _batched(tree: Any, fn: Callable, dim: int,
             other: Callable = lambda t: t) -> Any:
    """``fn(leaf)`` on every tensor leaf with a batch dim (``dim``; a
    cache's ``pos`` and ``len`` have none), ``other(leaf)`` on the other
    tensor leaves."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if not isinstance(node, torch.Tensor):
            return node
        if node.ndim <= dim or key in _UNBATCHED:
            return other(node)
        return fn(node)
    return walk(tree)


def _rank_rows(tree: Any, mesh, dim: int = 0) -> Any:
    """This rank's rows of every batched leaf, cut on ``dim`` (a cache's
    batch dim is 1, after the layer stack) over the data axes
    (``models/lm.py`` ``batch_rows``: every row when they do not divide),
    each cut a tensor of its own."""
    def cut(t):
        rows = lm_model.batch_rows(mesh, t.shape[dim])
        return t if rows is None else t.narrow(
            dim, rows.start, rows.stop - rows.start).clone()
    return _batched(tree, cut, dim)


def _bank_cut(cfg: ArchConfig, mesh) -> Optional[str]:
    """How the tensor-parallel layout cuts ``cfg``'s expert banks over
    ``mesh`` (``"ep"``, ``"tp"``), else None."""
    tp = sharding.model_tp(cfg, mesh)
    return tp.experts if tp is not None else None


def layout_name(cfg: ArchConfig, mesh) -> str:
    """The layout a bundle of ``cfg`` over ``mesh`` takes: ``"tensor
    parallel"`` (the reference's ``Rules``), ``"expert parallel"`` (a
    config naming its share of the experts, ``experts_held``, the rest
    whole) or ``"replicated"``."""
    if sharding.tensor_parallel(cfg, mesh):
        return "tensor parallel"
    if cfg.experts_held is not None:
        return "expert parallel"
    return "replicated"


def _blocks(tree: Any, specs: Any, cfg: ArchConfig, mesh) -> Any:
    """This rank's blocks of a whole (abstract) tree under the
    tensor-parallel layout; any other layout's tree is already the rank's
    (a share's banks are its config's, ``experts_held``)."""
    if not sharding.tensor_parallel(cfg, mesh):
        return tree
    return sharding.shard_tree(tree, specs, mesh)


def _loss_fn(cfg: ArchConfig, mesh=None, use_ep: bool = True,
             remat: str = "none",
             dtype: torch.dtype = torch.bfloat16) -> Callable:
    """``loss(params, qstate, batch, lam) -> (loss, metrics)``.  One
    shard's share of expert parallelism also trains on one device
    through ``cfg.experts_held``."""
    check_supported(cfg)
    check_remat(remat)
    fwd = (W.whisper_forward_loss if cfg.family == "audio"
           else lm_model.lm_forward_loss)

    def loss(params, qstate, batch, lam):
        ctx = QuantCtx(quant=cfg.quantize, lam=lam, compute_dtype=dtype)
        return fwd(params, qstate, batch, ctx, cfg, mesh=mesh,
                   use_ep=use_ep, remat=remat)
    return loss


# ---------------------------------------------------------------- train

def build_train_step(cfg: ArchConfig, mesh, *,
                     shape_name: str = "train_4k", remat: str = "full",
                     use_ep: bool = True, zero1: bool = True,
                     adam_cfg: Optional[adam.AdamConfig] = None,
                     compress: Optional[GradCompressCfg] = None,
                     dtype: torch.dtype = torch.bfloat16) -> StepBundle:
    """This rank's train step over ``mesh`` with the reference's defaults
    (remat full, expert parallelism, ZeRO-1, λ ``cfg.lam``).
    ``fn(state, batch)`` takes this rank's rows of the batch
    (``data.pipeline.ShardedFeed(mesh=)`` places them);
    ``init_state(params)`` builds the state ``fn`` takes."""
    kind = layout_name(cfg, mesh)
    tp = T.tp_specs(cfg, mesh)
    step = ec4t.make_train_step(
        _loss_fn(cfg, mesh, use_ep, remat, dtype),
        adam_cfg or adam.AdamConfig(), lam=cfg.lam, compress=compress,
        mesh=mesh, zero1=zero1, specs=tp)

    def init_state(params) -> dict:
        """The state of this rank's params (its blocks under the
        tensor-parallel layout: ``lm_init(mesh=)`` or
        ``runtime.sharding.shard_tree``)."""
        return ec4t.init_train_state(params, compress, mesh=mesh,
                                     zero1=zero1, specs=tp)

    def layout() -> tuple:
        a_params = specs_mod.abstract_params(cfg)
        p_specs = sharding.layout_specs(a_params, cfg, mesh)
        a_state = init_state(_blocks(a_params, p_specs, cfg, mesh))
        g_batch = specs_mod.input_specs(cfg, shape_name)
        rules = make_rules(cfg, mesh)
        m_specs = sharding.opt_specs(a_params, mesh, p_specs) if zero1 \
            else p_specs
        state_specs = {
            "params": p_specs,
            "opt": {"m": m_specs, "v": m_specs, "step": ()},
            "qstate": sharding.qstate_layout(a_state["qstate"], p_specs),
        }
        if "err" in a_state:
            state_specs["err"] = p_specs
        return ((state_specs, rules.batch_specs(g_batch)),
                (state_specs, None), (a_state, _rank_rows(g_batch, mesh)))
    return StepBundle("train", step, layout, donate=(0,),
                      init_state=init_state, kind=kind,
                      experts=_bank_cut(cfg, mesh))


def state_sharding(bundle: StepBundle, mesh) -> Callable:
    """``sharding_fn`` for ``CheckpointManager.restore`` of a train state
    onto ``mesh`` from a train bundle built for it: ``fn(path, leaf) ->
    runtime.sharding.NamedSpec`` of the leaf named ``path`` under the
    bundle's layout of its state over the whole tree (``in_specs[0]``,
    what ``CheckpointManager.save(specs=)`` gathers by): the params'
    layout (``runtime.sharding.layout_specs``), ZeRO-1's cut of m and v
    over the data axes on top of it (``opt_specs``), opt's step and the
    probabilities replicated, the ECL state's placeholders cut as their
    params' leading dims (``runtime.sharding.qstate_layout``)."""
    by_name = {name: spec for name, _, spec in sharding.named_specs(
        bundle.args[0], bundle.in_specs[0])}

    def sharding_fn(path: str, leaf) -> sharding.NamedSpec:
        return sharding.NamedSpec(mesh, by_name[path])
    return sharding_fn


# -------------------------------------------------------------- serving

def _frozen_params(cfg: ArchConfig, serve_dtype: str = "packed4") -> Any:
    """Abstract serving tree: ``"packed4"`` (codes at 4 bits a weight,
    decoded where used: the FantastIC4 path) or ``"bf16"`` (plain
    weights, the comparison point)."""
    a_params = specs_mod.abstract_params(cfg)
    if serve_dtype == "bf16":
        def to_bf16(node):
            if qat.is_quant_leaf(node):
                return node["w"].to(torch.bfloat16)
            if isinstance(node, dict):
                return {k: to_bf16(v) for k, v in node.items()}
            return node
        return to_bf16(a_params)
    if serve_dtype != "packed4":
        raise ValueError(f"serve_dtype {serve_dtype!r}: packed4 or bf16")
    return qat.freeze_tree(a_params, qat.build_qstate(a_params), cfg.lam)


def _cache_specs(rules: Rules, cache: Any, cfg: ArchConfig = None,
                 mesh=None) -> Any:
    """A cache's layout: its batch dim (1) over the data axes; under the
    tensor-parallel layout the reference's ``Rules.cache_specs`` (the KV
    heads and the SSM state's heads over 'model' where they divide), else
    every other dim whole.  whisper's cross K/V (a tuple of two (L, B, T,
    n_kv, D) tensors) is cut on its heads as the layout cuts cross k and
    v, where the reference's ``cache_specs`` names no cut for it (its
    leaves are ``0`` and ``1``, not ``//k`` or ``//v``)."""
    if sharding.tensor_parallel(cfg, mesh):
        if isinstance(cache, tuple):
            heads = sharding.model_tp(cfg, mesh).heads
            return tuple((None, rules.batch_spec(1, t.shape[1])[0], None,
                          "model" if heads else None, None) for t in cache)
        return rules.cache_specs(cache)

    def spec(t):
        return (None, rules.batch_spec(1, t.shape[1])[0]) + \
            (None,) * (t.ndim - 2)
    return _batched(cache, spec, 1, lambda t: (None,) * t.ndim)


def _next_token(logits: torch.Tensor, cfg: ArchConfig,
                mesh=None) -> torch.Tensor:
    return lm_model.next_token(logits, cfg, mesh)


def _rank_cache(cache: Any, cfg: ArchConfig, mesh, rules: Rules) -> Any:
    """This rank's rows of a cache, and its KV and SSM heads under the
    tensor-parallel layout."""
    cache = _rank_rows(cache, mesh, dim=1)
    if not sharding.tensor_parallel(cfg, mesh):
        return cache
    heads = map_(lambda _, s: tuple(a if a == "model" else None for a in s),
                 cache, _cache_specs(rules, cache, cfg, mesh))
    return _blocks(cache, heads, cfg, mesh)


def build_prefill_step(cfg: ArchConfig, mesh, *,
                       shape_name: str = "prefill_32k",
                       use_ep: bool = True,
                       serve_dtype: str = "packed4") -> StepBundle:
    """``fn(params, batch) -> (next token, cache[, cross K/V])`` of this
    rank's rows: the cache holds the cell's ``seq`` slots."""
    kind = layout_name(cfg, mesh)
    info = specs_mod.SHAPES[shape_name]
    b, s = info["batch"], info["seq"]
    ctx = _ctx(cfg, quant=False)

    if cfg.family == "audio":
        @torch.no_grad()
        def fn(params, batch):
            enc = W.whisper_encode(params, 0, batch["embeds"], ctx, cfg,
                                   mesh=mesh)
            cross = W.precompute_cross(params, 0, enc, ctx, cfg, mesh=mesh)
            cache = W.init_dec_cache(cfg, batch["tokens"].shape[0],
                                     W.MAX_TGT, device=enc.device,
                                     mesh=mesh)
            logits, cache = W.whisper_decode(params, 0, batch["tokens"],
                                             cross, ctx, cfg, cache=cache,
                                             mesh=mesh)
            return _next_token(logits, cfg, mesh), cache, cross

        def out_specs(rules):
            g_cache = W.init_dec_cache(cfg, b, W.MAX_TGT,
                                       device=specs_mod.META)
            hd = cfg.resolved_head_dim
            g_cross = (torch.empty(
                (cfg.n_layers, b, cfg.enc_len, cfg.n_kv, hd),
                dtype=torch.bfloat16, device=specs_mod.META),) * 2
            return (rules.batch_spec(2, b),
                    _cache_specs(rules, g_cache, cfg, mesh),
                    _cache_specs(rules, g_cross, cfg, mesh))
    else:
        @torch.no_grad()
        def fn(params, batch):
            x = batch.get("tokens", batch.get("embeds"))
            cache = T.init_cache(cfg, x.shape[0], s, device=x.device,
                                 mesh=mesh)
            logits, cache, _ = T.lm_apply(
                params, 0, batch.get("tokens"), ctx, cfg,
                embeds=batch.get("embeds"), cache=cache, mesh=mesh,
                use_ep=use_ep)
            return _next_token(logits, cfg, mesh), cache

        def out_specs(rules):
            g_cache = T.init_cache(cfg, b, s, device=specs_mod.META)
            return (rules.batch_spec(2, b),
                    _cache_specs(rules, g_cache, cfg, mesh))

    def layout() -> tuple:
        rules = make_rules(cfg, mesh)
        a_params = _frozen_params(cfg, serve_dtype)
        g_batch = specs_mod.input_specs(cfg, shape_name)
        p_specs = sharding.layout_specs(a_params, cfg, mesh)
        return ((p_specs, rules.batch_specs(g_batch)),
                out_specs(rules), (_blocks(a_params, p_specs, cfg, mesh),
                                   _rank_rows(g_batch, mesh)))
    return StepBundle("prefill", fn, layout, kind=kind,
                      experts=_bank_cut(cfg, mesh))


def build_decode_step(cfg: ArchConfig, mesh, *,
                      shape_name: str = "decode_32k",
                      use_ep: bool = True,
                      serve_dtype: str = "packed4") -> StepBundle:
    """``fn(params, batch) -> (next token, cache)``: one new token a row of
    this rank's rows against its cache (``batch["cache"]``, consumed)."""
    kind = layout_name(cfg, mesh)
    ctx = _ctx(cfg, quant=False)

    if cfg.family == "audio":
        @torch.no_grad()
        def fn(params, batch):
            logits, cache = W.whisper_decode(
                params, 0, batch["tokens"], batch["cross_kv"], ctx, cfg,
                positions=batch["positions"], cache=batch["cache"],
                mesh=mesh)
            return _next_token(logits, cfg, mesh), cache
    else:
        @torch.no_grad()
        def fn(params, batch):
            logits, cache, _ = T.lm_apply(
                params, 0, batch.get("tokens"), ctx, cfg,
                embeds=batch.get("embeds"), positions=batch["positions"],
                cache=batch["cache"], mesh=mesh, use_ep=use_ep)
            return _next_token(logits, cfg, mesh), cache

    def layout() -> tuple:
        rules = make_rules(cfg, mesh)
        a_params = _frozen_params(cfg, serve_dtype)
        g_batch = specs_mod.input_specs(cfg, shape_name)
        a_batch = {k: _rank_rows(v, mesh) for k, v in g_batch.items()
                   if k not in ("cache", "cross_kv")}
        for k in ("cache", "cross_kv"):
            if k in g_batch:
                a_batch[k] = _rank_cache(g_batch[k], cfg, mesh, rules)
        batch_specs = dict(rules.batch_specs(
            {k: v for k, v in g_batch.items()
             if k not in ("cache", "cross_kv")}))
        for k in ("cache", "cross_kv"):
            if k in g_batch:
                batch_specs[k] = _cache_specs(rules, g_batch[k], cfg, mesh)
        info = specs_mod.SHAPES[shape_name]
        out_specs = (rules.batch_spec(2, info["batch"]), batch_specs["cache"])
        p_specs = sharding.layout_specs(a_params, cfg, mesh)
        return ((p_specs, batch_specs), out_specs,
                (_blocks(a_params, p_specs, cfg, mesh), a_batch))
    return StepBundle("decode", fn, layout, donate=(1,), kind=kind,
                      experts=_bank_cut(cfg, mesh))


BUILDERS = {"train": build_train_step, "prefill": build_prefill_step,
            "decode": build_decode_step}


def build_step(cfg: ArchConfig, mesh, shape_name: str, **kw) -> StepBundle:
    kind = specs_mod.SHAPES[shape_name]["kind"]
    return BUILDERS[kind](cfg, mesh, shape_name=shape_name, **kw)
