"""Decoder-only transformer (the JAX package's ``nn/transformer.py``),
dense and moe families.

Layers are **stacked**: every leaf of ``params["stacks"][kind]`` has a
leading (L, ...) axis, one stack per layer kind (``"dense"``, ``"moe"``)
as in the reference, and :func:`lm_apply` runs the stacks in the
reference's order with a Python loop over each stack's layers in place of
``jax.lax.scan`` (each layer reads views of the stacked leaves).  An
expert bank is stacked (L, E, ...): each (layer, expert) has its own ω
and probabilities.  Per-layer quantization state and KV caches are
stacked the same way.  A config with ``experts_held`` builds and runs one
shard's share of each MoE layer (``nn/moe.py``).  Under EC4T training
(``ctx.quant``) the forward fake-quantizes every stacked quantized leaf
once, before the layer loop, in one grouped quantization
(:func:`quantize_stack`); each layer then reads its view of the stacked
ŵ.  The reference's sharding and
rematerialisation arguments have no counterpart here.

A config with ``mla`` (deepseek-v3) builds multi-head latent attention
in every layer and a latent cache (``nn/attention.py``).  The other
families (ssm, hybrid, vlm, audio) raise ``NotImplementedError``: they
wait for ROADMAP queue 1 item 8.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from ..core import qat
from ..tree import leaves, map_, unflatten
from . import attention as attn
from . import moe as moe_lib
from .layers import (embedding_init, gelu_mlp, gelu_mlp_init, layer_norm,
                     layer_norm_init, linear_init, rms_norm, rms_norm_init,
                     rope_cos_sin, subtree, swiglu, swiglu_init)
from .module import QuantCtx

HUGE_WINDOW = 1 << 30     # "global attention" encoded as a very wide window


KINDS = ("dense", "moe")       # the stacks, in the reference's order


def check_supported(cfg: ArchConfig) -> None:
    """Raise for every arch the port's stack does not build yet."""
    if (cfg.family not in KINDS or cfg.encdec
            or cfg.mrope_sections is not None):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family} family) is not ported yet: the port's "
            "transformer builds the dense and moe families only, with GQA "
            "or MLA attention (ssm, hybrid, vlm and audio wait for ROADMAP "
            "queue 1 item 8)")


def _mla_cfg(cfg: ArchConfig) -> attn.MLACfg:
    m = cfg.mla
    return attn.MLACfg(d_model=cfg.d_model, n_heads=cfg.n_heads,
                       q_lora_rank=m.q_lora_rank, kv_lora_rank=m.kv_lora_rank,
                       qk_nope_dim=m.qk_nope_dim, qk_rope_dim=m.qk_rope_dim,
                       v_head_dim=m.v_head_dim)


def _norm_init(cfg: ArchConfig, d: int, device) -> dict:
    return layer_norm_init(d, device) if cfg.norm == "layer" \
        else rms_norm_init(d, device)


def _norm(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(p, x) if cfg.norm == "layer" else rms_norm(p, x)


def _mlp_init(generator: torch.Generator, cfg: ArchConfig, d_ff: int) -> dict:
    if cfg.act == "gelu":
        return gelu_mlp_init(generator, cfg.d_model, d_ff, cfg.quantize)
    return swiglu_init(generator, cfg.d_model, d_ff, cfg.quantize)


def _mlp(cfg: ArchConfig, p: dict, q: Any, x: torch.Tensor,
         ctx: QuantCtx) -> torch.Tensor:
    if cfg.act == "gelu":
        return gelu_mlp(p, q, x, ctx)
    return swiglu(p, q, x, ctx)


# ------------------------------------------------------------- layer init

def _layer_init(generator: torch.Generator, cfg: ArchConfig,
                kind: str = "dense") -> dict:
    """kind: dense | moe (from the family, per depth)."""
    if kind not in KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet "
                                  "(ROADMAP queue 1 item 8)")
    d, dev = cfg.d_model, generator.device
    if cfg.mla is not None:
        attn_p = attn.mla_init(generator, _mla_cfg(cfg), cfg.quantize)
    else:
        attn_p = attn.gqa_init(generator, d, cfg.n_heads, cfg.n_kv,
                               cfg.resolved_head_dim, cfg.quantize,
                               qkv_bias=cfg.qkv_bias)
    p = {"ln1": _norm_init(cfg, d, dev), "attn": attn_p,
         "ln2": _norm_init(cfg, d, dev)}
    if kind == "moe":
        p["moe"] = moe_lib.moe_init(generator, d, cfg.d_ff, cfg.n_experts,
                                    cfg.quantize,
                                    n_shared=cfg.n_shared_experts,
                                    experts_held=cfg.experts_held)
    else:
        p["mlp"] = _mlp_init(generator, cfg, cfg.dense_ff or cfg.d_ff)
    return p


def _stack(trees: list) -> Any:
    """(L, ...) leaves; one layer stacks as a view, without a copy (a
    full-width expert bank is 6.4 GB)."""
    if len(trees) == 1:
        return map_(lambda x: x.unsqueeze(0), trees[0])
    return map_(lambda *xs: torch.stack(xs), *trees)


def _layer_kinds(cfg: ArchConfig) -> list:
    check_supported(cfg)
    if cfg.family == "moe":
        return (["dense"] * cfg.n_dense_layers
                + ["moe"] * (cfg.n_layers - cfg.n_dense_layers))
    return ["dense"] * cfg.n_layers


def _kind_layers(cfg: ArchConfig) -> dict:
    """kind -> the indices of its layers, for each kind present, in the
    reference's stack order."""
    kinds = _layer_kinds(cfg)
    out = {kind: [i for i, k in enumerate(kinds) if k == kind]
           for kind in KINDS}
    return {kind: idx for kind, idx in out.items() if idx}


def lm_init(cfg: ArchConfig, *, seed: int = 0,
            generator: Optional[torch.Generator] = None,
            device=None) -> dict:
    """Random parameters for ``cfg``, every draw from one
    ``torch.Generator`` on the target device (seeded with ``seed`` when
    none is given).  The values need not equal the JAX package's: a
    comparison carries JAX's tree across (``convert.lm_tree_from_numpy``)."""
    if generator is None:
        generator = torch.Generator(
            device=resolve_device(device)).manual_seed(seed)
    kinds = _layer_kinds(cfg)
    layers = [_layer_init(generator, cfg, kind) for kind in kinds]
    p = {
        "embed": embedding_init(generator, cfg.padded_vocab, cfg.d_model),
        "final_norm": _norm_init(cfg, cfg.d_model, generator.device),
        "stacks": {kind: _stack([layers[i] for i in idx])
                   for kind, idx in _kind_layers(cfg).items()},
    }
    del layers
    if not cfg.tie_embeddings:
        p["lm_head"] = linear_init(generator, cfg.d_model, cfg.padded_vocab,
                                   quantize=False)
    return p


# ------------------------------------------------------------------ cache

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Stacked per-layer decode state, ``max_len`` slots a layer (callers
    that prefill keep the full length, so multi-token writes never
    wrap).  An MLA arch caches the latent and the rope key
    (:func:`attention.init_mla_cache`)."""
    dev = resolve_device(device)

    def per():
        if cfg.mla is not None:
            return {"attn": attn.init_mla_cache(batch, max_len, _mla_cfg(cfg),
                                                dtype, device=dev)}
        return {"attn": attn.init_kv_cache(batch, max_len, cfg.n_kv,
                                           cfg.resolved_head_dim, dtype,
                                           device=dev)}
    return {kind: _stack([per()] * len(idx))
            for kind, idx in _kind_layers(cfg).items()}


# ---------------------------------------------------------------- forward

def _windows_for(cfg: ArchConfig, idx: list) -> Optional[list]:
    """Per-layer window sizes (mixed global/SWA layers), or None for a
    uniform setting."""
    if not cfg.global_attn_layers:
        return None
    return [HUGE_WINDOW if i in cfg.global_attn_layers else cfg.window
            for i in idx]


def _block(cfg: ArchConfig, kind: str, lp: dict, lq: Any, x: torch.Tensor,
           ctx: QuantCtx, *, cos_sin, positions, lcache, window) -> tuple:
    """One transformer block; returns (x, new_lcache, aux)."""
    h = _norm(cfg, lp["ln1"], x)
    acache = lcache["attn"] if lcache is not None else None
    if cfg.mla is not None:
        ay, new_ac = attn.mla_apply(lp["attn"], subtree(lq, "attn"), h, ctx,
                                    _mla_cfg(cfg), cos_sin=cos_sin,
                                    positions=positions, cache=acache,
                                    chunk=cfg.attn_chunk)
    else:
        ay, new_ac = attn.gqa_apply(lp["attn"], subtree(lq, "attn"), h, ctx,
                                    n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                                    head_dim=cfg.resolved_head_dim,
                                    cos_sin=cos_sin, positions=positions,
                                    causal=True, window=window, cache=acache,
                                    chunk=cfg.attn_chunk)
    x = x + ay
    h2 = _norm(cfg, lp["ln2"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "moe":
        y2, aux = moe_lib.moe_ffn(lp["moe"], subtree(lq, "moe"), h2, ctx,
                                  top_k=cfg.top_k, gate=cfg.moe_gate,
                                  capacity_factor=cfg.capacity_factor,
                                  routed_scaling=cfg.routed_scaling,
                                  experts_held=cfg.experts_held)
        x = x + y2
    else:
        x = x + _mlp(cfg, lp["mlp"], subtree(lq, "mlp"), h2, ctx)
    return x, ({"attn": new_ac} if new_ac is not None else {}), aux


def _layer(tree: Any, l: int) -> Any:
    """Layer ``l`` of an L-stacked tree (views); a non-tree state is kept."""
    if isinstance(tree, (dict, list, tuple)):
        return map_(lambda a: a[l], tree)
    return tree


def quantize_stack(stack_p: Any, stack_q: Any, ctx: QuantCtx) -> Any:
    """The stacked parameters a train forward reads: every quantized leaf
    (L, R, C) replaced by its fake-quantized ŵ in ``ctx.dtype``, all of
    them in one grouped quantization (on the card ⌈segments / 32⌉
    ecl_quant launches: SmolLM-360M's 32 × 7 leaves take 7).  Each layer
    is a segment with its own ω, probabilities and mean(w²), as the
    reference quantizes one layer at a time inside its scan."""
    return qat.fake_quant_tree(stack_p, stack_q, ctx.lam, ctx.dtype)


def _unstack(tree: Any, n: int) -> list:
    """The ``n`` per-layer trees of an L-stacked tree, each leaf a view
    from one ``unbind`` (whose backward stacks the layers' gradients in
    one operation instead of one full-size scatter a layer)."""
    per = [t.unbind(0) for t in leaves(tree)]
    return [unflatten(tree, [p[l] for p in per]) for l in range(n)]


def readout(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the head (tied to the embedding or not): fp32
    logits (..., padded_vocab) of ``x`` (..., d), the padded vocab rows
    masked to -1e30."""
    x = _norm(cfg, params["final_norm"], x).to(torch.float32)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].to(torch.float32).T
    else:
        logits = x @ params["lm_head"]["kernel"].to(torch.float32)
    if cfg.padded_vocab != cfg.vocab:
        logits = logits.masked_fill(
            torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab,
            -1e30)
    return logits


def lm_apply(params: dict, qstate: Any, tokens: torch.Tensor,
             ctx: QuantCtx, cfg: ArchConfig, *,
             positions: Optional[torch.Tensor] = None,
             cache: Optional[dict] = None) -> tuple:
    """Forward pass.  Returns (logits, new_cache, aux_loss).

    ``tokens`` (B, S) int.  ``positions`` (B, S) absolute positions
    (decode passes the cache offset); default arange.
    """
    x = params["embed"]["table"].to(ctx.dtype)[tokens]
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)

    rotary_dim = cfg.mla.qk_rope_dim if cfg.mla is not None \
        else int(cfg.resolved_head_dim * cfg.rotary_frac)
    cos_sin = rope_cos_sin(positions, rotary_dim, cfg.rope_theta,
                           dtype=torch.float32)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = {} if cache is not None else None
    for kind, idx in _kind_layers(cfg).items():
        windows = _windows_for(cfg, idx)
        stack_p = params["stacks"][kind]
        stack_q = subtree(subtree(qstate, "stacks"), kind)
        stack_c = cache.get(kind) if cache is not None else None
        layer_p = _unstack(quantize_stack(stack_p, stack_q, ctx), len(idx)) \
            if ctx.quant else None
        # the reference's scan carry: a stack's aux from an fp32 zero, in
        # layer order, then added to the total
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_layers = []
        for l in range(len(idx)):
            window = cfg.window if windows is None else windows[l]
            lp = layer_p[l] if layer_p is not None else _layer(stack_p, l)
            x, nc, a = _block(cfg, kind, lp, _layer(stack_q, l), x, ctx,
                              cos_sin=cos_sin, positions=positions,
                              lcache=_layer(stack_c, l)
                              if stack_c is not None else None,
                              window=window)
            aux = aux + a
            new_layers.append(nc)
        aux_total = aux_total + aux
        if stack_c is not None:
            new_cache[kind] = _stack(new_layers)

    logits = readout(cfg, params, x)
    return logits, new_cache, aux_total
