"""Decoder-only transformer (the JAX package's ``nn/transformer.py``),
dense family.

Layers are **stacked**: every leaf of ``params["stacks"]["dense"]`` has a
leading (L, ...) axis, as in the reference, and :func:`lm_apply` runs
them with a Python loop over the layers in place of ``jax.lax.scan``
(each layer reads views of the stacked leaves).  Per-layer quantization
state and KV caches are stacked the same way.  Under EC4T training
(``ctx.quant``) the forward fake-quantizes every stacked quantized leaf
once, before the layer loop, in one grouped quantization
(:func:`quantize_stack`); each layer then reads its view of the stacked
ŵ.  The reference's sharding and rematerialisation arguments have no
counterpart here.

The other families (moe, ssm, hybrid, mla, vlm, audio) raise
``NotImplementedError``: they wait for ROADMAP queue 1 item 8.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from ..core import qat
from ..tree import leaves, map_, unflatten
from . import attention as attn
from .layers import (embedding_init, gelu_mlp, gelu_mlp_init, layer_norm,
                     layer_norm_init, linear_init, rms_norm, rms_norm_init,
                     rope_cos_sin, subtree, swiglu, swiglu_init)
from .module import QuantCtx

HUGE_WINDOW = 1 << 30     # "global attention" encoded as a very wide window


def check_dense(cfg: ArchConfig) -> None:
    """Raise for every arch the port's stack does not build yet."""
    if (cfg.family != "dense" or cfg.mla is not None or cfg.encdec
            or cfg.mrope_sections is not None):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family} family) is not ported yet: the port's "
            "transformer builds dense-family archs only (moe, ssm, hybrid, "
            "mla, vlm and audio wait for ROADMAP queue 1 item 8)")


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
    if kind != "dense":
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet "
                                  "(ROADMAP queue 1 item 8)")
    d, dev = cfg.d_model, generator.device
    return {
        "ln1": _norm_init(cfg, d, dev),
        "attn": attn.gqa_init(generator, d, cfg.n_heads, cfg.n_kv,
                              cfg.resolved_head_dim, cfg.quantize,
                              qkv_bias=cfg.qkv_bias),
        "ln2": _norm_init(cfg, d, dev),
        "mlp": _mlp_init(generator, cfg, cfg.dense_ff or cfg.d_ff),
    }


def _stack(trees: list) -> Any:
    return map_(lambda *xs: torch.stack(xs), *trees)


def _layer_kinds(cfg: ArchConfig) -> list:
    check_dense(cfg)
    return ["dense"] * cfg.n_layers


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
    p = {
        "embed": embedding_init(generator, cfg.padded_vocab, cfg.d_model),
        "final_norm": _norm_init(cfg, cfg.d_model, generator.device),
        "stacks": {"dense": _stack([_layer_init(generator, cfg, kind)
                                    for kind in kinds])},
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = linear_init(generator, cfg.d_model, cfg.padded_vocab,
                                   quantize=False)
    return p


# ------------------------------------------------------------------ cache

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Stacked per-layer decode state, ``max_len`` slots a layer (callers
    that prefill keep the full length, so multi-token writes never
    wrap)."""
    n = len(_layer_kinds(cfg))
    per = {"attn": attn.init_kv_cache(batch, max_len, cfg.n_kv,
                                      cfg.resolved_head_dim, dtype,
                                      device=resolve_device(device))}
    return {"dense": _stack([per] * n)}


# ---------------------------------------------------------------- forward

def _windows_for(cfg: ArchConfig, idx: list) -> Optional[list]:
    """Per-layer window sizes (mixed global/SWA layers), or None for a
    uniform setting."""
    if not cfg.global_attn_layers:
        return None
    return [HUGE_WINDOW if i in cfg.global_attn_layers else cfg.window
            for i in idx]


def _block(cfg: ArchConfig, lp: dict, lq: Any, x: torch.Tensor,
           ctx: QuantCtx, *, cos_sin, positions, lcache, window) -> tuple:
    """One dense transformer block; returns (x, new_lcache)."""
    h = _norm(cfg, lp["ln1"], x)
    acache = lcache["attn"] if lcache is not None else None
    ay, new_ac = attn.gqa_apply(lp["attn"], subtree(lq, "attn"), h, ctx,
                                n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                                head_dim=cfg.resolved_head_dim,
                                cos_sin=cos_sin, positions=positions,
                                causal=True, window=window, cache=acache,
                                chunk=cfg.attn_chunk)
    x = x + ay
    h2 = _norm(cfg, lp["ln2"], x)
    x = x + _mlp(cfg, lp["mlp"], subtree(lq, "mlp"), h2, ctx)
    return x, ({"attn": new_ac} if new_ac is not None else {})


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
    kinds = _layer_kinds(cfg)
    x = params["embed"]["table"].to(ctx.dtype)[tokens]
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)

    rotary_dim = int(cfg.resolved_head_dim * cfg.rotary_frac)
    cos_sin = rope_cos_sin(positions, rotary_dim, cfg.rope_theta,
                           dtype=torch.float32)
    windows = _windows_for(cfg, list(range(len(kinds))))
    stack_p = params["stacks"]["dense"]
    stack_q = subtree(subtree(qstate, "stacks"), "dense")
    stack_c = cache.get("dense") if cache is not None else None
    layer_p = _unstack(quantize_stack(stack_p, stack_q, ctx), len(kinds)) \
        if ctx.quant else None
    new_layers = []
    for l in range(len(kinds)):
        window = cfg.window if windows is None else windows[l]
        lp = layer_p[l] if layer_p is not None else _layer(stack_p, l)
        x, nc = _block(cfg, lp, _layer(stack_q, l), x, ctx,
                       cos_sin=cos_sin, positions=positions,
                       lcache=_layer(stack_c, l) if stack_c is not None
                       else None, window=window)
        new_layers.append(nc)

    logits = readout(cfg, params, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = {"dense": _stack(new_layers)} if stack_c is not None \
        else None
    return logits, new_cache, aux
