"""Whisper-base backbone (the JAX package's ``models/whisper.py``,
arXiv:2212.04356): an encoder-decoder transformer.

The conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, T, d_model).  Everything after it is
real: the encoder (sinusoidal positions, bidirectional MHA, LayerNorm, GELU
MLPs with biases), the decoder (learned positions, causal self-attention
with a KV cache, cross-attention to the encoder) and the tied readout with
the padded vocab masked to -1e30.  Layers are stacked ((L, ...) leaves,
``enc_layers`` and ``dec_layers``) and run by a Python loop over views of
them, in place of the reference's ``jax.lax.scan``.

Cross-attention K and V come once from the encoder output
(:func:`precompute_cross`) and serve every decode step.  The EC4T train
forward (:func:`whisper_forward_loss`) fake-quantizes the projections of
both stacks together first, in one grouped ECL call
(:func:`quantize_layers`: on the card ⌈segments / 32⌉ ecl_quant launches,
96 segments and 3 launches at the published widths); the encoder, the
cross K/V and the decoder read that ŵ, so the cross k and v are quantized
once.  Called alone on master weights under ``ctx.quant``, each function
quantizes leaf by leaf where it reads them, as the reference does (the
same codes and ŵ: the ECL op is elementwise).

Decoder positions index the learned ``dec_pos`` (``MAX_TGT`` rows).  The
reference's gather clamps an index past the end to the last row; the port
clamps on the device the same way (a torch index past the end is a
device-side assert on the card).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from ..core import qat
from ..nn import attention as attn
from ..nn.layers import (draw, embedding_init, gelu_mlp, gelu_mlp_init,
                         layer_norm, layer_norm_init, linear,
                         make_generator, sinusoidal_positions, subtree)
from ..nn.module import QuantCtx
from ..nn.transformer import _layer, _stack, _unstack

MAX_TGT = 448      # whisper's decoder context
LAYER_STACKS = ("enc_layers", "dec_layers")


def _enc_layer_init(g: torch.Generator, cfg: ArchConfig) -> dict:
    d, hd, dev = cfg.d_model, cfg.resolved_head_dim, g.device
    return {
        "ln1": layer_norm_init(d, dev),
        "attn": attn.gqa_init(g, d, cfg.n_heads, cfg.n_kv, hd, cfg.quantize),
        "ln2": layer_norm_init(d, dev),
        "mlp": gelu_mlp_init(g, d, cfg.d_ff, cfg.quantize),
    }


def _dec_layer_init(g: torch.Generator, cfg: ArchConfig) -> dict:
    d, hd, dev = cfg.d_model, cfg.resolved_head_dim, g.device
    return {
        "ln1": layer_norm_init(d, dev),
        "attn": attn.gqa_init(g, d, cfg.n_heads, cfg.n_kv, hd, cfg.quantize),
        "ln_cross": layer_norm_init(d, dev),
        "cross": attn.gqa_init(g, d, cfg.n_heads, cfg.n_kv, hd,
                               cfg.quantize),
        "ln2": layer_norm_init(d, dev),
        "mlp": gelu_mlp_init(g, d, cfg.d_ff, cfg.quantize),
    }


def whisper_init(cfg: ArchConfig, *, seed: int = 0,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> dict:
    """Random parameters for ``cfg``, every draw from one
    ``torch.Generator`` on the target device (seeded with ``seed`` when
    none is given).  The values need not equal the JAX package's: a
    comparison carries JAX's tree across (``convert.lm_tree_from_numpy``)."""
    g = generator if generator is not None else make_generator(
        resolve_device(device), seed)
    return {
        "enc_layers": _stack([_enc_layer_init(g, cfg)
                              for _ in range(cfg.n_enc_layers)]),
        "enc_ln": layer_norm_init(cfg.d_model, g.device),
        "dec_layers": _stack([_dec_layer_init(g, cfg)
                              for _ in range(cfg.n_layers)]),
        "dec_ln": layer_norm_init(cfg.d_model, g.device),
        "embed": embedding_init(g, cfg.padded_vocab, cfg.d_model),
        "dec_pos": draw(torch.randn, (MAX_TGT, cfg.d_model), g) * 0.02,
    }


def quantize_layers(params: dict, qstate: Any, ctx: QuantCtx) -> dict:
    """Under ``ctx.quant``, ``params`` with both layer stacks replaced by
    their fake-quantized ŵ in ``ctx.dtype``, all in one grouped
    quantization (each layer a segment with its own ω and probabilities,
    as the reference quantizes one layer at a time inside its scan);
    otherwise ``params`` as it is."""
    if not ctx.quant:
        return params
    w_hat = qat.fake_quant_tree({k: params[k] for k in LAYER_STACKS},
                                {k: subtree(qstate, k) for k in LAYER_STACKS},
                                ctx.lam, ctx.dtype)
    return {**params, **w_hat}


# ---------------------------------------------------------------- encoder

def whisper_encode(params: dict, qstate: Any, frames: torch.Tensor,
                   ctx: QuantCtx, cfg: ArchConfig) -> torch.Tensor:
    """frames (B, T, d), the stubbed conv frontend's output -> the encoder
    states (B, T, d)."""
    b, t, _ = frames.shape
    x = frames.to(ctx.dtype) + sinusoidal_positions(
        t, cfg.d_model, ctx.dtype, device=frames.device)[None]
    eq = subtree(qstate, "enc_layers")
    pos = torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)
    for l, lp in enumerate(_unstack(params["enc_layers"], cfg.n_enc_layers)):
        lq = _layer(eq, l)
        h = layer_norm(lp["ln1"], x)
        y, _ = attn.gqa_apply(lp["attn"], subtree(lq, "attn"), h, ctx,
                              n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                              head_dim=cfg.resolved_head_dim,
                              positions=pos, causal=False,
                              chunk=cfg.attn_chunk)
        x = x + y
        h = layer_norm(lp["ln2"], x)
        x = x + gelu_mlp(lp["mlp"], subtree(lq, "mlp"), h, ctx)
    return layer_norm(params["enc_ln"], x)


def precompute_cross(params: dict, qstate: Any, enc_out: torch.Tensor,
                     ctx: QuantCtx, cfg: ArchConfig) -> tuple:
    """Every decoder layer's cross K and V of the encoder states:
    (L, B, T, n_kv, head_dim) each."""
    b, t, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    dq = subtree(qstate, "dec_layers")
    ks, vs = [], []
    for l, lp in enumerate(_unstack(params["dec_layers"], cfg.n_layers)):
        lqc = subtree(_layer(dq, l), "cross")
        ks.append(linear(lp["cross"]["k"], subtree(lqc, "k"), enc_out, ctx)
                  .reshape(b, t, cfg.n_kv, hd))
        vs.append(linear(lp["cross"]["v"], subtree(lqc, "v"), enc_out, ctx)
                  .reshape(b, t, cfg.n_kv, hd))
    return torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------- decoder

def init_dec_cache(cfg: ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> dict:
    """The decoder's stacked self-attention KV cache, ``max_len`` slots."""
    per = {"attn": attn.init_kv_cache(batch, max_len, cfg.n_kv,
                                      cfg.resolved_head_dim, dtype,
                                      device=resolve_device(device))}
    return _stack([per] * cfg.n_layers)


def whisper_decode(params: dict, qstate: Any, tokens: torch.Tensor,
                   cross_kv: tuple, ctx: QuantCtx, cfg: ArchConfig, *,
                   positions: Optional[torch.Tensor] = None,
                   cache: Optional[dict] = None) -> tuple:
    """The decoder over ``tokens`` (B, S) at ``positions`` (B, S; default
    arange), attending to ``cross_kv``.  Returns (fp32 logits (B, S,
    padded_vocab), the new cache or None)."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    x = params["embed"]["table"].to(ctx.dtype)[tokens]
    # the reference's gather clamps a position past the table's end
    rows = positions.clamp(max=params["dec_pos"].shape[0] - 1)
    x = x + params["dec_pos"].to(ctx.dtype)[rows]
    dq = subtree(qstate, "dec_layers")
    cross_k, cross_v = cross_kv
    new_layers = []
    for l, lp in enumerate(_unstack(params["dec_layers"], cfg.n_layers)):
        lq = _layer(dq, l)
        lcache = _layer(cache, l) if cache is not None else None
        h = layer_norm(lp["ln1"], x)
        y, new_c = attn.gqa_apply(
            lp["attn"], subtree(lq, "attn"), h, ctx, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv, head_dim=cfg.resolved_head_dim,
            positions=positions, causal=True,
            cache=lcache["attn"] if lcache is not None else None,
            chunk=cfg.attn_chunk)
        x = x + y
        h = layer_norm(lp["ln_cross"], x)
        # cross-attention: queries from the decoder, the encoder's K and V
        y, _ = attn.gqa_apply(lp["cross"], subtree(lq, "cross"), h, ctx,
                              n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                              head_dim=cfg.resolved_head_dim,
                              positions=positions,
                              kv_override=(cross_k[l], cross_v[l]),
                              chunk=cfg.attn_chunk)
        x = x + y
        h = layer_norm(lp["ln2"], x)
        x = x + gelu_mlp(lp["mlp"], subtree(lq, "mlp"), h, ctx)
        new_layers.append({"attn": new_c})
    x = layer_norm(params["dec_ln"], x)
    logits = x.to(torch.float32) @ params["embed"]["table"].to(
        torch.float32).T
    if cfg.padded_vocab != cfg.vocab:
        logits = logits.masked_fill(
            torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab,
            -1e30)
    return logits, (_stack(new_layers) if cache is not None else None)


def whisper_forward_loss(params: dict, qstate: Any, batch: dict,
                         ctx: QuantCtx, cfg: ArchConfig, *, mesh=None,
                         **_) -> tuple:
    """The train forward: encode the batch's stubbed ``embeds``, then
    teacher-force the decoder on its ``tokens`` against ``labels``.  Both
    stacks are fake-quantized in one grouped pass first.  Returns (loss,
    metrics); over a ``mesh`` the batch is this rank's rows and the loss
    the whole batch's (``lm_loss(mesh=)``).  Extra keywords (``remat``,
    ``use_ep``) are ignored, as the reference's ``**_`` ignores them."""
    from .lm import lm_loss
    params = quantize_layers(params, qstate, ctx)
    enc = whisper_encode(params, qstate, batch["embeds"], ctx, cfg)
    cross = precompute_cross(params, qstate, enc, ctx, cfg)
    logits, _ = whisper_decode(params, qstate, batch["tokens"], cross, ctx,
                               cfg)
    loss = lm_loss(logits, batch["labels"], cfg.vocab, batch.get("mask"),
                   mesh=mesh)
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"ce": loss, "aux": zero, "loss": loss}
