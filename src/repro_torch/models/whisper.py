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

Over a mesh whose 'model' axis holds more than one rank, whisper takes
the reference's tensor-parallel layout (``runtime.sharding.model_tp``,
``Rules.param_specs`` leaf for leaf): a rank holds its heads of q, k and
v (self and cross) and the rows of o of the same heads, its columns of
fc1 and its rows of fc2, and its rows of the tied embedding (so its
logits are its block of the vocabulary); the norms, fc2's bias and
``dec_pos`` are replicated.  Each function takes ``mesh=`` and runs the
rank's part: attention through ``AttnTP`` (no sequence-parallel form:
the reference's whisper has none), the MLP through ``gelu_mlp(mesh=)``,
the lookup through ``embed_rows``; its cross K/V and its KV cache hold
its heads.  Where the heads do not divide the axis (8 over 16) attention
stays whole on each rank and the FFN and the vocabulary are still cut.

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
from ..nn.layers import (draw, embed_rows, embedding_init, gelu_mlp,
                         gelu_mlp_init, layer_norm, layer_norm_init, linear,
                         make_generator, sinusoidal_positions, subtree)
from ..nn.module import QuantCtx
from ..nn.transformer import _abstract, _layer, _stack, _unstack, tp_specs
from ..runtime import sharding
from ..tree import map_

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
                 device=None, mesh=None) -> dict:
    """Random parameters for ``cfg``, every draw from one
    ``torch.Generator`` on the target device (seeded with ``seed`` when
    none is given).  The values need not equal the JAX package's: a
    comparison carries JAX's tree across (``convert.lm_tree_from_numpy``).
    Over a ``mesh`` with the tensor-parallel layout
    (``runtime.sharding.tensor_parallel``) this rank's blocks of that
    tree, bitwise: each layer and the embedding are drawn whole, in the
    same order, cut, and the whole one freed before the next draw."""
    g = generator if generator is not None else make_generator(
        resolve_device(device), seed)
    specs = tp_specs(cfg, mesh)
    if specs is None:
        keep = lambda tree, _: tree
        per_layer = {k: None for k in LAYER_STACKS}
    else:
        keep = lambda tree, spec: sharding.shard_tree(tree, spec, mesh)
        per_layer = {k: map_(lambda _, sp: sp[1:], _abstract(cfg)[k],
                             specs[k]) for k in LAYER_STACKS}
    enc = [keep(_enc_layer_init(g, cfg), per_layer["enc_layers"])
           for _ in range(cfg.n_enc_layers)]
    p = {"enc_layers": _stack(enc),
         "enc_ln": layer_norm_init(cfg.d_model, g.device)}
    del enc
    dec = [keep(_dec_layer_init(g, cfg), per_layer["dec_layers"])
           for _ in range(cfg.n_layers)]
    p.update(dec_layers=_stack(dec),
             dec_ln=layer_norm_init(cfg.d_model, g.device))
    del dec
    p["embed"] = keep(embedding_init(g, cfg.padded_vocab, cfg.d_model),
                      specs and specs["embed"])
    p["dec_pos"] = draw(torch.randn, (MAX_TGT, cfg.d_model), g) * 0.02
    return p


def _tp(cfg: ArchConfig, mesh):
    """Under the layout over ``mesh``: its cuts (``ModelTP``, None when
    whole), the rank's attention cut (``nn.attention.AttnTP``, None when
    attention is whole) and the mesh its MLP splits over (None when
    whole)."""
    tp = sharding.model_tp(cfg, mesh)
    if tp is None:
        return None, None, None
    atp = attn.AttnTP(mesh, heads=tp.heads, o_rows=tp.o_rows) \
        if tp.heads or tp.o_rows else None
    return tp, atp, mesh if tp.mlp else None


def _local_kv(cfg: ArchConfig, tp) -> int:
    """The KV heads a rank holds: ``n_kv / tp`` where the heads are cut."""
    return cfg.n_kv // tp.tp if tp is not None and tp.heads else cfg.n_kv


def quantize_layers(params: dict, qstate: Any, ctx: QuantCtx,
                    cfg: Optional[ArchConfig] = None, mesh=None) -> dict:
    """Under ``ctx.quant``, ``params`` with both layer stacks replaced by
    their fake-quantized ŵ in ``ctx.dtype``, all in one grouped
    quantization (each layer a segment with its own ω and probabilities,
    as the reference quantizes one layer at a time inside its scan);
    otherwise ``params`` as it is.  Over a tensor-parallel ``mesh`` a
    rank quantizes its blocks of both stacks in one pass, each segment's
    mean(w²) summed over the ranks that hold its other blocks
    (``qat.Shards``)."""
    if not ctx.quant:
        return params
    specs = tp_specs(cfg, mesh) if cfg is not None else None
    shards = None if specs is None else qat.Shards(
        mesh, {k: specs[k] for k in LAYER_STACKS})
    w_hat = qat.fake_quant_tree({k: params[k] for k in LAYER_STACKS},
                                {k: subtree(qstate, k) for k in LAYER_STACKS},
                                ctx.lam, ctx.dtype, shards)
    return {**params, **w_hat}


# ---------------------------------------------------------------- encoder

def whisper_encode(params: dict, qstate: Any, frames: torch.Tensor,
                   ctx: QuantCtx, cfg: ArchConfig, *,
                   mesh=None) -> torch.Tensor:
    """frames (B, T, d), the stubbed conv frontend's output -> the encoder
    states (B, T, d), whole on every rank of a ``mesh``."""
    b, t, _ = frames.shape
    _, atp, mlp_mesh = _tp(cfg, mesh)
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
                              chunk=cfg.attn_chunk, tp=atp)
        x = x + y
        h = layer_norm(lp["ln2"], x)
        x = x + gelu_mlp(lp["mlp"], subtree(lq, "mlp"), h, ctx, mlp_mesh)
    return layer_norm(params["enc_ln"], x)


def precompute_cross(params: dict, qstate: Any, enc_out: torch.Tensor,
                     ctx: QuantCtx, cfg: ArchConfig, *, mesh=None) -> tuple:
    """Every decoder layer's cross K and V of the encoder states:
    (L, B, T, n_kv, head_dim) each; over a ``mesh`` whose layout cuts the
    heads, a rank's ``n_kv / tp`` heads."""
    b, t, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    n_kv = _local_kv(cfg, sharding.model_tp(cfg, mesh))
    dq = subtree(qstate, "dec_layers")
    ks, vs = [], []
    for l, lp in enumerate(_unstack(params["dec_layers"], cfg.n_layers)):
        lqc = subtree(_layer(dq, l), "cross")
        ks.append(linear(lp["cross"]["k"], subtree(lqc, "k"), enc_out, ctx)
                  .reshape(b, t, n_kv, hd))
        vs.append(linear(lp["cross"]["v"], subtree(lqc, "v"), enc_out, ctx)
                  .reshape(b, t, n_kv, hd))
    return torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------- decoder

def init_dec_cache(cfg: ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None, mesh=None) -> dict:
    """The decoder's stacked self-attention KV cache, ``max_len`` slots;
    over a ``mesh`` whose layout cuts the heads, a rank's ``n_kv / tp``
    KV heads (``Rules.cache_specs``' block)."""
    n_kv = _local_kv(cfg, sharding.model_tp(cfg, mesh))
    per = {"attn": attn.init_kv_cache(batch, max_len, n_kv,
                                      cfg.resolved_head_dim, dtype,
                                      device=resolve_device(device))}
    return _stack([per] * cfg.n_layers)


def whisper_decode(params: dict, qstate: Any, tokens: torch.Tensor,
                   cross_kv: tuple, ctx: QuantCtx, cfg: ArchConfig, *,
                   positions: Optional[torch.Tensor] = None,
                   cache: Optional[dict] = None, mesh=None) -> tuple:
    """The decoder over ``tokens`` (B, S) at ``positions`` (B, S; default
    arange), attending to ``cross_kv``.  Returns (fp32 logits (B, S,
    padded_vocab), the new cache or None); over a ``mesh`` whose layout
    cuts the vocabulary, this rank's block of the logits (its rows of the
    tied table), the padded rows found by their global index."""
    b, s = tokens.shape
    tp, atp, mlp_mesh = _tp(cfg, mesh)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    table = params["embed"]["table"]
    if tp is not None and tp.vocab:
        x = embed_rows(table, tokens, ctx.dtype, mesh)
    else:
        x = table.to(ctx.dtype)[tokens]
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
            chunk=cfg.attn_chunk, tp=atp)
        x = x + y
        h = layer_norm(lp["ln_cross"], x)
        # cross-attention: queries from the decoder, the encoder's K and V
        y, _ = attn.gqa_apply(lp["cross"], subtree(lq, "cross"), h, ctx,
                              n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                              head_dim=cfg.resolved_head_dim,
                              positions=positions,
                              kv_override=(cross_k[l], cross_v[l]),
                              chunk=cfg.attn_chunk, tp=atp)
        x = x + y
        h = layer_norm(lp["ln2"], x)
        x = x + gelu_mlp(lp["mlp"], subtree(lq, "mlp"), h, ctx, mlp_mesh)
        new_layers.append({"attn": new_c})
    x = layer_norm(params["dec_ln"], x)
    logits = x.to(torch.float32) @ table.to(torch.float32).T
    if cfg.padded_vocab != cfg.vocab:
        n = logits.shape[-1]
        first = 0 if n == cfg.padded_vocab else \
            mesh.axis_index("model") * n
        logits = logits.masked_fill(
            torch.arange(first, first + n, device=logits.device) >= cfg.vocab,
            -1e30)
    return logits, (_stack(new_layers) if cache is not None else None)


def whisper_forward_loss(params: dict, qstate: Any, batch: dict,
                         ctx: QuantCtx, cfg: ArchConfig, *, mesh=None,
                         **_) -> tuple:
    """The train forward: encode the batch's stubbed ``embeds``, then
    teacher-force the decoder on its ``tokens`` against ``labels``.  Both
    stacks are fake-quantized in one grouped pass first.  Returns (loss,
    metrics); over a ``mesh`` the batch is this rank's rows and the loss
    the whole batch's (``lm_loss(mesh=)``), through the vocabulary-parallel
    cross-entropy where the rank's logits are its block of the
    vocabulary.  Extra keywords (``remat``, ``use_ep``) are ignored, as the
    reference's ``**_`` ignores them."""
    from .lm import lm_loss
    params = quantize_layers(params, qstate, ctx, cfg, mesh)
    enc = whisper_encode(params, qstate, batch["embeds"], ctx, cfg,
                         mesh=mesh)
    cross = precompute_cross(params, qstate, enc, ctx, cfg, mesh=mesh)
    logits, _ = whisper_decode(params, qstate, batch["tokens"], cross, ctx,
                               cfg, mesh=mesh)
    loss = lm_loss(logits, batch["labels"], cfg.vocab, batch.get("mask"),
                   mesh=mesh,
                   vocab_parallel=logits.shape[-1] != cfg.padded_vocab)
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"ce": loss, "aux": zero, "loss": loss}
