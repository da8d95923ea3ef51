"""Decoder-only transformer (the JAX package's ``nn/transformer.py``):
the dense, moe, ssm and hybrid families.

Layers are **stacked**: every leaf of ``params["stacks"][kind]`` has a
leading (L, ...) axis, one stack per layer kind (``"dense"``, ``"moe"``,
``"ssm"``, ``"hybrid"``) as in the reference, and :func:`lm_apply` runs
the stacks in the reference's order with a Python loop over each stack's
layers in place of ``jax.lax.scan`` (each layer reads views of the
stacked leaves).  An expert bank is stacked (L, E, ...): each (layer,
expert) has its own ω and probabilities.  Per-layer quantization state
and caches are stacked the same way.  A config with ``experts_held``
builds and runs one shard's share of each MoE layer (``nn/moe.py``).
Under EC4T training (``ctx.quant``) the forward fake-quantizes every
stacked quantized leaf once, before the layer loop, in one grouped
quantization (:func:`quantize_stack`); each layer then reads its view of
the stacked ŵ.  ``remat`` is the reference's rematerialisation of the
layer body (:func:`_remat`); its sharding arguments have no counterpart
here.

A config with ``mla`` (deepseek-v3) builds multi-head latent attention
in every layer and a latent cache (``nn/attention.py``).  An ``ssm``
layer (mamba2) is a Mamba2 SSD block alone (``nn/ssm.py``), with no
attention, no FFN and no rotary; a ``hybrid`` layer (hymba) runs GQA
attention and the SSD block side by side on the same normed input and
averages their RMS-normed outputs, then an MLP.  Their caches hold the
recurrent state (``"ssm"``: the (B, H, P, N) state and the conv tail) for
every layer, and a hybrid layer a KV cache beside it.  The vlm family
(qwen2-vl) is a dense stack whose rotary is M-RoPE (``mrope_sections``),
fed token ids or the stubbed vision frontend's patch embeddings
(``lm_apply(embeds=)``).  For an audio (enc-dec) config ``lm_init`` and
``lm_apply`` build and run a dense decoder-only stack, as the reference's
do; whisper's encoder-decoder is ``models/whisper.py``.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import resolve_device
from ..configs.base import ArchConfig
from ..core import bitplanes, qat
from ..runtime import sharding
from ..tree import leaves, map_, unflatten
from . import attention as attn
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import (embed_rows, embedding_init, gelu_mlp, gelu_mlp_init,
                     layer_norm, layer_norm_init, linear_init, make_generator,
                     mrope_cos_sin, rms_norm,
                     rms_norm_init, rope_cos_sin, subtree, swiglu,
                     swiglu_init)
from .module import QuantCtx

HUGE_WINDOW = 1 << 30     # "global attention" encoded as a very wide window


KINDS = ("dense", "moe", "ssm", "hybrid")   # the stacks, the reference's order
REMAT = ("none", "full", "dots")
# the products ``dots`` keeps: a projection's 2-D matmul (``linear``'s
# ``x @ w``), not a product with batch dims (attention's and the expert
# banks' einsums and bmm), as dots_with_no_batch_dims_saveable
_SAVED_DOTS = frozenset({torch.ops.aten.mm.default,
                         torch.ops.aten.addmm.default})


FAMILIES = KINDS + ("vlm", "audio")        # every registered arch's


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a family the port does not build (every registered arch
    is built)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not one the port builds "
            f"({', '.join(FAMILIES)})")


def _ssm_cfg(cfg: ArchConfig) -> ssm_lib.SSMCfg:
    return ssm_lib.SSMCfg(d_model=cfg.d_model, d_inner=cfg.d_inner,
                          n_heads=cfg.ssm_heads, d_state=cfg.ssm_state,
                          n_groups=cfg.ssm_groups, chunk=cfg.ssm_chunk)


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
         ctx: QuantCtx, mesh=None) -> torch.Tensor:
    """The FFN; with ``mesh`` its hidden width split over 'model' (column-
    then row-sharded, one all-reduce)."""
    if cfg.act == "gelu":
        return gelu_mlp(p, q, x, ctx, mesh)
    return swiglu(p, q, x, ctx, mesh)


# ------------------------------------------------------------- layer init

def _layer_init(generator: torch.Generator, cfg: ArchConfig,
                kind: str = "dense", banks=None) -> dict:
    """kind: dense | moe | ssm | hybrid (from the family, per depth);
    ``banks`` draws a MoE layer's expert banks (``moe_init``'s)."""
    if kind not in KINDS:
        raise ValueError(f"layer kind {kind!r}: one of {', '.join(KINDS)}")
    d, dev = cfg.d_model, generator.device
    p = {"ln1": _norm_init(cfg, d, dev)}
    if kind != "ssm":
        if cfg.mla is not None:
            p["attn"] = attn.mla_init(generator, _mla_cfg(cfg), cfg.quantize)
        else:
            p["attn"] = attn.gqa_init(generator, d, cfg.n_heads, cfg.n_kv,
                                      cfg.resolved_head_dim, cfg.quantize,
                                      qkv_bias=cfg.qkv_bias)
    if kind in ("ssm", "hybrid"):
        p["ssm"] = ssm_lib.ssm_init(generator, _ssm_cfg(cfg), cfg.quantize)
    if kind == "hybrid":
        # always RMS, whatever cfg.norm, as the reference's
        p["attn_norm"] = rms_norm_init(d, dev)
        p["ssm_norm"] = rms_norm_init(d, dev)
    if kind == "ssm":
        return p
    p["ln2"] = _norm_init(cfg, d, dev)
    if kind == "moe":
        p["moe"] = moe_lib.moe_init(generator, d, cfg.d_ff, cfg.n_experts,
                                    cfg.quantize,
                                    n_shared=cfg.n_shared_experts,
                                    experts_held=cfg.experts_held,
                                    banks=banks)
    elif kind == "hybrid":
        p["mlp"] = _mlp_init(generator, cfg, cfg.d_ff)
    else:
        p["mlp"] = _mlp_init(generator, cfg, cfg.dense_ff or cfg.d_ff)
    return p


BANKS = ("gate", "up", "down")


def bank_seed(seed: int, layer: int, expert: int, bank: int) -> int:
    """The seed of one expert's bank ``BANKS[bank]`` in layer ``layer`` of
    the MoE stack."""
    return seed + 1_000_003 * (1 + layer) + 1_009 * expert + bank


@torch.no_grad()
def _expert_banks(cfg: ArchConfig, seed: int, layer: int, device,
                  tp: Optional[sharding.ModelTP] = None) -> dict:
    """Layer ``layer``'s expert banks, each expert drawn from a generator
    of its own (:func:`bank_seed`), uniform in ±1/√d as ``moe_init`` draws
    them: the experts of ``cfg.experts_held`` (every one without), or
    under the tensor-parallel layout ``tp`` this rank's block (its E/tp
    experts, or each expert drawn whole in turn and its FFN columns
    kept).  A bank's ω is the whole bank's: its blocks' are gathered (the
    experts) or their max|w| reduced (the FFN width) over 'model'."""
    first, count = moe_lib.held_experts(cfg.experts_held, cfg.n_experts)
    cut = tp.experts if tp is not None else None
    if cut is not None:
        index = tp.mesh.axis_index("model")
        if cut == "ep":
            count = cfg.n_experts // tp.tp
            first = index * count
    scale = cfg.d_model ** -0.5
    out = {}
    for b, name in enumerate(BANKS):
        d_in, d_out = ((cfg.d_ff, cfg.d_model) if name == "down"
                       else (cfg.d_model, cfg.d_ff))
        ff_dim = 0 if name == "down" else 1     # in one expert's matrix
        shape = [count, d_in, d_out]
        if cut == "tp":
            shape[1 + ff_dim] //= tp.tp
        w = torch.empty(shape, dtype=torch.float32, device=device)
        if w.device.type != "meta":
            for j in range(count):
                g = torch.Generator(device=w.device).manual_seed(
                    bank_seed(seed, layer, first + j, b))
                if cut == "tp":
                    whole = torch.rand((d_in, d_out), generator=g,
                                       device=w.device)
                    blk = shape[1 + ff_dim]
                    w[j].copy_(whole.narrow(ff_dim, index * blk, blk))
                    del whole
                else:
                    torch.rand((d_in, d_out), generator=g, out=w[j])
            w.mul_(2 * scale).sub_(scale)
        if not cfg.quantize:
            out[name] = w
            continue
        if cut == "tp":
            amax = tp.mesh.all_reduce(w.abs().amax(dim=(-2, -1)), "model",
                                      op="max")
            omega = bitplanes.omega_from_amax(amax, w.dtype)
        else:
            omega = bitplanes.init_omega_from_weights(w)
            if cut == "ep":
                omega = tp.mesh.all_gather(omega, "model", dim=0)
        out[name] = {"w": w, "omega": omega}
    return out


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
    if cfg.family in ("ssm", "hybrid"):
        return [cfg.family] * cfg.n_layers
    return ["dense"] * cfg.n_layers         # dense, vlm and audio


def _kind_layers(cfg: ArchConfig) -> dict:
    """kind -> the indices of its layers, for each kind present, in the
    reference's stack order."""
    kinds = _layer_kinds(cfg)
    out = {kind: [i for i, k in enumerate(kinds) if k == kind]
           for kind in KINDS}
    return {kind: idx for kind, idx in out.items() if idx}


def lm_init(cfg: ArchConfig, *, seed: int = 0,
            generator: Optional[torch.Generator] = None,
            device=None, mesh=None) -> dict:
    """Random parameters for ``cfg``: every draw from one
    ``torch.Generator`` on the target device (seeded with ``seed`` when
    none is given) but the expert banks, each expert of which is drawn
    from a generator of its own seeded from ``seed`` and its layer, expert
    and bank, so that an expert's weights do not depend on which experts
    are drawn beside it (a share's banks, ``experts_held``, are the slice
    of the whole's).  The values need not equal the JAX package's: a
    comparison carries JAX's tree across (``convert.lm_tree_from_numpy``).
    Over a ``mesh`` with the tensor-parallel layout
    (``runtime.sharding.tensor_parallel``) this rank's blocks of that
    tree: each layer but its expert banks, the embedding and the head are
    drawn whole (ω from the whole weights), cut, and the whole one freed
    before the next draw; the banks are drawn as the rank's blocks
    (:func:`_expert_banks`, collective over 'model')."""
    _decoder_only_layout(cfg, mesh)
    if generator is None:
        generator = make_generator(resolve_device(device), seed)
    specs = tp_specs(cfg, mesh)
    tp = sharding.model_tp(cfg, mesh)
    keep = (lambda tree, spec: tree) if specs is None else \
        (lambda tree, spec: sharding.shard_tree(tree, spec, mesh))
    per_layer = {}
    if specs is not None:      # a layer's spec: its stack's, without L;
        # the banks are drawn as this rank's blocks
        per_layer = {kind: map_(lambda t, sp: sp[1:], tree, specs["stacks"]
                                [kind]) for kind, tree in
                     _abstract(cfg)["stacks"].items()}
        if "moe" in per_layer:
            per_layer["moe"]["moe"]["experts"] = map_(
                lambda t: (None,) * (t.ndim - 1),
                _abstract(cfg)["stacks"]["moe"]["moe"]["experts"])
    layers, n_moe = [], 0
    for kind in _layer_kinds(cfg):
        banks = None
        if kind == "moe":
            banks = functools.partial(_expert_banks, cfg, seed, n_moe,
                                      generator.device, tp)
            n_moe += 1
        layers.append(keep(_layer_init(generator, cfg, kind, banks),
                           per_layer.get(kind)))
    p = {
        "embed": keep(embedding_init(generator, cfg.padded_vocab,
                                     cfg.d_model),
                      specs and specs["embed"]),
        "final_norm": _norm_init(cfg, cfg.d_model, generator.device),
        "stacks": {kind: _stack([layers[i] for i in idx])
                   for kind, idx in _kind_layers(cfg).items()},
    }
    del layers
    if not cfg.tie_embeddings:
        p["lm_head"] = keep(linear_init(generator, cfg.d_model,
                                        cfg.padded_vocab, quantize=False),
                            specs and specs["lm_head"])
    return p


def _decoder_only_layout(cfg: ArchConfig, mesh) -> None:
    """Raise for the audio family over a tensor-parallel mesh: its layout
    is whisper's tree's (``models/whisper.py``), not this stack's."""
    if cfg.family == "audio" and sharding.tensor_parallel(cfg, mesh):
        raise ValueError(f"{cfg.name} over {dict(mesh.shape)}: whisper's "
                         "tensor-parallel layout is its encoder-decoder's "
                         "(models/whisper.py), not a decoder-only stack's")


@functools.lru_cache(maxsize=None)
def _abstract(cfg: ArchConfig) -> dict:
    """``cfg``'s whole parameter tree on meta: whisper's encoder-decoder
    for the audio family, else :func:`lm_init`'s."""
    if cfg.family == "audio":
        from ..models.whisper import whisper_init
        return whisper_init(cfg, device="meta")
    return lm_init(cfg, device="meta")


@functools.lru_cache(maxsize=None)
def _tp_specs(cfg: ArchConfig, axes: tuple, sizes: tuple) -> dict:
    from ..launch.mesh import MeshSpec
    return sharding.layout_specs(_abstract(cfg), cfg, MeshSpec(sizes, axes))


def tp_specs(cfg: ArchConfig, mesh) -> Optional[dict]:
    """The tensor-parallel layout of ``cfg``'s training tree over ``mesh``
    (``runtime.sharding.layout_specs`` of its whole abstract tree, built
    once: whisper's for the audio family), or None where the layout keeps
    weights whole."""
    if not sharding.tensor_parallel(cfg, mesh):
        return None
    return _tp_specs(cfg, tuple(mesh.axis_names),
                     tuple(mesh.shape[a] for a in mesh.axis_names))


# ------------------------------------------------------------------ cache

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, cap_window: bool = False,
               device=None, mesh=None) -> dict:
    """Stacked per-layer decode state.  An attention layer gets ``max_len``
    slots (callers that prefill keep the full length, so multi-token
    writes never wrap); with ``cap_window`` (decode-only use) an SWA arch
    with no global layers gets a window-sized ring, O(window) memory at
    any context length, while hymba's global layers force the full length.
    An MLA arch caches the latent and the rope key
    (:func:`attention.init_mla_cache`).  An ssm or hybrid layer also keeps
    its recurrent state (``"ssm"``: fp32 whatever ``dtype``, as the
    reference's), the same size at any context length.  Over a ``mesh``
    whose tensor-parallel layout shards the heads (``runtime.sharding.
    model_tp``) a rank caches its ``n_kv / tp`` KV heads; an MLA rank
    caches the whole latent (only its heads are cut); an SSM rank its
    ``H / tp`` heads of the state where they are cut (``ssm_heads``) and
    the whole conv tail, the blocks of ``Rules.cache_specs``."""
    dev = resolve_device(device)
    tp = sharding.model_tp(cfg, mesh)
    n_kv = cfg.n_kv // tp.tp if tp is not None and tp.heads else cfg.n_kv
    ssm_heads = cfg.ssm_heads // tp.tp if tp is not None and tp.ssm_heads \
        else None

    def attn_cache():
        if cfg.mla is not None:
            return attn.init_mla_cache(batch, max_len, _mla_cfg(cfg), dtype,
                                       device=dev)
        kv_len = max_len
        if cap_window and cfg.window and not cfg.global_attn_layers:
            kv_len = min(max_len, cfg.window)
        return attn.init_kv_cache(batch, kv_len, n_kv,
                                  cfg.resolved_head_dim, dtype, device=dev)

    def per(kind):
        out = {}
        if kind != "ssm":
            out["attn"] = attn_cache()
        if kind in ("ssm", "hybrid"):
            out["ssm"] = ssm_lib.init_ssm_state(batch, _ssm_cfg(cfg),
                                                device=dev,
                                                n_heads=ssm_heads)
        return out
    return {kind: _stack([per(kind)] * len(idx))
            for kind, idx in _kind_layers(cfg).items()}


# ---------------------------------------------------------------- forward

def _windows_for(cfg: ArchConfig, idx: list) -> Optional[list]:
    """Per-layer window sizes (mixed global/SWA layers), or None for a
    uniform setting."""
    if not cfg.global_attn_layers:
        return None
    return [HUGE_WINDOW if i in cfg.global_attn_layers else cfg.window
            for i in idx]


def _ssm_tp(tp: Optional[sharding.ModelTP]) -> Optional[ssm_lib.SSMTP]:
    """The SSD block's cuts of the layout ``tp`` (None: whole)."""
    if tp is None:
        return None
    return ssm_lib.SSMTP(tp.mesh, in_rows=tp.ssm_in, out_rows=tp.ssm_out,
                         heads=tp.ssm_heads)


def _ssm_branch(cfg: ArchConfig, lp: dict, lq: Any, h: torch.Tensor,
                ctx: QuantCtx, lcache, tp=None) -> tuple:
    """The SSD block on ``h``: one decode step from the cached state when
    one token comes with a cache, else sequence mode seeded by the cached
    state (a prefill from zeros, or its continuation); over 'model' this
    rank's part under the layout ``tp`` (``runtime.sharding.ModelTP``)."""
    st = lcache["ssm"] if lcache is not None else None
    stp = _ssm_tp(tp)
    if h.shape[1] == 1 and st is not None:
        return ssm_lib.ssm_step(lp["ssm"], subtree(lq, "ssm"), h, ctx,
                                _ssm_cfg(cfg), st, tp=stp)
    return ssm_lib.ssm_apply(lp["ssm"], subtree(lq, "ssm"), h, ctx,
                             _ssm_cfg(cfg), state=st, tp=stp)


def _attn_batch_reshard(cfg: ArchConfig, mesh, seq: int) -> bool:
    """True when attention should run sequence-parallel over the *model*
    axis (the reference's predicate, word for word).

    Archs whose head counts don't divide the model axis (smollm 15H/5kv,
    hymba 25H/5kv, qwen2-vl 12H/2kv, glm4 2kv...) keep their attention
    weights replicated; without this every model rank would run the
    *same* attention.  A rank instead takes ``seq / tp`` query rows, and
    the keys and values are gathered over 'model'.
    """
    if mesh is None or "model" not in mesh.axis_names:
        return False
    tp = mesh.shape["model"]
    if tp == 1 or cfg.mla is not None:
        return False
    heads_sharded = cfg.n_heads % tp == 0 and cfg.n_kv % tp == 0
    return (not heads_sharded) and seq % tp == 0


def _seq_block(t, mesh):
    """This rank's S / tp rows (dim 1) of ``t`` (a tensor or a tuple of
    them, as cos / sin)."""
    if isinstance(t, tuple):
        return tuple(_seq_block(a, mesh) for a in t)
    n = t.shape[1] // mesh.axis_size("model")
    return t.narrow(1, mesh.axis_index("model") * n, n)


def _block(cfg: ArchConfig, kind: str, lp: dict, lq: Any, x: torch.Tensor,
           ctx: QuantCtx, *, cos_sin, positions, lcache, window, mesh=None,
           use_ep: bool = True, attn_reshard: bool = False) -> tuple:
    """One transformer block; returns (x, new_lcache, aux).  Over a mesh
    with the tensor-parallel layout (``runtime.sharding.model_tp``) a rank
    runs its heads (MLA's from its gathered latents), its columns of the
    FFN or of the shared expert, its block of the expert banks through
    their exchange, and its part of an SSD block (its rows of the
    projections, its heads of the scan where they are cut); with
    ``attn_reshard`` its GQA attention is sequence-parallel
    (:func:`_attn_batch_reshard`) and a hybrid's SSD block runs on the
    whole sequence, as the reference's ``_block``."""
    h = _norm(cfg, lp["ln1"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = {}
    tp = sharding.model_tp(cfg, mesh)
    if kind == "ssm":
        y, new_st = _ssm_branch(cfg, lp, lq, h, ctx, lcache, tp)
        if lcache is not None:
            new_cache["ssm"] = new_st
        return x + y, new_cache, aux

    acache = lcache["attn"] if lcache is not None else None
    if cfg.mla is not None:
        atp = None if tp is None else attn.AttnTP(
            mesh, heads=tp.heads, o_rows=tp.o_rows, q_down=tp.q_down,
            kv_down=tp.kv_down)
        ay, new_ac = attn.mla_apply(lp["attn"], subtree(lq, "attn"), h, ctx,
                                    _mla_cfg(cfg), cos_sin=cos_sin,
                                    positions=positions, cache=acache,
                                    chunk=cfg.attn_chunk, tp=atp)
    else:
        h_a, cs_a, pos_a, atp = h, cos_sin, positions, None
        if tp is not None or attn_reshard:
            atp = attn.AttnTP(mesh, heads=tp is not None and tp.heads,
                              o_rows=tp is not None and tp.o_rows,
                              seq=attn_reshard)
        if attn_reshard:
            h_a, pos_a = _seq_block(h, mesh), _seq_block(positions, mesh)
            cs_a = _seq_block(cos_sin, mesh) if cos_sin is not None \
                else None
        ay, new_ac = attn.gqa_apply(lp["attn"], subtree(lq, "attn"), h_a, ctx,
                                    n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                                    head_dim=cfg.resolved_head_dim,
                                    cos_sin=cs_a, positions=pos_a,
                                    causal=True, window=window, cache=acache,
                                    chunk=cfg.attn_chunk, tp=atp)
    if new_ac is not None:
        new_cache["attn"] = new_ac
    if kind == "hybrid":
        # hymba: the mean of the two branches' normed outputs, both on h
        sy, new_st = _ssm_branch(cfg, lp, lq, h, ctx, lcache, tp)
        if lcache is not None:
            new_cache["ssm"] = new_st
        ay = 0.5 * (rms_norm(lp["attn_norm"], ay)
                    + rms_norm(lp["ssm_norm"], sy))
    x = x + ay
    h2 = _norm(cfg, lp["ln2"], x)
    if kind == "moe":
        y2, aux = moe_lib.moe_ffn(lp["moe"], subtree(lq, "moe"), h2, ctx,
                                  top_k=cfg.top_k, gate=cfg.moe_gate,
                                  capacity_factor=cfg.capacity_factor,
                                  routed_scaling=cfg.routed_scaling,
                                  mesh=mesh, use_ep=use_ep,
                                  experts_held=cfg.experts_held,
                                  d_ff=cfg.d_ff,
                                  shared_mesh=mesh if tp is not None
                                  and tp.shared else None)
        x = x + y2
    else:
        x = x + _mlp(cfg, lp["mlp"], subtree(lq, "mlp"), h2, ctx,
                     mesh if tp is not None and tp.mlp else None)
    return x, new_cache, aux


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def check_remat(remat: str) -> None:
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}: one of {', '.join(REMAT)}")


def _remat(fn, remat: str):
    """``fn`` wrapped as the reference's ``jax.checkpoint`` of the scan
    body: ``full`` keeps a layer's inputs only and runs its forward again
    in the backward, ``dots`` also keeps its projections' products.  A
    non-reentrant checkpoint records the same graph, so the loss and the
    gradients are bitwise ``none``'s; without grad mode ``fn`` runs as
    is."""
    check_remat(remat)
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return functools.partial(
        checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     _dots_policy))


def _layer(tree: Any, l: int) -> Any:
    """Layer ``l`` of an L-stacked tree (views); a non-tree state is kept."""
    if isinstance(tree, (dict, list, tuple)):
        return map_(lambda a: a[l], tree)
    return tree


def quantize_stack(stack_p: Any, stack_q: Any, ctx: QuantCtx,
                   shards: Optional[qat.Shards] = None) -> Any:
    """The stacked parameters a train forward reads: every quantized leaf
    (L, R, C) replaced by its fake-quantized ŵ in ``ctx.dtype``, all of
    them in one grouped quantization (on the card ⌈segments / 32⌉
    ecl_quant launches: SmolLM-360M's 32 × 7 leaves take 7).  Each layer
    is a segment with its own ω, probabilities and mean(w²), as the
    reference quantizes one layer at a time inside its scan.
    :func:`lm_apply` hands it every stack at once (``params["stacks"]``),
    so a dense and a MoE stack share the launches; over a tensor-parallel
    mesh with their layout (``shards``), a rank quantizes its blocks."""
    return qat.fake_quant_tree(stack_p, stack_q, ctx.lam, ctx.dtype, shards)


def _unstack(tree: Any, n: int) -> list:
    """The ``n`` per-layer trees of an L-stacked tree, each leaf a view
    from one ``unbind`` (whose backward stacks the layers' gradients in
    one operation instead of one full-size scatter a layer)."""
    per = [t.unbind(0) for t in leaves(tree)]
    return [unflatten(tree, [p[l] for p in per]) for l in range(n)]


def readout(cfg: ArchConfig, params: dict, x: torch.Tensor,
            mesh=None) -> torch.Tensor:
    """The final norm and the head (tied to the embedding or not): fp32
    logits (..., padded_vocab) of ``x`` (..., d), the padded vocab rows
    masked to -1e30.  Over a ``mesh`` whose tensor-parallel layout splits
    the vocabulary, this rank's block of them (its rows of the table or
    columns of the head), the padded rows found by their global index."""
    x = _norm(cfg, params["final_norm"], x).to(torch.float32)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].to(torch.float32).T
    else:
        logits = x @ params["lm_head"]["kernel"].to(torch.float32)
    if cfg.padded_vocab != cfg.vocab:
        n = logits.shape[-1]
        first = 0 if n == cfg.padded_vocab else \
            mesh.axis_index("model") * n
        logits = logits.masked_fill(
            torch.arange(first, first + n, device=logits.device) >= cfg.vocab,
            -1e30)
    return logits


def lm_apply(params: dict, qstate: Any, tokens: Optional[torch.Tensor],
             ctx: QuantCtx, cfg: ArchConfig, *,
             embeds: Optional[torch.Tensor] = None,
             positions: Optional[torch.Tensor] = None,
             cache: Optional[dict] = None, remat: str = "none",
             mesh=None, use_ep: bool = True,
             attn_reshard: Optional[bool] = None) -> tuple:
    """Forward pass.  Returns (logits, new_cache, aux_loss).

    ``tokens`` (B, S) int, or ``embeds`` (B, S, d): the stubbed vlm / audio
    frontends' embeddings, the input as they are in place of the token
    lookup.  ``positions`` (B, S) absolute positions (decode passes the
    cache offset); default arange.  With ``mrope_sections`` the rotary is
    M-RoPE over three identical (t, h, w) streams of ``positions``, as
    the reference feeds it.  ``remat``: one of :data:`REMAT`, each
    block's rematerialisation under autograd (the grouped ŵ is made once
    before the loop either way, so it adds no ECL pass).  Over a ``mesh``
    (``launch.mesh``) each rank runs its own rows with its own cache, and
    the MoE layers exchange tokens (``nn.moe.moe_ffn``, ``use_ep`` as the
    reference takes it).  An arch of a decoder-only family over a 'model'
    axis of more than one rank holds its blocks of the weights
    (``runtime.sharding.model_tp``): the lookup, each block's heads, FFN
    and shared-expert columns, expert banks, SSD projections (and heads)
    and the head are split over 'model', and the logits are this rank's
    block of the vocabulary; ``embeds`` then come whole to every rank.
    ``attn_reshard`` (default: no cache and :func:`_attn_batch_reshard`)
    runs attention sequence-parallel.  whisper's encoder-decoder over
    such a mesh runs through ``models/whisper.py``.
    """
    _decoder_only_layout(cfg, mesh)
    tp = sharding.model_tp(cfg, mesh)
    if embeds is None:
        if tp is not None and tp.vocab:
            x = embed_rows(params["embed"]["table"], tokens, ctx.dtype, mesh)
        else:
            x = params["embed"]["table"].to(ctx.dtype)[tokens]
        b, s = tokens.shape
    else:
        x = embeds.to(ctx.dtype)
        b, s = embeds.shape[:2]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    if attn_reshard is None:
        attn_reshard = cache is None and _attn_batch_reshard(cfg, mesh, s)

    cos_sin = None         # attention-free: no rotary (and no head_dim)
    if cfg.family != "ssm":
        rotary_dim = cfg.mla.qk_rope_dim if cfg.mla is not None \
            else int(cfg.resolved_head_dim * cfg.rotary_frac)
        if cfg.mrope_sections is not None:
            cos_sin = mrope_cos_sin(torch.stack([positions] * 3),
                                    rotary_dim, cfg.rope_theta,
                                    cfg.mrope_sections, dtype=torch.float32)
        else:
            cos_sin = rope_cos_sin(positions, rotary_dim, cfg.rope_theta,
                                   dtype=torch.float32)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = {} if cache is not None else None
    w_hat = None
    if ctx.quant:
        args = (params["stacks"], subtree(qstate, "stacks"), ctx)
        w_hat = quantize_stack(*args) if tp is None else quantize_stack(
            *args, qat.Shards(mesh, tp_specs(cfg, mesh)["stacks"]))
    for kind, idx in _kind_layers(cfg).items():
        block = _remat(functools.partial(_block, cfg, kind, mesh=mesh,
                                         use_ep=use_ep,
                                         attn_reshard=attn_reshard), remat)
        windows = _windows_for(cfg, idx)
        stack_p = params["stacks"][kind]
        stack_q = subtree(subtree(qstate, "stacks"), kind)
        stack_c = cache.get(kind) if cache is not None else None
        layer_p = _unstack(w_hat[kind], len(idx)) \
            if w_hat is not None else None
        # the reference's scan carry: a stack's aux from an fp32 zero, in
        # layer order, then added to the total
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_layers = []
        for l in range(len(idx)):
            window = cfg.window if windows is None else windows[l]
            lp = layer_p[l] if layer_p is not None else _layer(stack_p, l)
            x, nc, a = block(lp, _layer(stack_q, l), x, ctx,
                             cos_sin=cos_sin, positions=positions,
                             lcache=_layer(stack_c, l)
                             if stack_c is not None else None,
                             window=window)
            aux = aux + a
            new_layers.append(nc)
        aux_total = aux_total + aux
        if stack_c is not None:
            new_cache[kind] = _stack(new_layers)

    logits = readout(cfg, params, x, mesh)
    return logits, new_cache, aux_total
