"""Attention (the JAX package's ``nn/attention.py``): GQA, SWA and MLA.

* **GQA** (smollm, danube, glm4, ...) — ``n_kv <= n_heads`` KV heads,
  queries grouped; MHA is the ``n_kv == n_heads`` case.
* **SWA** (danube) — a sliding-window mask of width ``window``.
* **Cross-attention** (whisper's decoder) — ``gqa_apply(kv_override=)``:
  queries from ``x``, K and V precomputed from the encoder.
* **MLA** (deepseek-v3) — low-rank latent compression of Q and KV.  The
  cache holds only the latent c_kv (``kv_lora_rank`` wide) and the shared
  rope key (``qk_rope_dim``); a prefill decompresses the latent one KV
  chunk at a time inside the softmax loop (the naive form, never the whole
  (B, S, H, qk_dim) K), a decode step attends over the latent itself with
  W_uk folded into the query and W_uv applied after (the absorbed form).

Every softmax runs through :func:`chunked_attention`, the reference's
online softmax over KV chunks (running max and normaliser, the finite
``NEG_INF`` keeping fully masked rows free of NaN), as a Python loop over
the chunks in place of ``jax.lax.scan``; its ``kv_chunk_fn`` maps a chunk
of the KV parts to (K, V), the identity for GQA and the latent
decompression for MLA.  The score products accumulate in fp32.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import (apply_rotary, linear, linear_init, linear_row_parallel,
                     subtree)
from .module import QuantCtx, materialize

NEG_INF = -1e30  # large-but-finite: keeps fully-masked rows NaN-free


# ------------------------------------------------------------ mask helpers

def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
               window, kv_len: Optional[torch.Tensor]) -> torch.Tensor:
    """Additive bias (B, Sq, Skv) from position vectors.

    q_pos (B, Sq) absolute query positions; kv_pos (B, Skv) key positions
    (-1 = padding); kv_len optional (B,) valid cache entries.
    """
    q = q_pos[:, :, None]
    k = kv_pos[:, None, :]
    ok = k >= 0
    if causal:
        ok = ok & (k <= q)
    if window is not None:
        ok = ok & (q - k < window)
    if kv_len is not None:
        ok = ok & (k < kv_len[:, None, None])
    bias = torch.full(ok.shape, NEG_INF, dtype=torch.float32,
                      device=ok.device)
    return bias.masked_fill(ok, 0.0)


def _pad_seq(a: torch.Tensor, pad: int, value=0) -> torch.Tensor:
    """Pad axis 1 of ``a`` by ``pad`` entries at the end."""
    return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad), value=value)


# ------------------------------------------------ chunked online softmax

def chunked_attention(q: torch.Tensor, kv_parts: tuple, *,
                      q_pos: torch.Tensor, kv_pos: torch.Tensor,
                      causal: bool = True, window=None,
                      kv_len: Optional[torch.Tensor] = None,
                      chunk: int = 1024, scale: float,
                      n_kv: int, dv: int,
                      kv_chunk_fn: Optional[Callable] = None) -> torch.Tensor:
    """Exact softmax attention, online over KV chunks.

    q (B, Sq, H, D).  ``kv_parts`` is a tuple of tensors with the KV
    sequence on axis 1; ``kv_chunk_fn(parts_chunk)`` maps a chunk of it to
    ``(k, v)`` of shapes (B, c, n_kv, D) and (B, c, n_kv, dv).  Without
    it ``kv_parts`` is that ``(k, v)``.  Returns (B, Sq, H, dv) in fp32.
    """
    b, sq, h, d = q.shape
    rep = h // n_kv
    qf = (q * scale).reshape(b, sq, n_kv, rep, d).to(torch.float32)

    skv = kv_parts[0].shape[1]
    chunk = min(chunk, skv)
    pad = (-skv) % chunk
    if pad:
        kv_parts = tuple(_pad_seq(a, pad) for a in kv_parts)
        # padded keys land at position -1 so the mask rejects them
        kv_pos = _pad_seq(kv_pos, pad, value=-1)
    m = torch.full((b, n_kv, rep, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, n_kv, rep, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n_kv, rep, sq, dv), dtype=torch.float32,
                      device=q.device)

    def body(m, l, acc, qf, pos_c, *parts_c):
        kc, vc = parts_c if kv_chunk_fn is None else kv_chunk_fn(parts_c)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kc.to(torch.float32))
        s = s + _mask_bias(q_pos, pos_c, causal=causal, window=window,
                           kv_len=kv_len)[:, None, None]
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p, vc.to(torch.float32))
        return m_new, l, acc

    # the reference's jax.checkpoint(body): under autograd each chunk keeps
    # only its inputs and the carries, and the backward re-forms the
    # chunk's scores (same operations, same order: bitwise the gradients
    # of the loop without it)
    step = body
    if torch.is_grad_enabled():
        step = functools.partial(checkpoint, body, use_reentrant=False)
    for start in range(0, skv + pad, chunk):
        m, l, acc = step(m, l, acc, qf, kv_pos[:, start:start + chunk],
                         *(a[:, start:start + chunk] for a in kv_parts))
    out = acc / torch.clamp(l, min=1e-30)[..., None]           # (B,G,r,Sq,dv)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv)


def dense_attention_ref(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                        kv_len=None, scale=None) -> torch.Tensor:
    """O(Sq·Skv)-memory oracle for tests."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    rep = q.shape[2] // k.shape[2]
    kf = torch.repeat_interleave(k.to(torch.float32), rep, dim=2)
    vf = torch.repeat_interleave(v.to(torch.float32), rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * scale, kf)
    s = s + _mask_bias(q_pos, kv_pos, causal=causal, window=window,
                       kv_len=kv_len)[:, None]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf)


def softmax_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                      kv_len=None, chunk=1024, scale=None) -> torch.Tensor:
    """Standard (k, v) entry point into :func:`chunked_attention`."""
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    return chunked_attention(
        q, (k, v), q_pos=q_pos, kv_pos=kv_pos, causal=causal,
        window=window, kv_len=kv_len, chunk=chunk, scale=scale,
        n_kv=k.shape[2], dv=v.shape[-1])


# ---------------------------------------------------------------- KV cache

def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    """Ring-buffer KV cache.  ``pos`` holds each slot's absolute position
    (-1 = empty); masking is purely position-based, so a window-sized
    buffer wraps for free."""
    return {
        "k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_slots(length: torch.Tensor, size: int, s: int) -> torch.Tensor:
    """The ``s`` slots a write of ``s`` entries takes in a ring of ``size``
    that holds ``length`` entries: from ``length % size``, with the start
    clamped to ``size - s`` as ``lax.dynamic_update_slice`` clamps it (a
    multi-entry write must not wrap).  ``length`` () or (n,) -> (s,) or
    (n, s), on ``length``'s device, with no host round trip."""
    start = torch.clamp(length.to(torch.int64) % size, max=size - s)
    return start[..., None] + torch.arange(s, device=length.device)


def _cache_update(cache: dict, entries: dict,
                  positions: torch.Tensor) -> dict:
    """Write Sq new entries at slot ``len % size`` (functional): each
    tensor of ``entries`` (``k`` and ``v``, or MLA's ``ckv`` and
    ``krope``; (B, Sq, ...)) into the cache's ring of the same name.

    Multi-entry writes (prefill) must not wrap: callers size prefill
    caches at full sequence length; only single-token decode wraps."""
    s = positions.shape[1]
    slots = cache_slots(cache["len"], cache["pos"].shape[0], s)
    new = {name: cache[name].index_copy(1, slots, t.to(cache[name].dtype))
           for name, t in entries.items()}
    new["pos"] = cache["pos"].index_copy(0, slots,
                                         positions[0].to(torch.int32))
    new["len"] = cache["len"] + s
    return new


# -------------------------------------------------------------------- GQA

def gqa_init(generator: torch.Generator, d_model: int, n_heads: int,
             n_kv: int, head_dim: int, quantize: bool,
             qkv_bias: bool = False) -> dict:
    g = generator
    return {
        "q": linear_init(g, d_model, n_heads * head_dim, quantize,
                         bias=qkv_bias),
        "k": linear_init(g, d_model, n_kv * head_dim, quantize, bias=qkv_bias),
        "v": linear_init(g, d_model, n_kv * head_dim, quantize, bias=qkv_bias),
        "o": linear_init(g, n_heads * head_dim, d_model, quantize),
    }


def gqa_project(p: dict, q_state: Any, x: torch.Tensor, ctx: QuantCtx, *,
                n_heads: int, n_kv: int, head_dim: int,
                cos_sin: Optional[tuple]) -> tuple:
    """q (B, S, H, D), k and v (B, S, n_kv, D) of ``x``, rotated."""
    b, s, _ = x.shape
    q = linear(p["q"], subtree(q_state, "q"), x, ctx).reshape(
        b, s, n_heads, head_dim)
    k = linear(p["k"], subtree(q_state, "k"), x, ctx).reshape(
        b, s, n_kv, head_dim)
    v = linear(p["v"], subtree(q_state, "v"), x, ctx).reshape(
        b, s, n_kv, head_dim)
    if cos_sin is not None:
        cos, sin = cos_sin
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    return q, k, v


@dataclasses.dataclass(frozen=True)
class AttnTP:
    """How one rank runs an attention block over the 'model' axis of
    ``mesh``: ``heads`` its q / k / v (and biases) are its ``n_heads / tp``
    and ``n_kv / tp`` heads' columns (its cache holds those KV heads), or
    MLA's q_up / kv_up its ``n_heads / tp`` heads' columns; ``o_rows`` its
    o holds the rows of ``n_heads / tp`` heads (a row-sharded product,
    summed over 'model'); ``seq`` sequence-parallel: its x is its ``S /
    tp`` rows of the sequence, whose keys and values are gathered over
    'model' so that its queries attend to every key, and whose output is
    gathered back along S; ``q_down`` / ``kv_down`` MLA's down-projections
    hold its columns, their outputs gathered along the features over
    'model' before anything reads them."""
    mesh: Any
    heads: bool = False
    o_rows: bool = False
    seq: bool = False
    q_down: bool = False
    kv_down: bool = False


def _o_parallel(p: dict, q: Any, out: torch.Tensor, ctx: QuantCtx,
                tp: AttnTP) -> torch.Tensor:
    """The output projection of ``out`` (B, S, heads·D) under ``tp``: the
    whole sequence's (B, S, d) on every rank."""
    mesh = tp.mesh
    if not tp.o_rows:             # o whole (and so every head here)
        y = linear(p, q, out, ctx)
        return mesh.all_gather(y, "model", dim=1) if tp.seq else y
    if not tp.heads:
        # every head's output here: the whole sequence's, then the columns
        # of the heads whose rows of o this rank holds
        if tp.seq:
            out = mesh.all_gather(out, "model", dim=1)
        w = out.shape[-1] // mesh.axis_size("model")
        out = out.narrow(-1, mesh.axis_index("model") * w, w)
    return linear_row_parallel(p, q, out, ctx, mesh)


def gqa_apply(p: dict, q_state: Any, x: torch.Tensor, ctx: QuantCtx, *,
              n_heads: int, n_kv: int, head_dim: int,
              cos_sin: Optional[tuple] = None,
              positions: Optional[torch.Tensor] = None,
              causal: bool = True, window=None,
              cache: Optional[dict] = None,
              kv_override: Optional[tuple] = None,
              chunk: int = 1024, tp: Optional[AttnTP] = None) -> tuple:
    """Self-attention, or cross-attention when ``kv_override`` = (k, v)
    (B, Skv, n_kv, D) is given: those keys and values as they are (no
    rotary, no cache update, no causal mask), at positions 0 .. Skv - 1.
    Returns (y, new_cache).  ``positions``: (B, Sq) absolute positions of
    x.  ``tp``: this rank's part over a mesh (:class:`AttnTP`; the head
    counts stay the whole model's); y is then the whole sequence's."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    if tp is not None and tp.heads:
        n_heads //= tp.mesh.axis_size("model")
        n_kv //= tp.mesh.axis_size("model")
    if kv_override is None:
        q, k, v = gqa_project(p, q_state, x, ctx, n_heads=n_heads,
                              n_kv=n_kv, head_dim=head_dim, cos_sin=cos_sin)
    else:
        q = linear(p["q"], subtree(q_state, "q"), x, ctx).reshape(
            b, s, n_heads, head_dim)
        k, v = kv_override
        cache, causal = None, False

    new_cache = None
    if cache is not None:
        new_cache = _cache_update(cache, {"k": k, "v": v}, positions)
        k, v = new_cache["k"], new_cache["v"]
        kv_pos = new_cache["pos"].expand(b, k.shape[1])
    elif tp is not None and tp.seq:
        k, v, kv_pos = (tp.mesh.all_gather(t, "model", dim=1)
                        for t in (k, v, positions))
    else:
        kv_pos = torch.arange(k.shape[1], dtype=torch.int32,
                              device=x.device).expand(b, k.shape[1])

    out = softmax_attention(q, k, v, positions, kv_pos, causal=causal,
                            window=window, chunk=chunk)
    out = out.reshape(b, s, n_heads * head_dim).to(ctx.dtype)
    if tp is not None:
        return _o_parallel(p["o"], subtree(q_state, "o"), out, ctx,
                           tp), new_cache
    y = linear(p["o"], subtree(q_state, "o"), out, ctx)
    return y, new_cache


# -------------------------------------------------------------------- MLA

@dataclasses.dataclass(frozen=True)
class MLACfg:
    """DeepSeek-V3 multi-head latent attention dims (arXiv:2412.19437)."""
    d_model: int = 7168
    n_heads: int = 128
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


def mla_init(generator: torch.Generator, cfg: MLACfg,
             quantize: bool) -> dict:
    """The low-rank Q and KV projections and the output projection."""
    c, g = cfg, generator
    return {
        "q_down": linear_init(g, c.d_model, c.q_lora_rank, quantize),
        "q_up": linear_init(g, c.q_lora_rank, c.n_heads * c.qk_dim, quantize),
        "kv_down": linear_init(g, c.d_model, c.kv_lora_rank + c.qk_rope_dim,
                               quantize),
        "kv_up": linear_init(g, c.kv_lora_rank,
                             c.n_heads * (c.qk_nope_dim + c.v_head_dim),
                             quantize),
        "o": linear_init(g, c.n_heads * c.v_head_dim, c.d_model, quantize),
    }


def init_mla_cache(batch: int, max_len: int, cfg: MLACfg,
                   dtype=torch.bfloat16, device=None) -> dict:
    """The latent ring cache: c_kv and the rotated rope key of every
    slot, in the caller's dtype, and each slot's position (-1 = empty)."""
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                             device=device),
        "pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def mla_apply(p: dict, q_state: Any, x: torch.Tensor, ctx: QuantCtx,
              cfg: MLACfg, *, cos_sin: tuple,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None, chunk: int = 1024,
              force_absorbed: Optional[bool] = None,
              tp: Optional[AttnTP] = None) -> tuple:
    """MLA block; returns (y, new_cache).  The form follows the
    reference: Sq > 1 (prefill) takes the *naive* form, decompressing each
    KV chunk of the latent inside the softmax loop; Sq == 1 (decode) the
    *absorbed* form, attending over the latent with ``n_kv = 1`` and
    ``dv = kv_lora_rank``; ``force_absorbed`` picks one.  The up-projection
    is materialised once a call (a frozen leaf decoded from its codes).
    ``tp``: this rank's part over a mesh (:class:`AttnTP`, never
    sequence-parallel, as the reference's): a column-cut down-projection's
    output gathered whole (the latent is split into c_kv and the rope key
    only then), the rank's heads from its up-projections' columns (the
    absorbed form's W_uk and W_uv too), o row-cut and summed; the latent
    cache is whole on every rank."""
    b, s, _ = x.shape
    c = cfg
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    if tp is not None and tp.seq:
        raise ValueError("MLA does not run sequence-parallel")
    n_heads = c.n_heads
    if tp is not None and tp.heads:
        n_heads //= tp.mesh.axis_size("model")

    def down(name, cut):
        y = linear(p[name], subtree(q_state, name), x, ctx)
        return tp.mesh.all_gather(y, "model", dim=-1) if cut else y

    q = linear(p["q_up"], subtree(q_state, "q_up"),
               down("q_down", tp is not None and tp.q_down), ctx)
    q = q.reshape(b, s, n_heads, c.qk_dim)
    q_nope, q_rope = q[..., :c.qk_nope_dim], q[..., c.qk_nope_dim:]

    kv = down("kv_down", tp is not None and tp.kv_down)
    ckv, k_rope = kv[..., :c.kv_lora_rank], kv[..., c.kv_lora_rank:]

    cos, sin = cos_sin
    q_rope = apply_rotary(q_rope, cos, sin)
    k_rope = apply_rotary(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]

    new_cache = None
    if cache is not None:
        new_cache = _cache_update(cache, {"ckv": ckv, "krope": k_rope},
                                  positions)
        ckv, k_rope = new_cache["ckv"], new_cache["krope"]
        kv_pos = new_cache["pos"].expand(b, ckv.shape[1])
    else:
        kv_pos = torch.arange(ckv.shape[1], dtype=torch.int32,
                              device=x.device).expand(b, ckv.shape[1])

    scale = c.qk_dim ** -0.5
    w_up = materialize(p["kv_up"]["kernel"],
                       subtree(subtree(q_state, "kv_up"), "kernel"), ctx)
    w_up = w_up.reshape(c.kv_lora_rank, n_heads,
                        c.qk_nope_dim + c.v_head_dim)
    w_uk = w_up[..., :c.qk_nope_dim]                  # (r, H, nope)
    w_uv = w_up[..., c.qk_nope_dim:]                  # (r, H, v)

    absorbed = (s == 1) if force_absorbed is None else force_absorbed
    if absorbed:
        # fold W_uk into the query; attend over the latent (n_kv = 1)
        q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope.to(torch.float32),
                             w_uk.to(torch.float32))
        q_full = torch.cat([q_abs, q_rope.to(torch.float32)], dim=-1)
        k_lat = torch.cat([ckv, k_rope], dim=-1)[:, :, None, :]
        out_lat = chunked_attention(
            q_full, (k_lat, ckv[:, :, None, :]), q_pos=positions,
            kv_pos=kv_pos, causal=True, chunk=chunk, scale=scale, n_kv=1,
            dv=c.kv_lora_rank)
        out = torch.einsum("bqhr,rhd->bqhd", out_lat, w_uv.to(torch.float32))
    else:
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        w_up32 = w_up.to(torch.float32)

        def decompress(parts_c):
            ckv_c, kr_c = parts_c                     # (B,c,r), (B,c,rope)
            kvu = torch.einsum("bkr,rhd->bkhd", ckv_c.to(torch.float32),
                               w_up32)
            kr = kr_c[:, :, None, :].to(torch.float32).expand(
                *kr_c.shape[:2], n_heads, c.qk_rope_dim)
            k_c = torch.cat([kvu[..., :c.qk_nope_dim], kr], dim=-1)
            return k_c, kvu[..., c.qk_nope_dim:]

        out = chunked_attention(
            q_full, (ckv, k_rope), q_pos=positions, kv_pos=kv_pos,
            causal=True, chunk=chunk, scale=scale, n_kv=n_heads,
            dv=c.v_head_dim, kv_chunk_fn=decompress)

    out = out.reshape(b, s, n_heads * c.v_head_dim).to(ctx.dtype)
    if tp is not None:
        return _o_parallel(p["o"], subtree(q_state, "o"), out, ctx,
                           tp), new_cache
    y = linear(p["o"], subtree(q_state, "o"), out, ctx)
    return y, new_cache
