"""Attention (the JAX package's ``nn/attention.py``), GQA only.

* **GQA** (smollm, danube, glm4, ...) — ``n_kv <= n_heads`` KV heads,
  queries grouped; MHA is the ``n_kv == n_heads`` case.
* **SWA** (danube) — a sliding-window mask of width ``window``.

Every softmax runs through :func:`chunked_attention`, the reference's
online softmax over KV chunks (running max and normaliser, the finite
``NEG_INF`` keeping fully masked rows free of NaN), as a Python loop over
the chunks in place of ``jax.lax.scan``.  The score products accumulate
in fp32.  MLA (deepseek-v3) waits for its family (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from .layers import apply_rotary, linear, linear_init, subtree
from .module import QuantCtx

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
                      n_kv: int, dv: int) -> torch.Tensor:
    """Exact softmax attention, online over KV chunks.

    q (B, Sq, H, D); ``kv_parts`` is ``(k, v)`` of shapes (B, Skv, n_kv, D)
    and (B, Skv, n_kv, dv).  Returns (B, Sq, H, dv) in fp32.
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
    for start in range(0, skv + pad, chunk):
        kc, vc = (a[:, start:start + chunk] for a in kv_parts)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kc.to(torch.float32))
        s = s + _mask_bias(q_pos, kv_pos[:, start:start + chunk],
                           causal=causal, window=window,
                           kv_len=kv_len)[:, None, None]
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p, vc.to(torch.float32))
        m = m_new
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


def _cache_update(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                  positions: torch.Tensor) -> dict:
    """Write Sq new KV entries at slot ``len % size`` (functional).

    Multi-entry writes (prefill) must not wrap: callers size prefill
    caches at full sequence length; only single-token decode wraps."""
    size, s = cache["k"].shape[1], k_new.shape[1]
    slots = cache_slots(cache["len"], size, s)
    return {
        "k": cache["k"].index_copy(1, slots, k_new.to(cache["k"].dtype)),
        "v": cache["v"].index_copy(1, slots, v_new.to(cache["v"].dtype)),
        "pos": cache["pos"].index_copy(0, slots,
                                       positions[0].to(torch.int32)),
        "len": cache["len"] + s,
    }


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


def gqa_apply(p: dict, q_state: Any, x: torch.Tensor, ctx: QuantCtx, *,
              n_heads: int, n_kv: int, head_dim: int,
              cos_sin: Optional[tuple] = None,
              positions: Optional[torch.Tensor] = None,
              causal: bool = True, window=None,
              cache: Optional[dict] = None,
              chunk: int = 1024) -> tuple:
    """Self-attention.  Returns (y, new_cache).  ``positions``: (B, Sq)
    absolute positions of x."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    q, k, v = gqa_project(p, q_state, x, ctx, n_heads=n_heads, n_kv=n_kv,
                          head_dim=head_dim, cos_sin=cos_sin)

    new_cache = None
    if cache is not None:
        new_cache = _cache_update(cache, k, v, positions)
        k, v = new_cache["k"], new_cache["v"]
        kv_pos = new_cache["pos"].expand(b, k.shape[1])
    else:
        kv_pos = torch.arange(k.shape[1], dtype=torch.int32,
                              device=x.device).expand(b, k.shape[1])

    out = softmax_attention(q, k, v, positions, kv_pos, causal=causal,
                            window=window, chunk=chunk)
    out = out.reshape(b, s, n_heads * head_dim).to(ctx.dtype)
    y = linear(p["o"], subtree(q_state, "o"), out, ctx)
    return y, new_cache
