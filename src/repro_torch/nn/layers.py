"""Shared layers (the JAX package's ``nn/layers.py``): norms, the
quantization-aware linear, embeddings, rotary embeddings (RoPE, partial
rotary and Qwen2-VL's multimodal M-RoPE), whisper's sinusoidal positions
and the MLP blocks.

Each ``*_init`` draws from an explicit ``torch.Generator`` and puts its
tensors on the generator's device.  On the meta device, where no
``torch.Generator`` can live, :func:`make_generator` gives a
:class:`MetaGenerator` and every draw (:func:`draw`) is an empty meta
tensor of the same shape and dtype: a tree is built without storage.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from .module import QuantCtx, materialize, maybe_quant_param


# ------------------------------------------------------------------ draws

class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device."""
    device = torch.device("meta")


def make_generator(device, seed: int = 0):
    """A generator on ``device`` seeded with ``seed``; on the meta device a
    :class:`MetaGenerator`."""
    if torch.device(device).type == "meta":
        return MetaGenerator()
    return torch.Generator(device=device).manual_seed(seed)


def draw(fn, shape: tuple, generator, dtype=torch.float32) -> torch.Tensor:
    """``fn(shape)`` (``torch.rand`` or ``torch.randn``) from ``generator``
    on its device; on the meta device an empty tensor of that shape."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return fn(shape, generator=generator, dtype=dtype,
              device=generator.device)


# ------------------------------------------------------------------ norms

def rms_norm_init(d: int, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


def layer_norm_init(d: int, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


# ----------------------------------------------------------------- linear

def linear_init(generator: torch.Generator, d_in: int, d_out: int,
                quantize: bool, bias: bool = False,
                dtype=torch.float32) -> dict:
    """Weights uniform in ±1/√d_in, as the reference draws them."""
    dev = generator.device
    scale = 1.0 / (d_in ** 0.5)
    w = draw(torch.rand, (d_in, d_out), generator, dtype) * (2 * scale) \
        - scale
    p = {"kernel": maybe_quant_param(w, quantize)}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype, device=dev)
    return p


def linear(p: dict, q: Any, x: torch.Tensor, ctx: QuantCtx) -> torch.Tensor:
    qk = q["kernel"] if isinstance(q, dict) else 0
    w = materialize(p["kernel"], qk, ctx)
    y = x @ w
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def linear_row_parallel(p: dict, q: Any, x: torch.Tensor, ctx: QuantCtx,
                        mesh, axis: str = "model") -> torch.Tensor:
    """:func:`linear` of a row-sharded kernel: ``x`` this rank's block of
    the contraction, ``p["kernel"]`` the same rows.  The ranks' partial
    products are summed over ``axis`` in fp32 (one all-reduce) and rounded
    to x's dtype once, as one product's fp32 accumulation is; the bias,
    replicated, is added once, after the sum."""
    qk = q["kernel"] if isinstance(q, dict) else 0
    w = materialize(p["kernel"], qk, ctx)
    y = mesh.all_reduce(x.to(torch.float32) @ w.to(torch.float32), axis)
    y = y.to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


# -------------------------------------------------------------- embedding

def embedding_init(generator: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32) -> dict:
    return {"table": draw(torch.randn, (vocab, d), generator, dtype) * 0.02}


def embed(p: dict, ids: torch.Tensor, ctx: QuantCtx) -> torch.Tensor:
    return p["table"].to(ctx.dtype)[ids]


def embed_rows(table: torch.Tensor, ids: torch.Tensor, dtype, mesh,
               axis: str = "model") -> torch.Tensor:
    """The vocabulary-parallel lookup: ``table`` this rank's rows of the
    embedding (rows ``index · n`` on), an id outside them read as zeros,
    the ranks' rows summed over ``axis`` (each id's row comes from the one
    rank that holds it, so the sum is that row exactly)."""
    n = table.shape[0]
    local = ids.to(torch.int64) - mesh.axis_index(axis) * n
    held = (local >= 0) & (local < n)
    x = table.to(dtype)[local.clamp(0, n - 1)]
    return mesh.all_reduce(x.masked_fill(~held[..., None], 0), axis)


def unembed(p: dict, x: torch.Tensor, ctx: QuantCtx) -> torch.Tensor:
    """Tied read-out: logits = x @ table.T (f32 accumulation)."""
    return x.to(torch.float32) @ p["table"].to(torch.float32).T


# ----------------------------------------------------------------- rotary

def _rope_angles(positions: torch.Tensor, half: int,
                 theta: float) -> torch.Tensor:
    """positions (...) -> fp32 angles (..., half): position x θ^(-i/half)."""
    expo = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** expo)
    return positions.to(torch.float32)[..., None] * freqs


def rope_cos_sin(positions: torch.Tensor, rotary_dim: int, theta: float,
                 dtype=torch.float32) -> tuple:
    """positions (..., S) -> cos, sin (..., S, rotary_dim // 2)."""
    ang = _rope_angles(positions, rotary_dim // 2, theta)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def mrope_cos_sin(positions: torch.Tensor, rotary_dim: int, theta: float,
                  sections, dtype=torch.float32) -> tuple:
    """Qwen2-VL's multimodal RoPE.  positions (3, B, S): the (t, h, w)
    streams; ``sections`` the rotary *pairs* of each stream (summing to
    rotary_dim // 2).  Each pair takes its angle from the stream its index
    falls in, picked by a gather (the reference's one-hot einsum selects
    the same fp32 angle exactly).  -> cos, sin (B, S, rotary_dim // 2)."""
    half = rotary_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"rotary_dim // 2 = {half}")
    ang = _rope_angles(positions, half, theta)           # (3, B, S, half)
    pair = torch.arange(half, device=positions.device)
    # each pair's stream: 0, 1 or 2 by the section its index falls in
    # (built on the device: no host-to-device copy)
    stream = (pair >= sections[0]).to(torch.int64) \
        + (pair >= sections[0] + sections[1]).to(torch.int64)
    sel = torch.gather(ang, 0, stream.expand(ang.shape[1:])[None])[0]
    return torch.cos(sel).to(dtype), torch.sin(sel).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, Dh); cos, sin (B, S, half) with half <= Dh // 2.

    Rotates the first 2·half dims (GLM-style partial rotary), pairing dim
    i with dim i + half (the NeoX / llama convention)."""
    half = cos.shape[-1]
    x_rot, x_pass = x[..., :2 * half], x[..., 2 * half:]
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return torch.cat([out, x_pass], dim=-1) if x_pass.shape[-1] else out


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """fp32 a·b + c rounded once (the fp64 product of two fp32 is exact);
    a number among b and c is an fp32 constant."""
    def f64(v):
        return torch.as_tensor(v, dtype=torch.float32).to(torch.float64)
    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """fp32 exp by the reference's arithmetic: XLA's CPU exp, Cephes'
    polynomial in fused multiply-adds (``polynomial_approximations``'s
    ``GenerateVF32Exp``).  It is not correctly rounded (one ulp off on
    about one argument in ten), and a one-ulp frequency moves a sinusoid
    at position 1,500 by ~1e-4, so the table takes the reference's
    frequencies bit for bit this way, on the CPU and on the card."""
    n = torch.floor(_fma(x, 1.44269504088896341, 0.5)).clamp(-127, 127)
    r = _fma(-n, 0.693359375, x)
    r = _fma(-n, -2.12194440e-4, r)
    z = _fma(r, 1.9875691500e-4, 1.3981999507e-3)
    for c in (8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1,
              5.0000001201e-1):
        z = _fma(z, r, c)
    z = 1.0 + _fma(z, r * r, r)
    # 2^n from its exponent bits, exact (0 at n = -127, as XLA's)
    return z * ((n.to(torch.int32) + 127) << 23).view(torch.float32)


def sinusoidal_positions(n: int, d: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (n, d): sin then cos of
    position x exp(-ln(10000) i / (d/2 - 1))."""
    half = d // 2
    i = torch.arange(half, dtype=torch.float32, device=device)
    # ln(10000) in fp32 on the host: a 0-d CPU tensor enters a device
    # product as a scalar, with no copy; the divisor is a tensor, since
    # CUDA divides by a scalar through its reciprocal (not IEEE division)
    freqs = _exp_f32(-torch.log(torch.tensor(10000.0)) * i
                     / torch.full_like(i, half - 1))
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] \
        * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# -------------------------------------------------------------------- MLP

def swiglu_init(generator: torch.Generator, d: int, d_ff: int,
                quantize: bool) -> dict:
    return {"gate": linear_init(generator, d, d_ff, quantize),
            "up": linear_init(generator, d, d_ff, quantize),
            "down": linear_init(generator, d_ff, d, quantize)}


def swiglu(p: dict, q: Any, x: torch.Tensor, ctx: QuantCtx,
           mesh=None) -> torch.Tensor:
    """With ``mesh``: gate and up this rank's columns of the hidden width,
    down its rows (:func:`linear_row_parallel` over 'model')."""
    g = linear(p["gate"], subtree(q, "gate"), x, ctx)
    u = linear(p["up"], subtree(q, "up"), x, ctx)
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    if mesh is not None:
        return linear_row_parallel(p["down"], subtree(q, "down"), h, ctx,
                                   mesh)
    return linear(p["down"], subtree(q, "down"), h, ctx)


def gelu_mlp_init(generator: torch.Generator, d: int, d_ff: int,
                  quantize: bool, bias: bool = True) -> dict:
    return {"fc1": linear_init(generator, d, d_ff, quantize, bias=bias),
            "fc2": linear_init(generator, d_ff, d, quantize, bias=bias)}


def gelu_mlp(p: dict, q: Any, x: torch.Tensor, ctx: QuantCtx,
             mesh=None) -> torch.Tensor:
    """gelu is the tanh approximation, ``jax.nn.gelu``'s default.  With
    ``mesh`` fc1 (and its bias) this rank's columns, fc2 its rows, fc2's
    bias added once after the sum (:func:`linear_row_parallel`)."""
    h = linear(p["fc1"], subtree(q, "fc1"), x, ctx)
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    if mesh is not None:
        return linear_row_parallel(p["fc2"], subtree(q, "fc2"), h, ctx, mesh)
    return linear(p["fc2"], subtree(q, "fc2"), h, ctx)


def subtree(q: Any, key: str) -> Any:
    """Navigate the qstate mirror tree (0 where absent)."""
    return q[key] if isinstance(q, dict) and key in q else 0
