"""Shared layers (the JAX package's ``nn/layers.py``): norms, the
quantization-aware linear, embeddings, rotary embeddings (RoPE and
partial rotary) and the MLP blocks.

Each ``*_init`` draws from an explicit ``torch.Generator`` and puts its
tensors on the generator's device.  ``mrope_cos_sin`` and
``sinusoidal_positions`` wait for the vlm and audio families (ROADMAP
queue 1).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from .module import QuantCtx, materialize, maybe_quant_param


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
    w = torch.rand((d_in, d_out), generator=generator, dtype=dtype,
                   device=dev) * (2 * scale) - scale
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


# -------------------------------------------------------------- embedding

def embedding_init(generator: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32) -> dict:
    return {"table": torch.randn((vocab, d), generator=generator,
                                 dtype=dtype, device=generator.device)
            * 0.02}


def embed(p: dict, ids: torch.Tensor, ctx: QuantCtx) -> torch.Tensor:
    return p["table"].to(ctx.dtype)[ids]


def unembed(p: dict, x: torch.Tensor, ctx: QuantCtx) -> torch.Tensor:
    """Tied read-out: logits = x @ table.T (f32 accumulation)."""
    return x.to(torch.float32) @ p["table"].to(torch.float32).T


# ----------------------------------------------------------------- rotary

def rope_cos_sin(positions: torch.Tensor, rotary_dim: int, theta: float,
                 dtype=torch.float32) -> tuple:
    """positions (..., S) -> cos, sin (..., S, rotary_dim // 2)."""
    half = rotary_dim // 2
    expo = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** expo)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


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


# -------------------------------------------------------------------- MLP

def swiglu_init(generator: torch.Generator, d: int, d_ff: int,
                quantize: bool) -> dict:
    return {"gate": linear_init(generator, d, d_ff, quantize),
            "up": linear_init(generator, d, d_ff, quantize),
            "down": linear_init(generator, d_ff, d, quantize)}


def swiglu(p: dict, q: Any, x: torch.Tensor, ctx: QuantCtx) -> torch.Tensor:
    g = linear(p["gate"], subtree(q, "gate"), x, ctx)
    u = linear(p["up"], subtree(q, "up"), x, ctx)
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return linear(p["down"], subtree(q, "down"), h, ctx)


def gelu_mlp_init(generator: torch.Generator, d: int, d_ff: int,
                  quantize: bool, bias: bool = True) -> dict:
    return {"fc1": linear_init(generator, d, d_ff, quantize, bias=bias),
            "fc2": linear_init(generator, d_ff, d, quantize, bias=bias)}


def gelu_mlp(p: dict, q: Any, x: torch.Tensor, ctx: QuantCtx) -> torch.Tensor:
    """gelu is the tanh approximation, ``jax.nn.gelu``'s default."""
    h = linear(p["fc1"], subtree(q, "fc1"), x, ctx)
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return linear(p["fc2"], subtree(q, "fc2"), h, ctx)


def subtree(q: Any, key: str) -> Any:
    """Navigate the qstate mirror tree (0 where absent)."""
    return q[key] if isinstance(q, dict) and key in q else 0
