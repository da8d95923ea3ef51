"""Mamba2's state-space duality (SSD) block (the JAX package's
``nn/ssm.py``; arXiv:2405.21060).

Sequence mode (train, prefill) runs the chunked SSD algorithm: the
sequence is cut into chunks of ``chunk`` steps; each chunk's own
contribution is a quadratic product under a decay mask, the chunk-final
states are carried from chunk to chunk, and one more product adds the
carried state to every step.  The reference combines the chunk states
with ``jax.lax.associative_scan`` (log depth); here a sequential loop over
the chunks applies the same ``combine``, s_c = exp(a_tot_c)·s_{c-1} +
states_c, so the sums run in another order than XLA's tree and agree
within rounding, not bit for bit.  Cost is linear in the sequence length.

Decode mode carries a recurrent state (B, H, P, N) and the convolution's
last ``conv_width - 1`` inputs; one token costs O(H·P·N) whatever the
context length.

The in and out projections are EC4T-quantized (the bulk of the
parameters); ``A_log``, ``dt_bias``, ``D``, the convolution and the norm
scale stay fp32, as in the reference.

Over the 'model' axis of a mesh (:class:`SSMTP`, the reference's
``Rules``: in_proj ``row_contract``, out_proj ``row``, the dynamics
replicated, the state cut on its heads where they divide) a rank
contracts its d_model slice of the input with its rows of in_proj and the
fp32 partial projections are all-reduced; the convolution runs on the
whole ``xBC`` (its tail stays whole, as the reference's cache).  With the
heads cut it scans its ``H / tp`` heads (its slices of x, z, dt, A_log,
dt_bias, D and the norm scale; B and C whole, or its groups), the gated
norm's mean over d_inner a sum over its columns all-reduced, and its
out_proj rows are those heads' columns; else the scan and the norm run
whole and it takes its ``d_inner / tp`` columns for its out_proj rows.
out_proj's partial sums take one more all-reduce.  Every exchange is
``Mesh.all_reduce``, whose backward sums the gradients over the slice,
so a replicated leaf a rank reads in part gets its part of the gradient
there and ``runtime.sharding.replica_axes`` sums the parts.

The product of the four operands ``bcqhn,bckhn,bchqk,bckhp->bcqhp`` is
taken as (C·Bᵀ per group) ⊙ L, then times x: its largest intermediate is
(b, nc, h, Q, Q), and no intermediate holds n or p beside both Q axes.
Groups reach heads as ``repeat_interleave`` does (head i reads group
i // (h / g)), through a (g, h / g) view of the head axis, so no
per-head copy of B or C is made.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from .attention import _pad_seq
from .layers import draw, linear, linear_init, linear_row_parallel, subtree
from .module import QuantCtx

_MASKED = -1e30     # a finite -inf inside the exp: exp gives 0, no NaN grads


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_model: int
    d_inner: int          # = expand * d_model
    n_heads: int          # d_inner // headdim
    d_state: int
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256

    @property
    def headdim(self) -> int:
        return self.d_inner // self.n_heads

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def ssm_init(generator: torch.Generator, cfg: SSMCfg, quantize: bool) -> dict:
    c, dev = cfg, generator.device
    d_in_proj = 2 * c.d_inner + 2 * c.n_groups * c.d_state + c.n_heads
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": linear_init(generator, c.d_model, d_in_proj, quantize),
        "out_proj": linear_init(generator, c.d_inner, c.d_model, quantize),
        "conv_w": draw(torch.randn, (c.conv_width, c.conv_dim),
                       generator) * 0.1,
        "conv_b": torch.zeros((c.conv_dim,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, c.n_heads, **f32)),
        "dt_bias": torch.zeros((c.n_heads,), **f32),
        "D": torch.ones((c.n_heads,), **f32),
        "norm_scale": torch.ones((c.d_inner,), **f32),
    }


@dataclasses.dataclass(frozen=True)
class SSMTP:
    """How one rank runs the SSD block over the 'model' axis of ``mesh``
    (``runtime.sharding.ModelTP``'s SSM cuts): ``in_rows`` in_proj holds
    its d_model / tp rows; ``out_rows`` out_proj its d_inner / tp rows;
    ``heads`` the state and the scan hold its H / tp heads (whose d_inner
    columns are its out_proj rows), else the scan runs whole."""
    mesh: Any
    in_rows: bool = False
    out_rows: bool = False
    heads: bool = False


def init_ssm_state(batch: int, cfg: SSMCfg, dtype=torch.float32,
                   device=None, n_heads: Optional[int] = None) -> dict:
    """Zeros: the (batch, H, P, N) state (``n_heads`` of them: a rank's
    under :class:`SSMTP` ``heads``) and the whole conv tail."""
    return {
        "ssm": torch.zeros((batch, n_heads or cfg.n_heads, cfg.headdim,
                            cfg.d_state), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.conv_dim),
                            dtype=dtype, device=device),
    }


def _gated_rms_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-6, mesh=None) -> torch.Tensor:
    """Mamba2's RMSNorm(y * silu(z)) gate; with ``mesh`` y, z and scale
    are this rank's equal blocks of d_inner, the mean over it the sum of
    every block's, all-reduced over 'model'."""
    yf = y.to(torch.float32) * F.silu(z.to(torch.float32))
    if mesh is None:
        var = torch.mean(yf * yf, dim=-1, keepdim=True)
    else:
        var = mesh.all_reduce(torch.sum(yf * yf, dim=-1, keepdim=True),
                              "model") / (yf.shape[-1]
                                          * mesh.axis_size("model"))
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _segsum_exp(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) log-decays -> (..., Q, Q) lower-triangular
    exp(Σ_{k<i<=q} a_i).  The mask goes inside the exp: ``where(mask,
    exp(diff), 0)`` would leak inf·0 = NaN through the upper triangle in
    the backward (diff > 0 there overflows exp)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]     # (..., q, k): Σ_{k+1..q}
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return torch.exp(torch.where(mask, diff, _MASKED))


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None) -> tuple:
    """Chunked SSD scan.

    x (b, s, h, p) inputs already scaled by dt; a (b, s, h) log-decay
    (dt·A, <= 0); B, C (b, s, g, n) with h % g == 0.  A sequence that is
    not a multiple of ``chunk`` is padded with a = 0 (decay 1) and x, B,
    C = 0, and cut after.  Returns (y (b, s, h, p), final state
    (b, h, p, n)), both fp32.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-s) % chunk
    if pad:
        x, a, B, C = (_pad_seq(t, pad) for t in (x, a, B, C))
    nc = x.shape[1] // chunk
    f32 = torch.float32

    xc = x.reshape(b, nc, chunk, g, rep, p).to(f32)
    ac = a.reshape(b, nc, chunk, h).to(f32)
    Bc = B.reshape(b, nc, chunk, g, n).to(f32)
    Cc = C.reshape(b, nc, chunk, g, n).to(f32)

    # ---- intra-chunk (block-diagonal) term: ((C·Bᵀ) ⊙ L) · x
    L = _segsum_exp(ac.permute(0, 1, 3, 2))                 # (b,nc,h,Q,Q)
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)         # (b,nc,g,Q,Q)
    M = L.view(b, nc, g, rep, chunk, chunk) * CB[:, :, :, None]
    del L, CB
    y_diag = torch.einsum("bcgrqk,bckgrp->bcqgrp", M, xc)
    del M

    # ---- chunk-final states
    a_cum = torch.cumsum(ac, dim=2)                         # (b,nc,Q,h)
    a_tot = a_cum[:, :, -1]                                 # (b,nc,h)
    decay_to_end = torch.exp(a_tot[:, :, None] - a_cum)     # (b,nc,Q,h)
    states = torch.einsum(
        "bckgn,bckgrp->bcgrpn", Bc,
        xc * decay_to_end.view(b, nc, chunk, g, rep, 1))    # (b,nc,g,r,p,n)
    states = states.reshape(b, nc, h, p, n)

    # ---- inter-chunk recurrence s_c = exp(a_tot_c)·s_{c-1} + states_c,
    # a sequential loop over the chunks; prev[c] is the state entering c
    decay_chunk = torch.exp(a_tot)                          # (b,nc,h)
    carried = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
               if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(carried)
        carried = states[:, c] + carried * decay_chunk[:, c, :, None, None]
    prev = torch.stack(prev, dim=1)                         # (b,nc,h,p,n)

    # ---- inter-chunk output term
    y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", Cc,
                         prev.view(b, nc, g, rep, p, n))
    y_off = y_off * torch.exp(a_cum).view(b, nc, chunk, g, rep, 1)
    y = (y_diag + y_off).reshape(b, nc * chunk, h, p)[:, :s]
    return y, carried


def _split(zxbcdt: torch.Tensor, c: SSMCfg) -> tuple:
    """(z, xBC, dt_raw) along the last axis of the in-projection."""
    return (zxbcdt[..., :c.d_inner],
            zxbcdt[..., c.d_inner:c.d_inner + c.conv_dim],
            zxbcdt[..., -c.n_heads:])


def _xbc(xBC: torch.Tensor, c: SSMCfg) -> tuple:
    """(x, B, C) of the convolved xBC (..., conv_dim)."""
    gn = c.n_groups * c.d_state
    return (xBC[..., :c.d_inner], xBC[..., c.d_inner:c.d_inner + gn],
            xBC[..., c.d_inner + gn:])


def _model_block(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's equal block of the last dim of ``t`` over 'model'."""
    n = t.shape[-1] // mesh.axis_size("model")
    return t.narrow(-1, mesh.axis_index("model") * n, n)


def _in_proj(p: dict, q: Any, u: torch.Tensor, ctx: QuantCtx,
             tp: Optional[SSMTP]) -> torch.Tensor:
    """zxbcdt of ``u``: whole, or under ``tp.in_rows`` the sum over 'model'
    of each rank's d_model slice times its rows (fp32)."""
    if tp is None or not tp.in_rows:
        return linear(p["in_proj"], subtree(q, "in_proj"), u, ctx)
    return linear_row_parallel(p["in_proj"], subtree(q, "in_proj"),
                               _model_block(u, tp.mesh), ctx, tp.mesh)


def _rank_heads(c: SSMCfg, tp: Optional[SSMTP], z, x, B, C, dt_raw,
                p: dict) -> tuple:
    """Under ``tp.heads`` the config of this rank's H / tp heads and its
    slices of z, x, dt_raw (its heads' columns), B and C (its groups; whole
    with one group) and of ``p``'s per-head and per-column dynamics
    (A_log, dt_bias, D, norm_scale); else ``c`` and the rest as they
    are."""
    if tp is None or not tp.heads:
        return c, z, x, B, C, dt_raw, p
    n, i = tp.mesh.axis_size("model"), tp.mesh.axis_index("model")
    h = c.n_heads // n
    g = c.n_groups // n if c.n_groups > 1 else 1
    lc = dataclasses.replace(c, d_inner=h * c.headdim, n_heads=h, n_groups=g)
    h0, g0 = i * h, (i * g if c.n_groups > 1 else 0)
    hp, gn = c.headdim, c.d_state
    cols = lambda t, first, width: t.narrow(-1, first, width)
    p = {**p, **{k: p[k].narrow(0, h0, h) for k in ("A_log", "dt_bias", "D")},
         "norm_scale": p["norm_scale"].narrow(0, h0 * hp, lc.d_inner)}
    return (lc, cols(z, h0 * hp, lc.d_inner), cols(x, h0 * hp, lc.d_inner),
            cols(B, g0 * gn, g * gn), cols(C, g0 * gn, g * gn),
            cols(dt_raw, h0, h), p)


def _out_proj(p: dict, q: Any, y: torch.Tensor, ctx: QuantCtx,
              tp: Optional[SSMTP]) -> torch.Tensor:
    """out_proj of the normed ``y``: whole; or under ``tp.out_rows`` this
    rank's rows against its columns of y (its heads' y, or its block of
    the whole y), summed over 'model'."""
    if tp is None or not tp.out_rows:
        return linear(p["out_proj"], subtree(q, "out_proj"), y, ctx)
    if not tp.heads:
        y = _model_block(y, tp.mesh)
    return linear_row_parallel(p["out_proj"], subtree(q, "out_proj"), y,
                               ctx, tp.mesh)


def ssm_apply(p: dict, q_state: Any, u: torch.Tensor, ctx: QuantCtx,
              cfg: SSMCfg, *, state: Optional[dict] = None,
              tp: Optional[SSMTP] = None) -> tuple:
    """Sequence-mode mamba2 block: u (b, s, d_model) -> (y, new_state).

    With ``state`` its ssm state and conv tail seed the computation
    (prefill continuation).  The convolution runs in ``ctx.dtype``, the
    scan in fp32, and its output is cast to ``ctx.dtype`` before the gated
    norm, as the reference's.  ``tp``: this rank's part over 'model'
    (:class:`SSMTP`; ``state["ssm"]`` then its heads' under ``heads``)."""
    c = cfg
    b, s, _ = u.shape
    z, xBC, dt_raw = _split(_in_proj(p, q_state, u, ctx, tp), c)

    # causal depthwise conv (width W): the left pad is the conv tail or 0
    w = c.conv_width
    tail = (state["conv"].to(xBC.dtype) if state is not None
            else torch.zeros((b, w - 1, c.conv_dim), dtype=xBC.dtype,
                             device=xBC.device))
    xBC_pad = torch.cat([tail, xBC], dim=1)
    new_conv_tail = xBC_pad[:, -(w - 1):]
    conv = xBC_pad[:, 0:s] * p["conv_w"][0].to(xBC.dtype)
    for i in range(1, w):
        conv = conv + xBC_pad[:, i:i + s] * p["conv_w"][i].to(xBC.dtype)
    xBC = F.silu(conv.to(torch.float32) + p["conv_b"]).to(ctx.dtype)

    lc, z, x, B, C, dt_raw, p = _rank_heads(c, tp, z, *_xbc(xBC, c),
                                            dt_raw, p)
    x = x.reshape(b, s, lc.n_heads, lc.headdim)
    B = B.reshape(b, s, lc.n_groups, lc.d_state)
    C = C.reshape(b, s, lc.n_groups, lc.d_state)

    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])   # (b,s,h)
    a = dt * -torch.exp(p["A_log"])                              # log-decay
    x_dt = x.to(torch.float32) * dt[..., None]

    init = state["ssm"] if state is not None else None
    y, fin = ssd_chunked(x_dt, a, B, C, lc.chunk, init_state=init)
    y = y + x.to(torch.float32) * p["D"][:, None]
    y = y.reshape(b, s, lc.d_inner).to(ctx.dtype)

    y = _gated_rms_norm(y, z, p["norm_scale"],
                        mesh=tp.mesh if lc is not c else None)
    out = _out_proj(p, q_state, y, ctx, tp)
    return out, {"ssm": fin, "conv": new_conv_tail.to(torch.float32)}


def ssm_step(p: dict, q_state: Any, u: torch.Tensor, ctx: QuantCtx,
             cfg: SSMCfg, state: dict, tp: Optional[SSMTP] = None) -> tuple:
    """Decode mode: u (b, 1, d_model), O(H·P·N) a token; the convolution
    runs in fp32 here.  ``tp`` as :func:`ssm_apply`'s."""
    c = cfg
    b = u.shape[0]
    z, xBC_new, dt_raw = _split(_in_proj(p, q_state, u, ctx, tp)[:, 0], c)

    conv_in = torch.cat([state["conv"].to(xBC_new.dtype), xBC_new[:, None]],
                        dim=1)
    conv = torch.einsum("bwc,wc->bc", conv_in.to(torch.float32), p["conv_w"])
    xBC = F.silu(conv + p["conv_b"]).to(ctx.dtype)
    new_conv_tail = conv_in[:, 1:].to(torch.float32)

    c, z, x, B, C, dt_raw, p = _rank_heads(c, tp, z, *_xbc(xBC, c), dt_raw,
                                           p)
    x = x.reshape(b, c.n_groups, c.n_heads // c.n_groups, c.headdim)
    B = B.reshape(b, c.n_groups, 1, c.d_state).to(torch.float32)
    C = C.reshape(b, c.n_groups, c.d_state).to(torch.float32)

    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])   # (b,h)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))

    dtx = (dt.view(b, c.n_groups, -1, 1) * x.to(torch.float32))
    s_new = (state["ssm"].to(torch.float32) * dA[..., None, None]
             + (dtx[..., None] * B[..., None, :]).reshape(
                 b, c.n_heads, c.headdim, c.d_state))
    y = torch.einsum("bgrpn,bgn->bgrp",
                     s_new.view(b, c.n_groups, -1, c.headdim, c.d_state), C)
    y = y.reshape(b, c.n_heads, c.headdim) \
        + x.reshape(b, c.n_heads, c.headdim).to(torch.float32) \
        * p["D"][:, None]
    y = y.reshape(b, c.d_inner).to(ctx.dtype)

    y = _gated_rms_norm(y, z, p["norm_scale"],
                        mesh=tp.mesh if c is not cfg else None)
    out = _out_proj(p, q_state, y[:, None], ctx, tp)
    return out, {"ssm": s_new, "conv": new_conv_tail}
