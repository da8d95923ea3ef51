"""Entropy-Constrained Lloyd (ECL) assignment — paper §IV-C.

    code(w) = argmin_c  (w - v_c)^2 + λ · mean(w²) · (-log2 P_c)

The penalty is scaled by mean(w²) so one global λ means the same on every
layer (the JAX package's ``core/ecl.py:56-65``).  Ties go to the lowest
code, as ``torch.argmin`` and ``jnp.argmin`` both return the first index.

:func:`assign` builds the penalty where w lies and takes the codes from
the grouped ECL op (``kernels.ops.ecl_quant_many``): on CUDA tensors one
launch of the hand-written kernel for every tensor (and every leading
index of a batched ω); on the CPU its plain version, which rounds every
term as the reference does.  :func:`assign_many` and
:func:`quantize_many` take every quantized tensor of a net in one call;
:func:`assign_general` assigns against a codebook of any size (the EC2T
baseline), in plain PyTorch.
The probability state is EMA-updated from each fresh assignment
(:func:`update_probs`), one alternating ECL iteration per training step.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..kernels import ops
from .bitplanes import NUM_CODES, codebook

#: floor for cluster probabilities; keeps -log2(P) finite.
PROB_FLOOR = 1e-8


def entropy_bits(probs: torch.Tensor) -> torch.Tensor:
    """First-order entropy H = -Σ P log2 P: (*lead, 16) -> (*lead,)."""
    p = torch.clamp(probs, PROB_FLOOR, 1.0)
    return -torch.sum(torch.where(probs > 0, p * torch.log2(p),
                                  torch.zeros_like(p)), dim=-1)


def penalty(w: torch.Tensor, probs: torch.Tensor, lam) -> torch.Tensor:
    """The entropy term λ·mean(w²)·(-log2 clamp(P)) per code, in the
    reference's order of operations: (*lead, 16) for w (*lead, R, C) with
    batched probs, else (16,).  ``lam`` is a number or a tensor; it stays
    on the host as a scalar operand, so nothing is copied to the card."""
    wf = w.detach().to(torch.float32)
    if probs.ndim > 1:
        scale = torch.mean(wf * wf, dim=(-2, -1))[..., None]
    else:
        scale = torch.mean(wf * wf)
    lam_t = torch.as_tensor(lam, dtype=torch.float32)
    return lam_t * scale * -torch.log2(torch.clamp(probs, PROB_FLOOR, 1.0))


def quantize(w: torch.Tensor, omega: torch.Tensor,
             pen: torch.Tensor) -> tuple:
    """(codes uint8, ŵ fp32) of w's shape against a precomputed penalty
    (:func:`penalty`): :func:`quantize_many` of one tensor.  A batched ω
    (*lead, 4) runs every leading index in the same launch."""
    return quantize_many([w], [omega], [pen])[0]


def quantize_many(ws: Sequence[torch.Tensor], omegas: Sequence[torch.Tensor],
                  pens: Sequence[torch.Tensor]) -> list:
    """[(codes, ŵ)] of every tensor through the grouped ECL op
    ``kernels.ops.ecl_quant_many``: one CUDA kernel launch for tensors on
    the card, the plain version per tensor on the CPU."""
    return ops.ecl_quant_many(ws, omegas, pens)


def assign(w: torch.Tensor, omega: torch.Tensor, probs: torch.Tensor,
           lam) -> torch.Tensor:
    """uint8 codes minimising distance + entropy penalty.

    w: (*lead, R, C) with omega (*lead, 4) and probs (*lead, 16), or any
    shape with unbatched (4,) / (16,) -> codes with w's shape.
    """
    return assign_many([w], [omega], [probs], lam)[0]


def assign_many(ws: Sequence[torch.Tensor], omegas: Sequence[torch.Tensor],
                probs: Sequence[torch.Tensor], lam) -> list:
    """:func:`assign` of every tensor, one grouped quantization."""
    with torch.no_grad():
        pens = [penalty(w, p, lam) for w, p in zip(ws, probs)]
        return [c for c, _ in quantize_many(ws, omegas, pens)]


def code_counts(codes: torch.Tensor, lead_ndim: int = 0) -> torch.Tensor:
    """Exact int64 count of each of the 16 codes per lead index: (*lead,
    16) for codes (*lead, ...).  One comparison a code, so the largest
    temporary is one byte per code element, not the reference's (n, 16)
    one-hot; no host synchronisation (``torch.bincount`` on the card reads
    the largest code back first).  Each match mask is summed as bytes
    into int32 (exact: a segment holds fewer than 2**31 codes, else
    int64), which the card reduces faster than a bool sum into int64."""
    flat = codes.reshape(*codes.shape[:lead_ndim], -1)
    acc = torch.int32 if flat.shape[-1] < 2**31 else torch.int64
    return torch.stack([(flat == c).view(torch.uint8).sum(-1, dtype=acc)
                        for c in range(NUM_CODES)], dim=-1).to(torch.int64)


def histogram(codes: torch.Tensor, lead_ndim: int = 0) -> torch.Tensor:
    """Normalised 16-bin histogram of codes (float32, sums to 1 per lead):
    the exact :func:`code_counts` divided in fp32 by their total.  Where
    the reference's fp32 one-hot sums are exact (every count and the total
    below 2**24) the result equals its bit for bit; past 2**24 the
    reference's sums round and these counts do not."""
    counts = code_counts(codes, lead_ndim)
    total = counts.sum(-1, keepdim=True)
    return counts.to(torch.float32) / torch.clamp(
        total.to(torch.float32), min=1.0)


def update_probs(probs: torch.Tensor, codes: torch.Tensor,
                 momentum: float = 0.9) -> torch.Tensor:
    """EMA update of the cluster-probability state from fresh assignments."""
    return momentum * probs + (1.0 - momentum) * histogram(
        codes, lead_ndim=probs.ndim - 1)


def ecl_fit(w: torch.Tensor, omega: torch.Tensor, lam: float,
            iters: int = 10) -> tuple:
    """Full alternating ECL (post-training quantization): assignment ↔
    probability update from uniform probabilities, ``iters`` times, then a
    last assignment; centroids stay fixed (the paper's modification).
    Each assignment is one launch of the grouped ECL op.  Returns
    (codes, probs)."""
    lead = omega.shape[:-1]
    probs = torch.full((*lead, NUM_CODES), 1.0 / NUM_CODES,
                       dtype=torch.float32, device=w.device)
    for _ in range(iters):
        probs = histogram(assign(w, omega, probs, lam), lead_ndim=len(lead))
    return assign(w, omega, probs, lam), probs


def sparsity(codes: torch.Tensor) -> torch.Tensor:
    """Fraction of exact zeros (code 0)."""
    return torch.mean((codes == 0).to(torch.float32))


def assign_general(w: torch.Tensor, book: torch.Tensor, probs: torch.Tensor,
                   lam) -> torch.Tensor:
    """ECL assignment against an arbitrary codebook ``book`` (C,), with
    probabilities (C,): the EC2T ternary baseline's C = 3 ({-a, 0, +a},
    the paper's fig. 9 comparison) as well as any other C.  Same
    scale-invariant entropy penalty as :func:`assign`.  Plain PyTorch on
    either device: the ECL kernel takes the 16 subset sums of ω only."""
    wf = w.to(torch.float32)
    pen = -torch.log2(torch.clamp(probs, PROB_FLOOR, 1.0))
    scale = torch.mean(wf * wf)
    lam_t = torch.as_tensor(lam, dtype=torch.float32)
    cost = (wf[..., None] - book.to(torch.float32)) ** 2 \
        + lam_t * scale * pen
    return torch.argmin(cost, dim=-1).to(torch.uint8)
