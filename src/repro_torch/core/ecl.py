"""Entropy-Constrained Lloyd (ECL) assignment — paper §IV-C.

    code(w) = argmin_c  (w - v_c)^2 + λ · mean(w²) · (-log2 P_c)

The penalty is scaled by mean(w²) so one global λ means the same on every
layer (the JAX package's ``core/ecl.py:56-65``).  Ties go to the lowest
code, as ``torch.argmin`` and ``jnp.argmin`` both return the first index.

:func:`assign` builds the penalty where w lies and takes the codes from
the fused ECL op (``kernels.ops.ecl_quant``): on a CUDA tensor the
hand-written kernel, once per leading index of a batched ω; on the CPU its
plain version, which rounds every term as the reference does.  The
probability state is EMA-updated from each fresh assignment
(:func:`update_probs`), one alternating ECL iteration per training step.
"""
from __future__ import annotations

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
    (:func:`penalty`), through the fused ECL op ``kernels.ops.ecl_quant``:
    the CUDA kernel for a tensor on the card, its plain version on the
    CPU.  A batched ω (*lead, 4) runs once per leading index."""
    if omega.ndim == 1:
        return ops.ecl_quant(w, omega, pen)
    w3 = w.reshape(-1, *w.shape[-2:])
    om, pn = omega.reshape(-1, 4), pen.reshape(-1, NUM_CODES)
    outs = [ops.ecl_quant(w3[i], om[i], pn[i]) for i in range(w3.shape[0])]
    return (torch.stack([c for c, _ in outs]).reshape(w.shape),
            torch.stack([v for _, v in outs]).reshape(w.shape))


def assign(w: torch.Tensor, omega: torch.Tensor, probs: torch.Tensor,
           lam) -> torch.Tensor:
    """uint8 codes minimising distance + entropy penalty.

    w: (*lead, R, C) with omega (*lead, 4) and probs (*lead, 16), or any
    shape with unbatched (4,) / (16,) -> codes with w's shape.
    """
    return quantize(w.detach(), omega.detach(), penalty(w, probs, lam))[0]


def histogram(codes: torch.Tensor, lead_ndim: int = 0) -> torch.Tensor:
    """Normalised 16-bin histogram of codes (float32, sums to 1 per lead).

    Each bin counts its matches as a float32 sum of 0/1: exact integers up
    to 2**24 whatever the order, so equal to the reference's one-hot sum,
    with a bool (n, 16) intermediate instead of its float one."""
    lead = codes.shape[:lead_ndim]
    bins = torch.arange(NUM_CODES, dtype=codes.dtype, device=codes.device)
    hits = codes.reshape(*lead, -1, 1) == bins
    counts = hits.sum(-2, dtype=torch.float32)
    return counts / torch.clamp(counts.sum(-1, keepdim=True), min=1.0)


def update_probs(probs: torch.Tensor, codes: torch.Tensor,
                 momentum: float = 0.9) -> torch.Tensor:
    """EMA update of the cluster-probability state from fresh assignments."""
    return momentum * probs + (1.0 - momentum) * histogram(
        codes, lead_ndim=probs.ndim - 1)


def sparsity(codes: torch.Tensor) -> torch.Tensor:
    """Fraction of exact zeros (code 0)."""
    return torch.mean((codes == 0).to(torch.float32))
