"""Entropy-Constrained Lloyd (ECL) assignment — paper §IV-C.

    code(w) = argmin_c  (w - v_c)^2 + λ · mean(w²) · (-log2 P_c)

The penalty is scaled by mean(w²) so one global λ means the same on every
layer (the JAX package's ``core/ecl.py:56-65``).  Ties go to the lowest
code, as ``torch.argmin`` and ``jnp.argmin`` both return the first index.
"""
from __future__ import annotations

import torch

from .bitplanes import NUM_CODES, codebook

#: floor for cluster probabilities; keeps -log2(P) finite.
PROB_FLOOR = 1e-8


def entropy_bits(probs: torch.Tensor) -> torch.Tensor:
    """First-order entropy H = -Σ P log2 P: (*lead, 16) -> (*lead,)."""
    p = torch.clamp(probs, PROB_FLOOR, 1.0)
    return -torch.sum(torch.where(probs > 0, p * torch.log2(p),
                                  torch.zeros_like(p)), dim=-1)


def assign(w: torch.Tensor, omega: torch.Tensor, probs: torch.Tensor,
           lam: float) -> torch.Tensor:
    """uint8 codes minimising distance + entropy penalty.

    w: (*lead, R, C) with omega (*lead, 4) and probs (*lead, 16), or any
    shape with unbatched (4,) / (16,) -> codes with w's shape.
    """
    book = codebook(omega).to(torch.float32)
    penalty = -torch.log2(torch.clamp(probs, PROB_FLOOR, 1.0))
    wf = w.to(torch.float32)
    if omega.ndim > 1:
        scale = torch.mean(wf * wf, dim=(-2, -1), keepdim=True)[..., None]
        book = book[..., None, None, :]
        penalty = penalty[..., None, None, :]
    else:
        scale = torch.mean(wf * wf)
    lam_t = torch.tensor(lam, dtype=torch.float32, device=w.device)
    cost = (wf[..., None] - book) ** 2 + lam_t * scale * penalty
    return torch.argmin(cost, dim=-1).to(torch.uint8)


def histogram(codes: torch.Tensor, lead_ndim: int = 0) -> torch.Tensor:
    """Normalised 16-bin histogram of codes (float32, sums to 1 per lead)."""
    lead = codes.shape[:lead_ndim]
    onehot = torch.nn.functional.one_hot(codes.to(torch.int64),
                                         NUM_CODES).to(torch.float32)
    counts = onehot.reshape(*lead, -1, NUM_CODES).sum(-2)
    return counts / torch.clamp(counts.sum(-1, keepdim=True), min=1.0)
