"""Causal-LM task heads (the JAX package's ``models/lm.py``): masked
cross-entropy over the padded vocab, and greedy prefill + decode.

The transformer body lives in ``nn/transformer.py``.  ``lm_loss`` and
``lm_forward_loss`` are what an LM trainer calls; ``generate`` is the
direct greedy loop that the serving program (``serving/lm.py``) is held
against.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..nn import transformer as T
from ..nn.module import QuantCtx


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy.  logits (B, S, Vp); labels (B, S) with
    ids < vocab; the padded-vocab columns were already masked to -1e30."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(lp, -1, labels.to(torch.int64)[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def lm_forward_loss(params, qstate, batch: dict, ctx: QuantCtx,
                    cfg: ArchConfig) -> tuple:
    """The train forward: (loss, metrics)."""
    logits, _, aux = T.lm_apply(params, qstate, batch["tokens"], ctx, cfg)
    ce = lm_loss(logits, batch["labels"], cfg.vocab, batch.get("mask"))
    loss = ce + cfg.aux_loss_coef * aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


def greedy_step(params, qstate, tokens: torch.Tensor, ctx: QuantCtx,
                cfg: ArchConfig, *, positions: torch.Tensor,
                cache: dict) -> tuple:
    """One serving step: feed tokens, return (next_token (B, 1), cache)."""
    logits, cache, _ = T.lm_apply(params, qstate, tokens, ctx, cfg,
                                  positions=positions, cache=cache)
    nxt = torch.argmax(logits[:, -1:, :cfg.vocab], dim=-1).to(torch.int32)
    return nxt, cache


@torch.no_grad()
def generate(params, qstate, prompt: torch.Tensor, ctx: QuantCtx,
             cfg: ArchConfig, *, max_new: int) -> torch.Tensor:
    """Greedy generation: prefill the prompt, then decode ``max_new - 1``
    more tokens; (B, max_new) int32 on the prompt's device."""
    b, s = prompt.shape
    dev = prompt.device
    cache = T.init_cache(cfg, b, s + max_new, dtype=torch.float32,
                         device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    nxt, cache = greedy_step(params, qstate, prompt, ctx, cfg,
                             positions=pos, cache=cache)
    outs = [nxt]
    for t in range(max_new - 1):
        p_t = torch.full((b, 1), s + t, dtype=torch.int32, device=dev)
        nxt, cache = greedy_step(params, qstate, nxt, ctx, cfg,
                                 positions=p_t, cache=cache)
        outs.append(nxt)
    return torch.cat(outs, dim=1)
