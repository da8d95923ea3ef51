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
            mask: Optional[torch.Tensor] = None, *,
            mesh=None, vocab_parallel: bool = False) -> torch.Tensor:
    """Token-mean cross entropy.  logits (B, S, Vp); labels (B, S) with
    ids < vocab; the padded-vocab columns were already masked to -1e30.
    Over a ``mesh`` whose data axes hold several ranks, the mean of the
    whole batch on every rank: ``Σ nll·mask`` and ``Σ mask`` summed over
    the data axes (the sum differentiably), not a mean of the ranks'
    means.  With ``vocab_parallel`` the logits are this rank's block of
    the vocabulary and the loss the same, through
    :func:`vocab_parallel_nll`."""
    if vocab_parallel:
        nll = vocab_parallel_nll(logits, labels, mesh)
    else:
        lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(lp, -1, labels.to(torch.int64)[..., None])[..., 0]
    if mesh is None or mesh.axis_size(mesh.data_axes) == 1:
        if mask is None:
            return nll.mean()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if mask is None:
        num = nll.sum()
        den = torch.full((), nll.numel(), dtype=torch.float32,
                         device=nll.device)
    else:
        num, den = (nll * mask).sum(), mask.to(torch.float32).sum()
    num = mesh.all_reduce(num, mesh.data_axes)
    with torch.no_grad():
        den = mesh.all_reduce(den, mesh.data_axes)
    return num / torch.clamp(den, min=1.0)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       mesh, axis: str = "model") -> torch.Tensor:
    """−log softmax at each label from this rank's block of the
    vocabulary (logits (B, S, Vp / tp), columns ``index · Vp / tp`` on):
    the max over 'model' (detached: the softmax does not depend on it), the
    sum of exp over 'model', and the label's logit from the rank that
    holds it (zeros elsewhere, summed over 'model'); every rank gets every
    token's value."""
    lf = logits.to(torch.float32)
    n = lf.shape[-1]
    with torch.no_grad():
        m = mesh.all_reduce(lf.detach().amax(-1), axis, op="max")
    se = mesh.all_reduce(torch.exp(lf - m[..., None]).sum(-1), axis)
    local = labels.to(torch.int64) - mesh.axis_index(axis) * n
    held = (local >= 0) & (local < n)
    tgt = torch.gather(lf, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    tgt = mesh.all_reduce(tgt.masked_fill(~held, 0.0), axis)
    return m + torch.log(se) - tgt


def lm_forward_loss(params, qstate, batch: dict, ctx: QuantCtx,
                    cfg: ArchConfig, *, mesh=None, use_ep: bool = True,
                    remat: str = "none") -> tuple:
    """The train forward: (loss, metrics).  The input is the batch's
    ``tokens`` or its ``embeds`` (the stubbed vlm frontend's: a vlm batch
    holds embeds and labels, no tokens); ``remat``, ``mesh`` and
    ``use_ep`` as :func:`~repro_torch.nn.transformer.lm_apply` takes
    them.  Over a mesh the batch is this rank's rows, and ``loss``, ``ce``
    and ``aux`` are the whole batch's on every rank (a tensor-parallel
    rank's logits its block of the vocabulary: the vocabulary-parallel
    cross-entropy)."""
    logits, _, aux = T.lm_apply(params, qstate, batch.get("tokens"), ctx,
                                cfg, embeds=batch.get("embeds"),
                                remat=remat, mesh=mesh, use_ep=use_ep)
    ce = lm_loss(logits, batch["labels"], cfg.vocab, batch.get("mask"),
                 mesh=mesh,
                 vocab_parallel=logits.shape[-1] != cfg.padded_vocab)
    loss = ce + cfg.aux_loss_coef * aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


def greedy_step(params, qstate, tokens: torch.Tensor, ctx: QuantCtx,
                cfg: ArchConfig, *, positions: torch.Tensor,
                cache: dict, mesh=None, use_ep: bool = True) -> tuple:
    """One serving step: feed tokens, return (next_token (B, 1), cache)."""
    logits, cache, _ = T.lm_apply(params, qstate, tokens, ctx, cfg,
                                  positions=positions, cache=cache,
                                  mesh=mesh, use_ep=use_ep)
    return next_token(logits, cfg, mesh), cache


def next_token(logits: torch.Tensor, cfg: ArchConfig,
               mesh=None) -> torch.Tensor:
    """The greedy token (B, 1) int32 of the last position's logits; a
    rank's block of the vocabulary is gathered over 'model' first, so that
    a tie goes to the first index, as in one process."""
    last = logits[:, -1:]
    if last.shape[-1] != cfg.padded_vocab:
        last = mesh.all_gather(last, "model", dim=-1)
    return torch.argmax(last[..., :cfg.vocab], dim=-1).to(torch.int32)


def batch_rows(mesh, b: int) -> Optional[slice]:
    """This rank's rows of a batch of ``b`` over ``mesh``'s data axes (the
    reference's ``batch_spec``: split when they divide, else every row);
    None for every row."""
    if mesh is None:
        return None
    n = mesh.axis_size(mesh.data_axes)
    if n == 1 or b % n:
        return None
    i = mesh.axis_index(mesh.data_axes)
    return slice(i * (b // n), (i + 1) * (b // n))


@torch.no_grad()
def generate(params, qstate, prompt: torch.Tensor, ctx: QuantCtx,
             cfg: ArchConfig, *, max_new: int, mesh=None,
             use_ep: bool = True) -> torch.Tensor:
    """Greedy generation: prefill the prompt, then decode ``max_new - 1``
    more tokens; (B, max_new) int32 on the prompt's device.  Over a
    ``mesh`` every rank takes the whole prompt, runs its rows (split over
    the data axes) with its own cache through the MoE exchanges, and the
    tokens are gathered back, so every rank returns every row.  An arch's
    tensor-parallel ranks (``runtime.sharding.model_tp``) each run their
    heads' cache (KV and SSM state) and gather the last logits over
    'model' (:func:`next_token`)."""
    rows = batch_rows(mesh, prompt.shape[0])
    if rows is not None:
        prompt = prompt[rows]
    b, s = prompt.shape
    dev = prompt.device
    cache = T.init_cache(cfg, b, s + max_new, dtype=torch.float32,
                         device=dev, mesh=mesh)
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    kw = dict(mesh=mesh, use_ep=use_ep)
    nxt, cache = greedy_step(params, qstate, prompt, ctx, cfg,
                             positions=pos, cache=cache, **kw)
    outs = [nxt]
    for t in range(max_new - 1):
        p_t = torch.full((b, 1), s + t, dtype=torch.int32, device=dev)
        nxt, cache = greedy_step(params, qstate, nxt, ctx, cfg,
                                 positions=p_t, cache=cache, **kw)
        outs.append(nxt)
    out = torch.cat(outs, dim=1)
    if rows is not None:
        out = mesh.all_gather(out, mesh.data_axes, dim=0)
    return out
