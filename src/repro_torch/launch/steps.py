"""The LM train step's loss (the JAX package's ``launch/steps.py``
``_loss_fn``): ``lm_forward_loss``, or ``whisper_forward_loss`` for the
audio family, under a ``QuantCtx`` that fake-quantizes every quantized
leaf when the arch quantizes, in the reference's bf16 compute dtype
unless the caller names another, with the layer body rematerialised as
``remat`` says (``none``, ``full`` or ``dots``: ``nn/transformer.py``
``lm_apply``; whisper's forward ignores it, as the reference's does).

The reference's step bundles over a mesh (``build_train_step``,
``build_prefill_step``, ``build_decode_step``) wait for ROADMAP queue 1
item 9 (XLA tooling, ported by analogue).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import ArchConfig
from ..models import lm as lm_model
from ..models import whisper as W
from ..nn.module import QuantCtx
from ..nn.transformer import check_remat, check_supported


def _loss_fn(cfg: ArchConfig, mesh=None, remat: str = "none",
             dtype: torch.dtype = torch.bfloat16) -> Callable:
    """``loss(params, qstate, batch, lam) -> (loss, metrics)``.  The
    reference's ``use_ep`` (expert parallelism over a mesh, whose forward
    ``nn.moe`` serves) trains with the next slice, training over a mesh
    (ROADMAP queue 1 item 6); one shard's share of it trains through
    ``cfg.experts_held``."""
    if mesh is not None:
        raise NotImplementedError(
            "a loss over a mesh is not ported yet: it comes with training "
            "over a mesh, the next slice (ROADMAP queue 1 item 6, its "
            "training half); pass mesh=None")
    check_supported(cfg)
    check_remat(remat)
    audio = cfg.family == "audio"

    def loss(params, qstate, batch, lam):
        ctx = QuantCtx(quant=cfg.quantize, lam=lam, compute_dtype=dtype)
        fwd = W.whisper_forward_loss if audio else lm_model.lm_forward_loss
        return fwd(params, qstate, batch, ctx, cfg, remat=remat)
    return loss
