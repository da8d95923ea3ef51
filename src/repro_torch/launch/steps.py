"""The LM train step's loss (the JAX package's ``launch/steps.py``
``_loss_fn``): ``lm_forward_loss`` under a ``QuantCtx`` that fake-
quantizes every quantized leaf when the arch quantizes, in the
reference's bf16 compute dtype unless the caller names another.

The reference's step bundles over a mesh (``build_train_step``,
``build_prefill_step``, ``build_decode_step``) wait for ROADMAP queue 1
item 9 (XLA tooling, ported by analogue); rematerialisation (``remat``
``full`` / ``dots``) for queue 1 item 10.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import ArchConfig
from ..models import lm as lm_model
from ..nn.module import QuantCtx
from ..nn.transformer import check_supported

REMAT = ("none",)


def check_trainable(cfg: ArchConfig) -> None:
    """Raise for every arch the port cannot train yet: those its stack
    does not build (ssm, hybrid, vlm, audio), and MLA, which it serves but
    does not train yet.  The dense and moe families train, a moe config's
    share (``experts_held``) included."""
    check_supported(cfg)
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name} uses MLA (multi-head latent attention): the port "
            "serves it, but training it is not ported yet (the rest of "
            "ROADMAP queue 1 item 8.2)")


def check_remat(remat: str) -> None:
    if remat not in REMAT:
        raise NotImplementedError(
            f"remat={remat!r}: only 'none' is ported; activation "
            "rematerialisation ('full', 'dots') waits for ROADMAP queue 1 "
            "item 10")


def _loss_fn(cfg: ArchConfig, mesh=None, remat: str = "none",
             dtype: torch.dtype = torch.bfloat16) -> Callable:
    """``loss(params, qstate, batch, lam) -> (loss, metrics)``.  The
    reference's ``use_ep`` (expert parallelism over a mesh) waits for
    ROADMAP queue 1 item 6; one shard's share of it trains through
    ``cfg.experts_held``."""
    if mesh is not None:
        raise NotImplementedError(
            "a loss over a mesh is not ported yet (ROADMAP queue 1 item 6, "
            "scale-out); pass mesh=None")
    check_trainable(cfg)
    check_remat(remat)

    def loss(params, qstate, batch, lam):
        ctx = QuantCtx(quant=cfg.quantize, lam=lam, compute_dtype=dtype)
        return lm_model.lm_forward_loss(params, qstate, batch, ctx, cfg)
    return loss
