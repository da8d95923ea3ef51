"""The LM train step's loss and the train step over a mesh (the JAX
package's ``launch/steps.py`` ``_loss_fn`` and ``build_train_step``).

``_loss_fn`` is ``lm_forward_loss``, or ``whisper_forward_loss`` for the
audio family, under a ``QuantCtx`` that fake-quantizes every quantized
leaf when the arch quantizes, in the reference's bf16 compute dtype
unless the caller names another, with the layer body rematerialised as
``remat`` says (``none``, ``full`` or ``dots``: ``nn/transformer.py``
``lm_apply``; whisper's forward ignores it, as the reference's does).
Over a ``mesh`` (``launch.mesh``) each rank runs its rows through the MoE
exchanges (``use_ep`` as the reference takes it) and the loss is the
whole batch's on every rank.

:func:`build_train_step` is the eager counterpart of the reference's
(``src/repro/launch/steps.py:64-88``): this rank's step and the function
that builds its state, with ZeRO-1's moments when ``zero1``.  The
reference's ``StepBundle`` (abstract args and shardings for the dry run)
and its prefill and decode bundles wait for ROADMAP queue 1 item 9 (XLA
tooling, ported by analogue).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..configs.base import ArchConfig
from ..models import lm as lm_model
from ..models import whisper as W
from ..nn.module import QuantCtx
from ..nn.transformer import check_remat, check_supported
from ..optim import adam, ec4t
from ..optim.grad_compress import GradCompressCfg


def _loss_fn(cfg: ArchConfig, mesh=None, use_ep: bool = True,
             remat: str = "none",
             dtype: torch.dtype = torch.bfloat16) -> Callable:
    """``loss(params, qstate, batch, lam) -> (loss, metrics)``.  One
    shard's share of expert parallelism also trains on one device
    through ``cfg.experts_held``."""
    check_supported(cfg)
    check_remat(remat)
    fwd = (W.whisper_forward_loss if cfg.family == "audio"
           else lm_model.lm_forward_loss)

    def loss(params, qstate, batch, lam):
        ctx = QuantCtx(quant=cfg.quantize, lam=lam, compute_dtype=dtype)
        return fwd(params, qstate, batch, ctx, cfg, mesh=mesh,
                   use_ep=use_ep, remat=remat)
    return loss


def build_train_step(cfg: ArchConfig, mesh, *, remat: str = "full",
                     use_ep: bool = True, zero1: bool = True,
                     adam_cfg: Optional[adam.AdamConfig] = None,
                     compress: Optional[GradCompressCfg] = None,
                     dtype: torch.dtype = torch.bfloat16) -> tuple:
    """This rank's ``(step, init_state)`` over ``mesh``, with the
    reference's defaults (remat full, expert parallelism, ZeRO-1, λ
    ``cfg.lam``): ``init_state(params)`` builds the train state (m and v
    of this rank's blocks with ``zero1``, the error feedback with
    ``compress``), and ``step(state, batch)`` takes this rank's rows of
    the batch (``data.pipeline.ShardedFeed(mesh=)`` places them)."""
    step = ec4t.make_train_step(
        _loss_fn(cfg, mesh, use_ep, remat, dtype),
        adam_cfg or adam.AdamConfig(), lam=cfg.lam, compress=compress,
        mesh=mesh, zero1=zero1)

    def init_state(params) -> dict:
        return ec4t.init_train_state(params, compress, mesh=mesh,
                                     zero1=zero1)
    return step, init_state
