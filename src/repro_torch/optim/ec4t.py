"""EC4T training step assembly (paper §IV, the full loop): the JAX
package's ``optim/ec4t.py``.

One training step =
  1. fake-quant forward + backward (straight-through to the masters, eq.
     (2) to the 4 basis centroids; ``core/qat.py``),
  2. optionally the int8 error-feedback round trip of the gradients
     (``optim/grad_compress.py``),
  3. Adam on the whole tree (masters + ω + everything unquantized),
  4. one alternating-ECL iteration: EMA-update the per-tensor cluster
     probabilities from fresh assignments (``qat.update_qstate``).

λ and the learning-rate scale are read from the device's step counter
``opt["step"]`` as 0-d device tensors: a step queues its work without
waiting for the card.  The MoE bias balancing of the reference
(``update_moe_bias``) waits for the moe family (ROADMAP queue 1 item 8),
and a mesh for scale-out (queue 1 item 6).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from .. import tree
from ..core import qat
from . import adam
from .grad_compress import GradCompressCfg, compress_grads, init_error_state


def _f32(value, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(torch.float32)
    return torch.full((), value, dtype=torch.float32, device=device)


def make_train_step(loss_fn: Callable, adam_cfg: adam.AdamConfig, *,
                    lam=0.02, probs_momentum: float = 0.9,
                    lr_schedule: Optional[Callable] = None,
                    compress: Optional[GradCompressCfg] = None,
                    mesh=None) -> Callable:
    """Build the EC4T train step.

    ``loss_fn(params, qstate, batch, lam) -> (loss, metrics)``; ``lam`` a
    number or ``lam(step) -> λ``, ``lr_schedule(step) -> scale``, both of
    the device's int32 step counter.  Returns ``step(state, batch) ->
    (state, metrics)`` with ``state = {params, opt, qstate, err?}`` and
    every metric a 0-d tensor on the parameters' device."""
    if mesh is not None:
        raise NotImplementedError(
            "a train step over a mesh is not ported yet (ROADMAP queue 1 "
            "item 6, scale-out); pass mesh=None")

    def step(state: dict, batch: dict) -> tuple:
        p, opt, qs = state["params"], state["opt"], state["qstate"]
        lam_t = lam(opt["step"]) if callable(lam) else lam
        lr_scale = lr_schedule(opt["step"]) if lr_schedule else 1.0

        leaves = tree.leaves(p)
        train = [t.detach().requires_grad_() if t.is_floating_point()
                 else t for t in leaves]
        loss, metrics = loss_fn(tree.unflatten(p, train), qs, batch, lam_t)
        wants = [t for t in train if t.requires_grad]
        found = iter(torch.autograd.grad(loss, wants, allow_unused=True))
        grads = []
        for t in train:
            g = next(found) if t.requires_grad else None
            grads.append(torch.zeros_like(t) if g is None else g)
        grads = tree.unflatten(p, grads)

        err = state.get("err")
        if compress is not None and err is not None:
            grads, err = compress_grads(grads, err, compress)

        new_p, new_opt, opt_metrics = adam.apply(p, grads, opt, adam_cfg,
                                                 lr_scale=lr_scale)
        new_qs = qat.update_qstate(new_p, qs, lam_t, probs_momentum)

        dev = opt["step"].device
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics, lam=_f32(lam_t, dev),
                       lr_scale=_f32(lr_scale, dev))
        new_state = {"params": new_p, "opt": new_opt, "qstate": new_qs}
        if err is not None:
            new_state["err"] = err
        return new_state, metrics

    return step


def init_train_state(params: Any,
                     compress: Optional[GradCompressCfg] = None) -> dict:
    """``{params, opt, qstate}`` (+ ``err`` with ``compress``), on the
    parameters' device."""
    state = {"params": params, "opt": adam.init(params),
             "qstate": qat.build_qstate(params)}
    if compress is not None:
        state["err"] = init_error_state(params, compress)
    return state
