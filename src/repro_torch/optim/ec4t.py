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
waiting for the card.  A MoE arch's router ``bias_correction`` is
detached in the forward, so its gradient is zero and Adam leaves it bit
for bit as it was.  :func:`update_moe_bias` (deepseek-v3's aux-loss-free
balancing) is ported, and, as in the reference, not called by the step:
the reference's module docstring lists it as a fifth stage, but its step
does not run it (ROADMAP queue 3).  A mesh waits for scale-out (queue 1
item 6).
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
        grads = [next(found) if t.requires_grad else None for t in train]
        grads = tree.unflatten(p, [torch.zeros_like(t) if g is None else g
                                   for g, t in zip(grads, train)])
        del found, wants

        err = state.get("err")
        if compress is not None and err is not None:
            grads, err = compress_grads(grads, err, compress)

        new_p, new_opt, opt_metrics = adam.apply(p, grads, opt, adam_cfg,
                                                 lr_scale=lr_scale)
        del grads      # not needed by the probability update (1.6 GB for a
        # full-width expert bank)
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


def update_moe_bias(params: Any, load_frac: torch.Tensor, *,
                    gamma: float = 1e-3) -> Any:
    """deepseek-v3 aux-loss-free balancing: decrease the routing bias of
    overloaded experts, increase underloaded (sign update, rate γ).
    ``load_frac``: (E,) fraction of assignments per expert this step.
    Returns a new tree; every leaf but a ``router/bias_correction`` is
    kept (the reference's ``tree_map_with_path`` over the whole tree)."""
    return _nudge_bias(params, "", load_frac, gamma)


def _nudge_bias(node: Any, path: str, load_frac: torch.Tensor,
                gamma: float) -> Any:
    if isinstance(node, dict):
        return {k: _nudge_bias(v, f"{path}/{k}", load_frac, gamma)
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_nudge_bias(v, f"{path}/{i}", load_frac, gamma)
                          for i, v in enumerate(node))
    if path.endswith("router/bias_correction"):
        target = 1.0 / node.shape[-1]
        return node + gamma * torch.sign(target - load_frac)
    return node
