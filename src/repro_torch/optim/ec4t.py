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
does not run it (ROADMAP queue 3).

Over a mesh (``launch.mesh``; the reference's pjit step) each rank runs
the loss on its rows, whose value is the global loss on every rank (the
loss reduces its sums over the data axes), and seeds its backward with
1 / world; every exchange has its adjoint, so a leaf's gradient is the
sum of the ranks' gradients over the ranks that hold a copy of it
(``runtime.sharding.replica_axes``: the whole mesh, or the data axes for
an expert-parallel share's banks).  That sum is one all-reduce of a flat
buffer per replica group, or the int8 round trip of ``grad_compress``.
The clip's global norm is the whole model's: replicated leaves counted
once, a share's banks summed over the expert axis.  Every rank then takes
the same Adam step and probability update, so each replicated leaf
(params, m, v, probs) stays equal bit for bit across its group.  With
``zero1`` each rank keeps m and v for its block of each leaf
(``runtime.sharding.zero1_specs``).  Under the dense and moe families'
tensor-parallel layout a rank's leaf may be its block of the whole
(``specs``): its gradient is summed over the data axes only, ω's
(replicated, its gradient from a block partial, or zero for an expert
whose bank the rank does not hold) over every axis, and the probability
update sums each segment's mean(w²) and code counts over the 'model'
ranks (``qat.Shards``).  No exchange needs a Megatron
identity-backward operator: every rank's loss is the whole loss, its
backward seeded with 1 / world, and each exchange carries its exact
adjoint.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from .. import tree
from ..core import qat
from . import adam
from ..runtime.sharding import replica_axes, zero1_specs
from .grad_compress import (GradCompressCfg, compress_grads, init_error_state,
                            mesh_data_axes)


def _f32(value, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(torch.float32)
    return torch.full((), value, dtype=torch.float32, device=device)


def make_train_step(loss_fn: Callable, adam_cfg: adam.AdamConfig, *,
                    lam=0.02, probs_momentum: float = 0.9,
                    lr_schedule: Optional[Callable] = None,
                    compress: Optional[GradCompressCfg] = None,
                    mesh=None, zero1: bool = False,
                    specs: Any = None) -> Callable:
    """Build the EC4T train step.

    ``loss_fn(params, qstate, batch, lam) -> (loss, metrics)``; ``lam`` a
    number or ``lam(step) -> λ``, ``lr_schedule(step) -> scale``, both of
    the device's int32 step counter.  Returns ``step(state, batch) ->
    (state, metrics)`` with ``state = {params, opt, qstate, err?}`` and
    every metric a 0-d tensor on the parameters' device.  Over ``mesh``
    (the loss built for the same mesh) ``batch`` holds this rank's rows;
    ``zero1`` takes a state from :func:`init_train_state` with the same
    mesh.  ``specs``: the layout of the whole tree whose blocks this
    rank's params are (``runtime.sharding.layout_specs``; None: every
    leaf whole, or a share's banks): each leaf's replica axes, its ZeRO-1
    cut, and the axes its mean(w²) and code counts are summed over in the
    probability update (``qat.Shards``)."""
    if zero1 and mesh is None:
        raise ValueError("zero1 shards the moments over a mesh; pass mesh")
    if compress is not None and mesh is not None:
        mesh_data_axes(mesh, compress)          # an unknown axis raises

    def step(state: dict, batch: dict) -> tuple:
        p, opt, qs = state["params"], state["opt"], state["qstate"]
        lam_t = lam(opt["step"]) if callable(lam) else lam
        lr_scale = lr_schedule(opt["step"]) if lr_schedule else 1.0
        metrics, grads = local_grads(loss_fn, p, qs, batch, lam_t, mesh)

        err = state.get("err")
        axes = replica_axes(p, mesh, specs) if mesh is not None else None
        if compress is not None and err is not None:
            grads, err = compress_grads(grads, err, compress, mesh=mesh,
                                        axes=axes)
        elif mesh is not None:
            grads = reduce_grads(grads, axes, mesh)
        gnorm = global_norm(grads, axes, mesh) if mesh is not None else None

        new_p, new_opt, opt_metrics = adam.apply(
            p, grads, opt, adam_cfg, lr_scale=lr_scale, gnorm=gnorm,
            zero1=(mesh, zero1_specs(p, mesh, specs)) if zero1 else None)
        del grads      # not needed by the probability update (1.6 GB for a
        # full-width expert bank)
        new_qs = qat.update_qstate(
            new_p, qs, lam_t, probs_momentum,
            None if specs is None else qat.Shards(mesh, specs))

        dev = opt["step"].device
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics, lam=_f32(lam_t, dev),
                       lr_scale=_f32(lr_scale, dev))
        new_state = {"params": new_p, "opt": new_opt, "qstate": new_qs}
        if err is not None:
            new_state["err"] = err
        return new_state, metrics

    return step


def local_grads(loss_fn: Callable, params: Any, qstate: Any, batch: dict,
                lam, mesh=None) -> tuple:
    """(metrics, grads) of one forward and backward: the gradient of every
    floating leaf (zeros where the loss does not reach it).  Over ``mesh``
    this rank's part, its backward seeded with 1 / world: the sum over
    each leaf's replica axes (:func:`reduce_grads`) is the gradient."""
    train = [t.detach().requires_grad_() if t.is_floating_point() else t
             for t in tree.leaves(params)]
    loss, metrics = loss_fn(tree.unflatten(params, train), qstate, batch,
                            lam)
    wants = [t for t in train if t.requires_grad]
    found = iter(torch.autograd.grad(
        loss, wants, allow_unused=True,
        grad_outputs=None if mesh is None
        else torch.full_like(loss, 1.0 / mesh.size)))
    grads = [next(found) if t.requires_grad else None for t in train]
    grads = tree.unflatten(params, [torch.zeros_like(t) if g is None else g
                                    for g, t in zip(grads, train)])
    return metrics, grads


@torch.no_grad()
def reduce_grads(grads: Any, axes: Any, mesh) -> Any:
    """Each leaf's gradient summed over its replica ``axes``
    (``replica_axes``' tree of frozensets): one all-reduce of a flat fp32
    buffer per group of leaves with the same axes, in tree order."""
    flat, groups = tree.leaves(grads), {}
    for i, a in enumerate(tree.leaves(axes)):
        if a and mesh.axis_size(a) > 1:
            groups.setdefault(a, []).append(i)
    out = list(flat)
    for a, idx in groups.items():
        buf = mesh.all_reduce(torch.cat([flat[i].reshape(-1).to(
            torch.float32) for i in idx]), a)
        for i, part in zip(idx, buf.split([flat[i].numel() for i in idx])):
            out[i] = part.view(flat[i].shape).to(flat[i].dtype)
    return tree.unflatten(grads, out)


def global_norm(grads: Any, axes: Any, mesh) -> torch.Tensor:
    """The whole model's gradient norm over a mesh, from reduced grads: a
    leaf replicated over the whole mesh counted once; a leaf held by fewer
    ranks (a share's banks) summed over the axes it is not replicated
    over."""
    every = tuple(mesh.axis_names)
    local, held = [], {}
    for g, a in zip(tree.leaves(grads), tree.leaves(axes)):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        rest = tuple(x for x in every if x not in a)
        if rest and mesh.axis_size(rest) > 1:
            held.setdefault(rest, []).append(sq)
        else:
            local.append(sq)
    total = sum(local)
    for rest, sqs in held.items():
        total = total + mesh.all_reduce(sum(sqs), rest)
    return torch.sqrt(total)


def init_train_state(params: Any,
                     compress: Optional[GradCompressCfg] = None, *,
                     mesh=None, zero1: bool = False,
                     specs: Any = None) -> dict:
    """``{params, opt, qstate}`` (+ ``err`` with ``compress``), on the
    parameters' device; with ``zero1`` the moments of this rank's blocks
    over ``mesh`` (``specs`` as :func:`make_train_step` takes it)."""
    if zero1 and mesh is None:
        raise ValueError("zero1 shards the moments over a mesh; pass mesh")
    state = {"params": params,
             "opt": adam.init(params, (mesh, zero1_specs(params, mesh, specs))
                              if zero1 else None),
             "qstate": qat.build_qstate(params)}
    if compress is not None:
        state["err"] = init_error_state(params, compress, mesh=mesh,
                                        specs=specs)
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
