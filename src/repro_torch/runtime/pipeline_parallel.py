"""GPipe pipeline parallelism over a 'pipe' mesh axis (the JAX package's
``runtime/pipeline_parallel.py``).

The layer stack (L, ...) is split into ``S`` contiguous stages, one per
rank of the ``'pipe'`` axis (:func:`stage_split`).  :func:`pipeline_apply`
streams ``n_micro`` micro-batches through them on the reference's
rotating schedule: each of the ``n_micro + S - 1`` ticks, stage 0 takes
micro-batch t, every stage runs ``layer_fn`` on the activation it holds,
the last stage keeps micro-batch ``t - S + 1``, and a ``ppermute`` by +1
hands each stage's output to the next.  At the end one all-reduce of the
outputs masked to the last stage gives every rank the result.

The schedule is differentiable, with its backward written out: the
reverse ticks, each an inverse ``ppermute`` of the activations' gradients
and ``layer_fn``'s VJP from the graph its forward tick kept.  Autograd
alone would not do: it runs a node's backward only on the ranks whose
loss reaches it, and the stages differ there (stage 0 drops what it
receives while it takes fresh micro-batches), so the ranks' backward
collectives would not meet.  Here every rank runs every exchange of the
backward in the same order.  Bubble fraction: (S - 1) / (M + S - 1), the
GPipe formula.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from .. import tree


def stage_split(stacked_params: Any, n_stages: int) -> Any:
    """(L, ...) stacked layer params -> (S, L // S, ...) stage-major."""
    def f(leaf):
        n = leaf.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} "
                             "stages")
        return leaf.reshape(n_stages, n // n_stages, *leaf.shape[1:])
    return tree.map_(f, stacked_params)


def pipeline_apply(layer_fn: Callable, stage_params: Any, x: torch.Tensor,
                   *, mesh, n_micro: int, axis: str = "pipe"
                   ) -> torch.Tensor:
    """Run ``x`` (B, ...) through every stage with GPipe micro-batching;
    every rank returns the whole (B, ...) output.

    ``layer_fn(stage_params_local, micro_x) -> micro_y`` applies one
    stage's block of layers.  ``stage_params`` leaves are (S, L/S, ...),
    every stage's (each rank takes its own, ``[axis_index]``), or (1,
    L/S, ...), this rank's stage only.  ``x`` is the same on every rank;
    B must divide by ``n_micro``."""
    n_stages = mesh.axis_size(axis)
    stage = mesh.axis_index(axis)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         "micro-batches")

    def local(p):
        if p.shape[0] not in (1, n_stages):
            raise ValueError(f"stage params of {p.shape[0]} stages on a "
                             f"{n_stages}-stage '{axis}' axis")
        return p[stage] if p.shape[0] == n_stages else p[0]
    params = tree.map_(local, stage_params)
    micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    out = _GPipe.apply(layer_fn, params, mesh, axis, micro,
                       *tree.leaves(params))
    return out.reshape(b, *out.shape[2:])


class _GPipe(torch.autograd.Function):
    """The rotating schedule over ``micro`` (M, mb, ...) with the stage's
    parameter leaves as inputs; its backward the reverse schedule."""

    @staticmethod
    def forward(ctx, layer_fn, params, mesh, axis, micro, *leaves):
        n_stages, stage = mesh.axis_size(axis), mesh.axis_index(axis)
        n_micro = micro.shape[0]
        grad = any(ctx.needs_input_grad[4:])
        ps = [t.detach().requires_grad_(t.is_floating_point() and grad)
              for t in leaves]
        p_tree = tree.unflatten(params, ps)
        perm = tuple((i, (i + 1) % n_stages) for i in range(n_stages))
        last = stage == n_stages - 1
        buf = torch.zeros_like(micro[0])
        outs, ticks = [None] * n_micro, []
        for t in range(n_micro + n_stages - 1):
            if stage == 0 and t < n_micro:
                buf = micro[t]
            with torch.enable_grad():
                inp = buf.detach().requires_grad_(grad)
                y = layer_fn(p_tree, inp)
            ticks.append((inp, y))
            retire = t - (n_stages - 1)
            if last and retire >= 0:
                outs[retire] = y.detach()
            buf = mesh._permute(y.detach(), mesh._key(axis), perm)
        out = torch.stack(outs) if last else torch.zeros_like(micro)
        out = mesh._reduce(out, mesh._key(axis))
        ctx.mesh, ctx.axis, ctx.perm, ctx.ps = mesh, axis, perm, ps
        ctx.ticks = ticks if grad else None
        return out

    @staticmethod
    def backward(ctx, g_out):
        mesh, key = ctx.mesh, ctx.mesh._key(ctx.axis)
        n_stages, stage = mesh.axis_size(key), mesh.axis_index(key)
        ticks, ps = ctx.ticks, ctx.ps
        n_micro = len(ticks) - n_stages + 1
        inverse = tuple((d, s) for s, d in ctx.perm)
        g_out = mesh._reduce(g_out.contiguous(), key)
        wants = [p for p in ps if p.requires_grad]
        g_params = [torch.zeros_like(p) for p in wants]
        g_micro = torch.zeros_like(g_out)
        g_next = None        # the gradient of the next tick's input
        for t in reversed(range(len(ticks))):
            inp, y = ticks[t]
            # the gradient of this tick's output: what its ppermute sent
            # on (the last tick's output goes nowhere)
            g_y = torch.zeros_like(y) if g_next is None else \
                mesh._permute(g_next, key, inverse)
            retire = t - (n_stages - 1)
            if stage == n_stages - 1 and retire >= 0:
                g_y = g_y + g_out[retire]
            found = torch.autograd.grad(y, [inp] + wants, g_y,
                                        allow_unused=True)
            for i, g in enumerate(found[1:]):
                if g is not None:
                    g_params[i] += g
            g_inp = found[0] if found[0] is not None \
                else torch.zeros_like(inp)
            if stage == 0 and t < n_micro:
                g_micro[t] = g_inp       # the input was micro-batch t
                g_next = torch.zeros_like(g_inp)
            else:
                g_next = g_inp
        ctx.ticks = None
        found = iter(g_params)
        g_leaves = [next(found) if p.requires_grad else None for p in ps]
        return (None, None, None, None, g_micro, *g_leaves)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble: (S - 1) / (M + S - 1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
