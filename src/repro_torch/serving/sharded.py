"""Column-sharded serving of one frozen pack over a ``('data', 'model')``
mesh: the port of the JAX package's ``serving/sharded.py``.

Each layer's packed (⌈K/2⌉, N) codes split over their output features on
the ``'model'`` axis (``runtime.sharding.serving_pack_specs``), so each
rank holds and decodes only its N/tp columns and runs kernel 1
(``matmul_kernel``) at (K, N/tp).  α₁ and b follow their layer's split;
ω and α₂ are replicated.  After each split layer one ``all_gather`` over
``'model'`` concatenates the column blocks in mesh order: there is no
reduction on this path.  Rows split over ``'data'`` when they divide it
and are replicated otherwise; the logits are gathered over ``'data'`` at
the end, so every rank returns every row.

Bit-exactness: the contraction dim is never split, every output column is
computed whole on one rank in the chain kernel's own order, and the
gather only re-concatenates, so the stack equals the per-layer chain
(``kernels.ops.fantastic4_mlp_chain`` / ``..._int8``) bit for bit; the
int8 requantisation is elementwise, so it runs in each rank's epilogue as
it does in the chain's.  A width that does not divide the model axis
(LeNet-300-100's 10 logits on 4 ranks) is computed whole on every rank.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..kernels import ops as kops
from ..runtime.sharding import Rules, serving_pack_specs, shard_slice


def _check_device(t: torch.Tensor, dev: torch.device, what: str) -> None:
    here = t.device
    if here.type == dev.type and (here.type != "cuda" or here.index == (
            torch.cuda.current_device() if dev.index is None else dev.index)):
        return
    raise ValueError(f"{what} lives on {here}, the mesh on {dev}: place "
                     "the pack and the batch on the mesh's device")


class ShardedStack:
    """One frozen pack bound to one mesh: this rank's operands cut once,
    at build.  Callable like a plan entry: ``stack(x) -> logits`` with
    ``x`` the whole batch (the same on every rank).  The pack and ``x``
    must live on the mesh's device: nothing is moved between the card and
    the host here.  Built by ``ExecutionPlan(mode="sharded")``."""

    def __init__(self, pack: dict, mesh, *, act_dtype: str = "float32",
                 act_scales: Optional[List[float]] = None,
                 use_kernel: bool = True):
        if "model" not in mesh.axis_names or "data" not in mesh.axis_names:
            raise ValueError(
                f"sharded serving needs a ('data', 'model') mesh; got axes "
                f"{tuple(mesh.axis_names)} (build one with "
                "launch.mesh.fit_mesh)")
        if act_dtype == "int8" and act_scales is None:
            raise ValueError("act_dtype='int8' requires act_scales")
        self.mesh = mesh
        self.layers = pack["layers"]
        self.act_dtype = act_dtype
        self.act_scales = list(act_scales) if act_scales else None
        self.use_kernel = use_kernel
        self.dp = mesh.shape["data"]
        self.tp = mesh.shape["model"]
        self.specs = serving_pack_specs(self.layers, Rules.for_mesh(mesh))
        self.col_sharded: Tuple[bool, ...] = tuple(
            s["packed"][1] is not None for s in self.specs)
        for i, layer in enumerate(self.layers):
            for name, t in layer.items():
                if isinstance(t, torch.Tensor):
                    _check_device(t, mesh.device, f"layer {i}'s {name}")
        self._operands = []
        for layer, spec in zip(self.layers, self.specs):
            def cut(name):
                t = layer.get(name)
                return None if t is None else shard_slice(
                    t, spec[name], mesh).contiguous()
            self._operands.append((
                cut("packed"), cut("omega"), cut("alpha1"), cut("bias"),
                layer.get("alpha2"),
                layer["shape"][0] % 2 == 1, layer.get("activation")))
        # the output columns a layer's gather moves to each rank
        self.gathered_bytes = [
            4 * (self.tp - 1) * (l["shape"][1] // self.tp) if c else 0
            for l, c in zip(self.layers, self.col_sharded)]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The per-layer chain with column-local matmuls and a gather
        after each split layer, mirroring ``fantastic4_mlp_chain`` /
        ``fantastic4_mlp_chain_int8`` expression for expression."""
        mesh = self.mesh
        if isinstance(x, torch.Tensor):
            _check_device(x, mesh.device, "x")
        x = torch.as_tensor(x, dtype=torch.float32, device=mesh.device)
        rows_split = x.shape[0] % self.dp == 0
        if rows_split:
            x = shard_slice(x, ("data", None), mesh)
        int8 = self.act_dtype == "int8"
        n = len(self._operands)
        in_scale = 1.0
        for i, (packed, omega, alpha1, bias, alpha2, odd_k, act) in \
                enumerate(self._operands):
            if odd_k:     # the pack carries one zero code row: mirror on x
                x = torch.nn.functional.pad(x, (0, 1))
            quant = int8 and i < n - 1
            x = kops.fantastic4_matmul(
                x, packed, omega, bias=bias,
                alpha1=alpha1 * in_scale if int8 and alpha1 is not None
                else alpha1,
                alpha2=None if int8 else alpha2, activation=act,
                use_kernel=self.use_kernel,
                quant_scale=self.act_scales[i] if quant else None)
            if self.col_sharded[i]:
                x = mesh.all_gather(x, "model", dim=1)
            if quant:
                in_scale = self.act_scales[i]
        if rows_split:
            x = mesh.all_gather(x, "data", dim=0)
        return x

    def describe(self) -> dict:
        return {
            "mesh": dict(self.mesh.shape),
            "n_devices": int(self.mesh.size),
            "col_sharded_layers": [i for i, c in enumerate(self.col_sharded)
                                   if c],
            "replicated_layers": [i for i, c in enumerate(self.col_sharded)
                                  if not c],
            "gathered_bytes_per_row": list(self.gathered_bytes),
            "collectives": ("staged through host buffers"
                            if self.mesh.stage_host else "in place"),
        }
