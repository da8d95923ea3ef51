"""Rank bodies of the scale-out paths: what each rank of a
:class:`~repro_torch.launch.mesh.RankPool` runs.

They live in the package so that a spawned rank imports its target by
name.  Each takes numpy inputs, makes its tensors on its own device
(:func:`~repro_torch.launch.mesh.default_device`), builds its meshes with
:func:`~repro_torch.launch.mesh.make_mesh` (every rank asks for the same
meshes in the same order) and returns numpy results and counts; the
caller holds them against the single-device paths.  A counter is zeroed
just before the call it counts and read just after.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..convert import lm_tree_from_numpy, pack_from_numpy, take_experts
from ..core import qat
from ..kernels import ecl_quant as eq
from ..kernels import fantastic4_matmul as fm
from ..kernels import ops as kops
from ..models import lm as LM
from ..nn import moe as moe_lib
from ..nn import transformer as T
from ..nn.module import FP32_CTX
from ..serving import plans
from ..serving.sharded import ShardedStack
from .mesh import default_device, make_mesh


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms(fn, iters: int, dev: torch.device) -> float:
    """ms a call: CUDA events around ``iters`` calls on the card, the host
    clock on the CPU."""
    _sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        _sync(dev)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def chain(x: torch.Tensor, layers, act_dtype: str, act_scales,
          use_kernel: bool) -> torch.Tensor:
    """The unsharded per-layer chain (kernel 1, or the plain oracle)."""
    if act_dtype == "int8":
        return kops.fantastic4_mlp_chain_int8(x, layers, act_scales,
                                              use_kernel=use_kernel)
    return kops.fantastic4_mlp_chain(x, layers, use_kernel=use_kernel)


def sharded_mlp(layers: list, xs: Sequence[np.ndarray],
                mesh_shapes: Sequence[tuple], *, act_dtype: str = "float32",
                act_scales: Optional[list] = None, iters: int = 0) -> list:
    """A ``ShardedStack`` of the frozen pack ``layers`` (numpy, as
    ``freeze_mlp`` makes them) over each mesh shape, on each batch of
    ``xs``.  Per call: this rank's logits, its kernel-1 launches, whether
    they equal the unsharded per-layer chain on this rank bit for bit
    (kernel 1 on the card, its plain version on the CPU), the plain
    oracle's logits, and with ``iters`` the ms a served batch."""
    dev = default_device()
    pack = pack_from_numpy({"layers": layers}, device=dev)
    out = []
    for shape in mesh_shapes:
        mesh = make_mesh(shape, device=dev)
        stack = ShardedStack(pack, mesh, act_dtype=act_dtype,
                             act_scales=act_scales)
        calls = []
        for x_np in xs:
            x = torch.from_numpy(np.ascontiguousarray(x_np)).to(dev)
            _sync(dev)
            fm.LAUNCHES = 0
            y = stack(x)
            _sync(dev)
            launches = fm.LAUNCHES
            whole = chain(x, pack["layers"], act_dtype, act_scales, True)
            rec = {"rows": int(x.shape[0]), "y": y.cpu().numpy(),
                   "launches": launches,
                   "bitwise": bool(torch.equal(y, whole)),
                   "plain": chain(x, pack["layers"], act_dtype, act_scales,
                                  False).cpu().numpy()}
            if iters:
                stack(x)
                rec["ms"] = _ms(lambda: stack(x), iters, dev)
            calls.append(rec)
        out.append({"mesh": tuple(shape), "describe": stack.describe(),
                    "calls": calls})
    return out


def sharded_plan(layers: list, xs: Sequence[np.ndarray], mesh_shape: tuple,
                 *, act_dtype: str = "float32",
                 act_scales: Optional[list] = None) -> dict:
    """``ExecutionPlan(mode="sharded")`` of the frozen pack ``layers`` over
    the mesh, serving each batch of ``xs`` through ``plan.run`` (rows
    padded to their bucket, the bucket's rows split over 'data' when they
    divide it).  Per batch: this rank's logits, its bucket and path, and
    whether they equal the unsharded per-layer chain bit for bit."""
    dev = default_device()
    pack = pack_from_numpy({"layers": layers}, device=dev)
    mesh = make_mesh(mesh_shape, device=dev)
    calib = {"act_scales": act_scales} if act_dtype == "int8" else None
    plan = plans.build_plan(pack, mode="sharded", mesh=mesh,
                            act_dtype=act_dtype, calib=calib, device=dev)
    calls = []
    for x_np in xs:
        x = torch.from_numpy(np.ascontiguousarray(x_np)).to(dev)
        y = plan.run(x)
        m = int(x.shape[0])
        calls.append({
            "rows": m, "bucket": plan.bucket_for(m), "path": plan.path_for(m),
            "y": y.cpu().numpy(),
            "bitwise": bool(torch.equal(
                y, chain(x, pack["layers"], act_dtype, act_scales, True)))})
    return {"describe": plan.describe(), "calls": calls}


def launcher_shard(argv: Sequence[str]) -> str:
    """One rank of the launcher's ``--shard`` (``serve._shard_rank``) in
    this world; what it printed (rank 0 prints, the others nothing)."""
    from . import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve._shard_rank(list(argv))
    return buf.getvalue()


def _rows(x: torch.Tensor, mesh) -> torch.Tensor:
    rows = LM.batch_rows(mesh, x.shape[0])
    return x if rows is None else x[rows]


def _gather_rows(y: torch.Tensor, mesh, b: int) -> torch.Tensor:
    if LM.batch_rows(mesh, b) is None:
        return y
    return mesh.all_gather(y, mesh.data_axes, dim=0)


def moe_layer(p: dict, x: np.ndarray, mesh_shape: tuple, *, path: str,
              top_k: int, gate: str = "softmax",
              capacity_factor: float = 1.25, routed_scaling: float = 1.0,
              share: bool = False) -> dict:
    """One MoE layer over the mesh: ``p`` (numpy, ``moe_init``'s tree with
    whole banks; ``share`` cuts them to this rank's E/ep experts, as a
    layer built with ``experts_held`` holds them), ``x`` (n, d) the whole
    batch.  Each rank takes its rows over the data axes, runs ``path``
    (``"ep"``, ``"tp"`` or ``"ffn"``: the dispatcher), and the rows are
    gathered back.  Returns y, aux and the dispatcher's choice."""
    dev = default_device()
    mesh = make_mesh(mesh_shape, device=dev)
    tree = lm_tree_from_numpy(p, device=dev)
    choice = moe_lib.moe_path(tree, mesh)
    experts_held = None
    if share:
        per = tree["router"]["w"].shape[1] // mesh.shape["model"]
        experts_held = (mesh.coords["model"] * per, per)
        tree = take_experts(tree, *experts_held, axis=0)
    xt = _rows(torch.from_numpy(x).to(dev), mesh)
    kw = dict(mesh=mesh, top_k=top_k, gate=gate,
              capacity_factor=capacity_factor, routed_scaling=routed_scaling)
    if path == "ep":
        y, aux = moe_lib.moe_apply_ep(tree, 0, xt, FP32_CTX,
                                      experts_held=experts_held, **kw)
    elif path == "tp":
        y, aux = moe_lib.moe_apply_tp(tree, 0, xt, FP32_CTX, **kw)
    else:
        y, aux = moe_lib.moe_ffn(tree, 0, xt, FP32_CTX,
                                 experts_held=experts_held, **kw)
    return {"y": _gather_rows(y, mesh, x.shape[0]).cpu().numpy(),
            "aux": float(aux), "path": choice}


def lm_generate(cfg, frozen: dict, prompt: np.ndarray, max_new: int,
                mesh_shape: tuple, *, use_ep: bool = True) -> dict:
    """``generate(mesh=)`` on a frozen LM tree (numpy) and ``cfg``: every
    rank's tokens (each rank returns every row)."""
    dev = default_device()
    mesh = make_mesh(mesh_shape, device=dev)
    tree = lm_tree_from_numpy(frozen, device=dev)
    toks = LM.generate(tree, 0, torch.from_numpy(prompt).to(dev), FP32_CTX,
                       cfg, max_new=max_new, mesh=mesh, use_ep=use_ep)
    return {"tokens": toks.cpu().numpy()}


# ------------------------------------------------ expert-parallel shares

def seeded_banks(params: dict, cfg, experts: Sequence[int], seed: int,
                 device) -> dict:
    """``params`` (an ``lm_init`` tree) with every MoE layer's banks
    replaced by experts ``experts`` drawn one at a time, each from a
    generator of its own (seeded by ``seed``, the layer and the expert),
    uniform in ±1/√d as ``moe_init`` draws them: a whole model and each
    rank's share then hold the same experts bit for bit, which one
    generator drawing all banks in turn cannot give."""
    stack = params["stacks"].get("moe")
    if stack is None:
        return params
    n_layers = stack["moe"]["router"]["w"].shape[0]
    scale = cfg.d_model ** -0.5
    banks = {}
    for b, name in enumerate(("gate", "up", "down")):
        d_in, d_out = ((cfg.d_ff, cfg.d_model) if name == "down"
                       else (cfg.d_model, cfg.d_ff))
        w = torch.empty((n_layers, len(experts), d_in, d_out),
                        dtype=torch.float32, device=device)
        for l in range(n_layers):
            for j, e in enumerate(experts):
                g = torch.Generator(device=device).manual_seed(
                    seed + 1_000_003 * (1 + l) + 1_009 * e + b)
                torch.rand((d_in, d_out), generator=g, out=w[l, j])
                w[l, j].mul_(2 * scale).sub_(scale)
        banks[name] = qat.make_quant_param(w)
    stack["moe"]["experts"] = banks
    return params


def expert_share_cfg(cfg, mesh_shape: tuple, rank: int):
    """``cfg`` cut to rank ``rank``'s experts on a ('data', 'model') mesh
    of ``mesh_shape`` (experts over 'model')."""
    ep = mesh_shape[1]
    per = cfg.n_experts // ep
    return dataclasses.replace(cfg, experts_held=(rank % ep * per, per))


def frozen_segments(tree) -> int:
    """The ECL segments a freeze of ``tree`` assigns: one a frozen leaf,
    or one a leading index of an L-stacked or expert-banked leaf (its ω
    ``(*lead, 4)``)."""
    if isinstance(tree, dict):
        if "packed" in tree and "omega" in tree:
            return tree["omega"].numel() // 4
        return sum(frozen_segments(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(frozen_segments(v) for v in tree)
    return 0


def ep_serve(cfg, prompt: np.ndarray, max_new: int, mesh_shape: tuple, *,
             seed: int = 0, bank_seed: int = 0) -> dict:
    """One rank of a frozen 4-bit MoE LM served expert-parallel: init this
    rank's share (``experts_held``; the non-expert weights whole, the
    banks from :func:`seeded_banks`), freeze it (the ranks in turn, so
    one freeze's temporaries are on the card at a time; ecl_quant's
    launches and the segments they assigned counted), then
    ``generate(mesh=)`` over the prompt and one forward of prompt + tokens
    without a cache (logits).  Returns the tokens, the logits, the launch
    and segment counts, times and peak memory."""
    dev = default_device()
    mesh = make_mesh(mesh_shape, device=dev)
    share = expert_share_cfg(cfg, mesh_shape, mesh.rank)
    first, count = share.experts_held
    launches, ms = 0, {}
    frozen = None
    for turn in range(mesh.size):
        if turn == mesh.rank:
            params = T.lm_init(share, seed=seed, device=dev)
            seeded_banks(params, share, range(first, first + count),
                         bank_seed, dev)
            qs = qat.build_qstate(params)
            _sync(dev)
            t0 = time.perf_counter()
            eq.LAUNCHES = 0
            frozen = qat.freeze_tree(params, qs, share.lam)
            _sync(dev)
            launches = eq.LAUNCHES
            ms["freeze"] = (time.perf_counter() - t0) * 1e3
            del params, qs
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if dist.is_initialized():
            dist.barrier()
    tokens = torch.from_numpy(prompt).to(dev)
    t0 = time.perf_counter()
    gen = LM.generate(frozen, 0, tokens, FP32_CTX, share, max_new=max_new,
                      mesh=mesh)
    _sync(dev)
    ms["generate"] = (time.perf_counter() - t0) * 1e3
    full = torch.cat([tokens.to(torch.int32), gen], dim=1)
    logits, _, aux = T.lm_apply(frozen, 0, _rows(full, mesh), FP32_CTX,
                                share, mesh=mesh)
    logits = _gather_rows(logits, mesh, full.shape[0])
    out = {"tokens": gen.cpu().numpy(),
           "logits": logits[..., :cfg.vocab].cpu().numpy(),
           "aux": float(aux), "experts_held": (first, count),
           "ecl_quant_launches": launches,
           "ecl_segments": frozen_segments(frozen), "ms": ms}
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None)
    return out
