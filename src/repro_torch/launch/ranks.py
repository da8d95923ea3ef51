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
import json
import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..convert import (lm_tree_from_numpy, pack_from_numpy, take_experts,
                       tree_to_numpy)
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
    """``generate(mesh=)`` on a frozen LM tree (numpy, whole; this rank's
    blocks of it under the tensor-parallel layout) and ``cfg``: every
    rank's tokens (each rank returns every row)."""
    from ..convert import shard_from_numpy
    from ..runtime.sharding import layout_specs
    dev = default_device()
    mesh = make_mesh(mesh_shape, device=dev)
    tree = shard_from_numpy(frozen, layout_specs(frozen, cfg, mesh), mesh,
                            device=dev)
    toks = LM.generate(tree, 0, torch.from_numpy(prompt).to(dev), FP32_CTX,
                       cfg, max_new=max_new, mesh=mesh, use_ep=use_ep)
    return {"tokens": toks.cpu().numpy()}


# ------------------------------------------------ expert-parallel shares

def frozen_segments(tree) -> int:
    """The ECL segments a freeze of ``tree`` assigned: one a frozen leaf,
    or one a leading index of an L-stacked or expert-banked leaf's codes
    (a rank's bank block: its experts only, beside the layer's whole
    ω)."""
    if isinstance(tree, dict):
        if "packed" in tree and "omega" in tree:
            return math.prod(tree["packed"].shape[:-2])
        return sum(frozen_segments(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(frozen_segments(v) for v in tree)
    return 0


def ep_serve(cfg, prompt: np.ndarray, max_new: int, mesh_shape: tuple, *,
             seed: int = 0) -> dict:
    """One rank of a frozen 4-bit MoE LM served over a tensor-parallel
    mesh whose 'model' axis the experts divide: ``lm_init(cfg, seed,
    mesh=)`` (this rank's blocks: its E/tp experts, its heads, its block of
    the vocabulary), frozen (ecl_quant's launches and the segments they
    assigned counted), then ``generate(mesh=)`` over the prompt and one
    forward of prompt + tokens without a cache (logits gathered over
    'model').  Returns the tokens, the logits, the experts held, the
    launch and segment counts, times and peak memory."""
    dev = default_device()
    mesh = _tp_mesh(cfg, mesh_shape)
    per = cfg.n_experts // mesh.axis_size("model")
    first = mesh.axis_index("model") * per
    ms = {}
    params = T.lm_init(cfg, seed=seed, device=dev, mesh=mesh)
    qs = qat.build_qstate(params)
    _sync(dev)
    t0 = time.perf_counter()
    eq.LAUNCHES = 0
    frozen = qat.freeze_tree(params, qs, cfg.lam,
                             shards=qat.Shards(mesh, T.tp_specs(cfg, mesh)))
    _sync(dev)
    launches = eq.LAUNCHES
    ms["freeze"] = (time.perf_counter() - t0) * 1e3
    del params, qs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tokens = torch.from_numpy(prompt).to(dev)
    t0 = time.perf_counter()
    gen = LM.generate(frozen, 0, tokens, FP32_CTX, cfg, max_new=max_new,
                      mesh=mesh)
    _sync(dev)
    ms["generate"] = (time.perf_counter() - t0) * 1e3
    full = torch.cat([tokens.to(torch.int32), gen], dim=1)
    logits, _, aux = T.lm_apply(frozen, 0, _rows(full, mesh), FP32_CTX,
                                cfg, mesh=mesh)
    if logits.shape[-1] != cfg.padded_vocab:
        logits = mesh.all_gather(logits, "model", dim=-1)
    logits = _gather_rows(logits, mesh, full.shape[0])
    out = {"tokens": gen.cpu().numpy(),
           "logits": logits[..., :cfg.vocab].cpu().numpy(),
           "aux": float(aux), "experts_held": (first, per),
           "ecl_quant_launches": launches,
           "ecl_segments": frozen_segments(frozen), "ms": ms}
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None)
    return out


# -------------------------------------------------- training over a mesh

def collective_grads(xs: Sequence[np.ndarray], rs: Sequence[np.ndarray],
                     mesh_shape: tuple, exchange: str, **kw) -> dict:
    """One of the mesh's exchanges under autograd: rank r applies
    ``exchange`` (``all_gather``, ``all_to_all``, ``all_reduce`` or
    ``ppermute``, keywords ``kw``) to ``xs[r]`` and takes the gradient of
    ``Σ out·rs[r]`` (seeded 1: the gradient of the sum over the ranks).
    Returns this rank's output and gradient."""
    dev = default_device()
    mesh = make_mesh(mesh_shape, device=dev)
    x = torch.from_numpy(xs[mesh.rank]).to(dev).requires_grad_()
    out = getattr(mesh, exchange)(x, **kw)
    g, = torch.autograd.grad(
        torch.sum(out * torch.from_numpy(rs[mesh.rank]).to(dev)), x)
    return {"out": out.detach().cpu().numpy(), "grad": g.cpu().numpy(),
            "requires_grad": out.requires_grad}


def digest(t: torch.Tensor) -> tuple:
    """Two int64 sums over ``t``'s bits (plain and position-weighted):
    equal for bitwise equal tensors, a cheap proxy across processes."""
    return tuple(int(v) for v in _digest_parts(t))


def _digest_parts(t: torch.Tensor, spec: tuple = (), mesh=None
                  ) -> torch.Tensor:
    """:func:`digest` as an int64 tensor (2,); of a block of a larger
    tensor (this rank's under ``spec`` over ``mesh``) its share of the
    whole tensor's digest: each element weighted by its position in the
    whole, so that the shares' sums (mod 2**64) are the whole's digest."""
    views = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}
    x = t.detach()
    flat = x.reshape(-1).view(views[x.element_size()]).to(torch.int64)
    if not any(a is not None for a in spec):
        pos = torch.arange(flat.numel(), dtype=torch.int64, device=x.device)
    else:
        sizes = [n * (1 if a is None else mesh.axis_size(a))
                 for n, a in zip(x.shape, spec)]
        pos = torch.zeros((), dtype=torch.int64, device=x.device)
        stride = 1
        for d in reversed(range(x.ndim)):
            a = spec[d]
            first = 0 if a is None else mesh.axis_index(a) * x.shape[d]
            idx = torch.arange(first, first + x.shape[d], dtype=torch.int64,
                               device=x.device) * stride
            pos = pos + idx.view((-1,) + (1,) * (x.ndim - 1 - d))
            stride *= sizes[d]
        pos = pos.reshape(-1)
    pos = pos % 1_000_003 + 1
    return torch.stack([flat.sum(), (flat * pos).sum()])


def whole_digests(tree_, specs, mesh) -> dict:
    """:func:`digest` by leaf name of the whole tree whose blocks under
    ``specs`` (a tree like ``tree_``; None: every leaf whole) this rank
    holds, from each block's share summed over the axes it is cut over
    (one all-reduce of int64 a group of leaves cut alike): every rank
    gets the whole tree's digests without gathering it.  Collective."""
    from ..runtime.sharding import spec_axes
    from ..tree import map_
    if specs is None:
        return {n: digest(t) for n, t in named_leaves(tree_)}
    parts = named_leaves(map_(lambda t, sp: _digest_parts(t, sp, mesh),
                              tree_, specs))
    names, vals = [n for n, _ in parts], [v for _, v in parts]
    axes = [a for _, a in named_leaves(map_(lambda t, sp: spec_axes(sp),
                                            tree_, specs))]
    groups = {}
    for i, a in enumerate(axes):
        if a:
            groups.setdefault(tuple(x for x in mesh.axis_names if x in a),
                              []).append(i)
    for a, idx in groups.items():
        summed = mesh.all_reduce(torch.stack([vals[i] for i in idx]), a)
        for j, i in enumerate(idx):
            vals[i] = summed[j]
    return {n: tuple(int(x) for x in v) for n, v in zip(names, vals)}


def named_leaves(tree_, prefix: str = "") -> list:
    """(``/a/b`` name, leaf) in tree order (dict keys sorted)."""
    if isinstance(tree_, dict):
        return [kv for k in sorted(tree_)
                for kv in named_leaves(tree_[k], f"{prefix}/{k}")]
    if isinstance(tree_, (list, tuple)):
        return [kv for i, v in enumerate(tree_)
                for kv in named_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree_)]


def model_init(cfg):
    """``cfg``'s init: whisper's for the audio family, else ``lm_init``
    (both take ``mesh=``)."""
    if cfg.family == "audio":
        from ..models.whisper import whisper_init
        return whisper_init
    return T.lm_init


def _train_state0(cfg, dev, params, qstate, seed, mesh=None):
    """(params, qstate, layout): this rank's initial state from ``params``
    / ``qstate`` (numpy, whole) or ``cfg``'s init with ``seed``, cut to its
    blocks under the tensor-parallel layout (``layout`` then
    ``T.tp_specs``, else None)."""
    from ..core import qat as Q
    from ..runtime.sharding import qstate_layout, shard_tree
    specs = T.tp_specs(cfg, mesh)
    if params is None:
        p = model_init(cfg)(cfg, seed=seed, device=dev, mesh=mesh)
        return p, Q.build_qstate(p), specs
    p = lm_tree_from_numpy(params, device=dev)
    q = lm_tree_from_numpy(qstate, device=dev)
    if specs is not None:
        p = shard_tree(p, specs, mesh)
        q = shard_tree(q, qstate_layout(q, specs), mesh)
    return p, q, specs


def reduced_bytes(params, mesh, compress=None, specs=None) -> int:
    """Bytes one step all-reduces over ``mesh`` (each call's buffer once):
    fp32 sums, or with ``compress`` an eligible leaf's int32 codes (the
    int8 wire is int32, as the reference's psum) and its scale's max.
    ``params`` this rank's leaves, ``specs`` their layout."""
    from .. import tree
    from ..runtime.sharding import replica_axes
    total = 0
    for g, a in zip(tree.leaves(params), tree.leaves(replica_axes(
            params, mesh, specs))):
        if not a or mesh.axis_size(a) == 1:
            continue
        total += 4 * g.numel()
        if compress is not None and g.is_floating_point() \
                and g.numel() >= compress.min_size:
            total += 4
    return total


def whole_tree(tree_, specs, mesh):
    """``tree_`` (this rank's blocks of params-shaped leaves, under
    ``specs``; any tree when ``specs`` is None) gathered over 'model' into
    the whole tree (collective: every rank calls it)."""
    from ..runtime.sharding import gather_tree
    return tree_ if specs is None else gather_tree(tree_, specs, mesh)


def _int8_local_step(loss_fn, adam_cfg, lam, gcfg, mesh, specs):
    """The mesh's train step with its int8 gradients replaced by the
    single-device round trip (``compress_grads(mesh=None)``) of its exact
    gradient, each leaf whole: what the mesh's int8 path gives bit for bit
    when every data rank holds the same rows (each eligible leaf's
    ``n·h``, ``h`` summed over its other replica axes; an ineligible leaf
    summed exactly)."""
    from .. import tree
    from ..optim import adam, ec4t
    from ..optim.grad_compress import (compress_grads, mesh_data_axes,
                                       split_axes)
    from ..runtime.sharding import replica_axes, shard_tree
    data = mesh_data_axes(mesh, gcfg)

    def step(state, batch):
        p, qs = state["params"], state["qstate"]
        metrics, g = ec4t.local_grads(loss_fn, p, qs, batch, lam, mesh)
        axes = replica_axes(p, mesh, specs)

        @torch.no_grad()
        def exact(gl, e, a):
            d, o = split_axes(mesh, data, a)
            h = mesh.all_reduce(gl, o) if o else gl
            if e.ndim == 0:
                return mesh.all_reduce(h, d) if d else h
            return h * mesh.axis_size(d)
        g = tree.map_(exact, g, state["err"], axes)
        # the round trip of each whole leaf (its scale the whole tensor's),
        # then this rank's blocks of it
        cut = None if specs is None else tree.map_(
            lambda t, sp: sp if t.ndim else (), state["err"], specs)
        g, err = compress_grads(whole_tree(g, specs, mesh),
                                whole_tree(state["err"], cut, mesh), gcfg)
        if specs is not None:
            g, err = shard_tree(g, specs, mesh), shard_tree(err, cut, mesh)
        new_p, opt, om = adam.apply(p, g, state["opt"], adam_cfg,
                                    gnorm=ec4t.global_norm(g, axes, mesh))
        new_qs = qat.update_qstate(
            new_p, qs, lam, shards=None if specs is None
            else qat.Shards(mesh, specs))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(om)
        return {"params": new_p, "opt": opt, "qstate": new_qs,
                "err": err}, metrics
    return step


def probs_bitwise(params, before, after, specs, mesh, lam) -> bool:
    """Whether ``after``, this rank's probabilities after a step, is
    bitwise one process's ``update_qstate`` of the whole new ``params``
    (this rank's blocks under ``specs``) from ``before``: one quantized
    leaf gathered at a time (collective), so that a rank never holds the
    whole tree; a segment's update does not depend on the leaves assigned
    beside it."""
    ok = True

    def walk(node, qb, qa, spec):
        nonlocal ok
        if qat.is_quant_leaf(node):
            one = qat.update_qstate(whole_tree(node, spec, mesh), qb, lam)
            ok = ok and torch.equal(one["probs"], qa["probs"])
        elif isinstance(node, dict):
            for k in node:
                walk(node[k], qb[k], qa[k], None if spec is None
                     else spec[k])
    walk(params, before, after, specs)
    return ok


def dump(tree_, path: str) -> None:
    """Every leaf of ``tree_`` as ``path/<leaf name>.npy`` (a rank hands a
    full-width tree to its parent through files: a pipe is the slower
    way for gigabytes)."""
    os.makedirs(path, exist_ok=True)
    for name, t in named_leaves(tree_):
        np.save(os.path.join(path, name.strip("/").replace("/", ".")
                             + ".npy"), t.detach().cpu().numpy())


def dump_blocks(tree_, specs, mesh, path: str) -> None:
    """The whole of ``tree_`` (this rank's blocks under ``specs`` over
    ``mesh``, cut over 'model' only; None: whole leaves) for
    :func:`load_dump`: the ranks of data index 0 each write their blocks
    to ``path/part<model index>``, rank 0 the dim each leaf is cut on to
    ``path/cuts.json``; nothing is gathered.  Collective in effect: every
    rank calls it (the parent reads after all return)."""
    if specs is None:
        if mesh.rank == 0:
            dump(tree_, path)
        return
    data = mesh.data_axes
    if mesh.axis_size(data) > 1 and mesh.axis_index(data) != 0:
        return
    dump(tree_, os.path.join(path, f"part{mesh.axis_index('model')}"))
    if mesh.axis_index("model") == 0:
        from ..tree import map_
        cuts = dict(named_leaves(map_(
            lambda t, sp: next((d for d, a in enumerate(sp)
                                if a is not None), -1), tree_, specs)))
        with open(os.path.join(path, "cuts.json"), "w") as f:
            json.dump({"parts": mesh.axis_size("model"), "cuts": cuts}, f)


def block_errors(tree_, specs, mesh, path: str) -> dict:
    """This rank's blocks of ``tree_`` (a tree of dicts, under ``specs``;
    None: whole) against the same blocks of the whole reference that
    :func:`dump` wrote to ``path`` (each file read through a memory map,
    only the block): by leaf name, (max |got - want|, max |want|, max
    |got - want| / (1 + |want|)), the last ``assert_allclose``'s test at
    atol = rtol; the caller takes each one's max over the ranks."""
    from ..convert import shard_from_numpy
    out = {}

    @torch.no_grad()
    def walk(node, spec, name):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], None if spec is None else spec[k],
                     f"{name}/{k}")
            return
        want = np.load(os.path.join(path, name.strip("/").replace(
            "/", ".") + ".npy"), mmap_mode="r")
        w = shard_from_numpy(want, (None,) * node.ndim if spec is None
                             else spec, mesh, device=node.device)
        got, w = node.detach().to(torch.float32), w.to(torch.float32)
        diff = (got - w).abs()
        out[name] = (float(diff.max()), float(w.abs().max()),
                     float((diff / (1 + w.abs())).max()))
    walk(tree_, specs, "")
    return out


def load_dump(path: str) -> dict:
    """:func:`dump`'s leaves by name (``/a/b``); of a :func:`dump_blocks`
    directory the whole leaves, each put together from its parts."""
    def one(d):
        return {"/" + f[:-4].replace(".", "/"): np.load(os.path.join(d, f))
                for f in sorted(os.listdir(d)) if f.endswith(".npy")}
    meta = os.path.join(path, "cuts.json")
    if not os.path.exists(meta):
        return one(path)
    with open(meta) as f:
        info = json.load(f)
    parts = [one(os.path.join(path, f"part{i}"))
             for i in range(info["parts"])]
    out = {}
    for name, whole in parts[0].items():
        cut = info["cuts"][name]
        out[name] = np.concatenate([p[name] for p in parts], axis=cut) \
            if cut >= 0 else whole
    return out


def dp_train(cfg, mesh_shape: tuple, batches: Sequence[dict], *,
             runs: Sequence[dict] = ({},), params=None, qstate=None,
             seed: int = 0, lr: float = 1e-3, grads: bool = False,
             compress_check=None, out_dir: Optional[str] = None,
             ref: Optional[str] = None) -> dict:
    """One rank of EC4T training over the mesh: the state from ``params``
    / ``qstate`` (numpy) or ``cfg``'s init with ``seed`` on this rank's
    device (:func:`model_init`; its blocks under the tensor-parallel
    layout), this
    rank's rows of each global batch of ``batches`` through
    ``ShardedFeed(mesh=)``.

    ``grads``: the gradients at the initial state on ``batches[0]`` (fp32,
    summed over each leaf's replicas; rank 0 dumps them to
    ``out_dir/grads``, or with ``ref`` each rank holds its blocks to those
    of ``ref/grads``: ``grad_errors``, :func:`block_errors`).  ``compress_check``
    (``GradCompressCfg``): there also the int8 round trip of the same
    gradients, and the largest ``|deq - exact| / (s / 2)`` of any eligible
    leaf (``exact``: the mean of the data ranks' ``n·h + e``, ``e = 0``).
    ``runs``: each a dict of ``build_train_step`` keywords (``zero1``,
    ``compress``, ``remat``, ``use_ep``, ``dtype``) with ``steps`` (default
    all batches), ``batches`` (its own, else ``batches``), ``state``
    (rank 0 dumps the final params to ``out_dir/run<i>``; with ``ref``
    each rank holds its blocks to ``ref/params``: ``param_errors``) and
    ``int8_local`` (with ``compress``: the step whose int8 gradients are
    the single-device round trip of the exact ones,
    :func:`_int8_local_step`) and ``probs_check`` (``probs_bitwise``: the
    last step's probabilities equal one process's ``update_qstate`` of the
    whole new params), each from the initial state.  Per run:
    metrics a step, ecl_quant launches a step, ms a step, peak memory,
    the bytes all-reduced a step (``reduced_bytes``, and ``model_bytes``:
    over 'model', counted by the mesh), the digests of the final params,
    probabilities, error feedback (this rank's own) and moments (not with
    ZeRO-1), and ``block_digests``: those of the moments of this rank's
    ZeRO-1 blocks, whole moments cut or ZeRO-1's own.  Every digest and
    dump is of the whole tree (:func:`whole_digests`, :func:`dump_blocks`:
    a rank's blocks are the whole tree's, nothing gathered)."""
    from .. import tree
    from ..data.pipeline import ShardedFeed
    from ..optim import adam, ec4t
    from ..optim.grad_compress import (compress_grads, cut_axes,
                                       init_error_state, mesh_data_axes,
                                       split_axes)
    from ..runtime.sharding import (qstate_layout, replica_axes, shard_slice,
                                    zero1_specs)
    from . import steps as S
    dev = default_device()
    mesh = make_mesh(mesh_shape, device=dev)
    t0 = time.perf_counter()
    p0, q0, lay = _train_state0(cfg, dev, params, qstate, seed, mesh)
    out = {"rank": mesh.rank, "runs": [], "s": {},
           "layout": S.layout_name(cfg, mesh)}
    out["s"]["init"] = time.perf_counter() - t0
    if grads or compress_check is not None:
        t0 = time.perf_counter()
        feed = ShardedFeed(lambda s: batches[s], mesh=mesh)
        batch = next(feed)
        feed.close()
        loss_fn = S._loss_fn(cfg, mesh, remat="none", dtype=torch.float32)
        metrics, g = ec4t.local_grads(loss_fn, p0, q0, batch, cfg.lam, mesh)
        axes = replica_axes(p0, mesh, lay)
        exact = ec4t.reduce_grads(g, axes, mesh)
        out["grad_metrics"] = {k: float(v.detach())
                               for k, v in metrics.items()}
        out["grad_digests"] = whole_digests(exact, lay, mesh)
        if grads and ref is not None:
            out["grad_errors"] = block_errors(exact, lay, mesh,
                                              os.path.join(ref, "grads"))
        elif grads:
            dump_blocks(exact, lay, mesh, os.path.join(out_dir, "grads"))
        out["s"]["grads"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if compress_check is not None:
            err = init_error_state(g, compress_check, mesh=mesh, specs=lay)
            deq, _ = compress_grads(g, err, compress_check, mesh=mesh,
                                    axes=axes)
            data = mesh_data_axes(mesh, compress_check)
            worst = 0.0
            for gl, el, dl, xl, a in zip(*map(tree.leaves,
                                              (g, err, deq, exact, axes))):
                if el.ndim == 0:
                    continue
                # the shared scale; with e = 0 the exact mean of the data
                # ranks' n·h is the exact sum
                d, o = split_axes(mesh, data, a)
                h = mesh.all_reduce(gl, o) if o else gl
                with torch.no_grad():
                    amax = torch.max(torch.abs(h * mesh.axis_size(d)))
                    over = d + cut_axes(mesh, a)
                    if over:
                        amax = mesh.all_reduce(amax, over, op="max")
                half = (amax / 127.0 + 1e-12) / 2
                worst = max(worst, float(torch.max(torch.abs(dl - xl))
                                         / half))
            out["int8_err_over_half_scale"] = worst
            out["int8_digests"] = whole_digests(deq, lay, mesh)
            del deq, err
        del g, exact, metrics
        out["s"]["int8_check"] = time.perf_counter() - t0
    for i, spec in enumerate(runs):
        t_run = time.perf_counter()
        spec = dict(spec)
        data = spec.pop("batches", batches)
        n_steps = spec.pop("steps", len(data))
        keep = spec.pop("state", False)
        local_int8 = spec.pop("int8_local", False)
        probs_check = spec.pop("probs_check", False)
        zero1 = spec.get("zero1", False)
        kw = dict(remat="none", use_ep=True, zero1=False,
                  dtype=torch.float32)
        kw.update(spec)
        acfg = adam.AdamConfig(lr=lr)
        bundle = S.build_train_step(cfg, mesh, adam_cfg=acfg, **kw)
        step = bundle.fn
        if local_int8:
            step = _int8_local_step(
                S._loss_fn(cfg, mesh, kw["use_ep"], kw["remat"],
                           kw["dtype"]), acfg, cfg.lam, kw["compress"],
                mesh, lay)
        state = bundle.init_state(p0)
        state["qstate"] = q0
        feed = ShardedFeed(lambda s: data[s], mesh=mesh)
        rec = {"metrics": [], "ecl_launches": [], "ms": [],
               "model_bytes": []}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(n_steps):
            batch = next(feed)
            _sync(dev)
            if dist.is_initialized():
                dist.barrier()
            qs_before = state["qstate"]
            eq.LAUNCHES = 0
            traffic = dict(getattr(mesh, "traffic", {}))
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            _sync(dev)
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["ecl_launches"].append(eq.LAUNCHES)
            rec["model_bytes"].append(model_bytes(mesh, traffic))
            rec["metrics"].append({k: float(v) for k, v in metrics.items()})
        feed.close()
        rec["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else None)
        if probs_check:
            rec["probs_bitwise"] = probs_bitwise(
                state["params"], qs_before, state["qstate"], lay, mesh,
                cfg.lam)
        rec["reduced_bytes"] = reduced_bytes(p0, mesh, kw.get("compress"),
                                             lay)
        final = {"params": state["params"], "qstate": state["qstate"]}
        if "err" in state:
            final["err"] = state["err"]
        if not zero1:
            final["opt"] = {k: state["opt"][k] for k in ("m", "v")}
        fspecs = None if lay is None else {   # the probabilities whole
            k: qstate_layout(v, lay) if k == "qstate"
            else {"m": lay, "v": lay} if k == "opt"
            else tree.map_(lambda t, sp: sp if t.ndim else (), v, lay)
            for k, v in final.items()}
        rec["digests"] = whole_digests(final, fspecs, mesh)
        # the moments of this rank's ZeRO-1 blocks, either way
        specs = zero1_specs(p0, mesh, lay)
        rec["block_digests"] = {n: digest(t) for n, t in named_leaves({
            k: state["opt"][k] if zero1 else tree.map_(
                lambda t, spec: shard_slice(t, spec, mesh),
                state["opt"][k], specs) for k in ("m", "v")})}
        if keep and ref is not None:
            rec["param_errors"] = block_errors(
                final["params"], lay, mesh, os.path.join(ref, "params"))
        elif keep:
            dump_blocks(final["params"], lay, mesh,
                        os.path.join(out_dir, f"run{i}"))
        del state, final
        rec["s"] = time.perf_counter() - t_run
        out["runs"].append(rec)
    del p0, q0
    if dev.type == "cuda":      # the next task's ranks get the card back
        torch.cuda.empty_cache()
    return out


def model_bytes(mesh, before: dict) -> int:
    """Bytes this rank's mesh sent into all-reduces over 'model' since
    ``before`` (a copy of ``mesh.traffic``)."""
    traffic = getattr(mesh, "traffic", {})
    key = ("all-reduce", ("model",))
    return traffic.get(key, 0) - before.get(key, 0)


def int8_feedback(shape: tuple, steps: int, seed: int, mesh_shape: tuple,
                  min_size: int = 16) -> dict:
    """``steps`` int8 round trips of distinct per-rank gradients (normal,
    from ``seed`` and the rank) through ``compress_grads(mesh=)`` with
    this rank's error feedback: the sum of the applied gradients, the sum
    of the exact ones (the mean of the data ranks' ``n·g``) and each
    step's shared scale."""
    from ..optim.grad_compress import (GradCompressCfg, compress_grads,
                                       init_error_state)
    dev = default_device()
    mesh = make_mesh(mesh_shape, device=dev)
    cfg = GradCompressCfg(min_size=min_size)
    n = mesh.axis_size(mesh.data_axes)
    rng = np.random.default_rng([seed, mesh.axis_index(mesh.data_axes)])
    err = init_error_state({"w": torch.zeros(shape, device=dev)}, cfg)
    applied = torch.zeros(shape, dtype=torch.float64, device=dev)
    exact = torch.zeros(shape, dtype=torch.float64, device=dev)
    scales = []
    axes = {"w": frozenset(mesh.data_axes)}
    for _ in range(steps):
        g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                             ).to(dev) / n
        gf = g * n + err["w"]
        with torch.no_grad():
            s = mesh.all_reduce(torch.max(torch.abs(gf)), mesh.data_axes,
                                op="max") / 127.0 + 1e-12
        scales.append(float(s))
        out, err = compress_grads({"w": g}, err, cfg, mesh=mesh, axes=axes)
        applied += out["w"].to(torch.float64)
        exact += mesh.all_reduce(g.to(torch.float64), mesh.data_axes)
    return {"applied": applied.cpu().numpy(), "exact": exact.cpu().numpy(),
            "scales": scales, "err_max": float(torch.max(torch.abs(
                err["w"])))}


def rank_rows(batch: dict, mesh_shape: tuple) -> dict:
    """This rank's rows of ``batch`` as ``ShardedFeed(mesh=)`` places
    them, or the ``ValueError`` it raises (its message)."""
    from ..data.pipeline import ShardedFeed
    mesh = make_mesh(mesh_shape, device=default_device())
    feed = ShardedFeed(lambda s: batch, mesh=mesh)
    try:
        return {k: v.cpu().numpy() for k, v in next(feed).items()}
    except ValueError as e:
        return {"error": str(e)}
    finally:
        feed.close()


def _moe_objective(p, x, r, mesh, *, path, coef, **kw):
    """``Σ y·r`` over the whole batch + ``coef``·aux on every rank, from
    this rank's rows ``x`` of it through ``path``."""
    if path == "ep":
        y, aux = moe_lib.moe_apply_ep(p, 0, x, FP32_CTX, mesh=mesh, **kw)
    elif path == "tp":
        kw.pop("experts_held", None)
        y, aux = moe_lib.moe_apply_tp(p, 0, x, FP32_CTX, mesh=mesh, **kw)
    else:
        y, aux = moe_lib.moe_ffn(p, 0, x, FP32_CTX, mesh=mesh, **kw)
    num = torch.sum(y * r)
    num = mesh.all_reduce(num, mesh.data_axes)
    return num + coef * aux, aux


def moe_single_grads(p: dict, x: np.ndarray, r: np.ndarray, *, blocks: int,
                     top_k: int, gate: str = "softmax",
                     capacity_factor: float = 1.25,
                     routed_scaling: float = 1.0, coef: float = 0.01,
                     device=None) -> tuple:
    """:func:`ep_train`'s objective on one device: ``moe_apply`` over the
    whole batch, the aux the mean of ``route``'s over the ``blocks`` token
    blocks the mesh's ranks route.  Returns (objective, the tokens'
    gradient, the parameters' gradients), numpy."""
    from .. import tree
    tp = lm_tree_from_numpy(p, device=device)
    leaves = [t.detach().requires_grad_() for t in tree.leaves(tp)]
    pt = tree.unflatten(tp, leaves)
    xt = torch.from_numpy(x).to(leaves[0].device).requires_grad_()
    y, _ = moe_lib.moe_apply(pt, 0, xt, FP32_CTX, top_k=top_k, gate=gate,
                             capacity_factor=capacity_factor,
                             routed_scaling=routed_scaling)
    pad = (-x.shape[0]) % blocks
    xp = torch.cat([xt, xt.new_zeros((pad, x.shape[1]))])
    aux = sum(moe_lib.route(b @ pt["router"]["w"],
                            pt["router"]["bias_correction"], top_k=top_k,
                            gate=gate, routed_scaling=routed_scaling)[2]
              for b in xp.chunk(blocks)) / blocks
    obj = torch.sum(y * torch.from_numpy(r).to(xt.device)) + coef * aux
    found = torch.autograd.grad(obj, [xt] + leaves, allow_unused=True)
    found = [torch.zeros_like(t) if g is None else g
             for g, t in zip(found, [xt] + leaves)]
    return (float(obj.detach()), found[0].cpu().numpy(),
            tree_to_numpy(tree.unflatten(tp, found[1:])))


def ep_train(p: dict, x: np.ndarray, r: np.ndarray, mesh_shape: tuple, *,
             path: str, top_k: int, gate: str = "softmax",
             capacity_factor: float = 1.25, routed_scaling: float = 1.0,
             coef: float = 0.01, share: bool = False,
             remats: Sequence[str] = ("none", "full")) -> dict:
    """One MoE layer over the mesh under grad: ``p`` (numpy,
    ``moe_init``'s tree, whole banks; ``share`` cuts them to this rank's
    E/ep experts), ``x`` (n, d) the whole batch, ``r`` (n, d) the
    objective's weights.  Each rank takes its rows, runs ``path`` and the
    objective ``Σ y·r + coef·aux`` (whole batch), seeds its backward with
    1 / world and sums each gradient over the ranks that hold a copy of
    it (the router, the shared expert and whole banks: the mesh; a
    share's banks: the data axes; its rows of ``x``: the 'model' axis,
    then gathered).  Once per ``remats`` entry (``full`` checkpoints the
    layer: its forward, exchanges included, runs again in the backward);
    the gradients of each are held bitwise to the first's.  Returns the
    objective, aux, the dispatcher's choice and the first run's
    gradients."""
    from torch.utils.checkpoint import checkpoint
    from .. import tree
    from ..optim import ec4t
    from ..runtime.sharding import replica_axes
    dev = default_device()
    mesh = make_mesh(mesh_shape, device=dev)
    whole = lm_tree_from_numpy(p, device=dev)
    kw = dict(top_k=top_k, gate=gate, capacity_factor=capacity_factor,
              routed_scaling=routed_scaling)
    tree_ = whole
    if share:
        per = whole["router"]["w"].shape[1] // mesh.shape["model"]
        kw["experts_held"] = (mesh.coords["model"] * per, per)
        tree_ = take_experts(whole, *kw["experts_held"], axis=0)
    rows = _rows(torch.from_numpy(x).to(dev), mesh)
    r_rows = _rows(torch.from_numpy(r).to(dev), mesh)
    axes = replica_axes({"moe": tree_}, mesh)["moe"]
    first, same = None, True
    for remat in remats:
        leaves = [t.detach().requires_grad_() for t in tree.leaves(tree_)]
        xt = rows.detach().requires_grad_()
        fn = lambda *a: _moe_objective(tree.unflatten(tree_, a[1:]), a[0],
                                       r_rows, mesh, path=path, coef=coef,
                                       **dict(kw))
        if remat == "full":
            obj, aux = checkpoint(fn, xt, *leaves, use_reentrant=False)
        else:
            obj, aux = fn(xt, *leaves)
        found = torch.autograd.grad(obj, [xt] + leaves,
                                    torch.full_like(obj, 1.0 / mesh.size),
                                    allow_unused=True)
        g = ec4t.reduce_grads(tree.unflatten(tree_, [
            torch.zeros_like(t) if f is None else f
            for f, t in zip(found[1:], leaves)]), axes, mesh)
        gx = mesh.all_reduce(found[0], "model") \
            if "model" in mesh.axis_names else found[0]
        gx = _gather_rows(gx, mesh, x.shape[0])
        got = {"obj": obj.detach(), "aux": aux.detach(), "x": gx, "p": g}
        if first is None:
            first = got
        else:
            same = same and all(torch.equal(a, b) for a, b in zip(
                tree.leaves(first), tree.leaves(got)))
    return {"obj": float(first["obj"]), "aux": float(first["aux"]),
            "path": moe_lib.moe_path(whole, mesh),
            "experts_held": kw.get("experts_held"),
            "grads": tree_to_numpy({"x": first["x"], "p": first["p"]}),
            "remat_bitwise": same}


def _tanh_stack(ws: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The reference test's layer body: ``x = tanh(x @ w)`` over the
    stage's (L/S, d, d) weights."""
    for w in ws.unbind(0):
        x = torch.tanh(x @ w)
    return x


def pp_apply(ws: np.ndarray, x: np.ndarray, r: np.ndarray, *,
             n_micro: Sequence[int], iters: int = 0) -> list:
    """``pipeline_apply`` of the tanh stack ``ws`` (L, d, d) over a
    ('pipe',) mesh of the world, for each micro-batch count: every rank's
    output, the objective ``Σ out·r``'s gradients (seeded 1 / world: this
    rank's stage block of ``ws``, and ``x``'s summed over the ranks), the
    ticks and, with ``iters``, ms a forward and backward."""
    from ..runtime import pipeline_parallel as pp
    dev = default_device()
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh((world,), ("pipe",), device=dev)
    stage = mesh.axis_index("pipe")
    w = torch.from_numpy(ws).to(dev)
    xt = torch.from_numpy(x).to(dev)
    rt = torch.from_numpy(r).to(dev)
    out = []
    for m in n_micro:
        def run():
            sw = pp.stage_split(w, world).detach().requires_grad_()
            xi = xt.detach().requires_grad_()
            y = pp.pipeline_apply(_tanh_stack, sw, xi, mesh=mesh,
                                  n_micro=m)
            gw, gx = torch.autograd.grad(torch.sum(y * rt), (sw, xi),
                                         torch.full((), 1.0 / world,
                                                    device=dev))
            return y, gw, mesh.all_reduce(gx, "pipe")
        y, gw, gx = run()
        rec = {"n_micro": m, "ticks": m + world - 1,
               "bubble": pp.bubble_fraction(world, m),
               "y": y.detach().cpu().numpy(),
               "stage_grad": gw[stage].cpu().numpy(),
               "x_grad": gx.cpu().numpy()}
        if iters:
            rec["ms"] = _ms(run, iters, dev)
        out.append(rec)
    return out


# ------------------------------------------------ tensor parallelism

def _tp_mesh(cfg, mesh_shape: tuple):
    from ..runtime.sharding import tensor_parallel
    mesh = make_mesh(mesh_shape, device=default_device())
    if not tensor_parallel(cfg, mesh):
        raise ValueError(f"{cfg.name} over {mesh_shape} is not tensor "
                         "parallel")
    return mesh


def _gather_vocab(logits: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """``logits`` whole over the vocabulary: a rank's block gathered over
    'model'."""
    if logits.shape[-1] == cfg.padded_vocab:
        return logits
    return mesh.all_gather(logits, "model", dim=-1)


def tp_forward(cfg, params, tokens: np.ndarray, mesh_shape: tuple, *,
               embeds: Optional[np.ndarray] = None) -> dict:
    """``lm_apply`` in fp32 of this rank's part of ``params`` (a whole
    numpy tree, cut to the rank's blocks by ``convert.shard_from_numpy``
    under the port's layout) on every row of ``tokens`` (or ``embeds``):
    the logits gathered over 'model' where they are a vocabulary block
    (numpy), whether the attention ran sequence-parallel, how the layout
    cut the expert banks (``ModelTP.experts``) and the SSD blocks
    (:func:`ssm_mode`)."""
    from ..convert import shard_from_numpy
    from ..runtime.sharding import layout_specs, model_tp
    mesh = make_mesh(mesh_shape, device=default_device())
    p = shard_from_numpy(params, layout_specs(params, cfg, mesh), mesh,
                         device=mesh.device)
    x = tokens if embeds is None else embeds
    on = lambda a: None if a is None else torch.from_numpy(a).to(mesh.device)
    with torch.no_grad():
        logits, _, _ = T.lm_apply(p, 0, on(tokens), FP32_CTX, cfg,
                                  embeds=on(embeds), mesh=mesh)
        whole = _gather_vocab(logits, cfg, mesh)
    tp = model_tp(cfg, mesh)
    return {"logits": whole.cpu().numpy(),
            "local_vocab": int(logits.shape[-1]),
            "reshard": T._attn_batch_reshard(cfg, mesh, x.shape[1]),
            "experts": tp.experts if tp is not None else None,
            "ssm": ssm_mode(tp)}


def ssm_mode(tp) -> Optional[str]:
    """How the layout ``tp`` (``runtime.sharding.ModelTP``, or None) cuts
    an SSD block: ``"heads"`` (the state and the scan by heads),
    ``"rows"`` (only the projections' rows: the scan whole on each rank)
    or None (whole)."""
    if tp is None or not (tp.ssm_in or tp.ssm_out):
        return None
    return "heads" if tp.ssm_heads else "rows"


def tp_serve(cfg, frozen, prompt: np.ndarray, max_new: int,
             mesh_shape: tuple) -> dict:
    """Greedy generation over the mesh from this rank's blocks of the
    frozen tree ``frozen`` (whole, numpy) in fp32 (:func:`serve_timed` on
    this rank's rows): every row's tokens (gathered over the data axes),
    ``generate(mesh=)``'s, and this rank's final cache (numpy)."""
    from ..convert import shard_from_numpy
    from ..runtime.sharding import layout_specs
    mesh = _tp_mesh(cfg, mesh_shape)
    p = shard_from_numpy(frozen, layout_specs(frozen, cfg, mesh), mesh,
                         device=mesh.device)
    whole = torch.from_numpy(prompt).to(mesh.device)
    rows = LM.batch_rows(mesh, whole.shape[0])
    out, cache = serve_timed(p, whole if rows is None else whole[rows], cfg,
                             FP32_CTX, max_new, 1, mesh)
    toks = torch.from_numpy(out["tokens"]).to(mesh.device)
    if rows is not None:
        toks = mesh.all_gather(toks, mesh.data_axes, dim=0)
    gen = LM.generate(p, 0, whole, FP32_CTX, cfg, max_new=max_new,
                      mesh=mesh)
    return {"tokens": toks.cpu().numpy(), "generate": gen.cpu().numpy(),
            "cache": tree_to_numpy(cache), "coords": dict(mesh.coords)}


def tp_blocks(cfg, seed: int, mesh_shape: tuple) -> dict:
    """What this rank holds of ``cfg``'s init with ``seed`` and ``mesh=``
    (``lm_init``, or ``whisper_init`` for audio) and of its ZeRO-1 train
    state: each leaf's name, shape and values (numpy), its Adam moments'
    shapes, and its blocks frozen (numpy)."""
    from . import steps as S
    mesh = _tp_mesh(cfg, mesh_shape)
    p = model_init(cfg)(cfg, seed=seed, device=mesh.device, mesh=mesh)
    state = S.build_train_step(cfg, mesh, remat="none").init_state(p)
    frozen = qat.freeze_tree(p, state["qstate"], cfg.lam,
                             shards=qat.Shards(mesh, T.tp_specs(cfg, mesh)))
    return {"params": {n: t.cpu().numpy() for n, t in named_leaves(p)},
            "m": {n: tuple(t.shape)
                  for n, t in named_leaves(state["opt"]["m"])},
            "frozen": tree_to_numpy(frozen), "coords": dict(mesh.coords)}


def row_parallel_linear(x: np.ndarray, w: np.ndarray, b: np.ndarray,
                        mesh_shape: tuple) -> dict:
    """``nn.layers.linear_row_parallel`` of this rank's rows of ``w`` (its
    block of ``x``'s columns) with the replicated bias ``b``: the summed
    output (numpy)."""
    from ..nn.layers import linear_row_parallel
    mesh = make_mesh(mesh_shape, device=default_device())
    n = w.shape[0] // mesh.axis_size("model")
    i = mesh.axis_index("model")
    p = {"kernel": torch.from_numpy(w[i * n:(i + 1) * n].copy()),
         "bias": torch.from_numpy(b)}
    y = linear_row_parallel(p, 0, torch.from_numpy(
        x[..., i * n:(i + 1) * n].copy()), FP32_CTX, mesh)
    return {"y": y.numpy()}


def serve_timed(params, prompt: Optional[torch.Tensor], cfg, ctx,
                max_new: int, tail: int, mesh=None,
                embeds: Optional[torch.Tensor] = None) -> dict:
    """Greedy generation as ``models.lm.generate`` runs it (this rank's
    rows and, under the tensor-parallel layout, its blocks and KV heads),
    from the ``prompt`` tokens or the stubbed frontend's ``embeds`` (B, S,
    d; the prefill's input, the greedy tokens then looked up as a vlm's
    text), timed on the host clock (synchronised): the tokens (B,
    max_new), the prefill's last ``tail`` positions' logits (gathered over
    'model'; numpy), prefill ms, each decode step's ms and the cache's
    bytes (K and V, or MLA's latent and rope key; the SSM states and conv
    tails apart); and the final cache."""
    first = prompt if embeds is None else embeds
    dev = first.device
    b, s = first.shape[:2]
    cache = T.init_cache(cfg, b, s + max_new, dtype=torch.float32,
                         device=dev, mesh=mesh)

    def nbytes(*ends):
        return sum(t.numel() * t.element_size()
                   for n, t in named_leaves(cache) if n.endswith(ends))
    kv = nbytes("/k", "/v", "/ckv", "/krope")
    ssm = {"ssm_state_bytes": nbytes("/ssm/ssm"),
           "conv_tail_bytes": nbytes("/ssm/conv")}
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache, _ = T.lm_apply(params, 0, prompt, ctx, cfg,
                                      embeds=embeds, positions=pos,
                                      cache=cache, mesh=mesh)
        nxt = LM.next_token(logits, cfg, mesh)
        _sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        last = _gather_vocab(logits[:, -tail:], cfg, mesh)
        out, steps = [nxt], []
        for t in range(max_new - 1):
            p_t = torch.full((b, 1), s + t, dtype=torch.int32, device=dev)
            _sync(dev)
            t0 = time.perf_counter()
            nxt, cache = LM.greedy_step(params, 0, nxt, ctx, cfg,
                                        positions=p_t, cache=cache,
                                        mesh=mesh)
            _sync(dev)
            steps.append((time.perf_counter() - t0) * 1e3)
            out.append(nxt)
    return {"tokens": torch.cat(out, dim=1).cpu().numpy(),
            "tail_logits": last[..., :cfg.vocab].cpu().numpy(),
            "prefill_ms": prefill_ms, "decode_ms": steps,
            "kv_cache_bytes": kv, **ssm}, cache


def tp_serve_card(cfg, mesh_shape: tuple, seed: int,
                  prompt: Optional[np.ndarray], max_new: int, tail: int,
                  embeds: Optional[np.ndarray] = None) -> dict:
    """One tensor-parallel rank's serving path: its frozen blocks of
    ``lm_init(cfg, seed, mesh=)`` (:func:`_tp_frozen`), then
    :func:`serve_timed` in fp32 on every prompt row (or every row of the
    stubbed frontend's ``embeds``, whole on each rank).  Returns the frozen
    blocks' digests by leaf name, the freeze's ms and ecl_quant launches
    (zeroed just before, read just after), the serve's results, for MLA
    the absorbed decode's distance from the naive form on this rank
    (:func:`mla_forms`), and the rank's peak memory."""
    dev = default_device()
    mesh = _tp_mesh(cfg, mesh_shape)
    frozen, out = _tp_frozen(cfg, mesh, seed)
    on = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    served, cache = serve_timed(frozen, on(prompt), cfg, FP32_CTX, max_new,
                                tail, mesh, embeds=on(embeds))
    out.update(served)
    if cfg.mla is not None:
        out["mla_forms_rel"] = mla_forms(cfg, frozen, cache, mesh, seed)
    del cache
    _tp_record(out, frozen, mesh)
    del frozen
    _release(dev)
    return out


def _tp_frozen(cfg, mesh, seed: int) -> tuple:
    """A tensor-parallel rank's frozen blocks: ``cfg``'s init with
    ``seed`` and ``mesh=`` (its blocks, the whole tree never held), frozen
    (the probabilities' and mean(w²)'s sums over 'model'), the peak
    memory counted from before the init.  Returns (frozen, a record of
    the init's seconds, the freeze's ms and its ecl_quant launches, zeroed
    just before it and read just after)."""
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    p = model_init(cfg)(cfg, seed=seed, device=dev, mesh=mesh)
    qs = qat.build_qstate(p)
    _sync(dev)
    init_s = time.perf_counter() - t0
    shards = qat.Shards(mesh, T.tp_specs(cfg, mesh))
    eq.LAUNCHES = 0
    t0 = time.perf_counter()
    frozen = qat.freeze_tree(p, qs, cfg.lam, shards=shards)
    _sync(dev)
    freeze_ms = (time.perf_counter() - t0) * 1e3
    launches = eq.LAUNCHES
    del p, qs
    return frozen, {"init_s": init_s, "freeze_ms": freeze_ms,
                    "freeze_launches": launches}


def _tp_record(out: dict, frozen, mesh) -> None:
    """Add the frozen blocks' digests by leaf name, the rank's coordinates
    and its peak memory to ``out``."""
    dev = mesh.device
    out.update(digests={n: digest(t) for n, t in named_leaves(frozen)},
               coords=dict(mesh.coords),
               peak_bytes=(torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None))


def _release(dev: torch.device) -> None:
    """Give the card's cached blocks back (the next task's ranks share
    it)."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()


@torch.no_grad()
def mla_forms(cfg, params, cache, mesh=None, seed: int = 0) -> float:
    """Layer 0's MLA block on one new token (normal, from ``seed``) at the
    next position of its served ``cache``, this rank's part (its heads,
    the latent whole) in the absorbed and in the naive form: the largest
    difference of the outputs over the naive output's largest value."""
    from ..nn import attention as A
    from ..nn.layers import rope_cos_sin
    from ..runtime.sharding import model_tp
    kind = next(iter(cache))
    lp = T._layer(params["stacks"][kind], 0)["attn"]
    lc = T._layer(cache[kind], 0)["attn"]
    dev = lc["ckv"].device
    b = lc["ckv"].shape[0]
    tp = model_tp(cfg, mesh)
    atp = None if tp is None else A.AttnTP(
        mesh, heads=tp.heads, o_rows=tp.o_rows, q_down=tp.q_down,
        kv_down=tp.kv_down)
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((b, 1, cfg.d_model), generator=g, device=dev)
    pos = lc["len"].to(torch.int32).expand(b, 1).contiguous()
    cos_sin = rope_cos_sin(pos, cfg.mla.qk_rope_dim, cfg.rope_theta)
    ys = [A.mla_apply(lp, 0, h, FP32_CTX, T._mla_cfg(cfg), cos_sin=cos_sin,
                      positions=pos, cache=lc, chunk=cfg.attn_chunk,
                      force_absorbed=form, tp=atp)[0]
          for form in (True, False)]
    return float(torch.max(torch.abs(ys[0] - ys[1]))
                 / torch.max(torch.abs(ys[1])))


# ------------------------------------------------ whisper over 'model'

def whisper_serve_timed(params, frames: torch.Tensor, prompt: torch.Tensor,
                        cfg, ctx, new: int, mesh=None) -> tuple:
    """The reference's whisper serving bodies on a frozen tree (this
    rank's blocks and rows over a tensor-parallel mesh): the prefill
    (``whisper_encode``, ``precompute_cross``, ``init_dec_cache`` of
    ``MAX_TGT`` slots in fp32, ``whisper_decode`` of the ``prompt`` ids),
    then ``new - 1`` cached greedy decode steps; each stage timed on the
    host clock (synchronised).  Returns ({tokens (B, new), each step's
    last logits (B, new, vocab) gathered over 'model' (numpy), encode,
    cross, prompt ms, each decode step's ms, KV-cache and cross K/V
    bytes}, the final cache, the cross K/V)."""
    from ..models import whisper as W
    dev = frames.device
    b, s = prompt.shape
    ms = {}

    def timed(key, fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        ms.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
        return out
    with torch.no_grad():
        enc = timed("encode", lambda: W.whisper_encode(
            params, 0, frames, ctx, cfg, mesh=mesh))
        cross = timed("cross", lambda: W.precompute_cross(
            params, 0, enc, ctx, cfg, mesh=mesh))
        del enc
        cache = W.init_dec_cache(cfg, b, W.MAX_TGT, dtype=torch.float32,
                                 device=dev, mesh=mesh)
        logits, cache = timed("prompt", lambda: W.whisper_decode(
            params, 0, prompt, cross, ctx, cfg, cache=cache, mesh=mesh))
        last = [_gather_vocab(logits[:, -1:], cfg, mesh)]
        toks = [LM.next_token(last[-1], cfg)]
        for t in range(new - 1):
            p_t = torch.full((b, 1), s + t, dtype=torch.int32, device=dev)
            logits, cache = timed("decode", lambda: W.whisper_decode(
                params, 0, toks[-1], cross, ctx, cfg, positions=p_t,
                cache=cache, mesh=mesh))
            last.append(_gather_vocab(logits[:, -1:], cfg, mesh))
            toks.append(LM.next_token(last[-1], cfg))
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    out = {"tokens": torch.cat(toks, dim=1).cpu().numpy(),
           "logits": torch.cat(last, dim=1)[..., :cfg.vocab].cpu().numpy(),
           "encode_ms": ms["encode"][0], "cross_ms": ms["cross"][0],
           "prompt_ms": ms["prompt"][0], "decode_ms": ms.get("decode", []),
           "kv_cache_bytes": nbytes(t for n, t in named_leaves(cache)
                                    if n.endswith(("/k", "/v"))),
           "cross_bytes": nbytes(cross)}
    return out, cache, cross


def whisper_tp_forward(cfg, params, frames: np.ndarray, tokens: np.ndarray,
                       mesh_shape: tuple) -> dict:
    """whisper in fp32 from this rank's part of ``params`` (a whole numpy
    tree, cut by ``convert.shard_from_numpy`` under the port's layout) on
    every row: the encoder states, the cross K and V gathered over the
    heads and the decoder's logits gathered over the vocabulary (numpy),
    the rank's share of the vocabulary and of the KV heads."""
    from ..convert import shard_from_numpy
    from ..models import whisper as W
    from ..runtime.sharding import layout_specs
    mesh = _tp_mesh(cfg, mesh_shape)
    p = shard_from_numpy(params, layout_specs(params, cfg, mesh), mesh,
                         device=mesh.device)
    on = lambda a: torch.from_numpy(a).to(mesh.device)
    with torch.no_grad():
        enc = W.whisper_encode(p, 0, on(frames), FP32_CTX, cfg, mesh=mesh)
        ck, cv = W.precompute_cross(p, 0, enc, FP32_CTX, cfg, mesh=mesh)
        logits, _ = W.whisper_decode(p, 0, on(tokens), (ck, cv), FP32_CTX,
                                     cfg, mesh=mesh)
        whole = [mesh.all_gather(t, "model", dim=3)
                 if t.shape[3] != cfg.n_kv else t for t in (ck, cv)]
    return {"enc": enc.cpu().numpy(),
            "cross": [t.cpu().numpy() for t in whole],
            "logits": _gather_vocab(logits, cfg, mesh).cpu().numpy(),
            "local_vocab": int(logits.shape[-1]),
            "local_kv": int(ck.shape[3])}


def whisper_tp_serve(cfg, frozen, frames: np.ndarray, prompt: np.ndarray,
                     new: int, mesh_shape: tuple) -> dict:
    """Greedy whisper serving (:func:`whisper_serve_timed`, fp32) from this
    rank's blocks of the frozen tree ``frozen`` (whole, numpy) on its rows
    of ``frames`` and ``prompt``: every row's tokens (gathered over the
    data axes), each step's gathered logits of its rows, and its final
    cache and cross K/V (numpy)."""
    from ..convert import shard_from_numpy
    from ..runtime.sharding import layout_specs
    mesh = _tp_mesh(cfg, mesh_shape)
    p = shard_from_numpy(frozen, layout_specs(frozen, cfg, mesh), mesh,
                         device=mesh.device)
    rows = LM.batch_rows(mesh, prompt.shape[0]) or slice(None)
    on = lambda a: torch.from_numpy(a[rows]).to(mesh.device)
    out, cache, cross = whisper_serve_timed(p, on(frames), on(prompt), cfg,
                                            FP32_CTX, new, mesh)
    toks = torch.from_numpy(out["tokens"]).to(mesh.device)
    if LM.batch_rows(mesh, prompt.shape[0]) is not None:
        toks = mesh.all_gather(toks, mesh.data_axes, dim=0)
    return {"tokens": toks.cpu().numpy(), "logits": out["logits"],
            "cache": tree_to_numpy(cache),
            "cross": [t.cpu().numpy() for t in cross],
            "coords": dict(mesh.coords)}


def whisper_serve_card(cfg, mesh_shape: tuple, seed: int,
                       frames: np.ndarray, prompt: np.ndarray,
                       new: int) -> dict:
    """One tensor-parallel rank's whisper serving path:
    ``whisper_init(cfg, seed, mesh=)`` (its blocks), its blocks frozen
    (:func:`_tp_frozen`), then :func:`whisper_serve_timed` in fp32 on
    every utterance of ``frames`` with the ``prompt`` ids.  Returns the
    frozen blocks' digests, the freeze's ms and ecl_quant launches, the
    serve's results and the rank's peak memory."""
    dev = default_device()
    mesh = _tp_mesh(cfg, mesh_shape)
    frozen, out = _tp_frozen(cfg, mesh, seed)
    on = lambda a: torch.from_numpy(a).to(dev)
    served, cache, cross = whisper_serve_timed(
        frozen, on(frames), on(prompt), cfg, FP32_CTX, new, mesh)
    out.update(served)
    del cache, cross
    _tp_record(out, frozen, mesh)
    del frozen
    _release(dev)
    return out


# ------------------------------------- a mesh checkpoint, elastic restore

def elastic_train(cfg, mesh_shape: Optional[tuple], batches: Sequence[dict],
                  ckpt_dir: str, *, save: bool = False, params=None,
                  qstate=None, seed: int = 0, lr: float = 1e-3,
                  zero1: bool = True, compress=None,
                  ref: Optional[str] = None, out_dir: Optional[str] = None,
                  device=None) -> dict:
    """One rank's part of a train state's checkpoint and its elastic
    restore over the mesh ``mesh_shape`` (None: one process on ``device``;
    ZeRO-1 ``zero1`` over a mesh, the int8 ``compress`` round trip); fp32
    steps (``launch.steps.build_train_step``).

    With ``save``: the state from ``params`` / ``qstate`` (numpy, whole)
    or ``cfg``'s init with ``seed`` (this rank's blocks), one step on
    ``batches[0]``, the state saved to ``ckpt_dir`` as step 1
    (``CheckpointManager.save(specs=, mesh=)``), then the rest of
    ``batches`` (the uninterrupted run).  Without: the latest checkpoint
    restored into this mesh's state (``steps.state_sharding``; one
    process: its whole state; ``FaultTolerantLoop.resume_or(sharding_fn=)``),
    then the rest of ``batches``.  Returns the
    whole digests of the state saved or restored (``saved`` / ``restored``,
    the error feedback apart) and after the last step (``final``), each
    step's metrics and ecl_quant launches, whether the last step's
    probabilities are bitwise one process's update of its params
    (``probs_bitwise``), this rank's own error feedback's digests and
    whether it is zero, save or restore ms, the checkpoint's bytes and,
    with ``ref``, this rank's params against ``ref/params``
    (:func:`block_errors`); with ``out_dir`` the final params are dumped
    to ``out_dir/params`` (:func:`dump_blocks`)."""
    from .. import tree
    from ..checkpoint.manager import CheckpointManager
    from ..data.pipeline import ShardedFeed
    from ..optim.adam import AdamConfig
    from ..runtime.fault import FaultTolerantLoop
    from . import steps as S
    from .specs import abstract_params
    dev = default_device() if device is None else torch.device(device)
    mesh = None if mesh_shape is None else make_mesh(mesh_shape, device=dev)
    bundle = S.build_train_step(
        cfg, mesh, remat="none", dtype=torch.float32,
        zero1=zero1 and mesh is not None, compress=compress,
        adam_cfg=AdamConfig(lr=lr))
    specs = bundle.in_specs[0] if mesh is not None else None
    body_specs = None if specs is None else {
        k: v for k, v in specs.items() if k != "err"}
    lay = T.tp_specs(cfg, mesh)
    mgr = CheckpointManager(ckpt_dir, keep=2)
    out = {"rank": 0 if mesh is None else mesh.rank,
           "layout": S.layout_name(cfg, mesh) if mesh is not None
           else "one process", "metrics": [], "ecl_launches": []}

    def digests(state):
        body = {k: v for k, v in state.items() if k != "err"}
        return whole_digests(body, body_specs, mesh)

    def barrier():        # the ranks start a timed save or restore alike
        if mesh is not None and dist.is_initialized():
            dist.barrier()
    if save:
        p0, q0, _ = _train_state0(cfg, dev, params, qstate, seed, mesh)
        state = bundle.init_state(p0)
        state["qstate"] = q0
        del p0, q0
        first, rest = 1, batches[1:]
        feed = ShardedFeed(lambda s: batches[s], mesh=mesh, device=dev)
        state, _ = bundle.fn(state, next(feed))
        feed.close()
        _sync(dev)
        barrier()
        t0 = time.perf_counter()
        path = mgr.save(first, state, specs=specs, mesh=mesh)
        out["save_ms"] = (time.perf_counter() - t0) * 1e3
        out["saved"] = digests(state)
    else:
        template = bundle.args[0] if mesh is not None else \
            bundle.init_state(abstract_params(cfg))
        template = tree.map_(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device=dev), template)
        barrier()
        t0 = time.perf_counter()
        state, first = FaultTolerantLoop(bundle.fn, mgr).resume_or(
            template, sharding_fn=None if mesh is None
            else S.state_sharding(bundle, mesh))
        _sync(dev)
        out["restore_ms"] = (time.perf_counter() - t0) * 1e3
        rest = batches[first:]
        path = os.path.join(ckpt_dir, f"step_{first:08d}")
        out["restored"] = digests(state)
    out["ckpt_bytes"] = os.path.getsize(os.path.join(path, "state.npz"))
    if "err" in state:
        out["err_digests"] = {n: digest(t)
                              for n, t in named_leaves(state["err"])}
        out["err_zero"] = all(not bool(t.any())
                              for t in tree.leaves(state["err"]))
    feed = ShardedFeed(lambda s: batches[s], mesh=mesh, start_step=first,
                       device=dev)
    for _ in rest:
        qs_before = state["qstate"]
        eq.LAUNCHES = 0
        state, metrics = bundle.fn(state, next(feed))
        out["ecl_launches"].append(eq.LAUNCHES)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
    feed.close()
    if rest and mesh is not None:
        out["probs_bitwise"] = probs_bitwise(
            state["params"], qs_before, state["qstate"], lay, mesh, cfg.lam)
    out["final"] = digests(state)
    if ref is not None:
        out["param_errors"] = block_errors(state["params"], lay, mesh,
                                           os.path.join(ref, "params"))
    if out_dir is not None:
        path = os.path.join(out_dir, "params")
        if mesh is None:
            dump(state["params"], path)
        else:
            dump_blocks(state["params"], lay, mesh, path)
    del state
    _release(dev)
    return out


def checkpoint_leaf(w: np.ndarray, spec: tuple, mesh_shape: tuple,
                    ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The reference's elastic case on this rank: with ``step``, this
    rank's block of ``w`` under ``spec`` saved over the mesh as ``{"w":
    block}`` at ``step``; without, the latest checkpoint restored onto the
    mesh under ``spec`` (``sharding_fn``).  Returns this rank's block
    (numpy) and its coordinates."""
    from ..checkpoint.manager import CheckpointManager
    from ..runtime.sharding import NamedSpec, shard_slice
    mesh = make_mesh(mesh_shape, device=default_device())
    mgr = CheckpointManager(ckpt_dir)
    block = shard_slice(torch.from_numpy(w), spec, mesh).to(mesh.device)
    if step is not None:
        mgr.save(step, {"w": block}, specs={"w": spec}, mesh=mesh)
    else:
        state, _ = mgr.restore({"w": torch.empty_like(block)},
                               sharding_fn=lambda path, leaf: NamedSpec(
                                   mesh, spec))
        block = state["w"]
    return {"w": block.cpu().numpy(), "coords": dict(mesh.coords)}
