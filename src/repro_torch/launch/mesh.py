"""Device meshes over ``torch.distributed``: the port of the JAX package's
``launch/mesh.py``, and the rank launcher the scale-out paths run under.

The reference's mesh is single-controller: one process sees every device
and ``shard_map`` runs a body on each.  PyTorch is multi-controller: one
process per rank, each with its own device, joined by a process group.
:class:`Mesh` is one rank's view of a ``('data', 'model')`` grid of the
world's ranks (row-major, so rank ``r`` sits at ``divmod(r, model)``): the
axis names and sizes, this rank's coordinates, one process group per
axis slice it belongs to, and its device.  Its collectives (``all_gather``
tiled in mesh order, ``all_to_all`` over the leading dim, ``all_reduce``,
``ppermute``) are ``torch.distributed``'s over those groups, each with its
adjoint under autograd, as ``shard_map``'s transpose gives the reference
one: the gather's backward is a reduce-scatter (the gradients summed over
the slice, this rank's block kept), the all-to-all's the reverse
all-to-all, a sum's an all-reduce sum of the gradients, a permutation's
the inverse permutation.  Every rank runs the same backward, so the
collectives of the backward meet in the same order on every rank.

Backends: NCCL where each rank has a card of its own, gloo on the CPU.
More ranks than cards (several ranks sharing one card, as on a one-card
host) run only when the caller names ``backend="gloo"``; gloo's
collectives then go through host buffers, staged explicitly (each
collective copies its CUDA tensor to the host and the result back), and
:func:`describe` says so.  The kernels run on the card either way.

:func:`run_ranks` (one call) and :class:`RankPool` (a world kept for
several calls) spawn the ranks of one host; a world started by
``torchrun`` is joined with :func:`init_from_env`.  A rank's failure is
raised in the parent with the rank's traceback.
"""
from __future__ import annotations

import itertools
import math
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device

AXES = ("data", "model")


# ---------------------------------------------------------------- shapes

def fit_mesh_shape(n: int, model: Optional[int] = None) -> Tuple[int, int]:
    """The reference's ``fit_mesh`` table over ``n`` ranks: ``model`` pins
    the tensor-parallel axis, else the largest power-of-two divisor of
    ``n`` with ``model**2 <= n``:

        1 -> (1, 1)   2 -> (2, 1)   4 -> (2, 2)   8 -> (4, 2)
        16 -> (4, 4)  64 -> (8, 8)  256 -> (16, 16)  6 -> (3, 2)
    """
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n}")
    if model is not None:
        model = int(model)
        if model < 1 or n % model:
            raise ValueError(f"model axis {model} does not divide {n} devices")
    else:
        model = 1
        while n % (model * 2) == 0 and (model * 2) ** 2 <= n:
            model *= 2
    return n // model, model


class MeshSpec:
    """Axis names and sizes only: what :class:`~repro_torch.runtime.
    sharding.Rules` needs, for a mesh no host here builds (the
    reference's 256- and 512-chip production meshes)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        # the axes a batch is split over (the reference's batch layout)
        self.data_axes = tuple(a for a in ("pod", "data")
                               if a in self.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's production shapes: (data 16, model 16), or with a
    leading 'pod' axis of 2 (512 chips)."""
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec((16, 16), AXES)


# ------------------------------------------------------------------ mesh

class Mesh(MeshSpec):
    """One rank's view of a device mesh over the default process group.

    Every rank of the world builds the same mesh (the groups are made
    collectively, in one order); a mesh of one rank needs no process
    group at all.  ``device`` defaults to this rank's device (the card
    outside a rank); naming CUDA with no card raises.  With gloo on CUDA
    tensors (``stage_host``) every collective runs on host copies of its
    tensors."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str] = AXES,
                 *, device=None):
        super().__init__(shape, axis_names)
        initialized = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if initialized else 1
        if world != self.size:
            raise ValueError(f"mesh {self.shape} has {self.size} ranks, the "
                             f"world {world}")
        self.rank = dist.get_rank() if initialized else 0
        dims = tuple(self.shape.values())
        self.coords = dict(zip(self.axis_names, _unravel(self.rank, dims)))
        self.device = (default_device() if device is None
                       else resolve_device(device))
        self.backend = dist.get_backend() if initialized else None
        self.stage_host = (self.backend == "gloo"
                           and self.device.type == "cuda")
        # bytes this rank put into each (collective, axes), forward and
        # backward alike
        self.traffic: Dict[Tuple[str, Tuple[str, ...]], int] = {}
        # one group per (axis subset, slice): made on every rank in the
        # same order, kept where this rank belongs
        self._groups: Dict[Tuple[str, ...], Any] = {}
        # the world ranks of this rank's slice along each axis subset, in
        # mesh order (a slice member's index is its axis_index)
        self._members: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
        for r in range(1, len(self.axis_names) + 1):
            for sub in itertools.combinations(self.axis_names, r):
                for ranks in _slices(dims, self.axis_names, sub):
                    if self.rank in ranks:
                        self._members[sub] = ranks
                    if len(ranks) == 1 or len(ranks) == world:
                        continue      # no collective, or the whole world
                    g = dist.new_group(list(ranks))
                    if self.rank in ranks:
                        self._groups[sub] = g

    # ------------------------------------------------------------ groups

    def _key(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"mesh has no axes {unknown}: {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._key(axes))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (row-major over them)."""
        idx = 0
        for a in self._key(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """The process group of this rank's slice along ``axes`` (None for
        the whole world)."""
        key = self._key(axes)
        return self._groups.get(key)

    # ------------------------------------------------------- collectives

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.stage_host else t

    def _count(self, kind: str, key, t: torch.Tensor) -> None:
        k = (kind, tuple(key))
        self.traffic[k] = self.traffic.get(k, 0) + t.numel() * t.element_size()

    def all_gather(self, t: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """Every slice's ``t`` along ``axes``, concatenated on ``dim`` in
        mesh order (the reference's tiled ``all_gather``).  Backward: the
        gradients summed over the slice, this rank's block of them."""
        if self.axis_size(axes) == 1:
            return t
        return _AllGather.apply(t, self, self._key(axes), dim)

    def all_to_all(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Dim 0 cut into equal chunks, chunk i to slice member i; the
        result holds member i's chunk for this rank at chunk i.  Backward:
        the same exchange of the gradients (the chunks go home)."""
        n = self.axis_size(axes)
        if n == 1:
            return t
        if t.shape[0] % n:
            raise ValueError(f"all_to_all over {n} ranks: dim 0 of "
                             f"{tuple(t.shape)} does not divide")
        return _AllToAll.apply(t, self, self._key(axes))

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """The sum (``op="mean"``: over the slice's size; ``"max"``) of
        ``t`` over the slice along ``axes``; a new tensor.  Backward of a
        sum: the gradients' sum over the slice (of a mean, the same over
        the size); ``max`` has none and refuses a tensor under grad."""
        if op not in ("sum", "mean", "max"):
            raise ValueError(f"all_reduce op {op!r}: sum, mean or max")
        if op == "max" and t.requires_grad and torch.is_grad_enabled():
            raise ValueError("all_reduce(op='max') has no gradient; run it "
                             "under torch.no_grad()")
        n = self.axis_size(axes)
        if n == 1:
            return t.clone()
        if op == "max":
            return self._reduce(t, self._key(axes), dist.ReduceOp.MAX)
        out = _AllReduceSum.apply(t, self, self._key(axes))
        return out / n if op == "mean" else out

    def ppermute(self, t: torch.Tensor, axis, perm) -> torch.Tensor:
        """The reference's ``ppermute`` along ``axis``: for each ``(src,
        dst)`` of ``perm`` (indices along the axis) member ``dst`` gets
        member ``src``'s ``t``; a member no pair sends to gets zeros.
        Backward: the inverse permutation of the gradients."""
        key = self._key(axis)
        n = self.axis_size(key)
        perm = tuple((int(s), int(d)) for s, d in perm)
        srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
        if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
                or not all(0 <= i < n for i in srcs + dsts)):
            raise ValueError(f"ppermute over {n} ranks: {perm} is not a "
                             "partial permutation of them")
        return _Permute.apply(t, self, key, perm)

    # the collectives themselves, outside autograd

    def _reduce(self, t: torch.Tensor, key, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
        if self.axis_size(key) == 1:
            return t.clone()
        self._count("all-reduce", key, t)
        out = self._staged(t.contiguous()).clone()
        dist.all_reduce(out, op=op, group=self.group(key))
        return out.to(t.device)

    def _gather(self, t: torch.Tensor, key, dim: int) -> torch.Tensor:
        self._count("all-gather", key, t)
        src = self._staged(t.contiguous())
        parts = [torch.empty_like(src) for _ in range(self.axis_size(key))]
        dist.all_gather(parts, src, group=self.group(key))
        return torch.cat(parts, dim=dim).to(t.device)

    def _exchange(self, t: torch.Tensor, key) -> torch.Tensor:
        self._count("all-to-all", key, t)
        src = self._staged(t.contiguous())
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group(key))
        return out.to(t.device)

    def _permute(self, t: torch.Tensor, key, perm) -> torch.Tensor:
        members, me = self._members[key], self.axis_index(key)
        src = self._staged(t.contiguous())
        out = torch.zeros_like(src)
        ops = []
        for s, d in perm:
            if s == me and d == me:
                out.copy_(src)
            elif s == me:
                ops.append(dist.P2POp(dist.isend, src, members[d]))
            elif d == me:
                ops.append(dist.P2POp(dist.irecv, out, members[s]))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out.to(t.device)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, key, dim):
        ctx.mesh, ctx.key, ctx.dim, ctx.size = mesh, key, dim, t.shape[dim]
        return mesh._gather(t, key, dim)

    @staticmethod
    def backward(ctx, g):
        full = ctx.mesh._reduce(g, ctx.key)
        i = ctx.mesh.axis_index(ctx.key)
        return (full.narrow(ctx.dim, i * ctx.size, ctx.size).clone(),
                None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, key):
        ctx.mesh, ctx.key = mesh, key
        return mesh._exchange(t, key)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._exchange(g, ctx.key), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, key):
        ctx.mesh, ctx.key = mesh, key
        return mesh._reduce(t, key)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._reduce(g, ctx.key), None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, key, perm):
        ctx.mesh, ctx.key, ctx.perm = mesh, key, perm
        return mesh._permute(t, key, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return ctx.mesh._permute(g, ctx.key, inverse), None, None, None


def _unravel(rank: int, dims: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for d in reversed(dims):
        rank, c = divmod(rank, d)
        out.append(c)
    return tuple(reversed(out))


def _slices(dims, names, sub) -> list:
    """The rank tuples of every slice varying along the axes ``sub``."""
    fixed = [i for i, a in enumerate(names) if a not in sub]
    free = [i for i, a in enumerate(names) if a in sub]
    out = []
    for base in itertools.product(*(range(dims[i]) for i in fixed)):
        ranks = []
        for var in itertools.product(*(range(dims[i]) for i in free)):
            c = [0] * len(dims)
            for i, v in zip(fixed, base):
                c[i] = v
            for i, v in zip(free, var):
                c[i] = v
            r = 0
            for i, d in enumerate(dims):
                r = r * d + c[i]
            ranks.append(r)
        out.append(tuple(ranks))
    return out


class ShapeMesh(MeshSpec):
    """Rank 0's view of a mesh that exists only as shapes: the dry run's
    stand-in for the reference's 256- and 512-chip meshes
    (``launch/dryrun.py``).  It has :class:`Mesh`'s exchange interface
    (``all_gather``, ``all_to_all``, ``all_reduce`` sum / mean / max,
    ``ppermute``, each with its adjoint under autograd), but an exchange
    computes no values: it returns an empty tensor of the exchange's
    output shape on its operand's device (meant for the meta device) and
    adds the operand's bytes to ``collectives`` under its class --
    ``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``, the reference's convention
    (``launch/hlo_analysis.py``) -- and to every running
    ``launch.op_analysis`` count.  A gather's backward is the port's
    all-reduce of the gradients (:class:`Mesh`'s adjoint), so it is
    counted as one.  An axis of size 1 exchanges nothing, as on a real
    mesh."""

    CLASSES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str] = AXES,
                 *, device="meta"):
        super().__init__(shape, axis_names)
        self.rank = 0
        self.coords = {a: 0 for a in self.axis_names}
        self.device = torch.device(device)
        self.backend = None
        self.stage_host = False
        self.reset()

    def reset(self) -> None:
        self.collectives = {k: 0 for k in self.CLASSES}
        self.collectives["count"] = 0
        self.calls: list = []          # (class, axes, bytes) in order

    def bytes_over(self, axis: str) -> dict:
        """Per class, the bytes of the exchanges whose axes include
        ``axis``."""
        out = {k: 0 for k in self.CLASSES}
        for kind, key, nbytes in self.calls:
            if axis in key:
                out[kind] += nbytes
        return out

    _key = Mesh._key
    axis_size = Mesh.axis_size
    axis_index = Mesh.axis_index
    all_gather = Mesh.all_gather
    all_to_all = Mesh.all_to_all
    all_reduce = Mesh.all_reduce
    ppermute = Mesh.ppermute

    def _note(self, kind: str, key, t: torch.Tensor) -> None:
        from .op_analysis import note_collective
        nbytes = t.numel() * t.element_size()
        self.collectives[kind] += nbytes
        self.collectives["count"] += 1
        self.calls.append((kind, key, nbytes))
        note_collective(kind, nbytes)

    def _reduce(self, t: torch.Tensor, key, op=None) -> torch.Tensor:
        if self.axis_size(key) == 1:
            return t.clone()
        self._note("all-reduce", key, t)
        return torch.empty_like(t, memory_format=torch.contiguous_format)

    def _gather(self, t: torch.Tensor, key, dim: int) -> torch.Tensor:
        self._note("all-gather", key, t)
        shape = list(t.shape)
        shape[dim] *= self.axis_size(key)
        return t.new_empty(shape)

    def _exchange(self, t: torch.Tensor, key) -> torch.Tensor:
        self._note("all-to-all", key, t)
        return torch.empty_like(t, memory_format=torch.contiguous_format)

    def _permute(self, t: torch.Tensor, key, perm) -> torch.Tensor:
        self._note("collective-permute", key, t)
        return torch.empty_like(t, memory_format=torch.contiguous_format)


_MESHES: Dict[tuple, Mesh] = {}


def make_mesh(shape: Sequence[int], axes: Sequence[str] = AXES, *,
              device=None) -> Mesh:
    """The mesh of ``shape`` over the world, built once per process (its
    groups are kept, so every rank must ask for the same meshes in the
    same order)."""
    dev = default_device() if device is None else resolve_device(device)
    key = (tuple(shape), tuple(axes), str(dev),
           dist.get_world_size() if dist.is_initialized() else 1)
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = _MESHES[key] = Mesh(shape, axes, device=dev)
    return mesh


def fit_mesh(n_devices: Optional[int] = None, *,
             model: Optional[int] = None, device=None) -> Mesh:
    """The ``('data', 'model')`` mesh of the reference's table over the
    world's ranks (``n_devices`` defaults to the world size and may not
    exceed it)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else min(int(n_devices), world)
    if n != world and n >= 1:
        raise ValueError(f"a mesh spans the whole world: n_devices {n} of "
                         f"{world} ranks")
    return make_mesh(fit_mesh_shape(n, model), AXES, device=device)


def single_device_mesh(device=None) -> Mesh:
    return make_mesh((1, 1), AXES, device=device)


def describe(mesh) -> dict:
    """The reference's keys (``axes``, ``n_devices``), with this rank's
    coordinates and how its collectives run."""
    out = {"axes": dict(mesh.shape), "n_devices": int(mesh.size)}
    if isinstance(mesh, Mesh):
        if mesh.stage_host:
            how = "staged through host buffers (gloo on CUDA tensors)"
        else:
            how = "in place" if mesh.backend else "none (one rank)"
        out.update({"rank": mesh.rank, "coords": dict(mesh.coords),
                    "device": str(mesh.device), "backend": mesh.backend,
                    "collectives": how})
    return out


# ------------------------------------------------------------ the world

_RANK_DEVICE: Optional[torch.device] = None


def default_device() -> torch.device:
    """This rank's device (set when its process group starts), else the
    card (raising when there is none: no silent CPU fallback)."""
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    return resolve_device()


def resolve_backend(world: int, device, backend: Optional[str] = None
                    ) -> str:
    """gloo on the CPU, NCCL where every rank has a card of its own; more
    ranks than cards only with ``backend="gloo"`` named."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU; use gloo")
        return "gloo"
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the ranks on the CPU")
    cards = torch.cuda.device_count()
    if backend is None:
        if world > cards:
            raise ValueError(
                f"{world} ranks on {cards} CUDA device(s): NCCL needs a card "
                "a rank; pass backend='gloo' to let ranks share a card")
        return "nccl"
    if backend == "nccl" and world > cards:
        raise ValueError(f"backend='nccl' with {world} ranks on {cards} "
                         "card(s); pass backend='gloo' to share a card")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def rank_device(rank: int, device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(rank: int, world: int, backend: str, dev: torch.device,
           init: str) -> None:
    global _RANK_DEVICE
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    _RANK_DEVICE = dev
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)


def init_from_env(*, backend: Optional[str] = None, device="cuda") -> None:
    """Join the world ``torchrun`` started (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks the card)."""
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    b = resolve_backend(int(os.environ.get("LOCAL_WORLD_SIZE", world)),
                        device, backend)
    _start(rank, world, b, rank_device(local, device), "env://")


def world_from_env() -> Optional[int]:
    """The world size torchrun set, or None."""
    w = os.environ.get("WORLD_SIZE")
    return int(w) if w and "RANK" in os.environ else None


def _rank_main(rank, world, backend, device, init, tasks, results):
    try:
        _start(rank, world, backend, rank_device(rank, device), init)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args, kwargs = task
        try:
            results.put((rank, True, fn(*args, **kwargs)))
        except Exception:        # reported to the parent, which fails
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


def describe_world() -> dict:
    """This rank's place in the world (a :class:`RankPool` task)."""
    dev = default_device()
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": dist.get_backend(), "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu")}


class RankError(RuntimeError):
    """A rank failed; the message holds its traceback."""


class RankPool:
    """``world`` ranks of one host, spawned once and kept for several
    calls.  ``run(fn, *args)`` calls ``fn(*args)`` on every rank (``fn``
    importable by name: the ranks unpickle it) and returns the results
    in rank order; a failed or lost rank raises :class:`RankError` in
    the parent, and the pool is then closed.  A context manager; leaving
    it stops every rank."""

    def __init__(self, world: int, *, backend: Optional[str] = None,
                 device="cuda", timeout: float = 600.0):
        import torch.multiprocessing as mp
        self.world = int(world)
        self.device = torch.device(device)
        self.backend = resolve_backend(self.world, self.device, backend)
        self.timeout = timeout
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        self._results = ctx.Queue()
        init = f"tcp://127.0.0.1:{_free_port()}"
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, self.world, self.backend, str(self.device), init,
                  self._tasks[r], self._results))
            for r in range(self.world)]
        for p in self._procs:
            p.start()
        self.closed = False

    def run(self, fn: Callable, *args, **kwargs) -> list:
        if self.closed:
            raise RankError("the rank pool is closed")
        for q in self._tasks:
            q.put((fn, args, kwargs))
        out: Dict[int, Any] = {}
        waited = 0.0
        while len(out) < self.world:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [i for i, p in enumerate(self._procs)
                        if not p.is_alive() and i not in out]
                if dead or waited > self.timeout:
                    self.close()
                    raise RankError(
                        f"rank(s) {dead} ended with exit codes "
                        f"{[self._procs[i].exitcode for i in dead]}"
                        if dead else f"ranks did not answer in "
                        f"{self.timeout:.0f} s") from None
                continue
            if not ok:
                self.close()
                raise RankError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        return [out[r] for r in range(self.world)]

    def close(self) -> None:
        """Stop every rank: each ends after its task (10 s at most, the
        results it still sends drained meanwhile), then is terminated."""
        if self.closed:
            return
        self.closed = True
        for q in self._tasks:
            q.put(None)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and any(
                p.is_alive() for p in self._procs):
            try:
                self._results.get(timeout=0.1)
            except queue.Empty:
                pass
        for p in self._procs:
            if p.is_alive():
                p.terminate()
            p.join(5.0)
        for q in (*self._tasks, self._results):
            q.cancel_join_thread()     # a rank that was ended reads no more
            q.close()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run_ranks(fn: Callable, world: int, *, backend: Optional[str] = None,
              device="cuda", args: tuple = (), kwargs: Optional[dict] = None,
              timeout: float = 600.0) -> list:
    """``fn(*args, **kwargs)`` on ``world`` spawned ranks; the results in
    rank order.  See :class:`RankPool`."""
    with RankPool(world, backend=backend, device=device,
                  timeout=timeout) as pool:
        return pool.run(fn, *args, **(kwargs or {}))
