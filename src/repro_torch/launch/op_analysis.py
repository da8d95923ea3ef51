"""FLOPs, bytes, peak memory and collectives of one call: the counterpart
of the JAX package's ``launch/hlo_analysis.py``.

The reference walks the optimized HLO of a compiled program.  The port
runs eagerly, so :func:`analyze` runs the function once under a
``TorchDispatchMode`` and counts every ATen operation it dispatches (the
backward's too), on meta tensors (no storage: the dry run,
``launch/dryrun.py``) or on real ones:

* **flops** -- 2 · |out| · |contract| for every product (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``; ``matmul`` and ``einsum`` reach these), 1 per
  output element for the arithmetic elementwise operations of the
  reference's ``_ELEMENTWISE_FLOP_OPS`` (their ATen names), and 1 per
  input element for a reduction;
* **bytes** -- operand plus output bytes of every dispatched operation,
  views and allocations excepted.  This is the eager program's traffic:
  it has no fusion boundary, so every intermediate is written and read
  again, where the reference counts only what crosses a fusion's
  boundary;
* **peak_bytes** -- the most bytes of storage created inside the call
  that were alive at once (storages tracked by weak references to their
  tensors): the counterpart of the compiled program's ``temp_bytes``;
  ``argument_bytes`` and ``output_bytes`` beside it;
* **collectives** -- the operand bytes of each exchange class that a
  ``launch.mesh.ShapeMesh`` ran, with their total and count.

A hand-written CUDA kernel launches outside ATen; its wrapper reports its
launches and their work (``kernels/build.py`` ``note_work``) and the
count takes them.  On the meta device the wrapper copies and allocates
as the launch would and reports the launches it would make and their
work, so a count on meta equals the count of the same call on the card's
tensors (the launches on meta are the kernel's contract, not a count
taken where it launches: that is the wrapper's ``LAUNCHES``).  A loop in Python runs its body once per
trip, so nothing here multiplies by a trip count (the reference's walker
has to).
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels import build

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten

# 2 · |out| · |contract|: the contraction is the last dim of the first
# matrix operand
_PRODUCTS = {_aten.mm.default: 0, _aten.bmm.default: 0,
             _aten.addmm.default: 1, _aten.baddbmm.default: 1}

# the reference's _ELEMENTWISE_FLOP_OPS by their ATen names (each also in
# its in-place, out and _foreach forms)
ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "exp",
    "expm1", "log", "log1p", "rsqrt", "sqrt", "tanh", "sigmoid", "pow",
    "neg", "abs", "floor", "ceil", "round", "eq", "ne", "lt", "le", "gt",
    "ge", "where", "clamp", "clamp_min", "clamp_max", "logical_and",
    "logical_or", "logical_xor", "logical_not", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "bitwise_left_shift",
    "bitwise_right_shift", "__lshift__", "__rshift__", "_to_copy", "cos",
    "sin", "erf", "atan2", "remainder", "fmod", "sign", "reciprocal",
    "square", "silu", "gelu", "relu", "masked_fill", "addcmul", "addcdiv",
    "lerp", "copysign", "_log_softmax", "_softmax", "threshold_backward",
    "silu_backward", "gelu_backward", "sigmoid_backward", "tanh_backward",
    "_log_softmax_backward_data", "_softmax_backward_data", "isnan",
    "isinf",
})
REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
    "var", "std", "norm", "linalg_vector_norm", "any", "all", "cumsum",
    "logsumexp",
})
# no data moved: allocations without a fill, and metadata
_FREE = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "lift_fresh", "alias", "_local_scalar_dense", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "set_", "resize_", "_unsafe_view",
})

_ACTIVE: List["_Count"] = []


def _base(func) -> str:
    name = func.overloadpacket.__name__
    if name.startswith("_foreach_"):
        name = name[len("_foreach_"):]
    if name.endswith("_") and not name.startswith("_"):
        name = name[:-1]
    return name


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def note_collective(kind: str, nbytes: int) -> None:
    """Add one exchange to every running count (``ShapeMesh`` calls it)."""
    for c in _ACTIVE:
        c.collectives[kind] += nbytes
        c.collectives["count"] += 1


def _note_kernel(name: str, launches: int, flops: float,
                 nbytes: float) -> None:
    for c in _ACTIVE:
        c.flops += flops
        c.bytes += nbytes
        c.kernels[name] = c.kernels.get(name, 0) + launches


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.kernels: Dict[str, int] = {}
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.collectives["count"] = 0
        self._known: Dict[int, int] = {}       # storage -> live tensors
        self._size: Dict[int, int] = {}        # storage -> bytes
        self._outside: set = set()             # storages of the arguments
        self.live = 0
        self.peak = 0

    def watch_arguments(self, args) -> int:
        total = 0
        for t in _tensors(args):
            key = t.untyped_storage()._cdata
            if key not in self._outside:
                self._outside.add(key)
                total += t.untyped_storage().nbytes()
        return total

    def _track(self, out) -> None:
        seen = set()
        for t in _tensors(out):
            if id(t) in seen:
                continue
            seen.add(id(t))
            st = t.untyped_storage()
            key = st._cdata
            if key in self._outside:
                continue
            if key not in self._known:
                self._known[key] = 0
                self._size[key] = st.nbytes()
                self.live += self._size[key]
                self.peak = max(self.peak, self.live)
            self._known[key] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        n = self._known.get(key)
        if n is None:
            return
        if n <= 1:
            del self._known[key]
            self.live -= self._size.pop(key)
        else:
            self._known[key] = n - 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        name = _base(func)
        if func in _PRODUCTS:
            a = args[_PRODUCTS[func]]
            self.flops += 2.0 * out.numel() * a.shape[-1]
        elif name in ELEMENTWISE:
            self.flops += sum(t.numel() for t in _tensors(out))
        elif name in REDUCTIONS:
            self.flops += sum(t.numel() for t in _tensors(args[:1]))
        if not (func.is_view or name in _FREE):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        self._track(out)
        return out


def analyze(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count it: ``{"flops", "bytes",
    "collectives", "peak_bytes", "argument_bytes", "output_bytes", "ops",
    "kernels", "out"}`` (``collectives`` with the reference's classes,
    ``total`` and ``count``; ``kernels``: the hand-written kernels'
    launches by name, as their wrappers report them, or on meta the
    launches the card would make; ``out``: what ``fn`` returned)."""
    count = _Count()
    arg_bytes = count.watch_arguments((args, kwargs))
    if not _ACTIVE:
        build.WORK_LISTENERS.append(_note_kernel)
    _ACTIVE.append(count)
    try:
        with count:
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE.remove(count)
        if not _ACTIVE:
            build.WORK_LISTENERS.remove(_note_kernel)
    out_bytes = sum({t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                     for t in _tensors(out)}.values())
    coll = dict(count.collectives)
    coll["total"] = sum(coll[k] for k in COLLECTIVES)
    return {"flops": count.flops, "bytes": count.bytes, "collectives": coll,
            "peak_bytes": count.peak, "argument_bytes": arg_bytes,
            "output_bytes": out_bytes, "ops": count.ops,
            "kernels": dict(count.kernels), "out": out}
