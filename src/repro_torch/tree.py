"""Parameter trees: nested dicts, lists and tuples with tensor leaves.

The port's stand-in for ``jax.tree_util``.  Leaves are visited in the
order JAX flattens a tree (dict keys sorted), so a sum over the leaves,
such as Adam's global norm, adds the terms in the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in leaves(v)]
    return [tree]


def unflatten(tree: Any, new_leaves) -> Any:
    """``tree``'s structure with ``new_leaves`` (in :func:`leaves` order).
    No reference to ``new_leaves`` outlives the call: a recursive closure
    over its iterator would be a reference cycle, holding every leaf (a
    train step's gradients) until the cyclic collector ran."""
    return _build(tree, iter(new_leaves))


def _build(t: Any, it) -> Any:
    if isinstance(t, dict):
        built = {k: _build(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)


def map_(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *matching leaves of rest)`` over trees of one structure."""
    if isinstance(tree, dict):
        return {k: map_(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_(fn, v, *rs) for v, *rs in zip(tree, *rest))
    return fn(tree, *rest)
