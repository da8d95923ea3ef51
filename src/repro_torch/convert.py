"""Carry weights and training state across from the JAX package.

Every function takes the JAX package's trees with every array already
turned into numpy (``np.asarray`` on the caller's side, so this module
imports nothing of JAX) and return the port's tensors on ``device``;
:func:`tree_to_numpy` is the way back.  A MoE tree comes across whole
(router, (L, E, ...) banks, (L, E, 4) ω, (L, E, 16) probabilities, the
Adam moments); :func:`take_experts` cuts it to one device's share of the
experts.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import resolve_device

_PACK_TENSORS = ("packed", "omega", "alpha1", "bias", "alpha2")


def _to_torch(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v, dev) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree)).to(dev)
    return tree


def params_from_numpy(params: dict, qstate: dict, bn_state: dict, *,
                      device=None) -> tuple:
    """(params, qstate, bn_state) of ``models/mlp.py`` as the port's
    tensors, for ``repro_torch.models.mlp.freeze_mlp``."""
    dev = resolve_device(device)
    return (_to_torch(params, dev), _to_torch(qstate, dev),
            _to_torch(bn_state, dev))


def train_state_from_numpy(params: dict, qstate: dict, bn_state: dict,
                           opt: dict, *, device=None) -> tuple:
    """(params, qstate, bn_state, opt) of the JAX package's MLP trainer as
    the port's tensors: the Adam moments ``m``, ``v`` and the int32
    ``step`` come across with the weights, so one training step can be
    compared from the same state."""
    dev = resolve_device(device)
    return tuple(_to_torch(t, dev) for t in (params, qstate, bn_state, opt))


def pack_from_numpy(pack: dict, device=None) -> dict:
    """A frozen pack (``freeze_mlp`` output) as the port's pack.  The
    serving tensors become contiguous tensors; ``shape`` and
    ``activation`` are kept; other fields (``format``, ``size_bytes``,
    ``crc``, ...) pass through unread."""
    dev = resolve_device(device)
    layers = []
    for layer in pack["layers"]:
        out = dict(layer)
        for key in _PACK_TENSORS:
            out[key] = torch.from_numpy(np.array(layer[key])).to(dev)
        out["packed"] = out["packed"].to(torch.uint8).contiguous()
        for key in ("omega", "alpha1", "bias", "alpha2"):
            out[key] = out[key].to(torch.float32)
        out["shape"] = tuple(int(v) for v in layer["shape"])
        layers.append(out)
    return {**pack, "layers": layers}


def lm_tree_from_numpy(tree: Any, *, device=None) -> Any:
    """An LM tree of the JAX package (``lm_init`` params, ``build_qstate``
    state, a ``freeze_tree`` frozen tree or an ``init_cache`` cache) as the
    port's tensors, each array keeping its dtype (uint8 ``packed``, int32
    positions, fp32 weights); numbers and other leaves pass through."""
    return _to_torch(tree, resolve_device(device))


def lm_train_state_from_numpy(state: dict, *, device=None) -> dict:
    """An LM train state of the JAX package (``ec4t.init_train_state``:
    ``params``, ``qstate``, ``opt`` with the Adam moments ``m``, ``v`` and
    the int32 ``step``, and ``err`` when gradients are compressed) as the
    port's tensors, each array keeping its dtype: a train step or a
    checkpoint of either package then starts from the same state."""
    return _to_torch(state, resolve_device(device))


def take_experts(tree: Any, first: int, count: int, *, axis: int = 1
                 ) -> Any:
    """``tree`` with every array under an ``"experts"`` key cut to experts
    ``[first, first + count)`` along ``axis`` (1 for an L-stacked LM tree:
    banks (L, E, d_in, d_out), their ω (L, E, 4), probabilities (L, E, 16)
    and Adam moments; 0 for one ``moe_init`` layer), as contiguous copies;
    the router (all E outputs) and every other leaf are kept.  This is how
    a test gives the JAX package's whole tree (numpy or the port's
    tensors) to a config whose ``experts_held`` is ``(first, count)``."""
    index = (slice(None),) * axis + (slice(first, first + count),)
    return _take(tree, index, False)


def _take(node: Any, index: tuple, cut: bool) -> Any:
    if isinstance(node, dict):
        return {k: _take(v, index, cut or k == "experts")
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_take(v, index, cut) for v in node)
    if not cut:
        return node
    if isinstance(node, torch.Tensor):
        return node[index].contiguous()
    if isinstance(node, np.ndarray):
        return np.ascontiguousarray(node[index])
    return node


def tree_to_numpy(tree: Any) -> Any:
    """The inverse: every tensor of a port tree as a host numpy array of
    its dtype (what the JAX package's functions take); other leaves pass
    through."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree
