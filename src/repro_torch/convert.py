"""Carry weights across from the JAX package.

Both functions take the JAX package's trees with every array already
turned into numpy (``np.asarray`` on the caller's side, so this module
imports nothing of JAX) and return the port's tensors on ``device``.
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
