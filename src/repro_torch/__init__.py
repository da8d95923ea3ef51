"""FantastIC4 in PyTorch and CUDA: the port of the JAX package ``repro``.

Module names mirror ``repro`` so each counterpart is easy to find.  The
serving path (frozen 4-bit MLP packs through an ``ExecutionPlan``) runs on
hand-written CUDA kernels for Hopper (``csrc/``); every kernel keeps a
plain PyTorch version beside it, which a CPU tensor takes and the tests
hold against the JAX package.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another.  Raises when CUDA is asked for (or defaulted to) and
    there is none: there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev
