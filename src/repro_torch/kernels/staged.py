"""Sealed copies: the device copies the kernels read instead of the pack.

The CUDA kernels do not read a frozen layer's own ``packed`` and ``omega``
tensors.  They read copies built once per pack: the chain's slice-major
codes and ω (``fantastic4_matmul.chain_operands``), and the fused kernels'
layer tables (``LayerTable``: the slice-major codes of every layer, and
the descriptors, which hold ω and the scale by value).  On the CPU the
plain versions of ws and stream read the stacked operands, and int8
batch_tiled reads the folded α₁.  Each such copy is a :class:`Staged`: the
tensors a launch reads, and the checksum of each, taken from its bytes
when it is built.

A launch notes the copies it read (:func:`note`); a caller collects them
with :func:`reads`.  ``runtime.integrity.GuardedPlan`` collects them
around every launch and checks them against their seals after it, beside
the pack's own tensors.  A flip in a copy that a kernel reads is then
caught like a flip in the pack.  A copy built from a corrupted pack seals
the corruption, but the pack's own checksum catches that.
"""
from __future__ import annotations

import contextlib
import threading
import zlib
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch


def host_bytes(tensors) -> List[np.ndarray]:
    """Each tensor's bytes, copied to the host (flat uint8).  When every
    tensor lies on one CUDA device they are gathered there and copied in
    one transfer: one wait for the card instead of one a tensor."""
    tensors = list(tensors)
    if tensors and all(t.device.type == "cuda" and
                       t.device == tensors[0].device for t in tensors):
        flat = torch.cat([t.detach().contiguous().reshape(-1)
                          .view(torch.uint8) for t in tensors]).cpu().numpy()
        out, off = [], 0
        for t in tensors:
            nbytes = t.numel() * t.element_size()
            out.append(flat[off:off + nbytes])
            off += nbytes
        return out
    return [t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
            .numpy() for t in tensors]


def bytes_crc(b: np.ndarray) -> int:
    """Checksum of raw bytes: a seal never leaves the process, so it is
    zlib's CRC-32 whatever ``runtime.integrity.CRC_ALGO`` is."""
    return zlib.crc32(np.ascontiguousarray(b).data) & 0xFFFFFFFF


class Staged:
    """Device tensors that a launch reads, sealed when they were built
    (a fresh device-to-host copy of their bytes, one transfer).  ``codes``
    is the one among them that holds the 4-bit codes, if any."""

    def __init__(self, what: str, tensors: Sequence[torch.Tensor],
                 codes: Optional[torch.Tensor] = None):
        seen, uniq = set(), []
        for t in tensors:
            key = (t.data_ptr(), t.numel() * t.element_size())
            if key not in seen:
                seen.add(key)
                uniq.append(t)
        self.what = what
        self.codes = codes
        self.tensors = tuple(uniq)
        self.seal = tuple(bytes_crc(b) for b in host_bytes(self.tensors))

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors)


def require_intact(staged: Optional[Staged]) -> None:
    """Raise ``runtime.integrity.IntegrityError`` (kind ``"hot"``) when a
    sealed copy changed since it was built.  A copy built from another
    one (a layer table from the stacked operands, either from the folded
    int8 epilogue) checks it first: the new seal then covers bytes that
    go back to the pack."""
    if staged is None:
        return
    got = tuple(bytes_crc(b) for b in host_bytes(staged.tensors))
    if got != staged.seal:
        from ..runtime.integrity import IntegrityError
        raise IntegrityError(f"{staged.what} copy changed since it was "
                             "built", kind="hot")


_local = threading.local()


@contextlib.contextmanager
def reads() -> Iterator[List[Staged]]:
    """Collect the sealed copies that launches on this thread read inside
    the block (each once, in order of first read)."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    got: List[Staged] = []
    stack.append(got)
    try:
        yield got
    finally:
        stack.pop()


def note(staged: Staged) -> None:
    """Record that a launch on this thread reads ``staged``."""
    for got in getattr(_local, "stack", ()):
        if not any(s is staged for s in got):
            got.append(staged)
