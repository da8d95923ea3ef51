"""Frozen serving packs on disk: ``export_pack`` and ``load_pack``.

The port of the JAX package's ``checkpoint/manager.py::export_pack`` and
``load_pack``, in the same format: ``pack.npz`` (the cold tier's
:class:`~repro_torch.serving.pack_cache.ColdPack`, flattened by
``cold_pack_to_payload``) and ``report.json``, written atomically under
one directory.  An artifact written by either package loads, verifies and
serves in the other.  The train-state checkpoints of the JAX package's
``CheckpointManager`` are not ported yet.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Optional

import numpy as np

from ..runtime.integrity import IntegrityError


def export_pack(path: str, pack_or_cold, *, meta: Optional[dict] = None
                ) -> dict:
    """Write a frozen serving pack (``models.mlp.freeze_mlp`` dict or an
    already-cold ``ColdPack``) as its at-rest compressed artifact —
    ``pack.npz`` + ``report.json`` under ``path``, atomically.  This is
    the unit a serving host pulls to (re)register a model: the bytes on
    the wire are the cold tier's bytes."""
    from ..serving.pack_cache import (ColdPack, cold_pack_to_payload,
                                      compress_pack)
    cold = pack_or_cold if isinstance(pack_or_cold, ColdPack) \
        else compress_pack(pack_or_cold)
    payload = cold_pack_to_payload(cold)
    report = {
        "layers": [{"format": l.codes.format, "shape": list(l.shape),
                    "bytes": l.size_bytes} for l in cold.layers],
        "compressed_bytes": cold.size_bytes,
        "fp32_bytes": cold.fp32_bytes,
        "compression_ratio": cold.compression_ratio,
        **(meta or {}),
    }
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    # a crash between mkdtemp and os.replace leaves an orphaned temp
    # behind; sweep stale ones before paying for the new write
    for name in os.listdir(parent):
        if not (name.startswith(".tmp_pack_") or name.endswith(".tmp")):
            continue
        stale = os.path.join(parent, name)
        try:
            if os.path.isdir(stale):
                shutil.rmtree(stale, ignore_errors=True)
            else:
                os.remove(stale)
        except OSError:
            pass
    tmp = tempfile.mkdtemp(dir=parent, prefix=".tmp_pack_")
    try:
        np.savez(os.path.join(tmp, "pack.npz"), **payload)
        with open(os.path.join(tmp, "report.json"), "w") as f:
            json.dump(report, f, indent=2)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return report


def load_pack(path: str, *, verify: bool = True):
    """Load an :func:`export_pack` artifact as a
    :class:`~repro_torch.serving.pack_cache.ColdPack` — feed it to
    ``PackCache.add`` or ``PackCache.update`` without decoding anything
    here.

    A truncated / garbled / field-stripped ``pack.npz`` raises a typed
    :class:`~repro_torch.runtime.integrity.IntegrityError` (kind
    ``"artifact"``) naming the file, and with ``verify=True`` the stored
    payload checksums are re-verified before the pack is trusted."""
    from ..serving.pack_cache import cold_pack_from_payload, \
        verify_cold_pack
    npz = os.path.join(path, "pack.npz")
    try:
        with np.load(npz) as z:
            payload = {k: z[k] for k in z.files}
    except FileNotFoundError:
        raise
    except Exception as exc:       # zipfile/zlib/pickle decode failures
        raise IntegrityError(
            f"pack artifact {npz} is truncated or garbled: {exc}",
            kind="artifact", path=npz) from exc
    try:
        cold = cold_pack_from_payload(payload)
    except IntegrityError as exc:
        raise IntegrityError(
            f"pack artifact {npz} failed verification: {exc}",
            kind="artifact", path=npz) from exc
    except (KeyError, ValueError) as exc:
        raise IntegrityError(
            f"pack artifact {npz} is missing fields (partial write?): "
            f"{exc}", kind="artifact", path=npz) from exc
    if verify:
        try:
            verify_cold_pack(cold)
        except IntegrityError as exc:
            raise IntegrityError(
                f"pack artifact {npz} failed checksum verification: "
                f"{exc}", kind="artifact", path=npz) from exc
    return cold
