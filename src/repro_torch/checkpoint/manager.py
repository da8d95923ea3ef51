"""Checkpoints, compressed 4-bit exports and frozen serving packs on disk.

The port of the JAX package's ``checkpoint/manager.py``, in its formats:

* **train checkpoints** (:class:`CheckpointManager`) — the whole train
  state (fp32 masters, Adam moments, ECL probabilities, step) as
  ``step_XXXXXXXX/state.npz`` + ``meta.json``, each array named by its
  tree path joined with ``//``.  Written to a temp dir and ``os.replace``d
  into place, so a preemption mid-write never corrupts the latest
  checkpoint; ``keep`` old steps are garbage-collected.  Restore places
  each array on its template leaf's device (or one named device).
* **serving exports** (:func:`export_quantized` / :func:`load_quantized`)
  — per quantized tensor the ECL codes in their cheapest lossless format
  (CSR / bitmask / dense4, or Huffman) + the fp32 centroids; every
  tensor is assigned in one grouped call, a Huffman stream is encoded
  where its codes lie (and decoded on a device named at load).  An
  L-stacked leaf keeps its shape ((L, E, d_in, d_out) codes and (L, E, 4)
  ω for a MoE bank), and :func:`frozen_tree` turns a loaded export into
  the tree ``qat.freeze_tree`` gives, to serve it.
* **frozen serving packs** (:func:`export_pack` / :func:`load_pack`) —
  ``pack.npz`` (the cold tier's
  :class:`~repro_torch.serving.pack_cache.ColdPack`, flattened by
  ``cold_pack_to_payload``) and ``report.json``, written atomically.

A checkpoint, export or pack written by either package reads in the
other.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import bitplanes, ecl, formats, qat
from ..runtime.integrity import IntegrityError

SEP = "//"


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _paths(tree: Any, prefix: tuple = ()):
    """(name, leaf) in the JAX package's flattening order: dict keys
    sorted, sequences by index; names join the path with ``//``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield SEP.join(prefix), tree


def _flatten(tree: Any) -> dict:
    return {name: _host(leaf) for name, leaf in _paths(tree)}


def _tree_like(template: Any, flat: dict, device=None, prefix=()) -> Any:
    """``template``'s structure with the arrays of ``flat``: a tensor leaf
    becomes a tensor of its dtype on ``device`` (default: its own device),
    any other leaf a numpy array of its dtype."""
    if isinstance(template, dict):
        return {k: _tree_like(v, flat, device, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_tree_like(v, flat, device, prefix + (str(i),))
                              for i, v in enumerate(template))
    name = SEP.join(prefix)
    if name not in flat:
        raise KeyError(f"checkpoint missing {name}")
    arr = flat[name]
    shape = tuple(template.shape) if isinstance(template, torch.Tensor) \
        else np.shape(template)
    if tuple(arr.shape) != shape:
        raise ValueError(f"{name}: checkpoint shape {arr.shape} != model "
                         f"{shape}")
    if isinstance(template, torch.Tensor):
        dev = template.device if device is None else torch.device(device)
        return torch.from_numpy(np.asarray(arr, order="C")).to(
            device=dev, dtype=template.dtype)
    return arr.astype(np.asarray(template).dtype)


class CheckpointManager:
    """Atomic, keep-k train checkpoints under ``directory``."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save

    def save(self, step: int, state: Any, extra: Optional[dict] = None
             ) -> str:
        """Atomic: write to a temp dir, then rename.  Returns the final
        path."""
        flat = _flatten(state)
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        try:
            np.savez(os.path.join(tmp, "state.npz"), **flat)
            meta = {"step": int(step), **(extra or {})}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def all_steps(self) -> list:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ---------------------------------------------------------- restore

    def restore(self, template: Any, step: Optional[int] = None,
                device=None) -> tuple:
        """Load into the structure of ``template``; each array lands on
        its template leaf's device, or on ``device`` when one is named.
        Returns (state, meta)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(path, "state.npz")) as z:
            flat = {k: z[k] for k in z.files}
        state = _tree_like(template, flat, device)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return state, meta


# ------------------------------------------------------------- exports

def _visit(prefix: str, node: Any, qs: Any, quant: list,
           plain: list) -> None:
    """Collect (prefix, node, state) of every quantized leaf into
    ``quant`` and (prefix, leaf) of every other into ``plain``; a
    module-level walk, so no closure cycle keeps the tree's tensors
    alive after the export."""
    if qat.is_quant_leaf(node):
        quant.append((prefix, node, qs))
    elif isinstance(node, dict):
        for k in node:
            _visit(prefix + SEP + k if prefix else k, node[k],
                   qs[k] if isinstance(qs, dict) else 0, quant, plain)
    elif isinstance(node, (list, tuple)):
        for i, sub in enumerate(node):
            _visit(f"{prefix}{SEP}{i}", sub,
                   qs[i] if isinstance(qs, (list, tuple)) else 0, quant,
                   plain)
    else:
        plain.append((prefix, node))


def export_quantized(path: str, params: Any, qstate: Any, lam) -> dict:
    """Write the 4-bit serving artifact ``export.npz`` + ``report.json``:
    each quantized tensor's codes in their cheapest lossless format +
    centroids, unquantized leaves as they are.  Every tensor is assigned
    in one grouped call (on the card ⌈segments / 32⌉ ecl_quant launches).
    Returns the size report (the Table II analogue over this model)."""
    os.makedirs(path, exist_ok=True)
    quant: list = []
    plain: list = []
    _visit("", params, qstate, quant, plain)
    all_codes = ecl.assign_many([n["w"] for _, n, _ in quant],
                                [n["omega"] for _, n, _ in quant],
                                [q["probs"] for _, _, q in quant], lam)
    payload: dict = {}
    report = {"tensors": {}, "compressed_bytes": 0, "fp32_bytes": 0,
              "dense4_bytes": 0}
    for (prefix, node, _), codes_t in zip(quant, all_codes):
        codes = _host(codes_t)
        flat2d = codes.reshape(-1, codes.shape[-1])
        ct = formats.encode(codes_t.reshape(flat2d.shape),
                            formats.select_format_ext(flat2d))
        payload[prefix + SEP + "format"] = np.frombuffer(
            ct.format.encode(), dtype=np.uint8)
        payload[prefix + SEP + "shape"] = np.asarray(codes.shape)
        for k, v in ct.payload.items():
            payload[prefix + SEP + k] = v
        omega = _host(node["omega"])
        payload[prefix + SEP + "omega"] = omega
        nbytes = ct.size_bytes + omega.size * 4
        report["tensors"][prefix] = {
            "format": ct.format, "bytes": nbytes,
            "sparsity": float((codes == 0).mean())}
        report["compressed_bytes"] += nbytes
        report["fp32_bytes"] += codes.size * 4
        report["dense4_bytes"] += (codes.size + 1) // 2
    for prefix, node in plain:
        arr = _host(node)
        payload[prefix] = arr
        for key in ("fp32_bytes", "compressed_bytes", "dense4_bytes"):
            report[key] += arr.nbytes
    np.savez(os.path.join(path, "export.npz"), **payload)
    report["compression_ratio"] = (report["fp32_bytes"]
                                   / max(report["compressed_bytes"], 1))
    with open(os.path.join(path, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def load_quantized(path: str, device=None) -> dict:
    """Read an :func:`export_quantized` artifact back: ``{tensor prefix:
    {"codes": (…, n) uint8, "omega": (*lead, 4) fp32}}`` for each
    quantized tensor plus ``{prefix: array}`` for the unquantized leaves
    (the decoded-code form ``bitplanes.decode`` takes): all numpy, or all
    tensors on ``device`` when one is named, a Huffman stream then
    decoded there (the card decodes a MoE bank's in a fraction of the
    host's time)."""
    with np.load(os.path.join(path, "export.npz")) as z:
        payload = {k: z[k] for k in z.files}
    quant_prefixes = sorted(
        k[: -len(SEP + "format")] for k in payload
        if k.endswith(SEP + "format"))
    out: dict = {}
    claimed = set()
    for prefix in quant_prefixes:
        fmt = payload[prefix + SEP + "format"].tobytes().decode()
        shape = tuple(int(d) for d in payload[prefix + SEP + "shape"])
        meta_keys = {prefix + SEP + k for k in ("format", "shape", "omega")}
        ct_payload = {}
        for key in payload:
            if key.startswith(prefix + SEP) and key not in meta_keys:
                field = key[len(prefix + SEP):]
                if SEP not in field:      # not a nested sibling tensor
                    ct_payload[field] = payload[key]
        flat2d_shape = (int(np.prod(shape[:-1])), shape[-1])
        ct = formats.CompressedTensor(fmt, flat2d_shape, ct_payload)
        out[prefix] = {"codes": formats.decode(ct, device).reshape(shape),
                       "omega": _on(payload[prefix + SEP + "omega"], device)}
        claimed.update(meta_keys)
        claimed.update(prefix + SEP + k for k in ct_payload)
    for key, arr in payload.items():
        if key not in claimed:
            out[key] = _on(arr, device)
    return out


def _on(arr: np.ndarray, device):
    return arr if device is None else torch.from_numpy(arr).to(device)


def frozen_tree(loaded: dict, device=None) -> dict:
    """The serving tree of a :func:`load_quantized` result (numpy, or
    tensors on ``device``), as ``qat.freeze_tree`` makes it: each quantized tensor ``{"packed":
    row-pair-packed uint8 (*lead, K/2, N), "omega": fp32}`` (a MoE bank
    (L, E, d_in/2, d_out)), every other leaf a tensor of its dtype, all
    on ``device`` (default: the card), nested by the ``//`` paths."""
    dev = resolve_device(device)
    out: dict = {}
    for key, value in loaded.items():
        node = out
        *parents, leaf = key.split(SEP)
        for name in parents:
            node = node.setdefault(name, {})
        if isinstance(value, dict):
            codes = torch.as_tensor(value["codes"], device=dev)
            node[leaf] = {"packed": bitplanes.pack_codes_rows(codes),
                          "omega": torch.as_tensor(value["omega"],
                                                   dtype=torch.float32,
                                                   device=dev)}
        else:
            node[leaf] = torch.as_tensor(value, device=dev)
    return out


# frozen serving packs: at-rest ColdPack artifact (the cold tier's format)


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
