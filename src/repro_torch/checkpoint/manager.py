"""Checkpoints, compressed 4-bit exports and frozen serving packs on disk.

The port of the JAX package's ``checkpoint/manager.py``, in its formats:

* **train checkpoints** (:class:`CheckpointManager`) — the whole train
  state (fp32 masters, Adam moments, ECL probabilities, step) as
  ``step_XXXXXXXX/state.npz`` + ``meta.json``, each array named by its
  tree path joined with ``//``.  Written to a temp dir and ``os.replace``d
  into place, so a preemption mid-write never corrupts the latest
  checkpoint; ``keep`` old steps are garbage-collected.  Restore places
  each array on its template leaf's device (or one named device).  Over a
  mesh the save gathers each leaf whole from the ranks' blocks and rank 0
  writes the same npz of whole arrays; the restore is elastic, as the
  reference's ``restore(sharding_fn=)``: each rank cuts its block of each
  array under the current mesh's layout, so a checkpoint saved on one
  mesh restores onto another, or into one process, and the reverse.  The
  int8 error feedback is each rank's own: it is saved per rank beside
  the npz and restored only onto the mesh that saved it.
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
import torch.distributed as dist

from .. import resolve_device
from ..core import bitplanes, ecl, formats, qat
from ..runtime.integrity import IntegrityError
from ..runtime.sharding import (gather_tree, named_specs, shard_slice,
                                spec_axes)
from ..tree import map_

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


def _tree_like(template: Any, flat, device=None, prefix=(),
               sharding_fn=None) -> Any:
    """``template``'s structure with the arrays of ``flat`` (a mapping of
    names to arrays, read one at a time): a tensor leaf becomes a tensor of
    its dtype on ``device`` (default: its own device), any other leaf a
    numpy array of its dtype.  With ``sharding_fn`` each array is this
    rank's block of it (:meth:`CheckpointManager.restore`)."""
    if isinstance(template, dict):
        return {k: _tree_like(v, flat, device, prefix + (str(k),),
                              sharding_fn)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_tree_like(v, flat, device, prefix + (str(i),),
                                         sharding_fn)
                              for i, v in enumerate(template))
    name = SEP.join(prefix)
    if name not in flat:
        raise KeyError(f"checkpoint missing {name}")
    arr = flat[name]
    shape = tuple(template.shape) if isinstance(template, torch.Tensor) \
        else np.shape(template)
    if sharding_fn is not None and isinstance(template, torch.Tensor):
        placed = sharding_fn(name, template)
        whole = torch.from_numpy(np.asarray(arr, order="C"))
        block = shard_slice(whole, placed.spec, placed.mesh)
        if tuple(block.shape) != shape:
            raise ValueError(f"{name}: checkpoint shape {arr.shape} cut by "
                             f"{placed.spec} is {tuple(block.shape)}, model "
                             f"{shape}")
        dev = template.device if device is None else torch.device(device)
        # a copy: no view keeps the whole array alive past its cut
        return block.to(device=dev, dtype=template.dtype, copy=True)
    if tuple(arr.shape) != shape:
        raise ValueError(f"{name}: checkpoint shape {arr.shape} != model "
                         f"{shape}")
    if isinstance(template, torch.Tensor):
        dev = template.device if device is None else torch.device(device)
        return torch.from_numpy(np.asarray(arr, order="C")).to(
            device=dev, dtype=template.dtype)
    return arr.astype(np.asarray(template).dtype)


def _mesh_meta(mesh) -> dict:
    return {"axes": list(mesh.axis_names),
            "shape": [mesh.shape[a] for a in mesh.axis_names]}


def _barrier(mesh) -> None:
    if mesh.size > 1 and dist.is_initialized():
        dist.barrier()


def _zeros_like(template: Any, device=None) -> Any:
    return map_(lambda t: torch.zeros(
        t.shape, dtype=t.dtype,
        device=t.device if device is None else torch.device(device)),
        template)


class CheckpointManager:
    """Atomic, keep-k train checkpoints under ``directory``."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save

    def save(self, step: int, state: Any, extra: Optional[dict] = None, *,
             specs: Any = None, mesh=None) -> str:
        """Atomic: write to a temp dir, then rename.  Returns the final
        path.

        With ``mesh`` (collective: every rank of the mesh calls it)
        ``state`` is this rank's, each leaf its block under ``specs`` (a
        tree like ``state`` of spec tuples over the whole tree: the
        params' layout, ZeRO-1's cut of m and v over the data axes on top
        of it; None: every leaf whole): each leaf is gathered whole
        (``runtime.sharding.gather_tree``), one at a time, and rank 0
        writes the npz of whole arrays that one process writes, under the
        same names.  A dict state's ``err`` (the int8 error feedback) is
        each rank's own: every rank writes its ``err/rank<r>.npz`` into
        the temp dir, and ``meta.json`` names the mesh.  The ranks meet at
        barriers, so that the rename comes after every file and every rank
        returns after it."""
        if mesh is None:
            return self._write(step, _flatten(state), extra, None)
        err = state.get("err") if isinstance(state, dict) else None
        body = {k: v for k, v in state.items() if k != "err"} \
            if err is not None else state
        body_specs = specs if err is None or specs is None else {
            k: specs[k] for k in body}
        flat = {}
        for name, leaf, spec in named_specs(body, body_specs):
            if isinstance(leaf, torch.Tensor) and spec and spec_axes(spec):
                leaf = gather_tree(leaf, spec, mesh)
            if mesh.rank == 0:
                flat[name] = _host(leaf)
            del leaf
        meta = {"mesh": _mesh_meta(mesh), **(extra or {})}
        if err is not None:
            meta["err"] = "per rank"
        return self._write(step, flat, meta, mesh, err)

    def _write(self, step: int, flat: dict, extra: Optional[dict], mesh,
               err: Any = None) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        lead = mesh is None or mesh.rank == 0
        # one temp dir for every rank: rank 0 makes it, the others write
        # their error feedback into it before rank 0 renames it
        tmp = os.path.join(self.dir, f".tmp_step_{step:08d}") \
            if mesh is not None else None
        if lead:
            if tmp is None:
                tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
            else:
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
        try:
            if mesh is not None:
                _barrier(mesh)
                if err is not None:
                    os.makedirs(os.path.join(tmp, "err"), exist_ok=True)
                    np.savez(os.path.join(tmp, "err", f"rank{mesh.rank}.npz"),
                             **_flatten(err))
                _barrier(mesh)
            if lead:
                np.savez(os.path.join(tmp, "state.npz"), **flat)
                meta = {"step": int(step), **(extra or {})}
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
        except BaseException:
            if lead:
                shutil.rmtree(tmp, ignore_errors=True)
            raise
        if lead:
            self._gc()
        if mesh is not None:
            _barrier(mesh)
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
                device=None, *, sharding_fn=None) -> tuple:
        """Load into the structure of ``template``; each array lands on
        its template leaf's device, or on ``device`` when one is named.
        Returns (state, meta).

        ``sharding_fn(path, leaf)`` (the reference's elastic restore)
        gives the ``runtime.sharding.NamedSpec`` of each leaf on the
        current mesh (``path`` its ``//`` name, ``leaf`` this rank's
        template leaf, its block): each array is read whole, this rank's
        block cut (``shard_slice``) and copied, and the whole one dropped
        before the next is read.  A dict template's ``err`` (the int8
        error feedback, each rank's own) is restored from the rank's file
        only onto the mesh that saved it; on another mesh, in one process
        after a mesh's save, or on a mesh after one process's save, it is
        reset to zeros (the residuals belong to the saving ranks' rows and
        blocks)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        err_t = template.get("err") if isinstance(template, dict) else None
        own = err_t is not None and (meta.get("err") == "per rank"
                                     or sharding_fn is not None)
        body = {k: v for k, v in template.items() if k != "err"} if own \
            else template
        with np.load(os.path.join(path, "state.npz")) as z:
            state = _tree_like(body, z, device, sharding_fn=sharding_fn)
        if own:
            state["err"] = self._restore_err(path, meta, err_t, body, device,
                                             sharding_fn)
        return state, meta

    @staticmethod
    def _restore_err(path: str, meta: dict, template: Any, body: Any,
                     device, sharding_fn) -> Any:
        """The rank's saved error feedback where the current mesh (read
        off ``sharding_fn`` of the first leaf of ``body``) is the saving
        one, else zeros like ``template``."""
        if sharding_fn is None or meta.get("err") != "per rank":
            return _zeros_like(template, device)
        name, leaf, _ = next(named_specs(body, None))
        mesh = sharding_fn(name, leaf).mesh
        if _mesh_meta(mesh) != meta.get("mesh"):
            return _zeros_like(template, device)
        with np.load(os.path.join(path, "err", f"rank{mesh.rank}.npz")) as z:
            return _tree_like(template, z, device)


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
