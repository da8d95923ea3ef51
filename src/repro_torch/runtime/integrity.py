"""End-to-end integrity for compact packs: checksums, guards, recovery.

The port of the JAX package's ``runtime/integrity.py``, with the same
digests: a pack frozen, compressed or exported by either package verifies
in the other.

A FantastIC4 pack concentrates an entire fp32 layer into a handful of
4-bit bit-plane bytes plus a §V epilogue — the highest value-density
bytes in the system, where a single flipped bit silently corrupts a
whole column.  This module makes corruption *detectable* at every tier
the bytes live in:

* ``layer_content_crc`` — the canonical per-layer checksum over the
  TRUE-shape code matrix (``codes[:k]``, uint8) and the epilogue arrays
  (omega / alpha1 / bias / alpha2, float32).  It is invariant across
  representations: the frozen hot dict (row-pair packed nibbles, device
  tensors), the cold ``CompressedTensor`` tier, and the on-disk
  ``pack.npz`` artifact all verify against the same value.
* ``payload_crc`` — a cheap checksum over a ``CompressedTensor``'s raw
  payload arrays; lets the cold tier be scrubbed without decoding.
* ``GuardedPlan`` — a delegating plan proxy that re-verifies the live
  operands after each launch (detection happens before results are
  returned, so the micro-batcher's requeue-on-failure keeps the bucket
  intact), screens outputs for NaN/Inf, and can replay a golden canary
  probe through the live plan.
* ``IntegrityError`` — the typed failure every verification raises;
  ``ServingFrontend`` catches it to run the recovery rung (evict the
  poisoned plan, re-decode from the verified cold tier).

On the card, every verify copies the layer's *live device tensors* to
the host (:func:`live_crcs`: the whole stack in one transfer), and with
them the sealed copies the kernels read instead of the pack's own codes
and ω (``kernels.staged``: the slice-major code copies, the layer tables
and their descriptors), checked against the seals taken when they were
built.  It never keeps a host mirror beside them: a flip in device memory,
in the pack or in a copy a launch reads, must change what is checksummed.

Checksum algorithm: CRC32C when the optional ``crc32c`` package is
importable, else zlib's CRC-32 — no new dependencies.  Artifacts record
which algorithm produced their digests (``CRC_ALGO``) so a mismatched
reader fails loudly instead of mis-verifying.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..kernels.staged import bytes_crc, host_bytes
from ..kernels.staged import reads as staged_reads

try:                                    # pragma: no cover - env-dependent
    from crc32c import crc32c as _crc_impl

    CRC_ALGO = "crc32c"
except ImportError:                     # no new deps: fall back to zlib
    import zlib

    _crc_impl = zlib.crc32
    CRC_ALGO = "crc32"


class IntegrityError(RuntimeError):
    """Typed corruption signal.

    ``kind`` says which tier failed verification:

    * ``"hot"``      — a resolved plan's live operands drifted from the
      frozen checksums (recoverable: re-decode from cold);
    * ``"cold"``     — a cold-tier payload or its decoded content failed
      (NOT recoverable from this cache: quarantine);
    * ``"artifact"`` — an on-disk pack (``pack.npz``) is truncated,
      garbled, or fails its stored checksums;
    * ``"content"``  — a hot pack's stamped ``"crc"`` disagrees with its
      arrays at compress time;
    * ``"output"``   — a launch produced NaN/Inf;
    * ``"canary"``   — the golden probe's output changed.
    """

    def __init__(self, message: str, *, kind: str = "hot",
                 model_id: Optional[str] = None,
                 layer: Optional[int] = None,
                 path: Optional[str] = None):
        super().__init__(message)
        self.kind = kind
        self.model_id = model_id
        self.layer = layer
        self.path = path


def host_array(a, dtype=None) -> np.ndarray:
    """``a`` as a host numpy array: a tensor is copied from wherever it
    lives (a device tensor: a fresh device-to-host copy on every call)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a) if dtype is None else np.asarray(a, dtype)


def _crc(data, crc: int = 0) -> int:
    return _crc_impl(data, crc) & 0xFFFFFFFF


def crc_update(crc: int, arr, name: str = "") -> int:
    """Fold one array into a running CRC.  The header (name, dtype,
    shape) is part of the digest so a reshape or dtype change never
    aliases to the same value."""
    arr = np.ascontiguousarray(host_array(arr))
    header = f"{name}:{arr.dtype.str}:{arr.shape}".encode()
    crc = _crc(header, crc)
    return _crc(arr.tobytes(), crc)


def layer_content_crc(codes, omega, alpha1, bias, alpha2) -> int:
    """Canonical checksum of one frozen layer: true-shape (k, n) uint8
    codes + float32 epilogue arrays.  Representation-independent — hot
    packed dicts, cold ``CompressedTensor`` layers, and disk artifacts
    all reduce to this before digesting."""
    crc = crc_update(0, host_array(codes, np.uint8), "codes")
    for name, a in (("omega", omega), ("alpha1", alpha1),
                    ("bias", bias), ("alpha2", alpha2)):
        crc = crc_update(crc, host_array(a, np.float32), name)
    return crc


def unpack_codes_np(packed, k: int, n: int) -> np.ndarray:
    """Host-side inverse of ``bitplanes.pack_codes_rows``: row-pair
    nibbles back to the true (k, n) uint8 code matrix (dropping the
    odd-k zero pad row if one was appended at freeze time)."""
    packed = host_array(packed, np.uint8)
    lo = packed & np.uint8(0xF)
    hi = packed >> np.uint8(4)
    full = np.stack([lo, hi], axis=1).reshape(2 * packed.shape[0], n)
    return full[:k]


def hot_layer_crc(layer: Dict[str, Any]) -> int:
    """``layer_content_crc`` of a hot (resolved / frozen) layer dict,
    read from its live tensors."""
    k, n = (int(s) for s in layer["shape"])
    codes = unpack_codes_np(layer["packed"], k, n)
    return layer_content_crc(codes, layer["omega"], layer["alpha1"],
                             layer["bias"], layer["alpha2"])


_HOT_FIELDS = ("packed", "omega", "alpha1", "bias", "alpha2")
_NP_DTYPE = {torch.uint8: np.uint8, torch.float32: np.float32}


def _layer_tensors(layers) -> Optional[List[torch.Tensor]]:
    tensors = [l[k] for l in layers for k in _HOT_FIELDS]
    if all(isinstance(t, torch.Tensor) and t.dtype in _NP_DTYPE
           for t in tensors):
        return tensors
    return None


def _crcs_from_host(layers, host) -> List[int]:
    crcs = []
    for i, l in enumerate(layers):
        packed, omega, alpha1, bias, alpha2 = host[5 * i:5 * i + 5]
        k, n = (int(s) for s in l["shape"])
        crcs.append(layer_content_crc(unpack_codes_np(packed, k, n), omega,
                                      alpha1, bias, alpha2))
    return crcs


def hot_layer_crcs(layers) -> List[int]:
    """:func:`hot_layer_crc` of every layer, read from the live tensors
    in one device-to-host transfer where they all lie on one CUDA
    device; the digests are the same."""
    return live_crcs(layers)[0]


def live_crcs(layers, staged=()) -> tuple:
    """(:func:`hot_layer_crcs` of ``layers``, the checksum of every tensor
    of the sealed copies ``staged`` in their order), in one transfer."""
    tensors = _layer_tensors(layers)
    extra = [t for s in staged for t in s.tensors]
    if tensors is None:
        return ([hot_layer_crc(l) for l in layers],
                [bytes_crc(b) for b in host_bytes(extra)])
    raw = host_bytes(tensors + extra)
    host = [b.view(_NP_DTYPE[t.dtype]).reshape(tuple(t.shape))
            for t, b in zip(tensors, raw)]
    return (_crcs_from_host(layers, host),
            [bytes_crc(b) for b in raw[len(tensors):]])


def staged_of(layers) -> list:
    """Every sealed copy built from ``layers`` (``kernels.ops``)."""
    from ..kernels import ops
    return ops.staged_operands(layers)


def stamp_pack_crcs(pack: Dict[str, Any]) -> Dict[str, Any]:
    """Stamp ``layer["crc"]`` into every layer of a frozen pack that
    does not already carry one (idempotent; mutates in place)."""
    for layer in pack["layers"]:
        if layer.get("crc") is None:
            layer["crc"] = hot_layer_crc(layer)
    return pack


def payload_crc(ct) -> int:
    """Checksum of a ``CompressedTensor``'s raw payload (format tag,
    logical shape, and every payload array in sorted key order) —
    verifies the cold tier without paying for a decode."""
    crc = _crc(f"{ct.format}:{tuple(ct.shape)}".encode())
    for key, arr in ct.canonical_items():
        crc = crc_update(crc, arr, key)
    return crc


def unwrap_chain(plan, limit: int = 8) -> List[Any]:
    """The plan and every ``.plan``-linked inner proxy, outermost first.
    Wrapper proxies (GuardedPlan, FaultInjector) expose the wrapped
    plan as ``.plan``; terminal plans (ExecutionPlan, CachedPlan) do
    not, which ends the walk."""
    chain: List[Any] = []
    p = plan
    while p is not None and len(chain) < limit:
        chain.append(p)
        nxt = getattr(p, "plan", None)
        if nxt is p:
            break
        p = nxt
    return chain


def entry_layers(entry) -> Optional[list]:
    """The layer list a bucket entry launches from (``ExecutionPlan.entry``
    tags its callables with it, and the proxies pass the tag on), or None
    for an untagged callable.  Verifying the entry's own layers, not the
    program's current ones, keeps a launch on a plan that a recovery
    replaced meanwhile from passing on the fresh plan's checksums."""
    return getattr(entry, "layers", None)


@dataclass(frozen=True)
class IntegrityPolicy:
    """What ``GuardedPlan`` checks and when.

    ``verify_launch``   re-checksum the live operands after every launch
                        (the acceptance guarantee: every corrupted
                        launch is caught before results return).
    ``screen_outputs``  reject launches that produce NaN/Inf.
    ``canary``          keep a golden probe (seeded input + captured
                        output) and re-play it through the live plan at
                        scrub time; bit-equality required.  Only sound
                        while the plan's bucket bindings are stable —
                        leave it off for models subject to fallback.
    """

    verify_launch: bool = True
    screen_outputs: bool = True
    canary: bool = False
    canary_rows: int = 1
    canary_seed: int = 0


class GuardedPlan:
    """Delegating plan proxy that verifies operand checksums and screens
    outputs on the live launch path.

    Guards any :class:`~repro_torch.serving.plans.ServableProgram` whose
    ``.layers`` are standard frozen layer dicts.  Expected per-layer
    checksums come from the stamped ``layer["crc"]`` when the pack
    carries them (freeze / decode both stamp), else are computed from the
    first-seen operands (trust-on-first-use for hand-built packs).
    Verification runs AFTER the inner launch — a flip injected during the
    same call is still caught before results are returned, and the
    raising entry keeps the micro-batcher's requeue-on-failure contract
    intact.  A bucket entry verifies the layers it launched from
    (:func:`entry_layers`) and the sealed copies that launch read
    (``kernels.staged``: on the card the kernels read those, not the
    pack); ``verify()`` with neither, as the scrubber and the recovery
    rung call it, checks the program's layers and every copy memoized for
    them.

    After the frontend's recovery rung re-decodes from the cold tier,
    the same expected checksums re-verify the fresh operands — recovery
    is bit-identical, so no re-arming is needed.
    """

    def __init__(self, plan, *, policy: Optional[IntegrityPolicy] = None,
                 model_id: Optional[str] = None):
        self._plan = plan
        self.policy = policy or IntegrityPolicy()
        self.model_id = model_id
        self._expected: Optional[List[int]] = None
        self._canary_x: Optional[np.ndarray] = None
        self._canary_y: Optional[np.ndarray] = None
        self._lock = threading.Lock()
        self.stats = {"verifies": 0, "detected": 0, "screened": 0,
                      "canary_runs": 0, "canary_failures": 0,
                      "verify_s": 0.0}

    # -- delegation --------------------------------------------------
    @property
    def plan(self):
        return self._plan

    def __getattr__(self, name):
        return getattr(self._plan, name)

    def _count(self, key: str, by=1) -> None:
        with self._lock:
            self.stats[key] += by

    # -- checksums ---------------------------------------------------
    def expected_crcs(self) -> List[int]:
        with self._lock:
            if self._expected is None:
                exp = []
                for layer in self._plan.layers:
                    crc = layer.get("crc")
                    exp.append(int(crc) if crc is not None
                               else hot_layer_crc(layer))
                self._expected = exp
            return list(self._expected)

    def verify(self, layers: Optional[list] = None,
               staged: Optional[list] = None) -> None:
        """Re-checksum the live operands (``layers``, default the
        program's current ones) against the frozen values, and the sealed
        copies the kernels read (``staged``, default every copy built
        from ``layers``) against their seals."""
        t0 = time.perf_counter()
        expected = self.expected_crcs()
        if layers is None:
            layers = self._plan.layers
        if staged is None:
            # a program over several packs (an LM program) names the
            # copies memoized for each of its packs
            own = getattr(self._plan, "staged_operands", None)
            staged = own() if own is not None and \
                layers is self._plan.layers else staged_of(layers)
        if len(layers) != len(expected):
            raise IntegrityError(
                f"layer count changed ({len(expected)} -> {len(layers)})",
                kind="hot", model_id=self.model_id)
        got, sealed = live_crcs(layers, staged)
        for i, (g, exp) in enumerate(zip(got, expected)):
            if g != exp:
                self._count("detected")
                raise IntegrityError(
                    f"hot operand checksum mismatch at layer {i} "
                    f"(expected {exp:#010x}, got {g:#010x})",
                    kind="hot", model_id=self.model_id, layer=i)
        seals = [(s, c) for s in staged for c in s.seal]
        for (s, exp), g in zip(seals, sealed):
            if g != exp:
                self._count("detected")
                raise IntegrityError(
                    f"{s.what} copy the kernels read changed since it was "
                    f"built (expected {exp:#010x}, got {g:#010x})",
                    kind="hot", model_id=self.model_id)
        with self._lock:
            self.stats["verifies"] += 1
            self.stats["verify_s"] += time.perf_counter() - t0

    def _after_launch(self, y, layers: Optional[list] = None,
                      staged: Optional[list] = None):
        if self.policy.verify_launch:
            self.verify(layers, staged)
        if self.policy.screen_outputs:
            finite = bool(torch.isfinite(y).all()) \
                if isinstance(y, torch.Tensor) \
                else bool(np.all(np.isfinite(np.asarray(y))))
            if not finite:
                self._count("screened")
                raise IntegrityError(
                    "non-finite values in launch output",
                    kind="output", model_id=self.model_id)
        return y

    # -- launch surface ----------------------------------------------
    def entry(self, bucket: int):
        inner = self._plan.entry(bucket)
        layers = entry_layers(inner)

        def guarded_entry(xb):
            with staged_reads() as read:
                y = inner(xb)
            return self._after_launch(y, layers, read)

        guarded_entry.layers = layers
        return guarded_entry

    def run(self, x):
        with staged_reads() as read:
            y = self._plan.run(x)
        return self._after_launch(y, None, read)

    # -- canary ------------------------------------------------------
    def arm_canary(self, x: Optional[np.ndarray] = None) -> None:
        """Capture the golden (input, output) pair through the live
        plan.  Called lazily by the first ``check_canary`` when the
        policy enables the canary."""
        if x is None:
            rng = np.random.default_rng(self.policy.canary_seed)
            x = rng.standard_normal(
                (self.policy.canary_rows, self._plan.d_in)).astype(
                    np.float32)
        self._canary_x = np.asarray(x, np.float32)
        self._canary_y = host_array(self._plan.run(self._canary_x))

    def check_canary(self) -> None:
        if self._canary_y is None:
            self.arm_canary()
            return
        y = host_array(self._plan.run(self._canary_x))
        if y.shape != self._canary_y.shape or \
                not np.array_equal(y, self._canary_y):
            self._count("canary_failures")
            raise IntegrityError(
                "canary probe output changed", kind="canary",
                model_id=self.model_id)
        self._count("canary_runs")

    def describe(self) -> Dict[str, Any]:
        inner = self._plan.describe() if hasattr(self._plan, "describe") \
            else {}
        with self._lock:
            stats = dict(self.stats)
        return {**inner, "guarded": True, "integrity_stats": stats}
