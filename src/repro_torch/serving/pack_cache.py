"""Two-tier packed-weight model store: compressed cold tier, LRU hot tier.

The port of the JAX package's ``serving/pack_cache.py``.  A model's cold
form (:class:`ColdPack`) is host numpy and equal, array by array, to the
JAX package's, so one ``pack.npz`` serves either package; its hot form is
an :class:`~repro_torch.serving.plans.ExecutionPlan` over device tensors
on the cache's device.

* **cold tier** — every registered model lives in its entropy-coded
  :class:`~repro_torch.core.formats.CompressedTensor` form (``dense4`` /
  ``bitmask`` / ``csr`` / ``huffman``, chosen per layer by
  ``select_format_ext``) plus the fp32 §V epilogue constants, on the host.
* **hot tier** — an LRU of resolved plans under a configurable budget
  (``max_hot`` entries and/or ``hot_bytes`` decoded bytes).  A model is
  decoded, calibrated, and plan-resolved **lazily on first traffic**;
  eviction releases the plan, its pinned ``plans._PLAN_MEMO`` entry and
  the kernel-level operand memos (``ops.forget_pack_operands``: the
  chain's slice-major code copies, the ws stacks, the layer tables) — the
  model falls back to its compressed form and the next request
  re-resolves it.

Device memory comes back for real on eviction: nothing but the cache and
those memos holds the decoded tensors, and every launch records the
stream it runs on against the tensors it reads (``build.keep_for_stream``),
so memory a launch on another stream may still be reading is not handed
to a new allocation before that launch is done.

**Bit-identity across evict/reload** holds by construction: the codecs
are lossless, plan resolution is deterministic, and the int8 activation
scales measured at the *first* resolve are kept as the model's
calibration — a re-resolve reuses them instead of re-measuring.

Count-budget eviction runs **before** the new resolve, so the hot tier's
high-water mark never exceeds ``max_hot`` plans; the byte budget is
enforced after (the new plan's size is unknowable until decode) and
always spares the entry being returned.

:class:`CachedPlan` is the registry-facing face: a lazy proxy that
exposes the static plan surface (``d_in``/``d_out``/``bucket_sizes``/
``device``) without decoding, and resolves through the cache on first use
of an execution attribute (``bucket_for``/``entry``/``run``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..core import bitplanes, formats
from ..kernels import build
from ..runtime import integrity
from ..runtime.integrity import IntegrityError
from .plans import (DEFAULT_MAX_BUCKET, ExecutionPlan, _pow2_buckets,
                    adopt_plan, build_plan, forget_plan)

__all__ = [
    "ColdLayer", "ColdPack", "CachedPlan", "PackCache",
    "compress_pack", "decode_pack", "plan_resident_bytes",
    "cold_pack_to_payload", "cold_pack_from_payload",
    "verify_cold_pack",
]


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    a = np.asarray(a)
    return int(a.size) * a.dtype.itemsize


# --------------------------------------------------------------- cold form

@dataclasses.dataclass(frozen=True)
class ColdLayer:
    """One layer at rest: entropy-coded 4-bit codes + fp32 epilogue."""
    codes: formats.CompressedTensor     # (k, n) uint8 codes, compressed
    omega: np.ndarray                   # (4,) centroid basis
    alpha1: np.ndarray                  # (n,) §V scale
    bias: np.ndarray                    # (n,) folded bias
    alpha2: np.ndarray                  # scalar §V rescale
    shape: Tuple[int, int]              # (k, n) true shape (pre-padding)
    activation: Optional[str]           # "relu" | None
    # integrity digests (None on packs built before checksumming existed):
    # content_crc is the representation-independent layer_content_crc;
    # payload_crc covers the raw CompressedTensor payload so the cold
    # tier can be scrubbed without a decode.
    content_crc: Optional[int] = None
    payload_crc: Optional[int] = None

    @property
    def size_bytes(self) -> int:
        """At-rest footprint: compressed codes + epilogue constants."""
        return (self.codes.size_bytes + _nbytes(self.omega)
                + _nbytes(self.alpha1) + _nbytes(self.bias)
                + _nbytes(self.alpha2))

    @property
    def fp32_bytes(self) -> int:
        """The dense fp32 weight this layer replaces (paper CR basis)."""
        k, n = self.shape
        return (4 * k * n + _nbytes(self.omega) + _nbytes(self.alpha1)
                + _nbytes(self.bias) + _nbytes(self.alpha2))


@dataclasses.dataclass(frozen=True)
class ColdPack:
    """A frozen pack in its at-rest form — what the cold tier stores and
    what :func:`repro_torch.checkpoint.manager.export_pack` serializes."""
    layers: Tuple[ColdLayer, ...]
    act_bits: Optional[int] = None

    @property
    def shapes(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(l.shape for l in self.layers)

    @property
    def d_in(self) -> int:
        return self.layers[0].shape[0]

    @property
    def d_out(self) -> int:
        return self.layers[-1].shape[1]

    @property
    def size_bytes(self) -> int:
        return sum(l.size_bytes for l in self.layers)

    @property
    def fp32_bytes(self) -> int:
        return sum(l.fp32_bytes for l in self.layers)

    @property
    def compression_ratio(self) -> float:
        return self.fp32_bytes / max(self.size_bytes, 1)


def compress_pack(pack: dict) -> ColdPack:
    """Frozen serving pack (``models.mlp.freeze_mlp``, on any device) →
    at-rest form on the host.

    Codes are recovered from the kernel's row-pair nibble layout, the
    odd-``k`` zero padding row is stripped (``shape`` keeps the true
    ``k``), and each layer picks its best format over the extended set
    (including huffman).  Lossless: :func:`decode_pack` rebuilds a pack
    whose plan output is bit-identical to the original's."""
    layers = []
    for i, layer in enumerate(pack["layers"]):
        k, n = (int(d) for d in layer["shape"])
        codes = integrity.unpack_codes_np(layer["packed"], k, n)
        omega = integrity.host_array(layer["omega"], np.float32)
        alpha1 = integrity.host_array(layer["alpha1"], np.float32)
        bias = integrity.host_array(layer["bias"], np.float32)
        alpha2 = integrity.host_array(layer["alpha2"], np.float32)
        crc = integrity.layer_content_crc(codes, omega, alpha1, bias,
                                          alpha2)
        stamped = layer.get("crc")
        if stamped is not None and int(stamped) != crc:
            raise IntegrityError(
                f"pack layer {i} content disagrees with its stamped "
                f"checksum (expected {int(stamped):#010x}, got "
                f"{crc:#010x})", kind="content", layer=i)
        ct = formats.encode(codes, formats.select_format_ext(codes))
        layers.append(ColdLayer(
            codes=ct, omega=omega, alpha1=alpha1, bias=bias, alpha2=alpha2,
            shape=(k, n), activation=layer.get("activation"),
            content_crc=crc, payload_crc=integrity.payload_crc(ct)))
    return ColdPack(layers=tuple(layers), act_bits=pack.get("act_bits"))


def _check_payload(i: int, cl: ColdLayer) -> None:
    if cl.payload_crc is None:
        return
    got = integrity.payload_crc(cl.codes)
    if got != cl.payload_crc:
        raise IntegrityError(
            f"cold payload checksum mismatch at layer {i} "
            f"(expected {cl.payload_crc:#010x}, got {got:#010x})",
            kind="cold", layer=i)


def verify_cold_pack(cold: ColdPack) -> None:
    """Payload-level scrub of the cold tier: re-checksum every layer's
    raw ``CompressedTensor`` payload against ``payload_crc``.  Cheap (no
    decode) — the full content check happens on every
    :func:`decode_pack`.  Layers without digests (pre-checksum packs)
    are skipped."""
    for i, cl in enumerate(cold.layers):
        _check_payload(i, cl)


def decode_pack(cold: ColdPack, device=None) -> dict:
    """At-rest form → frozen serving pack of tensors on ``device`` (CUDA
    unless told otherwise): ``freeze_mlp`` layout, kernel row-pair
    packing, odd-``k`` zero pad, compression metadata kept so
    ``models.mlp.pack_compression_summary`` still reads it.  Every payload
    and content checksum is verified on the way up.  The copies to the
    card are waited for before the pack is returned, so a launch on any
    stream may read it."""
    dev = resolve_device(device)
    layers = []
    for i, cl in enumerate(cold.layers):
        k, n = cl.shape
        _check_payload(i, cl)
        try:
            codes = formats.decode(cl.codes).astype(np.uint8).reshape(k, n)
        except IntegrityError:
            raise
        except Exception as exc:
            raise IntegrityError(
                f"cold payload at layer {i} failed to decode: {exc}",
                kind="cold", layer=i) from exc
        content_crc = integrity.layer_content_crc(
            codes, cl.omega, cl.alpha1, cl.bias, cl.alpha2)
        if cl.content_crc is not None and content_crc != cl.content_crc:
            raise IntegrityError(
                f"decoded content checksum mismatch at layer {i} "
                f"(expected {cl.content_crc:#010x}, got "
                f"{content_crc:#010x})", kind="cold", layer=i)
        full = codes
        if k % 2:
            full = np.concatenate([codes, np.zeros((1, n), np.uint8)],
                                  axis=0)

        def t(a):
            return torch.from_numpy(np.array(a, np.float32)).to(dev)
        layers.append({
            "packed": bitplanes.pack_codes_rows(
                torch.from_numpy(full).to(dev)).contiguous(),
            "omega": t(cl.omega),
            "alpha1": t(cl.alpha1),
            "bias": t(cl.bias),
            "alpha2": t(cl.alpha2),
            "shape": (k, n),
            "activation": cl.activation,
            "format": cl.codes.format,
            "size_bytes": cl.codes.size_bytes,
            "dense_bytes": k * n * 4,
            "crc": content_crc,
        })
    build.publish(dev)
    pack = {"layers": layers}
    if cold.act_bits is not None:
        pack["act_bits"] = cold.act_bits
    return pack


# ------------------------------------------------- npz payload (de)serial

_SEP = "//"


def cold_pack_to_payload(cold: ColdPack, prefix: str = ""
                         ) -> Dict[str, np.ndarray]:
    """Flatten a :class:`ColdPack` into an ``np.savez``-able dict.  Keys
    are ``{prefix}layer{i}//field`` with the compressed payload nested a
    level deeper (``...//codes//{payload key}``)."""
    out: Dict[str, np.ndarray] = {
        prefix + "num_layers": np.int64(len(cold.layers)),
        prefix + "act_bits": np.int64(-1 if cold.act_bits is None
                                      else cold.act_bits),
        prefix + "crc_algo": np.array(integrity.CRC_ALGO),
    }
    for i, cl in enumerate(cold.layers):
        p = f"{prefix}layer{i}{_SEP}"
        out[p + "format"] = np.array(cl.codes.format)
        out[p + "shape"] = np.asarray(cl.shape, np.int64)
        out[p + "activation"] = np.array(cl.activation or "")
        out[p + "content_crc"] = np.int64(
            -1 if cl.content_crc is None else cl.content_crc)
        out[p + "payload_crc"] = np.int64(
            -1 if cl.payload_crc is None else cl.payload_crc)
        out[p + "omega"] = np.asarray(cl.omega, np.float32)
        out[p + "alpha1"] = np.asarray(cl.alpha1, np.float32)
        out[p + "bias"] = np.asarray(cl.bias, np.float32)
        out[p + "alpha2"] = np.asarray(cl.alpha2, np.float32)
        for key, arr in cl.codes.payload.items():
            out[f"{p}codes{_SEP}{key}"] = np.asarray(arr)
    return out


def cold_pack_from_payload(payload: Dict[str, np.ndarray],
                           prefix: str = "") -> ColdPack:
    """Inverse of :func:`cold_pack_to_payload` (accepts a live dict or a
    loaded ``NpzFile``).  A payload whose digests came from another
    checksum algorithm than this host's is refused."""
    n_layers = int(np.asarray(payload[prefix + "num_layers"]))
    act_bits = int(np.asarray(payload[prefix + "act_bits"]))
    algo_key = prefix + "crc_algo"
    if algo_key in payload:
        algo = str(np.asarray(payload[algo_key]))
        if algo != integrity.CRC_ALGO:
            raise IntegrityError(
                f"pack digests use checksum algorithm {algo!r} but this "
                f"host verifies with {integrity.CRC_ALGO!r}; refusing to "
                "mis-verify", kind="artifact")

    def _opt_crc(key: str) -> Optional[int]:
        if key not in payload:
            return None           # pre-checksum artifact
        v = int(np.asarray(payload[key]))
        return None if v < 0 else v

    layers = []
    for i in range(n_layers):
        p = f"{prefix}layer{i}{_SEP}"
        fmt = str(np.asarray(payload[p + "format"]))
        shape = tuple(int(d) for d in np.asarray(payload[p + "shape"]))
        act = str(np.asarray(payload[p + "activation"])) or None
        codes_prefix = f"{p}codes{_SEP}"
        ct_payload = {key[len(codes_prefix):]: np.asarray(payload[key])
                      for key in payload
                      if key.startswith(codes_prefix)}
        layers.append(ColdLayer(
            codes=formats.CompressedTensor(fmt, shape, ct_payload),
            omega=np.asarray(payload[p + "omega"], np.float32),
            alpha1=np.asarray(payload[p + "alpha1"], np.float32),
            bias=np.asarray(payload[p + "bias"], np.float32),
            alpha2=np.asarray(payload[p + "alpha2"], np.float32),
            shape=shape, activation=act,
            content_crc=_opt_crc(p + "content_crc"),
            payload_crc=_opt_crc(p + "payload_crc")))
    return ColdPack(layers=tuple(layers),
                    act_bits=None if act_bits < 0 else act_bits)


# ----------------------------------------------------------- hot-tier cost

def plan_resident_bytes(plan) -> int:
    """Decoded footprint of a resolved program's operands (the hot-tier
    accounting unit): per-layer packed codes + epilogue constants, plus
    the calibration vector.  The memoized kernel operands (slice-major
    code copies, ws stacks, layer tables) scale with this, so it is the
    byte knob ``hot_bytes`` budgets against."""
    total = 0
    for layer in plan.layers:
        for key in ("packed", "omega", "alpha1", "bias", "alpha2"):
            total += _nbytes(layer[key])
    scales = getattr(plan, "act_scales", None)
    if scales is not None:
        total += 4 * len(scales)
    return total


# ----------------------------------------------------------------- proxy

class CachedPlan:
    """Lazy plan handle: static surface without decoding, execution
    surface resolved through the owning :class:`PackCache` per call.
    Safe to hold across evictions — every execution attribute re-resolves
    (LRU hit when hot, decode+rebuild when cold)."""

    rows_per_request: Optional[int] = None   # row-oriented, like the plans

    def __init__(self, cache: "PackCache", model_id: str, *,
                 d_in: int, d_out: int,
                 bucket_sizes: Tuple[int, ...]):
        self.cache = cache
        self.model_id = model_id
        self.d_in = d_in
        self.d_out = d_out
        # static estimate (pow2 up to the configured max_bucket): the
        # resolved plan's top bucket can be smaller (block_m cap), in which
        # case bucket_for() returns None for the outsized coalesce and
        # run() serves it on the oversize binding.
        self.bucket_sizes = bucket_sizes

    @property
    def device(self) -> torch.device:
        return self.cache.device

    def resolve(self) -> ExecutionPlan:
        """The real plan — hot-tier hit or lazy decode+rebuild."""
        return self.cache.plan(self.model_id)

    @property
    def resident(self) -> bool:
        return self.cache.has_hot(self.model_id)

    # execution surface (everything MicroBatcher / the degradation ladder
    # touches) — each call goes through the cache so eviction is invisible
    def bucket_for(self, m: int) -> Optional[int]:
        return self.resolve().bucket_for(m)

    def entry(self, bucket: int):
        return self.resolve().entry(bucket)

    def run(self, x):
        return self.resolve().run(x)

    def warmup(self, buckets=None) -> None:
        self.resolve().warmup(buckets)

    def demote_bucket(self, rows: int, **kwargs):
        return self.resolve().demote_bucket(rows, **kwargs)

    @property
    def buckets(self):
        return self.resolve().buckets

    @property
    def act_scales(self):
        return self.resolve().act_scales

    @property
    def act_dtype(self):
        return self.resolve().act_dtype

    @property
    def pack(self) -> dict:
        return self.resolve().pack

    @property
    def layers(self):
        return self.resolve().layers

    def describe(self) -> dict:
        d = {"model_id": self.model_id, "cached": True,
             "resident": self.resident}
        if self.resident:
            d.update(self.resolve().describe())
        return d


# ----------------------------------------------------------------- cache

class PackCache:
    """The two-tier store (module docstring has the design contract).

    ``max_hot`` bounds resident plan *count* (evicted before a new
    resolve, so the high-water mark never exceeds it); ``hot_bytes``
    bounds resident decoded *bytes* (enforced post-resolve, sparing the
    entry being returned).  ``None`` disables a bound.  ``plan_kwargs``
    are defaults for every resolve (per-model kwargs at :meth:`add`
    override them).  ``device`` is where decoded packs live (CUDA unless
    told otherwise).  Thread-safe; resolution runs under the lock, so two
    racing requests for the same cold model decode it once."""

    def __init__(self, max_hot: Optional[int] = None,
                 hot_bytes: Optional[int] = None, *,
                 plan_kwargs: Optional[dict] = None, device=None):
        if max_hot is not None and max_hot < 1:
            raise ValueError(f"max_hot must be >= 1, got {max_hot}")
        self.max_hot = max_hot
        self.hot_bytes = hot_bytes
        self.device = resolve_device(device)
        self.default_plan_kwargs = dict(plan_kwargs or {})
        self._lock = threading.RLock()
        self._cold: Dict[str, ColdPack] = {}
        self._plan_kwargs: Dict[str, dict] = {}
        self._calib: Dict[str, dict] = {}
        self._hot: "OrderedDict[str, ExecutionPlan]" = OrderedDict()
        self._bytes: Dict[str, int] = {}
        self.stats = {"resolves": 0, "hits": 0, "evictions": 0,
                      "updates": 0, "decode_s": 0.0,
                      "resident_bytes": 0, "resident_high_water": 0,
                      "cold_start_s": []}

    # ------------------------------------------------------------ intake

    def add(self, model_id: str, pack: Union[dict, ColdPack], *,
            plan_kwargs: Optional[dict] = None) -> CachedPlan:
        """Register a model by pack — a frozen serving pack (compressed
        here) or an already-cold :class:`ColdPack` (e.g. from
        ``checkpoint.manager.load_pack``).  Nothing is decoded until
        first traffic; the returned :class:`CachedPlan` is what goes into
        a ``ModelRegistry``."""
        cold = pack if isinstance(pack, ColdPack) else compress_pack(pack)
        kwargs = {**self.default_plan_kwargs, **(plan_kwargs or {})}
        # a caller-provided calib seeds the per-model calibration the
        # cache otherwise captures at first resolve
        calib = kwargs.pop("calib", None)
        with self._lock:
            if model_id in self._cold:
                raise ValueError(f"model {model_id!r} already cached")
            self._cold[model_id] = cold
            self._plan_kwargs[model_id] = kwargs
            if calib is not None:
                self._calib[model_id] = calib
        max_bucket = kwargs.get("max_bucket", DEFAULT_MAX_BUCKET)
        return CachedPlan(self, model_id, d_in=cold.d_in,
                          d_out=cold.d_out,
                          bucket_sizes=_pow2_buckets(max(max_bucket, 1)))

    def update(self, model_id: str, pack: Union[dict, ColdPack]) -> None:
        """Hot-swap a model's weights (pack update): the cold form is
        replaced, the stale hot plan (if any) is evicted, and the stored
        calibration is dropped — the *next* request resolves the new
        weights."""
        cold = pack if isinstance(pack, ColdPack) else compress_pack(pack)
        with self._lock:
            if model_id not in self._cold:
                raise KeyError(f"model {model_id!r} not cached")
            self._cold[model_id] = cold
            self._calib.pop(model_id, None)
            self._evict_locked(model_id)
            self.stats["updates"] += 1

    def remove(self, model_id: str) -> None:
        """Forget a model entirely (both tiers).  Idempotent."""
        with self._lock:
            self._evict_locked(model_id)
            self._cold.pop(model_id, None)
            self._plan_kwargs.pop(model_id, None)
            self._calib.pop(model_id, None)

    def cold(self, model_id: str) -> ColdPack:
        """The at-rest form of a cached model (the recovery source of
        truth the scrubber verifies against)."""
        with self._lock:
            try:
                return self._cold[model_id]
            except KeyError:
                raise KeyError(
                    f"model {model_id!r} not cached; have "
                    f"{sorted(self._cold)}") from None

    # ----------------------------------------------------------- serving

    def plan(self, model_id: str) -> ExecutionPlan:
        """The resolved plan: LRU hit, or lazy decode + calibrate +
        resolve (count budget enforced *before* the resolve)."""
        with self._lock:
            hit = self._hot.get(model_id)
            if hit is not None:
                self._hot.move_to_end(model_id)
                self.stats["hits"] += 1
                return hit
            try:
                cold = self._cold[model_id]
            except KeyError:
                raise KeyError(
                    f"model {model_id!r} not cached; have "
                    f"{sorted(self._cold)}") from None
            while self.max_hot is not None and len(self._hot) >= self.max_hot:
                self._evict_locked(next(iter(self._hot)))
            t0 = time.perf_counter()
            kwargs = self._plan_kwargs.get(model_id, {})
            plan = build_plan(decode_pack(cold, self.device),
                              calib=self._calib.get(model_id),
                              **{**kwargs, "device": self.device})
            dt = time.perf_counter() - t0
            # first int8 resolve measures the activation scales; keep them
            # so every re-resolve is calibration-free AND bit-identical
            if model_id not in self._calib and plan.act_scales is not None:
                self._calib[model_id] = {
                    "act_scales": [float(s) for s in plan.act_scales]}
            # pin into the compat-path plan memo; unhashable kwargs
            # (calib_x arrays) are left out of its key
            adopt_plan(plan.pack, plan,
                       **{k: v for k, v in kwargs.items()
                          if isinstance(v, (str, int, float, bool,
                                            tuple, type(None)))})
            self._hot[model_id] = plan
            nbytes = plan_resident_bytes(plan)
            self._bytes[model_id] = nbytes
            self.stats["resolves"] += 1
            self.stats["decode_s"] += dt
            self.stats["cold_start_s"].append(dt)
            self.stats["resident_bytes"] += nbytes
            self.stats["resident_high_water"] = max(
                self.stats["resident_high_water"],
                self.stats["resident_bytes"])
            while (self.hot_bytes is not None and len(self._hot) > 1
                   and self.stats["resident_bytes"] > self.hot_bytes):
                self._evict_locked(next(iter(self._hot)))
            return plan

    # ---------------------------------------------------------- eviction

    def _evict_locked(self, model_id: str) -> bool:
        plan = self._hot.pop(model_id, None)
        if plan is None:
            return False
        self.stats["resident_bytes"] -= self._bytes.pop(model_id, 0)
        self.stats["evictions"] += 1
        # release the plan memo entry (pinned at adopt) and the memoized
        # kernel operands — without this the "evicted" plan stays
        # resident on the card through module-global memos
        forget_plan(plan.pack)
        return True

    def evict(self, model_id: str) -> bool:
        """Push one model back to the cold tier (no-op if not hot)."""
        with self._lock:
            return self._evict_locked(model_id)

    def evict_all(self) -> int:
        with self._lock:
            return sum(self._evict_locked(m) for m in list(self._hot))

    # ------------------------------------------------------- introspection

    def has_hot(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._hot

    def __contains__(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._cold

    def __len__(self) -> int:
        with self._lock:
            return len(self._cold)

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._cold)

    def hot_ids(self) -> List[str]:
        """LRU → MRU order."""
        with self._lock:
            return list(self._hot)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self.stats["resident_bytes"]

    @property
    def cold_bytes(self) -> int:
        with self._lock:
            return sum(c.size_bytes for c in self._cold.values())

    def describe(self) -> dict:
        with self._lock:
            return {
                "models": len(self._cold),
                "hot": list(self._hot),
                "max_hot": self.max_hot,
                "hot_bytes_budget": self.hot_bytes,
                "device": str(self.device),
                "resident_bytes": self.stats["resident_bytes"],
                "resident_high_water": self.stats["resident_high_water"],
                "cold_bytes": sum(c.size_bytes
                                  for c in self._cold.values()),
                "fp32_bytes": sum(c.fp32_bytes
                                  for c in self._cold.values()),
                "resolves": self.stats["resolves"],
                "hits": self.stats["hits"],
                "evictions": self.stats["evictions"],
                "updates": self.stats["updates"],
            }
