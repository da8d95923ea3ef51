"""Execution plans: serve-time dispatch resolved once per frozen pack.

Mirrors the JAX package's ``serving/plans.py``.  An :class:`ExecutionPlan`
fixes, at build time:

* **mode** — ``fused`` (the megakernel schedules), ``per_layer`` (the
  kernel-1 chain), ``oracle`` (plain PyTorch), with ``auto`` taking the
  fused schedules when the stack fits them.  The fits are the CUDA
  kernels' own shared-memory needs (``kernels/fantastic4_fused_mlp.py``).
* **activation dtype** — fp32 or the paper's §VI-C int8; calibration runs
  once here, never per request.
* **batch buckets** — powers of two up to the plan's ``block_m`` (the
  largest row tile the batch-tiled kernel holds), each bound to a kernel
  schedule by the dataflow prior (``kernels/autotune.py``): ws for the
  ≤ ``WS_BUCKET_ROWS`` latency buckets, db where requested, batch_tiled
  otherwise, stream when the stack does not fit the batch-tiled kernel.
  The timed per-bucket sweep of the JAX package is not ported yet.

The micro-batcher (``serving/batcher.py``) coalesces requests into these
buckets.
"""
from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

import numpy as np
import torch

from .. import resolve_device
from ..kernels import autotune
from ..kernels import ops as kops
from ..kernels.fantastic4_fused_mlp import (SMEM_BUDGET_BYTES,
                                            fused_mlp_fits,
                                            max_fused_block_m,
                                            stream_mlp_fits, tile_rows,
                                            ws_mlp_fits)
from ..memo import MISS, IdentityMemo

MODES = ("auto", "fused", "per_layer", "oracle", "sharded")
ACT_DTYPES = ("float32", "int8")
# weight-stationary latency prior: buckets of at most this many rows
WS_BUCKET_ROWS = 8
# rows per CTA of a stream bucket: small tiles spread a batch over SMs
STREAM_BLOCK_M = 8
DEFAULT_MAX_BUCKET = 256
_CALIB_BATCH = 64

PATH_BY_SCHEDULE = {"ws": "fused_ws", "batch_tiled": "fused",
                    "db": "fused_db", "stream": "fused_stream"}
SCHEDULE_BY_PATH = {v: k for k, v in PATH_BY_SCHEDULE.items()}


@runtime_checkable
class ServableProgram(Protocol):
    """What the serving layers program against: ``(rows, d_in)`` fp32
    batches to ``(rows, d_out)`` outputs through fixed row buckets.
    Optional surfaces (``rows_per_request``, ``warmup``, ``demote_bucket``,
    ``buckets``, ``schedule_for``, ``mode_label``, ``layers``) are
    feature-detected with ``getattr``."""

    d_in: int
    d_out: int
    bucket_sizes: Tuple[int, ...]

    def bucket_for(self, m: int) -> Optional[int]: ...

    def entry(self, bucket: int) -> Callable: ...

    def run(self, x): ...

    def describe(self) -> dict: ...


def calibrate_act_scales(pack: dict, x_calib: torch.Tensor) -> dict:
    """Per-layer int8 activation scales from a calibration batch: s_l maps
    layer l's output onto the next layer's [-127, 127] grid."""
    scales = []
    dev = pack["layers"][0]["packed"].device
    x = torch.as_tensor(x_calib, dtype=torch.float32, device=dev)
    for layer in pack["layers"]:
        if layer["shape"][0] % 2:
            x = torch.nn.functional.pad(x, (0, 1))
        y = kops.fantastic4_matmul(
            x, layer["packed"], layer["omega"], bias=layer["bias"],
            alpha1=layer["alpha1"], alpha2=None,
            activation=layer["activation"], use_kernel=False)
        s = torch.clamp(torch.max(torch.abs(y)), min=1e-6) / 127.0
        scales.append(float(s))
        x = y
    return {"act_scales": scales}


def _default_calib_x(d_in: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(_CALIB_BATCH, d_in)).astype(np.float32)


def _pow2_buckets(max_rows: int) -> Tuple[int, ...]:
    out, b = [], 1
    while b <= max_rows:
        out.append(b)
        b *= 2
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """One resolved (bucket rows -> kernel schedule) binding."""
    rows: int
    path: str        # "fused[_ws|_db|_stream]" | "per_layer" | "oracle"
    block_m: Optional[int] = None
    source: str = "mode"


class ExecutionPlan:
    """Frozen-pack serving plan: mode, blocks, calibration and per-bucket
    entries resolved once.  ``device`` defaults to CUDA (raising without
    it); the pack's tensors must already live there."""

    rows_per_request: Optional[int] = None

    def __init__(self, pack: dict, *,
                 mode: str = "auto",
                 act_dtype: str = "float32",
                 double_buffer: bool = False,
                 ws_bucket_rows: Optional[int] = None,
                 calib: Optional[dict] = None,
                 calib_x=None,
                 block_m: Optional[int] = None,
                 max_bucket: int = DEFAULT_MAX_BUCKET,
                 smem_budget_bytes: int = SMEM_BUDGET_BYTES,
                 device=None):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if mode == "sharded":
            raise NotImplementedError(
                "mode='sharded' is not ported yet (ROADMAP queue 1: "
                "scale-out)")
        if act_dtype not in ACT_DTYPES:
            raise ValueError(
                f"act_dtype must be one of {ACT_DTYPES}, got {act_dtype!r}")
        self.device = resolve_device(device)
        self.pack = pack
        self.layers = pack["layers"]
        for i, l in enumerate(self.layers):
            if l["packed"].device.type != self.device.type:
                raise ValueError(f"layer {i} lives on {l['packed'].device}, "
                                 f"the plan on {self.device}")
        self.shapes = tuple(tuple(l["shape"]) for l in self.layers)
        self.d_in = self.shapes[0][0]
        self.d_out = self.shapes[-1][1]
        self.requested_mode = mode
        self.act_dtype = act_dtype
        self.requested_double_buffer = double_buffer
        self.smem_budget_bytes = smem_budget_bytes
        self.notes: List[str] = []

        if ws_bucket_rows is not None:
            self.ws_eligible_rows: Optional[int] = ws_bucket_rows
            self.ws_prior_rows = ws_bucket_rows
            self.ws_prior_source = "explicit"
        elif mode in ("auto", "fused"):
            self.ws_eligible_rows = None
            self.ws_prior_rows = WS_BUCKET_ROWS
            self.ws_prior_source = "constant"
        else:
            self.ws_eligible_rows = 0
            self.ws_prior_rows = 0
            self.ws_prior_source = "mode"

        # ---- int8 calibration: once, at build time
        self.act_scales: Optional[List[float]] = None
        if act_dtype == "int8":
            if calib is not None:
                self.act_scales = list(calib["act_scales"])
            else:
                if calib_x is None:
                    calib_x = _default_calib_x(self.d_in)
                    self.notes.append(
                        "int8 calibration ran on a synthetic batch "
                        f"({_CALIB_BATCH}x{self.d_in}); pass calib=/calib_x= "
                        "for task-realistic scales")
                self.act_scales = list(
                    calibrate_act_scales(pack, calib_x)["act_scales"])

        # ---- mode resolution against the kernels' shared-memory fits
        fit_kw = dict(smem_budget_bytes=smem_budget_bytes, act_dtype=act_dtype)
        tile = block_m or max_fused_block_m(self.shapes, cap=max_bucket,
                                            **fit_kw)
        self._stack_fits = tile is not None and fused_mlp_fits(
            self.shapes, block_m=tile, **fit_kw)
        # db runs two row groups, so it needs a tile of >= 16 rows
        self._stack_fits_db = tile is not None and \
            tile_rows(tile, double_buffer=True)[1] and fused_mlp_fits(
                self.shapes, block_m=tile, double_buffer=True, **fit_kw)
        stream_ok = stream_mlp_fits(self.shapes, rows=max_bucket,
                                    block_m=STREAM_BLOCK_M, **fit_kw)
        if mode == "auto":
            mode = "fused" if (self._stack_fits or stream_ok) \
                else "per_layer"
        if mode == "fused" and not self._stack_fits:
            if stream_ok:
                self.notes.append(
                    "stack exceeds the batch-tiled kernel's shared memory "
                    f"({smem_budget_bytes} B): only the stream/ws schedules "
                    "are eligible")
            else:
                self.notes.append(
                    "stack exceeds every fused kernel's shared memory "
                    f"({smem_budget_bytes} B): resolved to per_layer")
                mode = "per_layer"
        self.resolved_mode = mode

        # ---- blocks: the batch-tiled row tile caps the buckets
        self.block_m = block_m
        self.block_source = "explicit" if block_m is not None else None
        if mode == "fused" and block_m is None:
            self.block_m = tile if self._stack_fits else \
                autotune.heuristic_blocks(max_bucket, self.d_in,
                                          self.d_out).block_m
            self.block_source = "heuristic"

        top = max_bucket
        if mode == "fused" and self.block_m:
            top = min(top, max(self.block_m, 1))
        self.bucket_sizes = _pow2_buckets(max(top, 1))
        self.buckets: Dict[int, BucketPlan] = {}
        if mode in ("per_layer", "oracle"):
            for b in self.bucket_sizes:
                self.buckets[b] = BucketPlan(b, mode)
            self.default_path = mode
        else:
            for b in self.bucket_sizes:
                self.buckets[b] = self._bind_bucket(b)
            if self._stack_fits_db and double_buffer:
                self.default_path = "fused_db"
            elif self._stack_fits:
                self.default_path = "fused"
            else:
                self.default_path = "per_layer"
        if any(p.path == "fused_stream" for p in self.buckets.values()):
            self.notes.append(
                "stream buckets: one cooperative grid per card at a time; "
                "launches from several CUDA streams are ordered behind a "
                "lock (the card runs two full-width cooperative grids one "
                "after the other)")
        ws_won = [b for b, p in self.buckets.items() if p.path == "fused_ws"]
        self.ws_crossover_rows = max(ws_won) if ws_won else 0

        if double_buffer:
            if mode != "fused":
                self.notes.append("double_buffer requested but resolved "
                                  f"mode is {mode}: ignored")
            elif not any(p.path == "fused_db" for p in self.buckets.values()):
                self.notes.append(
                    "double_buffer requested but no bucket has a >=16-row "
                    "tile that fits: single-buffered schedule everywhere")
        self._entries: Dict[int, Callable] = {}
        self._oversize_memo: Dict[int, BucketPlan] = {}

    # ------------------------------------------------------------ resolve

    def _eligible_schedules(self, rows: int) -> tuple:
        el = []
        if self._stack_fits:
            el.append("batch_tiled")
            if rows >= 16 and self._stack_fits_db:
                el.append("db")
        if stream_mlp_fits(self.shapes, rows=rows, block_m=STREAM_BLOCK_M,
                           smem_budget_bytes=self.smem_budget_bytes,
                           act_dtype=self.act_dtype):
            el.append("stream")
        cap = self.ws_eligible_rows
        if cap != 0 and (cap is None or rows <= cap) and \
                ws_mlp_fits(self.shapes, rows=rows,
                            smem_budget_bytes=self.smem_budget_bytes,
                            act_dtype=self.act_dtype):
            el.append("ws")
        return tuple(el)

    def _prior_schedule(self, rows: int, eligible: tuple) -> str:
        if "ws" in eligible and rows <= self.ws_prior_rows:
            return "ws"
        if "db" in eligible and self.requested_double_buffer:
            return "db"
        if "batch_tiled" in eligible:
            return "batch_tiled"
        return eligible[0]

    def _schedule_fits(self, schedule: str, rows: int, bm: int) -> bool:
        kw = dict(smem_budget_bytes=self.smem_budget_bytes,
                  act_dtype=self.act_dtype)
        if schedule in ("batch_tiled", "db"):
            return fused_mlp_fits(self.shapes, block_m=bm,
                                  double_buffer=schedule == "db", **kw)
        if schedule == "ws":
            return ws_mlp_fits(self.shapes, rows=rows, **kw)
        return stream_mlp_fits(self.shapes, rows=rows, block_m=bm, **kw)

    def _bind_bucket(self, rows: int) -> BucketPlan:
        eligible = self._eligible_schedules(rows)
        if not eligible:
            return BucketPlan(rows, "per_layer", source="mode")
        prior = self._prior_schedule(rows, eligible)
        cfg = autotune.get_schedule_config(
            rows, self.d_in, self.d_out, schedules=eligible, prior=prior,
            block_m_hint=STREAM_BLOCK_M if prior == "stream"
            else self.block_m)
        return BucketPlan(rows, PATH_BY_SCHEDULE[cfg.schedule],
                          block_m=cfg.block_m, source=cfg.source)

    def bucket_for(self, m: int) -> Optional[int]:
        """Smallest bucket holding ``m`` rows; None past the largest."""
        for b in self.bucket_sizes:
            if m <= b:
                return b
        return None

    def oversize_binding(self, m: int) -> BucketPlan:
        """Binding for a batch past the largest bucket (run at exact size):
        the top bucket's schedule when it fits ``m`` rows, else the
        whole-stack default, else the per-layer chain."""
        cached = self._oversize_memo.get(m)
        if cached is None:
            cached = self._oversize_memo[m] = self._resolve_oversize(m)
        return cached

    def _resolve_oversize(self, m: int) -> BucketPlan:
        if self.resolved_mode in ("per_layer", "oracle"):
            return BucketPlan(m, self.resolved_mode, source="mode")
        top = self.buckets[max(self.bucket_sizes)]
        if top.path.startswith("fused"):
            sched = SCHEDULE_BY_PATH[top.path]
            bm = top.block_m or self.block_m or STREAM_BLOCK_M
            if self._schedule_fits(sched, m, bm):
                return BucketPlan(m, top.path, block_m=bm, source=top.source)
        if self.default_path in ("fused", "fused_db") and self._stack_fits:
            return BucketPlan(m, self.default_path, block_m=self.block_m,
                              source="mode")
        return BucketPlan(m, "per_layer", source="mode")

    def demote_bucket(self, rows: int, *, reason: str = "fault") -> BucketPlan:
        """Rebind one bucket to the per-layer chain (graceful degradation):
        the chain is bitwise equal to the fused schedules on the int8 grid
        and within the fp32 gate, so the model keeps serving."""
        if rows not in self.buckets:
            raise KeyError(f"no bucket of {rows} rows; have "
                           f"{self.bucket_sizes}")
        bp = BucketPlan(rows, "per_layer", source=f"degraded:{reason}")
        self.buckets[rows] = bp
        self._entries.pop(rows, None)
        self.notes.append(f"bucket {rows} demoted to per_layer ({reason})")
        return bp

    # ------------------------------------------------------------ execute

    def _execute(self, x: torch.Tensor, path: str,
                 block_m: Optional[int] = None) -> torch.Tensor:
        if path in ("oracle", "per_layer"):
            use_kernel = path == "per_layer"
            if self.act_dtype == "int8":
                return kops.fantastic4_mlp_chain_int8(
                    x, self.layers, self.act_scales, use_kernel=use_kernel)
            return kops.fantastic4_mlp_chain(x, self.layers,
                                             use_kernel=use_kernel)
        return kops.fantastic4_mlp_fused(
            x, self.layers, block_m=block_m or self.block_m,
            act_dtype=self.act_dtype, act_scales=self.act_scales,
            schedule=SCHEDULE_BY_PATH[path],
            smem_budget_bytes=self.smem_budget_bytes)

    def entry(self, bucket: int) -> Callable[[torch.Tensor], torch.Tensor]:
        """Callable for exactly ``bucket`` rows, cached per bucket."""
        fn = self._entries.get(bucket)
        if fn is None:
            if bucket not in self.buckets:
                raise KeyError(f"no bucket of {bucket} rows; have "
                               f"{self.bucket_sizes}")
            bp = self.buckets[bucket]

            def fn(xb, _path=bp.path, _bm=bp.block_m, _bucket=bucket):
                if xb.shape[0] != _bucket:
                    raise ValueError(f"bucket {_bucket} entry got "
                                     f"{tuple(xb.shape)}")
                return self._execute(xb, _path, block_m=_bm)
            # the layers this entry launches from: integrity checks verify
            # these, whatever plan a cache handle resolves to meanwhile
            fn.layers = self.layers
            self._entries[bucket] = fn
        return fn

    def run(self, x) -> torch.Tensor:
        """Serve one batch: pad rows up to its bucket, run the bucket's
        entry, slice the real rows back out."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        m = x.shape[0]
        b = self.bucket_for(m)
        if b is None:
            obp = self.oversize_binding(m)
            return self._execute(x, obp.path, block_m=obp.block_m)
        if m < b:
            x = torch.nn.functional.pad(x, (0, 0, 0, b - m))
        return self.entry(b)(x)[:m]

    def __call__(self, x) -> torch.Tensor:
        return self.run(x)

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run every bucket entry once (builds the kernels and the
        per-pack operand tables before the first request)."""
        for b in buckets if buckets is not None else self.bucket_sizes:
            self.entry(b)(torch.zeros((b, self.d_in), device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- report

    def path_for(self, m: int) -> str:
        b = self.bucket_for(m)
        return self.oversize_binding(m).path if b is None \
            else self.buckets[b].path

    def schedule_for(self, m: int) -> str:
        path = self.path_for(m)
        return SCHEDULE_BY_PATH.get(path, path)

    def describe(self) -> dict:
        return {
            "requested_mode": self.requested_mode,
            "resolved_mode": self.resolved_mode,
            "act_dtype": self.act_dtype,
            "device": str(self.device),
            "block_m": self.block_m,
            "block_source": self.block_source,
            "bucket_sizes": list(self.bucket_sizes),
            "bucket_paths": {b: p.path for b, p in self.buckets.items()},
            "bucket_schedules": {
                b: SCHEDULE_BY_PATH.get(p.path, p.path)
                for b, p in self.buckets.items()},
            "bucket_block_m": {b: p.block_m for b, p in self.buckets.items()},
            "bucket_sources": {b: p.source for b, p in self.buckets.items()},
            "ws_crossover_rows": self.ws_crossover_rows,
            "ws_prior_rows": self.ws_prior_rows,
            "ws_prior_source": self.ws_prior_source,
            "default_path": self.default_path,
            "smem_budget_bytes": self.smem_budget_bytes,
            "notes": list(self.notes),
        }

    def mode_label(self, m: Optional[int] = None) -> str:
        names = {"fused": "fused megakernel",
                 "fused_db": "fused megakernel (double-buffered)",
                 "fused_ws": "fused megakernel (weight-stationary)",
                 "fused_stream": "fused megakernel (streaming)",
                 "per_layer": "per-layer kernel",
                 "oracle": "plain PyTorch oracle"}
        if m is not None:
            label = names[self.path_for(m)]
        else:
            paths = {p.path for p in self.buckets.values()}
            label = " / ".join(names[p] for p in names if p in paths)
        if self.act_dtype == "int8":
            label += " [int8 activations]"
        return label


def build_plan(pack: dict, **kwargs) -> ExecutionPlan:
    return ExecutionPlan(pack, **kwargs)


# plan memoization per (pack identity, configuration)
_PLAN_MEMO = IdentityMemo()


def get_plan(pack: dict, *, calib: Optional[dict] = None,
             **kwargs) -> ExecutionPlan:
    extra = tuple(sorted((k, str(v)) for k, v in kwargs.items()))
    hit = _PLAN_MEMO.get((pack, calib), extra)
    if hit is not MISS:
        return hit
    plan = ExecutionPlan(pack, calib=calib, **kwargs)
    _PLAN_MEMO.put((pack, calib), extra, plan)
    return plan


def adopt_plan(pack: dict, plan: ExecutionPlan, *,
               calib: Optional[dict] = None, **kwargs) -> None:
    """Register an externally-managed (pack-cache) plan under the key
    ``get_plan(pack, calib=calib, **kwargs)`` would compute, pinned: the
    memo's insertion-order eviction never drops it, so the compat path
    never resolves a duplicate beside it.  Release is explicit, via
    :func:`forget_plan`."""
    extra = tuple(sorted((k, str(v)) for k, v in kwargs.items()))
    _PLAN_MEMO.put((pack, calib), extra, plan, pin=True)


def forget_plan(pack: dict) -> None:
    """Release every plan and operand cache entry keyed on ``pack``."""
    _PLAN_MEMO.drop(pack)
    layers = pack.get("layers") if isinstance(pack, dict) else None
    if layers is not None:
        kops.forget_pack_operands(layers)
