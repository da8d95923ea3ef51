"""Block and schedule choice for the CUDA serving kernels: the port of the
JAX package's ``kernels/autotune.py``.

Three tiers, as in the reference:

1. **memory cache** -- a dict keyed by
   ``backend|m|k|n|dtype|fused|act[|extra]`` (:func:`cache_key`);
2. **persistent JSON cache** -- ``$FANTASTIC4_TORCH_AUTOTUNE_CACHE`` or
   ``~/.cache/fantastic4/autotune_torch.json``, the port's own file (the
   reference's ``FANTASTIC4_AUTOTUNE_CACHE`` is never read or written),
   so a sweep runs once per shape per card;
3. **resolution** -- on the card a timed candidate sweep (the caller
   supplies ``measure``, running the real kernel; ``kernels/ops.py``
   ``_timeit`` times it queued behind a spin kernel, so host time does not
   decide), else the heuristic or the dataflow prior.

The backend key on the card is the card's name (:func:`default_backend`,
sanitised for the ``|``-separated key), off it ``"cpu"``, so a CPU answer
never masks the card's sweep (the reference's ``interpret`` rule).  Key
formats are the reference's: :func:`cache_key` (pre-``act`` keys migrated
on load, :func:`_migrate_key`), :func:`bucket_cache_key` (``…|bucket``)
and :func:`ws_crossover_key` (``…|wscross``); a bucket entry records the
eligible set it was swept over (``swept``) and the union sweep keeps two
plans with different sets from shadowing each other.

Where the port differs from the reference:

* **Only measured entries are persisted.**  A heuristic or prior answer
  never reaches the JSON file, so off the card nothing is written.
* **A failing candidate raises.**  A candidate that does not fit the
  kernel's shared memory is ``inf`` by the caller's fit check, before any
  launch; a launch that fails raises (the reference's ``_timeit`` turns an
  exception into ``inf``, but a CUDA launch error is sticky and
  swallowing it would hide the kernel).
* **The candidates are the knobs the CUDA launches take.**  The fused
  kernels' row tile (``block_m``) is capped at ``MAX_TILE_ROWS`` = 32 rows
  (``kernels/fantastic4_matmul.py``), so the ladder is 8 / 16 / 32 where
  the TPU's was 32…256.  The chain kernel's tiles are the wrapper's
  (``chain_tiling``: up to 32 rows, ``SLICE_COLS`` = 16 columns, K whole
  or chunked), and ecl_quant's block is a compile-time constant
  (``kThreads``, ``csrc/ecl_quant.cu``): :func:`get_block_config` with
  ``fused=False`` and :func:`get_elementwise_config` keep the reference's
  cache contract, and nothing sweeps them.  The cluster size
  (``CLUSTER``) is not a reference knob and is not swept.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

from .fantastic4_matmul import MAX_TILE_ROWS
from .slices import SLICE_COLS

ENV_CACHE = "FANTASTIC4_TORCH_AUTOTUNE_CACHE"

# rows are padded to multiples of 8 (the reference's f32 sublane tile;
# the fused kernels' row tiles are multiples of 8 too)
ROW_ALIGN = 8
# the fused kernels' row-tile ladder: 8 .. MAX_TILE_ROWS
ROW_TILES = tuple(8 << i for i in range(MAX_TILE_ROWS.bit_length() - 3))
# the plan's bucket cap when the batch-tiled kernel gives none
MAX_BLOCK_M = 256

# the fused schedules a bucket can bind to (serving.plans maps them onto
# its bucket paths); "ws_crossover" marks the stored crossover entry
SCHEDULES = ("ws", "batch_tiled", "db", "stream")


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    block_m: int
    block_n: int
    block_k: int
    source: str = "heuristic"  # "heuristic" | "sweep" | "cache" | "migrated"
    schedule: Optional[str] = None     # set on (bucket, schedule) entries
    # the eligible set a (bucket, schedule) sweep measured over: a cached
    # winner answers only callers whose eligible set it covered
    swept: Optional[Tuple[str, ...]] = None

    def as_tuple(self) -> tuple:
        return (self.block_m, self.block_n, self.block_k)

    def same_blocks(self, other: "BlockConfig") -> bool:
        return self.as_tuple() == other.as_tuple()


_lock = threading.Lock()
_memory: Dict[str, BlockConfig] = {}
_disk_loaded_for: Optional[str] = None


def _round_up(v: int, mult: int) -> int:
    return -(-max(v, 1) // mult) * mult


def default_backend(device=None) -> str:
    """The backend key: the card's name (``torch.cuda.get_device_name``,
    every character outside ``[A-Za-z0-9._-]`` made ``_``) for a CUDA
    device, ``"cpu"`` for any other.  ``device=None`` means the card when
    there is one."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type != "cuda":
        return "cpu"
    return re.sub(r"[^A-Za-z0-9._-]", "_", torch.cuda.get_device_name(dev))


def tuning(device) -> str:
    """How a plan on ``device`` binds its buckets: ``"sweep"`` on a CUDA
    device (timed candidates, the cache), else ``"prior"`` (the dataflow
    prior, no cache read or written)."""
    return "sweep" if torch.device(device).type == "cuda" else "prior"


def cache_path() -> str:
    return os.environ.get(ENV_CACHE) or os.path.join(
        os.path.expanduser("~"), ".cache", "fantastic4", "autotune_torch.json")


def cache_key(m: int, k: int, n: int, *, dtype: str, fused: bool,
              backend: str, act_dtype: str = "float32",
              extra: str = "") -> str:
    """``extra`` tells apart problems that share (M, K, N), such as a
    fused stack's hidden widths."""
    tail = f"|{extra}" if extra else ""
    return (f"{backend}|m{m}|k{k}|n{n}|{dtype}|fused{int(fused)}"
            f"|act{act_dtype}{tail}")


def _migrate_key(key: str) -> str:
    """A pre-``act`` key (``backend|m..|k..|n..|dtype|fusedX[|extra]``)
    with ``actfloat32`` slotted in after ``fusedX``; current keys pass
    through unchanged."""
    segs = key.split("|")
    for i, seg in enumerate(segs):
        if seg.startswith("fused") and seg[5:].isdigit():
            if i + 1 < len(segs) and segs[i + 1].startswith("act"):
                return key
            return "|".join(segs[:i + 1] + ["actfloat32"] + segs[i + 1:])
    return key


def clear_memory_cache() -> None:
    """Drop the in-process cache (the JSON file is untouched)."""
    global _disk_loaded_for
    with _lock:
        _memory.clear()
        _disk_loaded_for = None


def _load_disk_locked() -> None:
    global _disk_loaded_for
    path = cache_path()
    if _disk_loaded_for == path:
        return
    _disk_loaded_for = path
    if not os.path.exists(path):
        return
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return
    for key, v in raw.items():
        try:
            sched = v.get("schedule")
            swept = v.get("swept")
            cfg = BlockConfig(int(v["block_m"]), int(v["block_n"]),
                              int(v["block_k"]),
                              source=v.get("source", "cache"),
                              schedule=str(sched) if sched else None,
                              swept=tuple(str(s) for s in swept)
                              if swept else None)
        except (AttributeError, KeyError, TypeError, ValueError):
            continue                     # stale or corrupt entry: ignored
        key = _migrate_key(key)
        if key not in _memory:
            _memory[key] = cfg


def _save_disk_locked() -> None:
    """Write every entry that is not a heuristic answer (measured entries
    and those loaded from the file) to the JSON cache."""
    path = cache_path()
    payload = {}
    for key, c in sorted(_memory.items()):
        if c.source == "heuristic":
            continue
        entry = {"block_m": c.block_m, "block_n": c.block_n,
                 "block_k": c.block_k, "source": c.source}
        if c.schedule is not None:
            entry["schedule"] = c.schedule
        if c.swept is not None:
            entry["swept"] = list(c.swept)
        payload[key] = entry
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
    os.replace(tmp, path)


def _store_locked(key: str, cfg: BlockConfig, persist: bool) -> None:
    _memory[key] = cfg
    if persist and cfg.source != "heuristic":
        try:
            _save_disk_locked()
        except OSError:
            pass                          # read-only: memory cache only


def heuristic_blocks(m: int, k: int, n: int, *, fused: bool = False,
                     max_block_m: int = MAX_BLOCK_M) -> BlockConfig:
    """Shape-clamped blocks, no timing.  Fused: the rounded batch capped at
    ``max_block_m`` (the plan's bucket cap; the batch-tiled kernel holds at
    most ``MAX_TILE_ROWS`` rows a tile).  The chain: its row tile (the
    batch up to ``MAX_TILE_ROWS``), ``SLICE_COLS`` columns a CTA and K
    whole, as ``chain_tiling`` launches it."""
    mp = _round_up(m, ROW_ALIGN)
    if fused:
        return BlockConfig(min(mp, max_block_m), SLICE_COLS,
                           _round_up(k, 2))
    return BlockConfig(min(mp, MAX_TILE_ROWS), SLICE_COLS, _round_up(k, 2))


def heuristic_elementwise_blocks(r: int, c: int) -> BlockConfig:
    """Shape-clamped (block_r, block_c) of the reference's non-TPU tier,
    ``block_k`` pinned to 0 (the elementwise sentinel of the cache key).
    ecl_quant's launch takes no block (``kThreads`` and ``kElemsPerCta``
    are compile-time constants in ``csrc/ecl_quant.cu``): this answers the
    cache contract only."""
    return BlockConfig(min(_round_up(r, ROW_ALIGN), 512),
                       min(_round_up(c, 128), 1024), 0)


def candidate_elementwise_blocks(r: int, c: int) -> Sequence[BlockConfig]:
    """The reference's (block_r, block_c) grid, for a caller that supplies
    its own measure; no launch of the port reads these blocks."""
    rp, cp = _round_up(r, ROW_ALIGN), _round_up(c, 128)
    brs = sorted({min(rp, v) for v in (64, 128, 256, 512)})
    bcs = sorted({min(cp, v) for v in (128, 256, 512, 1024)})
    return [BlockConfig(br, bc, 0, source="sweep")
            for br in brs for bc in bcs]


def _resolve_and_cache(key: str, *,
                       measure: Optional[Callable[[BlockConfig], float]],
                       candidates: Callable[[], Iterable[BlockConfig]],
                       heuristic: Callable[[], BlockConfig],
                       persist: bool) -> BlockConfig:
    """Cache -> timed sweep -> heuristic, one implementation for the
    block and elementwise entry points (``candidates`` and ``heuristic``
    are thunks, built only on a miss).  A measure returns seconds, ``inf``
    for a candidate that does not fit; an exception propagates."""
    with _lock:
        _load_disk_locked()
        hit = _memory.get(key)
    if hit is not None:
        return hit
    cfg = None
    if measure is not None:
        cands = list(candidates())
        timed = [(measure(c), i) for i, c in enumerate(cands)]
        best_t, best_i = min(timed)
        if best_t != float("inf"):
            cfg = dataclasses.replace(cands[best_i], source="sweep")
    if cfg is None:
        cfg = heuristic()
    with _lock:
        _store_locked(key, cfg, persist)
    return cfg


def get_elementwise_config(r: int, c: int, *,
                           dtype: str = "float32",
                           backend: Optional[str] = None,
                           measure: Optional[
                               Callable[[BlockConfig], float]] = None,
                           op: str = "eclquant",
                           persist: bool = True) -> BlockConfig:
    """(block_r, block_c) of a 2-D elementwise kernel under ``k=0`` plus an
    ``op`` extra, so its entries never collide with a matmul's."""
    backend = backend or default_backend()
    return _resolve_and_cache(
        cache_key(r, 0, c, dtype=dtype, fused=False, backend=backend,
                  extra=op),
        measure=measure,
        candidates=lambda: candidate_elementwise_blocks(r, c),
        heuristic=lambda: heuristic_elementwise_blocks(r, c),
        persist=persist)


def candidate_blocks(m: int, k: int, n: int, *, fused: bool = False
                     ) -> Sequence[BlockConfig]:
    """Candidates of the timed sweep.  Fused: the batch-tiled row tile over
    ``ROW_TILES`` clamped to the rounded batch (deduplicated).  The chain:
    its one launch configuration (:func:`heuristic_blocks`)."""
    if not fused:
        return [dataclasses.replace(heuristic_blocks(m, k, n),
                                    source="sweep")]
    mp = _round_up(m, ROW_ALIGN)
    return [BlockConfig(bm, SLICE_COLS, _round_up(k, 2), source="sweep")
            for bm in sorted({min(mp, v) for v in ROW_TILES})]


def get_block_config(m: int, k: int, n: int, *,
                     dtype: str = "float32", fused: bool = False,
                     backend: Optional[str] = None,
                     measure: Optional[Callable[[BlockConfig], float]] = None,
                     candidates: Optional[Iterable[BlockConfig]] = None,
                     act_dtype: str = "float32",
                     extra: str = "",
                     persist: bool = True) -> BlockConfig:
    """Blocks of one problem shape (cache -> sweep -> heuristic).
    ``measure`` runs one candidate and returns seconds (``inf``: it does
    not fit); without it the heuristic answers, kept in memory only.  A
    caller off the card passes ``backend="cpu"`` (the default there)."""
    backend = backend or default_backend()
    return _resolve_and_cache(
        cache_key(m, k, n, dtype=dtype, fused=fused, backend=backend,
                  act_dtype=act_dtype, extra=extra),
        measure=measure,
        candidates=lambda: (candidates if candidates is not None
                            else candidate_blocks(m, k, n, fused=fused)),
        heuristic=lambda: heuristic_blocks(m, k, n, fused=fused),
        persist=persist)


# --------------------------------------- (bucket, schedule) tuning unit

def bucket_cache_key(rows: int, k: int, n: int, *, dtype: str = "float32",
                     backend: Optional[str] = None,
                     act_dtype: str = "float32", stack: str = "") -> str:
    """Key of one batch bucket's (schedule, block_m) binding."""
    backend = backend or default_backend()
    return cache_key(rows, k, n, dtype=dtype, fused=True, backend=backend,
                     act_dtype=act_dtype,
                     extra=(f"{stack}|" if stack else "") + "bucket")


def ws_crossover_key(k: int, n: int, *, dtype: str = "float32",
                     backend: Optional[str] = None,
                     act_dtype: str = "float32", stack: str = "") -> str:
    backend = backend or default_backend()
    return cache_key(0, k, n, dtype=dtype, fused=True, backend=backend,
                     act_dtype=act_dtype,
                     extra=(f"{stack}|" if stack else "") + "wscross")


def candidate_schedule_blocks(rows: int, schedules: Sequence[str]
                              ) -> Sequence[Tuple[str, int]]:
    """(schedule, block_m) candidates of one bucket's sweep.  ws holds the
    whole (rounded) bucket, so its block_m is no knob; batch_tiled and
    stream take the ``ROW_TILES`` ladder clamped to the bucket; db needs
    two row groups of 8, so its tiles are multiples of 16."""
    mp = _round_up(rows, ROW_ALIGN)
    out = []
    for sched in schedules:
        if sched == "ws":
            out.append((sched, mp))
            continue
        bms = sorted({min(mp, v) for v in ROW_TILES})
        if sched == "db":
            bms = [b for b in bms if b % 16 == 0]
        out.extend((sched, bm) for bm in bms)
    return out


def prior_config(rows: int, prior: str, *,
                 block_m_hint: Optional[int] = None) -> BlockConfig:
    """The prior's binding: ``prior`` at ``block_m_hint`` clamped to the
    rounded bucket (the rounded bucket with no hint); never cached."""
    mp = _round_up(rows, ROW_ALIGN)
    bm = min(block_m_hint if block_m_hint is not None else MAX_BLOCK_M, mp)
    return BlockConfig(bm, 0, 0, source="heuristic", schedule=prior)


def get_schedule_config(rows: int, k: int, n: int, *,
                        schedules: Sequence[str],
                        prior: str,
                        dtype: str = "float32",
                        backend: Optional[str] = None,
                        act_dtype: str = "float32",
                        stack: str = "",
                        measure: Optional[
                            Callable[[str, int], float]] = None,
                        legacy_m: Optional[int] = None,
                        block_m_hint: Optional[int] = None,
                        persist: bool = True) -> BlockConfig:
    """One batch bucket's (schedule, block_m) binding.

    ``schedules`` is the bucket's eligible set (fits and opt-outs applied
    by the plan), ``prior`` the dataflow answer.  ``measure(schedule,
    block_m) -> seconds`` runs the kernel on the card (``inf``: the
    candidate does not fit); without it the prior answers, its block_m
    migrated from the old single fused entry (``legacy_m``: the rows it
    was tuned at) or from ``block_m_hint``, never cached.

    A cached entry answers only callers whose eligible set its sweep
    covered (``swept``).  Otherwise, with a measure, the sweep runs over
    the union of the caller's set and the entry's: the stored entry is
    the union's winner and the caller gets the best candidate it may
    bind, so plans with different sets converge.  Without a measure a
    forbidden winner is bypassed, not overwritten."""
    if not schedules:
        raise ValueError("schedules must name at least one eligible "
                         "schedule")
    unknown = [s for s in schedules if s not in SCHEDULES]
    if unknown:
        raise ValueError(f"unknown schedules {unknown}; valid: {SCHEDULES}")
    if prior not in schedules:
        prior = schedules[0]
    backend = backend or default_backend()
    key = bucket_cache_key(rows, k, n, dtype=dtype, backend=backend,
                           act_dtype=act_dtype, stack=stack)
    with _lock:
        _load_disk_locked()
        hit = _memory.get(key)
    covered: set = set()
    if hit is not None:
        covered = set(hit.swept) if hit.swept else \
            ({hit.schedule} if hit.schedule else set())
        if hit.schedule in schedules and \
                (set(schedules) <= covered or measure is None):
            return hit
    mp = _round_up(rows, ROW_ALIGN)
    cfg = store = None
    if measure is not None:
        sweep_set = tuple(schedules) + tuple(
            s for s in SCHEDULES if s in covered and s not in schedules)
        cands = list(candidate_schedule_blocks(rows, sweep_set))
        timed = [(measure(s, bm), i) for i, (s, bm) in enumerate(cands)]
        finite = [(t, i) for t, i in timed if t != float("inf")]
        caller_finite = [(t, i) for t, i in finite
                         if cands[i][0] in schedules]
        if caller_finite:
            _, i = min(caller_finite)
            s, bm = cands[i]
            cfg = BlockConfig(bm, 0, 0, source="sweep", schedule=s,
                              swept=sweep_set)
            _, iu = min(finite)
            su, bmu = cands[iu]
            store = cfg if iu == i else BlockConfig(
                bmu, 0, 0, source="sweep", schedule=su, swept=sweep_set)
    if cfg is None:
        legacy = None
        if legacy_m is not None:
            # the old single fused entry, tuned at the largest bucket
            with _lock:
                legacy = _memory.get(cache_key(
                    legacy_m, k, n, dtype=dtype, fused=True,
                    backend=backend, act_dtype=act_dtype, extra=stack))
        cfg = prior_config(rows, prior, block_m_hint=block_m_hint) \
            if legacy is None else BlockConfig(
                min(legacy.block_m, mp), 0, 0, source="migrated",
                schedule=prior)
    if store is None:
        # a prior depends on the caller's eligibility and requests:
        # caching it would shadow another plan's and mask a later sweep
        return cfg
    with _lock:
        _store_locked(key, store, persist)
    return cfg


def record_ws_crossover(rows: int, k: int, n: int, *,
                        dtype: str = "float32",
                        backend: Optional[str] = None,
                        act_dtype: str = "float32", stack: str = "",
                        persist: bool = True) -> None:
    """Persist the measured ws / batch-tiled crossover: the largest bucket
    whose sweep ws won (0: ws never won).  It replaces the
    ``WS_BUCKET_ROWS`` constant as the plan's prior from then on."""
    backend = backend or default_backend()
    key = ws_crossover_key(k, n, dtype=dtype, backend=backend,
                           act_dtype=act_dtype, stack=stack)
    cfg = BlockConfig(int(rows), 0, 0, source="sweep",
                      schedule="ws_crossover")
    with _lock:
        _load_disk_locked()      # merge with the file, never clobber it
        _store_locked(key, cfg, persist)


def get_ws_crossover(k: int, n: int, *, dtype: str = "float32",
                     backend: Optional[str] = None,
                     act_dtype: str = "float32",
                     stack: str = "") -> Optional[int]:
    """The measured crossover row count, or None if this backend has never
    swept the stack."""
    backend = backend or default_backend()
    key = ws_crossover_key(k, n, dtype=dtype, backend=backend,
                           act_dtype=act_dtype, stack=stack)
    with _lock:
        _load_disk_locked()
        hit = _memory.get(key)
    if hit is None or hit.schedule != "ws_crossover":
        return None
    return hit.block_m
