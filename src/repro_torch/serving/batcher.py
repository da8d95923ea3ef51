"""Request queue + tile-bucketed micro-batcher over a ServableProgram.

The port of the JAX package's ``serving/batcher.py``: the queue, triggers
and scatter are host-side numpy as there; only the launch moves a bucket to
the plan's device (``torch.from_numpy(...).to(device)``) and reads the
result back (``.cpu().numpy()``, which waits for the card).  The
virtual-clock ``replay`` driver is not ported yet.

The batcher depends only on the :class:`~repro_torch.serving.plans.ServableProgram`
surface — ``d_in``, ``bucket_sizes``, ``bucket_for``, ``entry``, ``run``,
plus the optional ``rows_per_request`` contract — so an
:class:`~repro_torch.serving.plans.ExecutionPlan` or any proxy around one
slots in unchanged.

FantastIC4's throughput story (§V: 2.45 TOPS on the GSC MLPs) assumes the
execution units always see full row tiles; a serving frontend that launches
the megakernel once per arriving request feeds it mostly padding.  The
:class:`MicroBatcher` closes that gap — continuous batching at MLP scale:

    requests ──▶ FIFO queue ──▶ coalesce into the plan's power-of-two
    (ragged)                    row buckets (pad the remainder) ──▶ one
                                bucket entry launch ──▶ scatter rows back
                                per request

Three flush triggers:

* **full tile** — the queue holds enough rows for the largest bucket:
  flush immediately (the megakernel sees a full ``block_m`` tile).
* **deadline** — the oldest queued request has waited ``max_delay``:
  flush a partial bucket rather than hold latency hostage to arrival rate.
* **explicit** — ``flush()`` / ``run_one(force=True)`` drains regardless
  (used by work-conserving drivers that flush whenever the engine is
  idle, and at shutdown).

Requests keep their rows contiguous (a multi-row request is never split
across buckets) and results are scattered back by request id.  Because
every row's output depends only on its own input row, a request served
from a padded/coalesced bucket is bit-identical to the same request served
alone through the same bucket entry — the padding-parity contract
the tests enforce.

Clock contract
--------------

The batcher is clock-agnostic: every method takes an explicit ``now`` (or
falls back to ``self.clock``), so tests and the ragged-arrival benchmark
can drive it on a virtual clock while the kernel launches run for real.
Two clock domains therefore exist and the stats keep them apart:

* ``stats["wall_compute_s"]`` — always the **live** ``perf_counter``
  measurement of the blocking device round-trips, whatever clock drives
  the trigger logic.  This is the number a host-load investigation wants.
* ``stats["compute_s"]`` — compute time in the **batcher's clock
  domain**.  With the default live clock the two are the same
  measurement.  When the caller injects a virtual clock (``clock=`` a
  fake, or ``clock=None`` for drivers like :func:`replay` that pass an
  explicit ``now`` everywhere), the batcher cannot know the virtual cost
  of a launch — the driver does — so ``run_one`` leaves ``compute_s``
  alone and the driver accounts its virtual service time via
  :meth:`MicroBatcher.account_compute`.  Mixing the two domains (the
  pre-fix behavior: live seconds accumulated under a virtual makespan)
  made ``compute_s / makespan`` utilization nonsense.

``pump(now=None)`` re-reads the clock on **every** loop iteration: a
deadline that expires while a long bucket blocks on compute is flushed by
the same pump instead of overshooting ``max_delay`` until the next driver
cycle.  An explicit ``now`` is evaluated exactly once (the virtual-clock
replay path decides time itself).

All mutating entry points are serialized by an internal lock, so a
threaded driver (``serving.frontend``) may ``submit`` from many threads
while one dispatch thread pumps; the lock is *released* around the
blocking device round-trip so intake never stalls behind compute.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .slo import (REJECT_QUEUE_FULL, AdmissionController, Rejected,
                  SLOTier, resolve_tier)


@dataclasses.dataclass
class _Pending:
    rid: int
    x: np.ndarray             # (rows, d_in) — host-resident until launch
    rows: int
    arrival: float
    deadline: float


@dataclasses.dataclass
class Completion:
    """One served request: scattered logits + queueing metadata."""
    rid: int
    y: np.ndarray             # (rows, d_out)
    arrival: float
    bucket: int               # rows of the bucket that served it
    batched_rows: int         # real rows sharing the launch


@dataclasses.dataclass
class Taken:
    """One coalesced bucket popped from the queue but not yet launched —
    the handoff unit between a dispatcher that *decides* (which stream
    runs this bucket) and the stream worker that *executes* it.  The
    requests stay host-side numpy until :meth:`MicroBatcher.execute`
    consumes them, so a failed launch can requeue them intact."""
    requests: List[_Pending]
    rows: int


class MicroBatcher:
    """See module docstring.  ``max_bucket`` caps coalescing below the
    plan's largest bucket (``max_bucket=1`` degenerates to naive
    per-request serving — the benchmark baseline).  ``clock=None`` marks
    a fully virtual batcher: every call must pass an explicit ``now`` and
    the driver owns compute accounting (see the clock contract above).

    ``keep_results=False`` is for drivers that consume completions from
    ``run_one``/``pump`` return values (the serving frontend resolves
    futures from them): nothing is retained for :meth:`result`, otherwise
    a long-running server would hold every output it ever produced.

    Overload posture (``serving.slo``): an explicit ``tier`` attaches a
    latency class — ``max_delay`` defaults to the tier's coalescing
    budget and every submit runs the :class:`AdmissionController` cost
    model against the tier's end-to-end deadline (sheds raise
    :class:`Rejected` with reason ``deadline``).  ``max_queued_rows``
    bounds the queue independently of tiers: a submit that would push the
    queued rows past the bound raises :class:`Rejected` with reason
    ``queue_full`` instead of growing memory without limit.  Both
    rejections leave the queue untouched and are counted in ``stats``
    (``rejected_full`` / ``shed_deadline`` / ``rejected_rows``).  Without
    ``tier``/``max_queued_rows`` intake behaves exactly as before
    (admit everything)."""

    def __init__(self, plan, *, max_delay: Optional[float] = None,
                 max_bucket: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = time.monotonic,
                 keep_results: bool = True,
                 tier: Optional[SLOTier] = None,
                 max_queued_rows: Optional[int] = None,
                 service_times: Optional[Dict[int, float]] = None):
        self.plan = plan
        # programs with per-row request state (e.g. one row per decode
        # sequence) fix the row count a request must carry; None = any.
        self.rows_per_request: Optional[int] = getattr(
            plan, "rows_per_request", None)
        self.tier = resolve_tier(tier)
        self.max_delay = self.tier.max_delay if max_delay is None \
            else max_delay
        top = max(plan.bucket_sizes)
        self.max_bucket = min(max_bucket or top, top)
        self.max_queued_rows = max_queued_rows
        self.clock = clock
        # live-domain compute accounting only when trigger time and
        # perf_counter advance together; any injected clock is virtual.
        self._live_clock = clock is time.monotonic
        self._lock = threading.RLock()
        self.keep_results = keep_results
        self._queue: Deque[_Pending] = collections.deque()
        self._queued_rows = 0
        self._inflight: set = set()          # submitted, result not stored
        self._results: Dict[int, Completion] = {}
        self._next_rid = 0
        self._last_failed_bucket: Optional[int] = None
        # the cost model is always maintained (EWMA of live launches, a
        # seeded table from the caller's measured sweep); it *gates*
        # intake only when a tier was explicitly attached — legacy
        # batchers keep the admit-everything contract.
        self.admission = AdmissionController(
            plan.bucket_for, self.max_bucket, service_times=service_times)
        self._admission_gates = tier is not None
        self.stats = {"requests": 0, "rows": 0, "flushes": 0,
                      "flushed_rows": 0, "padded_rows": 0,
                      "bucket_hist": {}, "compute_s": 0.0,
                      "wall_compute_s": 0.0, "rejected_full": 0,
                      "shed_deadline": 0, "rejected_rows": 0,
                      "launch_failures": 0}

    def _now(self, now: Optional[float]) -> float:
        if now is not None:
            return now
        if self.clock is None:
            raise ValueError(
                "virtual batcher (clock=None): pass an explicit now=")
        return self.clock()

    # ------------------------------------------------------------- intake

    def submit(self, x, now: Optional[float] = None) -> int:
        """Queue one request (``(rows, d_in)`` or a single ``(d_in,)``
        row); returns its request id.  Thread-safe.  Raises
        :class:`Rejected` (typed, reason-carrying) when the bounded queue
        is full or the tier's cost model proves the SLO unattainable —
        the queue is left untouched either way."""
        now = self._now(now)
        x = np.asarray(x, np.float32)         # host-side until the launch
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self.plan.d_in:
            raise ValueError(f"request must be (rows, {self.plan.d_in}), "
                             f"got {x.shape}")
        if self.rows_per_request and x.shape[0] != self.rows_per_request:
            # programs that carry per-row request state pin the row count;
            # admitting a mismatched request would mis-scatter every later
            # request sharing its bucket — fail loudly at intake instead.
            raise ValueError(
                f"program requires exactly {self.rows_per_request} row(s) "
                f"per request (rows_per_request contract), got "
                f"{x.shape[0]}")
        with self._lock:
            rows = x.shape[0]
            if self.max_queued_rows is not None and \
                    self._queued_rows + rows > self.max_queued_rows:
                self.stats["rejected_full"] += 1
                self.stats["rejected_rows"] += rows
                raise Rejected(
                    REJECT_QUEUE_FULL,
                    f"{self._queued_rows} rows queued + {rows} new > "
                    f"bound {self.max_queued_rows}")
            if self._admission_gates:
                try:
                    self.admission.admit(self._queued_rows, rows, self.tier)
                except Rejected:
                    self.stats["shed_deadline"] += 1
                    self.stats["rejected_rows"] += rows
                    raise
            rid = self._next_rid
            self._next_rid += 1
            self._queue.append(_Pending(rid, x, x.shape[0], now,
                                        now + self.max_delay))
            self._queued_rows += x.shape[0]
            self._inflight.add(rid)
            self.stats["requests"] += 1
            self.stats["rows"] += x.shape[0]
        return rid

    @property
    def pending_rows(self) -> int:
        return self._queued_rows

    def next_deadline(self) -> Optional[float]:
        with self._lock:
            return self._queue[0].deadline if self._queue else None

    def oldest_arrival(self) -> Optional[float]:
        with self._lock:
            return self._queue[0].arrival if self._queue else None

    @property
    def last_failed_bucket(self) -> Optional[int]:
        """Bucket rows of the most recent failed launch (degradation
        ladder input: which ``(bucket, schedule)`` entry to poison)."""
        return self._last_failed_bucket

    def drop_all(self) -> List[_Pending]:
        """Empty the queue without serving it (quarantine path): returns
        the dropped requests so the driver can resolve their futures with
        the root cause instead of leaving them hanging."""
        with self._lock:
            dropped = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
            for p in dropped:
                self._inflight.discard(p.rid)
            return dropped

    # -------------------------------------------------------------- flush

    def _take(self) -> List[_Pending]:
        """Pop whole requests FIFO up to ``max_bucket`` rows (always at
        least one request — an oversized request runs alone at exact
        size rather than being split).  Caller holds the lock."""
        taken: List[_Pending] = []
        rows = 0
        while self._queue:
            nxt = self._queue[0]
            if taken and rows + nxt.rows > self.max_bucket:
                break
            taken.append(self._queue.popleft())
            rows += nxt.rows
            if rows >= self.max_bucket:
                break
        self._queued_rows -= rows
        return taken

    def account_compute(self, dt: float) -> None:
        """Record ``dt`` seconds of compute in the batcher's clock domain.
        Virtual-clock drivers (e.g. :func:`replay` with a service-time
        table) call this with their virtual cost; the live wall time of
        the launch is already in ``stats["wall_compute_s"]``."""
        with self._lock:
            self.stats["compute_s"] += dt

    def take(self, now: Optional[float] = None) -> Optional[Taken]:
        """Pop one coalesced bucket off the queue without launching it
        (``None`` when the queue is empty).  The multi-stream frontend
        separates the two halves of :meth:`run_one`: the dispatch thread
        *takes* (so it can cost the bucket and pick the least-loaded
        stream) and the chosen stream worker *executes*.  A taken bucket
        the caller abandons can be returned via :meth:`requeue`."""
        self._now(now)
        with self._lock:
            taken = self._take()
        if not taken:
            return None
        return Taken(taken, sum(p.rows for p in taken))

    def requeue(self, taken: Taken) -> None:
        """Put a taken-but-never-launched bucket back at the queue head
        (original order, original deadlines) — the dispatcher's undo."""
        with self._lock:
            for p in reversed(taken.requests):
                self._queue.appendleft(p)
            self._queued_rows += taken.rows

    def run_one(self, now: Optional[float] = None
                ) -> Tuple[List[Completion], int, float]:
        """Serve one bucket now (no trigger checks — the caller decided).
        Returns ``(completions, bucket_rows, wall_seconds)``; wall time
        covers the blocking device round-trip for the whole bucket.  The
        lock is dropped around the round-trip so submits stay live.
        """
        t = self.take(now)
        if t is None:
            return [], 0, 0.0
        return self.execute(t)

    def execute(self, t: Taken, *, device=None
                ) -> Tuple[List[Completion], int, float]:
        """Launch one taken bucket (the execution half of
        :meth:`run_one`).  ``device`` routes the launch to a specific
        CUDA device (``torch.cuda.device`` scoped around the round-trip);
        by default the bucket goes to the plan's own device.  A failed
        launch requeues the taken requests at the queue head."""
        taken, rows = t.requests, t.rows
        bucket = self.plan.bucket_for(rows)
        padded = (bucket or rows) - rows
        # coalesce and scatter run host-side in numpy; the bucket entry is
        # the only device work a launch waits on.
        xb = np.concatenate([p.x for p in taken], axis=0) \
            if len(taken) > 1 else taken[0].x
        t0 = time.perf_counter()
        try:
            target = torch.device(device) if device is not None else \
                getattr(self.plan, "device", torch.device("cpu"))
            ctx = torch.cuda.device(target) if target.type == "cuda" \
                else contextlib.nullcontext()
            with ctx:
                xt = torch.from_numpy(np.ascontiguousarray(xb)).to(target)
                if bucket is None:
                    y = self.plan.run(xt)          # oversized: exact size
                    bucket = rows
                else:
                    if padded:
                        xt = torch.nn.functional.pad(xt, (0, 0, 0, padded))
                    y = self.plan.entry(bucket)(xt)
                y = y.cpu().numpy()
        except BaseException:
            # a failed launch loses NOTHING: requests are host-side numpy
            # until the kernel consumes them, so put the taken batch back
            # at the head of the queue (original order, original
            # deadlines) and let the driver decide — retry the intact
            # queue, fall back, or quarantine (serving.frontend's
            # degradation ladder).
            with self._lock:
                for p in reversed(taken):
                    self._queue.appendleft(p)
                self._queued_rows += rows
                self.stats["launch_failures"] += 1
                self._last_failed_bucket = bucket if bucket else rows
            raise
        dt = time.perf_counter() - t0
        self.admission.observe(bucket, dt)   # running EWMA cost model

        if y.ndim != 2 or y.shape[0] < rows:
            # a program that returns fewer rows than it was handed would
            # silently mis-scatter the tail requests of the bucket; make
            # the contract violation loud and attributable instead.
            raise RuntimeError(
                f"program returned {getattr(y, 'shape', None)} for a "
                f"{rows}-row bucket (need >= {rows} rows): refusing to "
                "scatter misaligned results")
        out: List[Completion] = []
        off = 0
        with self._lock:
            for p in taken:
                c = Completion(p.rid, y[off:off + p.rows], p.arrival, bucket,
                               rows)
                if self.keep_results:
                    self._results[p.rid] = c
                self._inflight.discard(p.rid)
                out.append(c)
                off += p.rows
            st = self.stats
            st["flushes"] += 1
            st["flushed_rows"] += rows
            st["padded_rows"] += padded
            st["bucket_hist"][bucket] = st["bucket_hist"].get(bucket, 0) + 1
            st["wall_compute_s"] += dt
            if self._live_clock:
                st["compute_s"] += dt
        return out, bucket, dt

    def pump(self, now: Optional[float] = None,
             force: bool = False) -> List[Completion]:
        """Flush every bucket whose trigger has fired (full tile or
        expired deadline; everything when ``force``).

        Without an explicit ``now`` the clock is re-read on every
        iteration: a deadline expiring *during* a bucket's blocking
        compute triggers in the same pump instead of waiting (and
        overshooting ``max_delay``) for the next driver cycle.  An
        explicit ``now`` is honored as-is — virtual-clock drivers decide
        what time it is."""
        reread = now is None
        cur = self._now(now)
        done: List[Completion] = []
        while True:
            with self._lock:
                if not self._queue:
                    break
                full = self._queued_rows >= self.max_bucket
                due = self._queue[0].deadline <= cur
                if not (full or due or force):
                    break
            done.extend(self.run_one(cur)[0])
            if reread:
                cur = self.clock()
        return done

    def flush(self, now: Optional[float] = None) -> List[Completion]:
        return self.pump(now, force=True)

    # ------------------------------------------------------------ results

    def result(self, rid: int) -> Optional[Completion]:
        """Pop a completed request's result.  Returns ``None`` while the
        request is still queued or in flight; raises ``KeyError`` for a
        rid that was never issued or whose result was already consumed —
        previously both cases returned ``None`` indistinguishably from
        "still queued", hiding double-pop bugs in drivers."""
        with self._lock:
            if rid in self._results:
                return self._results.pop(rid)
            if rid in self._inflight:
                return None
            if not (0 <= rid < self._next_rid):
                raise KeyError(f"unknown request id {rid}")
            raise KeyError(f"request {rid}: result already consumed")

    def serve(self, xs: Sequence) -> List[np.ndarray]:
        """Synchronous convenience: submit every request, drain the queue,
        return logits in submission order."""
        rids = [self.submit(x) for x in xs]
        self.flush()
        return [self.result(r).y for r in rids]
