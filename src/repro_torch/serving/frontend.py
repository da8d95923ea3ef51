"""Async multi-model serving frontend: a real-clock driver over batchers.

The port of the JAX package's ``serving/frontend.py``.  Where the JAX
package places stream workers on ``jax.devices()``, each worker here
launches on a CUDA stream of its own (``torch.cuda.Stream``) on the
plan's device, one card or several; the kernels launch on the current
stream, so the worker makes its stream current around every launch.
One deliberate difference: :meth:`ServingFrontend.asubmit` hands the
caller the root cause when the dispatch thread has died, also when it
died before the submit (the JAX package raises a generic
``RuntimeError`` then, with the cause only as ``__cause__``).

The :class:`MicroBatcher` decides *what* to coalesce; until now the repo
only had virtual-clock drivers (``replay``, the benchmarks) around it.
This module is the missing runtime half — the thing that turns the replay
simulator into a runnable server, and the deployment shape FantastIC4
targets: **many small compact MLPs sharing one device** (the paper's §V
units are never idle only if *something* always has a full tile to
launch).

    submit(model_id, x) ──▶ per-model MicroBatcher ──▶ one dispatch
    (any thread / async)     (queue → bucket)          thread, single
                                                       execution stream

Driver loop
-----------

One daemon thread owns the (real, ``time.monotonic``) clock and the
execution stream:

1. **pick** the next launch among batchers whose trigger has fired — a
   *full tile* (pending rows ≥ the largest bucket) launches immediately,
   a *due deadline* (oldest request waited ``max_delay``) launches a
   partial bucket.  Among fired batchers the **oldest head deadline
   wins** (deadline = arrival + ``max_delay``, so this is global FIFO in
   arrival order across models).
2. if nothing fired, **sleep until ``min(next_deadline)``** across all
   registered models — or indefinitely when every queue is empty; any
   ``submit`` notifies the condition variable, so a full tile formed by a
   burst launches without waiting out the deadline.
3. launch via ``MicroBatcher.run_one()`` with the batcher's lock dropped
   around the device round-trip — submits keep landing while the kernel
   runs, and the next pick re-reads the clock, so deadlines that expired
   during compute are served next (``pump`` enforces the same rule
   inside single-batcher drivers).

Fairness
--------

Oldest-deadline-first *across* models is starvation-free by
construction: a backlogged model's full tiles run while nothing is due
(work conservation), but the moment a trickle model's request ages past
its ``max_delay`` its deadline is the oldest fired trigger and it
preempts further full tiles.  A model under sustained load therefore
bounds another model's extra wait by one bucket's compute, not by the
backlog depth (``tests/test_torch_frontend.py`` pins this).

Clock contract
--------------

The frontend is the *live* driver: batchers it registers run on its
``time.monotonic`` clock, latencies reported in :class:`Served` are wall
time (submit → results scattered), and ``stats["compute_s"]`` equals
``stats["wall_compute_s"]`` (same domain).  Virtual-time experiments
belong to ``serving.replay``, which owns its clock explicitly — the two
drivers never share a batcher.

Sync callers get a ``concurrent.futures.Future`` back from
:meth:`ServingFrontend.submit`; async callers ``await`` the same request
through :meth:`ServingFrontend.asubmit` (the future is wrapped into the
running asyncio loop — the driver thread doubles as the executor, no
event-loop-blocking calls anywhere on the await path).

SLO tiers and overload
----------------------

``register(..., tier=)`` attaches a latency class (``serving.slo``): the
tier's ``max_delay`` is the batching budget, its ``deadline`` gates
admission (the batcher's cost model sheds requests that provably cannot
make the SLO), and its ``weight`` enters the pick rule — fired batchers
are ordered by ``head_deadline - tier.weight``, so a latency-tier
request preempts throughput-tier full tiles by up to ``weight`` seconds
of queue age and no more (bounded priority ⇒ still starvation-free).
Rejected/shed submits resolve their future with a typed
:class:`~.slo.Rejected` — callers always learn promptly, with a reason.

Faults and graceful degradation
-------------------------------

A failed launch is no longer fatal for the stream.  The batcher requeues
the taken requests (host-side numpy — nothing is lost) and the driver
walks a degradation ladder per model, governed by :class:`RetryPolicy`:

1. **retry** — the launch is re-driven from the intact queue up to
   ``max_retries`` times (transient launch errors clear on retry, the
   ``runtime.fault`` posture applied to serving);
2. **chain fallback** — a fused ``(bucket, schedule)`` entry that keeps
   failing is *poisoned*: ``plan.demote_bucket`` rebinds that bucket to
   the per-layer chain path (bit-identical results, degraded speed) and
   the ladder restarts;
3. **quarantine** — a model whose failures survive retry *and* fallback
   is isolated: its outstanding futures get the root cause, its queue is
   dropped, new submits are rejected (``Rejected("quarantined")``) — and
   **every other model keeps serving**.  Previously one bad model killed
   the whole dispatch stream.

Every rung is counted in ``stats`` (``retries`` / ``fallbacks`` /
``quarantined`` / per-model mirrors) — degradation is measurable, never
silent.  Errors in the dispatch machinery itself (not a launch) still
fail everything loudly, exactly as before.

Replicated execution streams (scale-out)
----------------------------------------

``ServingFrontend(streams=N)`` splits the driver into one dispatch
thread plus N stream workers, each with a CUDA stream of its own on the
plan's device (``devices=`` pins a worker to a device instead); on the
CPU the workers are threads only.
The dispatch thread still owns *what* launches (same tier-weighted
oldest-deadline pick), but instead of executing inline it **takes** the
coalesced bucket (``MicroBatcher.take``) and assigns it to the stream
with the least estimated backlog — join-shortest-estimated-work over
the admission controller's per-bucket service-time EWMA
(``AdmissionController.launch_estimate``), so a slow stream accrues
backlog and stops winning assignments.  The worker **executes**
(``MicroBatcher.execute``) with the batcher's requeue-on-failure
contract intact, and resolves the futures; :class:`Served` carries the
``stream`` that ran it.

The degradation ladder gains a per-stream rung: launch failures count
against the stream that ran them as well as the model, and a stream
whose failures survive the retry budget is **quarantined by itself**
(its queued tickets reroute to healthy streams, the model's ladder
restarts) as long as another stream is active — one poisoned device
degrades the fleet by 1/N instead of killing it.  Failures that follow
the model across streams still walk the model ladder (retry → chain
fallback → model quarantine) exactly as before.  ``streams=1``
(default) is byte-for-byte the single-stream driver above.
"""
from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..runtime.integrity import (GuardedPlan, IntegrityError,
                                 IntegrityPolicy, unwrap_chain)
from .batcher import MicroBatcher, Taken
from .pack_cache import (CachedPlan, ColdPack, PackCache,
                         verify_cold_pack)
from .plans import ServableProgram, forget_plan
from .slo import (REJECT_CORRUPTED, REJECT_QUARANTINED,
                  REJECT_UNREGISTERED, Rejected, resolve_tier)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Degradation ladder knobs (see module docstring).

    ``max_retries``  — launch retries per rung before escalating.
    ``backoff_s``    — sleep ``backoff_s * attempt`` between retries
                       (transient-fault spacing; 0 keeps tests fast).
    ``fallback``     — poison-and-demote the failing fused bucket to the
                       per-layer chain before giving up on the model.
    ``quarantine``   — isolate the model after the ladder; ``False``
                       escalates to the pre-ladder contract instead
                       (stream-fatal, every future fails).
    ``recover``      — detected corruption (a typed ``IntegrityError``
                       from a :class:`~repro_torch.runtime.integrity.\
GuardedPlan`) takes the recovery rung instead of the retry ladder:
                       evict the poisoned plan and re-decode from the
                       verified cold tier (bit-identical — captured
                       ``act_scales`` survive).  Only quarantines when
                       the cold copy itself fails verification."""
    max_retries: int = 2
    backoff_s: float = 0.0
    fallback: bool = True
    quarantine: bool = True
    recover: bool = True


@dataclasses.dataclass
class Served:
    """One completed request as the frontend hands it back."""
    model_id: str
    rid: int
    y: "np.ndarray"           # (rows, d_out), host-resident (see batcher)
    arrival: float            # frontend clock at submit
    finish: float             # frontend clock when results scattered
    latency: float            # finish - arrival (wall seconds)
    bucket: int               # rows of the bucket that served it
    batched_rows: int         # real rows sharing the launch
    stream: int = 0           # execution stream that ran the launch


class ModelRegistry:
    """Model id → (:class:`~.plans.ServableProgram`, :class:`MicroBatcher`).

    Any program satisfying the protocol registers — a frozen-pack
    :class:`~.plans.ExecutionPlan`,
    a :class:`~.pack_cache.CachedPlan` handle, or a guarded/fault-proxy
    wrapper around one of those; the registry and frontend feature-detect
    optional capabilities (``demote_bucket``, ``buckets``, ``pack``) and
    never type-switch on the concrete class.

    Every registered batcher shares the registry's clock, so one dispatch
    loop can compare deadlines across models directly.  Registration is
    thread-safe and allowed while a frontend is running (the driver picks
    the new queue up on its next cycle).  Registered batchers default to
    ``keep_results=False``: a frontend consumes completions from
    ``run_one``'s return value, so retaining them for ``result()`` would
    hold every output a long-running server ever produced — pass
    ``keep_results=True`` only for a batcher you drive yourself."""

    def __init__(self, *, clock: Callable[[], float] = time.monotonic,
                 cache: Optional[PackCache] = None):
        self.clock = clock
        self.cache = cache
        self._lock = threading.Lock()
        self._plans: Dict[str, ServableProgram] = {}
        self._batchers: Dict[str, MicroBatcher] = {}

    def register(self, model_id: str, plan: ServableProgram, *,
                 tier=None,
                 max_delay: Optional[float] = None,
                 max_bucket: Optional[int] = None,
                 max_queued_rows: Optional[int] = None,
                 service_times: Optional[Dict[int, float]] = None,
                 keep_results: bool = False,
                 integrity=None) -> MicroBatcher:
        """Register a model.  ``tier`` (an ``SLOTier`` or a name from
        ``serving.TIERS``) attaches a latency class: its ``max_delay``
        becomes the batching budget (an explicit ``max_delay`` still
        overrides) and its deadline gates admission through the
        batcher's cost model (seed it with measured per-bucket
        ``service_times``; live launches keep it current via EWMA).
        ``max_queued_rows`` bounds the queue — submits past it are
        rejected, typed, instead of growing memory.  ``integrity``
        (``True`` or an :class:`~repro_torch.runtime.integrity.\
IntegrityPolicy`) wraps the plan in a ``GuardedPlan`` — per-launch
        operand checksums, NaN/Inf output screen, scrubbable surface."""
        if integrity:
            policy = integrity if isinstance(integrity, IntegrityPolicy) \
                else IntegrityPolicy()
            plan = GuardedPlan(plan, policy=policy, model_id=model_id)
        resolved = resolve_tier(tier) if tier is not None else None
        if max_delay is None and resolved is None:
            max_delay = 2e-3          # pre-tier default, kept stable
        with self._lock:
            if model_id in self._batchers:
                raise ValueError(f"model {model_id!r} already registered")
            batcher = MicroBatcher(plan, max_delay=max_delay,
                                   max_bucket=max_bucket, clock=self.clock,
                                   keep_results=keep_results,
                                   tier=resolved,
                                   max_queued_rows=max_queued_rows,
                                   service_times=service_times)
            self._plans[model_id] = plan
            self._batchers[model_id] = batcher
        return batcher

    def register_pack(self, model_id: str,
                      pack: "dict | ColdPack", *,
                      plan_kwargs: Optional[dict] = None,
                      wrap: Optional[Callable] = None,
                      **reg_kwargs) -> MicroBatcher:
        """Register a model by its *pack* (frozen serving pack or cold
        :class:`~.pack_cache.ColdPack`) through the registry's
        :class:`~.pack_cache.PackCache`: the model stays compressed until
        first traffic, and its resolved plan lives under the cache's LRU
        budget.  A registry built without a cache gets an unbounded one
        on first use.  ``plan_kwargs`` go to the plan resolve
        (``act_dtype=...``, ``max_bucket=...``); ``wrap`` (a callable)
        interposes a proxy between the cache handle and the batcher —
        e.g. a ``runtime.fault.FaultInjector``, which composes with
        ``integrity=`` as GuardedPlan(wrap(CachedPlan)) so injected
        corruption is caught by the guard; the remaining kwargs are
        :meth:`register`'s (tier, max_delay, integrity, ...)."""
        with self._lock:
            if self.cache is None:
                self.cache = PackCache()
        proxy = self.cache.add(model_id, pack, plan_kwargs=plan_kwargs)
        plan = proxy if wrap is None else wrap(proxy)
        try:
            return self.register(model_id, plan, **reg_kwargs)
        except BaseException:
            self.cache.remove(model_id)
            raise

    def unregister(self, model_id: str) -> List:
        """Remove a model (lifecycle bugfix: there was no way to retire
        one — its plan, decoded operands, and memoized kernel operands leaked for
        the process lifetime).  Drops the queue and returns the dropped
        pending requests so the caller can resolve their futures with a
        typed cause (:meth:`ServingFrontend.unregister` does); releases
        every plan-side cache — the pack cache's tiers for cache-managed
        plans, the plan/operand memos for direct ones.  Raises
        ``KeyError`` for an unknown model."""
        with self._lock:
            if model_id not in self._batchers:
                raise KeyError(f"model {model_id!r} not registered; have "
                               f"{sorted(self._batchers)}")
            plan = self._plans.pop(model_id)
            batcher = self._batchers.pop(model_id)
        dropped = batcher.drop_all()
        # the registered plan may be wrapped (GuardedPlan / FaultInjector
        # proxies) — release the *innermost* plan's caches
        target = next((p for p in unwrap_chain(plan)
                       if isinstance(p, CachedPlan)), None)
        if target is not None:
            target.cache.remove(model_id)
        else:
            pack = getattr(plan, "pack", None)
            if isinstance(pack, dict):
                forget_plan(pack)
        return dropped

    def plan(self, model_id: str) -> ServableProgram:
        with self._lock:
            return self._plans[model_id]

    def batcher(self, model_id: str) -> MicroBatcher:
        try:
            return self._batchers[model_id]
        except KeyError:
            raise KeyError(f"model {model_id!r} not registered; have "
                           f"{sorted(self._batchers)}") from None

    def items(self) -> List[Tuple[str, MicroBatcher]]:
        with self._lock:
            return list(self._batchers.items())

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._batchers)

    def __contains__(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._batchers

    def __len__(self) -> int:
        with self._lock:
            return len(self._batchers)

    def next_deadline(self) -> Optional[float]:
        """Earliest queued deadline across every model (None when idle)."""
        deadlines = [d for _, b in self.items()
                     if (d := b.next_deadline()) is not None]
        return min(deadlines) if deadlines else None


class ServingFrontend:
    """See module docstring.  Use as a context manager (starts/stops the
    dispatch thread) or call :meth:`start` / :meth:`close` explicitly."""

    def __init__(self, registry: Optional[ModelRegistry] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 retry_policy: Optional[RetryPolicy] = RetryPolicy(),
                 cache: Optional[PackCache] = None,
                 streams: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 scrub_interval_s: Optional[float] = None,
                 stall_threshold_s: Optional[float] = None):
        self.registry = registry if registry is not None \
            else ModelRegistry(clock=clock, cache=cache)
        self.clock = self.registry.clock
        self.retry_policy = retry_policy
        # background scrubber cadence (None disables the thread;
        # scrub_once() is always callable) and the launch-watchdog
        # threshold (None disables check_stalls' flagging)
        self.scrub_interval_s = scrub_interval_s
        self.stall_threshold_s = stall_threshold_s
        self._scrub_stop = threading.Event()
        self._scrub_thread: Optional[threading.Thread] = None
        if streams is None:
            streams = len(devices) if devices else 1
        if streams < 1:
            raise ValueError(f"streams must be >= 1, got {streams}")
        if devices is not None and len(devices) != streams:
            raise ValueError(f"devices ({len(devices)}) must match "
                             f"streams ({streams})")
        self.streams = streams
        if devices is None:
            devices = [None] * streams     # each worker: the plan's device
        self._devices = [None if d is None else torch.device(d)
                         for d in devices]
        # each worker's CUDA stream per device, made on first use
        self._cuda_streams: Dict[Tuple[int, int], "torch.cuda.Stream"] = {}
        self._cond = threading.Condition()
        self._futures: Dict[Tuple[str, int],
                            concurrent.futures.Future] = {}
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._draining = True
        self._error: Optional[BaseException] = None
        self._quarantined: set = set()
        self._quarantine_reasons: Dict[str, str] = {}
        self._fail_streak: Dict[str, int] = {}
        # multi-stream state (all no-ops at streams=1): per-stream ticket
        # queues, estimated-backlog accounting for the JSW assignment,
        # failure streaks and the stream quarantine set.
        self._tickets: List[collections.deque] = \
            [collections.deque() for _ in range(streams)]
        self._stream_load = [0.0] * streams
        self._stream_streak = [0] * streams
        self._stream_quarantined: set = set()
        self._stream_inflight = 0
        self._workers_stop = False
        self.stats = {"launches": 0, "rejected": 0, "launch_failures": 0,
                      "retries": 0, "fallbacks": 0, "quarantined": [],
                      "by_model": {},
                      "integrity": {"detected": 0, "recovered": 0,
                                    "recovery_failed": 0,
                                    "recovery_s": []},
                      "scrub": {"cycles": 0, "checked": 0, "detected": 0,
                                "recovered": 0, "deferred": 0,
                                "errors": 0},
                      "streams": [{"launches": 0, "launch_failures": 0,
                                   "busy_s": 0.0, "quarantined": False,
                                   "last_launch_s": None,
                                   "inflight": False, "stalled": False}
                                  for _ in range(streams)]}

    def _model_stats(self, model_id: str) -> dict:
        # lazy: models may be registered through self.register OR straight
        # through the registry (documented as legal while running).
        return self.stats["by_model"].setdefault(
            model_id, {"requests": 0, "launches": 0, "rejected": 0,
                       "launch_failures": 0, "retries": 0, "fallbacks": 0,
                       "quarantined": False})

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "ServingFrontend":
        with self._cond:
            if self._running:
                return self
            if self._thread is not None and self._thread.is_alive():
                raise RuntimeError("previous dispatch thread is still "
                                   "draining; close() it first")
            self._running = True
            self._thread = threading.Thread(
                target=self._loop, name="serving-frontend", daemon=True)
            self._thread.start()
            if self.scrub_interval_s is not None and \
                    self._scrub_thread is None:
                self._scrub_stop = threading.Event()
                self._scrub_thread = threading.Thread(
                    target=self._scrub_loop, name="serving-scrubber",
                    daemon=True)
                self._scrub_thread.start()
        return self

    def close(self, *, drain: bool = True,
              timeout: Optional[float] = 30.0) -> None:
        """Stop the driver.  ``drain=True`` (default) serves everything
        still queued before the thread exits; ``drain=False`` cancels the
        outstanding futures instead.  Raises ``RuntimeError`` if the
        dispatch thread is still draining after ``timeout`` — the caller
        must retry (idempotent) rather than believe the stream stopped;
        futures are only cancelled once the thread is provably dead."""
        scrubber = self._scrub_thread
        if scrubber is not None:
            self._scrub_stop.set()
            scrubber.join(timeout)
            if not scrubber.is_alive():
                self._scrub_thread = None
        with self._cond:
            self._draining = drain
            if self._running:
                self._running = False
                self._cond.notify_all()
        thread = self._thread
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                raise RuntimeError(
                    f"dispatch thread still draining after {timeout} s; "
                    "retry close() (or close(drain=False))")
            self._thread = None
        if not drain:
            with self._cond:
                for fut in self._futures.values():
                    fut.cancel()
                self._futures.clear()

    def __enter__(self) -> "ServingFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    # ------------------------------------------------------------- intake

    def register(self, model_id: str, plan: ServableProgram, *,
                 tier=None,
                 max_delay: Optional[float] = None,
                 max_bucket: Optional[int] = None,
                 max_queued_rows: Optional[int] = None,
                 service_times: Optional[Dict[int, float]] = None,
                 integrity=None) -> MicroBatcher:
        batcher = self.registry.register(model_id, plan, tier=tier,
                                         max_delay=max_delay,
                                         max_bucket=max_bucket,
                                         max_queued_rows=max_queued_rows,
                                         service_times=service_times,
                                         integrity=integrity)
        self._model_stats(model_id)
        with self._cond:
            # a fresh registration under a quarantined id is a new model
            # (the old one was unregistered): it serves, not auto-rejects
            self._quarantined.discard(model_id)
            self._quarantine_reasons.pop(model_id, None)
            self._cond.notify_all()
        return batcher

    def register_pack(self, model_id: str, pack, *,
                      plan_kwargs: Optional[dict] = None,
                      wrap: Optional[Callable] = None,
                      **reg_kwargs) -> MicroBatcher:
        """Compressed-tier registration (see
        :meth:`ModelRegistry.register_pack`): the model stays in its
        entropy-coded cold form until first traffic.  ``integrity=``
        wraps the cache handle in a GuardedPlan; together with the cold
        tier this enables the recovery rung — detected corruption
        re-decodes from the verified compressed copy instead of
        quarantining."""
        batcher = self.registry.register_pack(
            model_id, pack, plan_kwargs=plan_kwargs, wrap=wrap,
            **reg_kwargs)
        self._model_stats(model_id)
        with self._cond:
            self._quarantined.discard(model_id)
            self._quarantine_reasons.pop(model_id, None)
            self._cond.notify_all()
        return batcher

    def unregister(self, model_id: str, *,
                   cause: Optional[BaseException] = None) -> None:
        """Retire a model: its queue is dropped, every outstanding future
        resolves promptly with a typed cause (default
        ``Rejected("unregistered")``), and every plan-side cache —
        registry entry, pack-cache tiers, plan/operand memos — is
        released.  New submits raise ``KeyError`` (unknown model).
        Raises ``KeyError`` if the model was never registered."""
        if cause is None:
            cause = Rejected(REJECT_UNREGISTERED,
                             "model was unregistered while the request "
                             "was outstanding", model_id=model_id)
        self.registry.unregister(model_id)
        with self._cond:
            self._fail_streak.pop(model_id, None)
            for key in [k for k in self._futures if k[0] == model_id]:
                fut = self._futures.pop(key)
                if not fut.cancelled():
                    fut.set_exception(cause)
            self._cond.notify_all()

    def submit(self, model_id: str, x) -> concurrent.futures.Future:
        """Queue one request from any thread; resolves to a
        :class:`Served` when its bucket has run.

        Overload/fault outcomes resolve the returned future with a typed
        :class:`~.slo.Rejected` (reason ``queue_full`` / ``deadline`` /
        ``quarantined``) instead of raising here or hanging — callers
        that ``await``/``result()`` uniformly see every outcome.  Invalid
        requests (bad shape, unknown model) still raise synchronously:
        those are caller bugs, not load conditions."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._cond:
            if self._error is not None:
                raise RuntimeError(
                    "frontend dispatch thread died") from self._error
            # quarantine check precedes the registry lookup: a
            # quarantined model is *unregistered* (lifecycle fix) yet
            # must keep rejecting with the typed reason, not "unknown
            # model"; doing the lookup under the lock also means a
            # racing unregister either sees this request in the queue
            # (and fails its future with the typed cause) or this
            # submit sees the model already gone (KeyError) — a future
            # can never be left dangling between the two.
            if model_id in self._quarantined:
                self.stats["rejected"] += 1
                self._model_stats(model_id)["rejected"] += 1
                reason = self._quarantine_reasons.get(
                    model_id, REJECT_QUARANTINED)
                detail = ("model weights failed integrity verification "
                          "and could not be recovered from the cold tier"
                          if reason == REJECT_CORRUPTED else
                          "model is quarantined after repeated launch "
                          "failures")
                fut.set_exception(Rejected(reason, detail,
                                           model_id=model_id))
                return fut
            batcher = self.registry.batcher(model_id)
            if not self._running:
                raise RuntimeError("frontend is not running (use "
                                   "`with frontend:` or call start())")
            try:
                rid = batcher.submit(x, now=self.clock())
            except Rejected as rej:
                rej.model_id = model_id
                self.stats["rejected"] += 1
                self._model_stats(model_id)["rejected"] += 1
                fut.set_exception(rej)
                return fut
            self._futures[(model_id, rid)] = fut
            self._model_stats(model_id)["requests"] += 1
            self._cond.notify_all()
        return fut

    async def asubmit(self, model_id: str, x) -> Served:
        """Asyncio face of :meth:`submit`: awaitable from any coroutine,
        driven by the same dispatch thread.  When the dispatch thread has
        died, the awaiting caller gets its root cause every time: through
        the future when it died after the submit, raised here when it
        died before."""
        try:
            fut = self.submit(model_id, x)
        except RuntimeError as exc:
            cause = exc.__cause__
            if cause is not None and cause is self._error:
                raise cause from None
            raise
        return await asyncio.wrap_future(fut)

    def serve(self, model_id: str, xs: Sequence,
              timeout: Optional[float] = None) -> List[Served]:
        """Synchronous convenience: submit every request, block until all
        are served, return in submission order.  If a later ``submit``
        raises (bad shape, dead frontend), the earlier futures are
        cancelled before the cause propagates — their queued requests
        would otherwise keep occupying the queue with nobody left to
        collect them."""
        futs: List[concurrent.futures.Future] = []
        try:
            for x in xs:
                futs.append(self.submit(model_id, x))
        except BaseException:
            for f in futs:
                f.cancel()
            raise
        return [f.result(timeout) for f in futs]

    # ----------------------------------------------------------- dispatch

    def _pick(self, now: float) -> Optional[Tuple[str, MicroBatcher]]:
        """The fired batcher with the oldest *tier-weighted* head
        deadline: full tiles fire immediately, partial buckets fire when
        due, and fired candidates are ordered by ``deadline -
        tier.weight`` — with the default (weight-0) tiers this is exactly
        global arrival FIFO (deadline = arrival + max_delay); a
        latency-class tier preempts other models' full tiles by up to its
        ``weight`` seconds of queue age, no more, so bulk tiers age past
        the credit and still win (starvation-free).  Quarantined models
        never launch."""
        best = None
        best_key = None
        for model_id, batcher in self.registry.items():
            if model_id in self._quarantined:
                continue
            deadline = batcher.next_deadline()
            if deadline is None:
                continue
            fired = (deadline <= now
                     or batcher.pending_rows >= batcher.max_bucket)
            if not fired:
                continue
            key = deadline - batcher.tier.weight
            if best_key is None or key < best_key:
                best, best_key = (model_id, batcher), key
        return best

    def _fatal(self, exc: BaseException) -> None:
        """Stream-fatal path (dispatch machinery error, or the ladder is
        disabled): fail everything outstanding loudly, refuse new work."""
        with self._cond:
            self._error = exc
            self._running = False
            self._draining = False      # nothing left worth draining
            self._workers_stop = True
            for fut in self._futures.values():
                if not fut.cancelled():
                    fut.set_exception(exc)
            self._futures.clear()
            self._cond.notify_all()

    def _quarantine(self, model_id: str, batcher: MicroBatcher,
                    exc: BaseException) -> None:
        """Isolate one model: root cause to its outstanding futures, its
        queue dropped, new submits rejected — other models keep serving.
        The model is fully *unregistered* (lifecycle fix: its plan,
        decoded operands and memoized kernel operands used to stay resident for
        the process lifetime); the quarantine flag is marked first so a
        racing submit sees the typed rejection, never "unknown model"."""
        with self._cond:
            self._quarantined.add(model_id)
            if isinstance(exc, IntegrityError):
                self._quarantine_reasons[model_id] = REJECT_CORRUPTED
            self._model_stats(model_id)["quarantined"] = True
            if model_id not in self.stats["quarantined"]:
                self.stats["quarantined"].append(model_id)
        try:
            self.registry.unregister(model_id)
        except KeyError:
            batcher.drop_all()     # already retired elsewhere: just drain
        with self._cond:
            for key in [k for k in self._futures if k[0] == model_id]:
                fut = self._futures.pop(key)
                if not fut.cancelled():
                    fut.set_exception(exc)
            self._cond.notify_all()

    def _degrade(self, model_id: str, batcher: MicroBatcher,
                 exc: Exception) -> None:
        """One failed launch through the ladder: retry (queue is intact —
        the batcher requeued the taken requests) → poison-and-demote the
        failing fused bucket to the per-layer chain → quarantine the
        model.  Raises when the ladder is disabled (stream-fatal, the
        pre-ladder contract)."""
        policy = self.retry_policy
        with self._cond:
            self.stats["launch_failures"] += 1
            ms = self._model_stats(model_id)
            ms["launch_failures"] += 1
            streak = self._fail_streak.get(model_id, 0) + 1
            self._fail_streak[model_id] = streak
        if policy is None:
            raise exc
        if isinstance(exc, IntegrityError) and policy.recover:
            # recovery rung: corruption is not transient — retrying the
            # same poisoned operands cannot succeed, and demoting the
            # bucket would serve corrupt bytes through the chain path.
            # Evict the plan and re-decode from the verified cold tier
            # (bit-identical); quarantine only when the cold copy itself
            # fails.
            with self._cond:
                self.stats["integrity"]["detected"] += 1
            if self._recover(model_id, batcher, exc):
                with self._cond:
                    self._fail_streak[model_id] = 0
                return
            with self._cond:
                self.stats["integrity"]["recovery_failed"] += 1
            if policy.quarantine:
                self._quarantine(model_id, batcher, exc)
                return
            raise exc
        if streak <= policy.max_retries:
            with self._cond:
                self.stats["retries"] += 1
                ms["retries"] += 1
            if policy.backoff_s > 0:
                time.sleep(policy.backoff_s * streak)
            return
        if policy.fallback:
            bucket = batcher.last_failed_bucket
            plan = batcher.plan
            try:
                bp = getattr(plan, "buckets", {}).get(bucket)
                demote = bp is not None and bp.path.startswith("fused") \
                    and hasattr(plan, "demote_bucket")
                if demote:
                    plan.demote_bucket(bucket, reason=f"{type(exc).__name__}"
                                       f" x{streak}")
            except KeyError:
                # a cache-managed model that another stream quarantined
                # (unregistered) while this launch ran: the quarantine
                # has failed its requests already
                with self._cond:
                    if model_id not in self._quarantined:
                        raise
                return
            if demote:
                with self._cond:
                    self.stats["fallbacks"] += 1
                    ms["fallbacks"] += 1
                    self._fail_streak[model_id] = 0   # fresh rung
                return
        if policy.quarantine:
            self._quarantine(model_id, batcher, exc)
            return
        raise exc

    # ------------------------------------------- integrity: recovery

    def _recover(self, model_id: str, batcher: MicroBatcher,
                 exc: BaseException) -> bool:
        """The recovery rung: evict the poisoned resolved plan and
        re-decode from the cold tier (``decode_pack`` verifies every
        payload and content checksum on the way up; the captured
        ``act_scales`` make the rebuild bit-identical).  The failed
        bucket's requests are already back in the queue (the batcher's
        requeue-on-failure contract), so the next pick re-serves them on
        the fresh operands.  Returns False — quarantine territory — when
        there is no cold tier to recover from (a directly-registered
        plan) or the cold copy fails verification too."""
        cached = next((p for p in unwrap_chain(batcher.plan)
                       if isinstance(p, CachedPlan)), None)
        if cached is None:
            return False
        t0 = time.perf_counter()
        try:
            cached.cache.evict(model_id)
            cached.cache.plan(model_id)     # verified cold-tier re-decode
            guard = next((p for p in unwrap_chain(batcher.plan)
                          if isinstance(p, GuardedPlan)), None)
            if guard is not None:
                guard.verify()              # fresh operands must check out
        except (IntegrityError, KeyError):
            return False
        dt = time.perf_counter() - t0
        with self._cond:
            it = self.stats["integrity"]
            it["recovered"] += 1
            it["recovery_s"].append(dt)
        return True

    # ------------------------------------------- integrity: scrubbing

    def scrub_once(self) -> dict:
        """One scrub pass over every registered model: verify the cold
        tier's payload checksums (cheap, no decode), re-verify resident
        guarded plans against their content checksums, and replay the
        canary probe where the policy arms one.  Detected corruption
        walks the same recover-or-quarantine path as a launch-time
        detection.  Non-resident cache-managed plans are NOT resolved —
        scrubbing never defeats the hot tier's laziness."""
        report = {"checked": 0, "detected": 0, "recovered": 0,
                  "quarantined": []}
        for model_id, batcher in self.registry.items():
            with self._cond:
                if model_id in self._quarantined:
                    continue
            chain = unwrap_chain(batcher.plan)
            guard = next((p for p in chain
                          if isinstance(p, GuardedPlan)), None)
            cached = next((p for p in chain
                           if isinstance(p, CachedPlan)), None)
            try:
                checked = False
                if cached is not None:
                    verify_cold_pack(cached.cache.cold(model_id))
                    checked = True
                if guard is not None and \
                        (cached is None or cached.resident):
                    guard.verify()
                    if guard.policy.canary:
                        guard.check_canary()
                    checked = True
                if checked:
                    report["checked"] += 1
            except KeyError:
                continue            # racing unregister: nothing to scrub
            except IntegrityError as exc:
                report["detected"] += 1
                with self._cond:
                    self.stats["integrity"]["detected"] += 1
                if exc.kind == "cold" or \
                        not self._recover(model_id, batcher, exc):
                    with self._cond:
                        self.stats["integrity"]["recovery_failed"] += 1
                    self._quarantine(model_id, batcher, exc)
                    report["quarantined"].append(model_id)
                else:
                    report["recovered"] += 1
        with self._cond:
            sc = self.stats["scrub"]
            sc["cycles"] += 1
            sc["checked"] += report["checked"]
            sc["detected"] += report["detected"]
            sc["recovered"] += report["recovered"]
        self.check_stalls()
        return report

    def _busy(self) -> bool:
        """Is the engine doing (or about to do) latency-sensitive work?"""
        with self._cond:
            if self._stream_inflight or \
                    any(ss.get("inflight")
                        for ss in self.stats["streams"]):
                return True
        return any(b.pending_rows for _, b in self.registry.items())

    #: consecutive busy cycles the scrubber will skip before scrubbing
    #: anyway — bounds starvation under sustained load to
    #: ``(SCRUB_MAX_DEFERS + 1) * scrub_interval_s``.
    SCRUB_MAX_DEFERS = 20

    def _scrub_loop(self) -> None:
        """Idle-aware cadence: wake every ``scrub_interval_s`` and scrub
        only when the engine is idle at that instant; a busy wake skips
        the whole cycle (bounded — after :data:`SCRUB_MAX_DEFERS`
        consecutive skips a saturated server gets scrubbed anyway).
        Deferring by whole intervals rather than polling in sub-interval
        slices keeps the thread's wakeup rate — and hence its GIL /
        scheduler interference with in-flight launches, which dwarfs the
        actual CRC work — independent of how busy the engine is.  A
        scrub failure is counted, never fatal: the scrubber is an
        auxiliary safety net and must not take the server down."""
        interval = max(float(self.scrub_interval_s), 1e-4)
        deferred = 0
        while not self._scrub_stop.wait(interval):
            if deferred < self.SCRUB_MAX_DEFERS and self._busy():
                deferred += 1
                with self._cond:
                    self.stats["scrub"]["deferred"] += 1
                continue
            deferred = 0
            try:
                self.scrub_once()
            except Exception:       # noqa: BLE001
                with self._cond:
                    self.stats["scrub"]["errors"] += 1

    # ------------------------------------------- launch watchdog

    def check_stalls(self, now: Optional[float] = None) -> List[int]:
        """Flag streams whose launch has been in flight longer than
        ``stall_threshold_s`` (a wedged device blocks its worker thread
        inside the launch — it cannot report on itself, so the scrubber
        / caller polls this).  Returns the stalled stream indices and
        mirrors them in ``stats["streams"][i]["stalled"]``; a stream
        that completes a launch clears its own flag."""
        if self.stall_threshold_s is None:
            return []
        if now is None:
            now = self.clock()
        stalled = []
        with self._cond:
            for i, ss in enumerate(self.stats["streams"]):
                last = ss.get("last_launch_s")
                if ss.get("inflight") and last is not None and \
                        now - last > self.stall_threshold_s:
                    ss["stalled"] = True
                    stalled.append(i)
                else:
                    ss["stalled"] = False
        return stalled

    def _loop(self) -> None:
        try:
            self._loop_inner()
        except BaseException as exc:           # noqa: BLE001
            # an error in the dispatch machinery itself (not a launch —
            # those walk the ladder in _degrade) is fatal for the stream:
            # a silent thread death would leave every future hanging
            # until its caller's timeout with no root cause.
            self._fatal(exc)

    def _loop_inner(self) -> None:
        if self.streams > 1:
            return self._loop_multi()
        while True:
            with self._cond:
                if not self._running:
                    if not self._draining:
                        return
                    pick = next(((m, b) for m, b in self.registry.items()
                                 if b.pending_rows
                                 and m not in self._quarantined), None)
                    if pick is None:
                        return
                else:
                    now = self.clock()
                    pick = self._pick(now)
                    if pick is None:
                        deadline = self.registry.next_deadline()
                        self._cond.wait(
                            None if deadline is None
                            else max(deadline - now, 0.0))
                        continue
            model_id, batcher = pick
            with self._cond:
                ss = self.stats["streams"][0]
                ss["last_launch_s"] = self.clock()   # watchdog heartbeat
                ss["inflight"] = True
            try:
                done, _bucket, _dt = batcher.run_one()
            except Exception as exc:           # noqa: BLE001
                self._degrade(model_id, batcher, exc)
                continue
            finally:
                with self._cond:
                    ss["inflight"] = False
            finish = self.clock()
            with self._cond:
                self._fail_streak.pop(model_id, None)
                self.stats["launches"] += 1
                self._model_stats(model_id)["launches"] += 1
                for c in done:
                    fut = self._futures.pop((model_id, c.rid), None)
                    if fut is not None and not fut.cancelled():
                        fut.set_result(Served(
                            model_id, c.rid, c.y, c.arrival, finish,
                            finish - c.arrival, c.bucket, c.batched_rows))

    # ------------------------------------------- multi-stream dispatch

    def _active_streams(self) -> List[int]:
        return [i for i in range(self.streams)
                if i not in self._stream_quarantined]

    def _assign_stream(self) -> int:
        """Join-shortest-estimated-work: the active stream with the least
        estimated backlog (queued ticket costs + in-flight remainder).
        Caller holds the lock."""
        active = self._active_streams()
        return min(active, key=lambda i: (self._stream_load[i], i))

    def _quarantine_stream(self, idx: int, exc: BaseException) -> None:
        """Isolate one execution stream: its queued tickets reroute to
        healthy streams (nothing is lost — requests go back to their
        batcher queues and re-fire), its worker exits, and dispatch
        never assigns to it again.  Only reachable while another stream
        is active — the last stream walks the model ladder instead."""
        requeued = []
        with self._cond:
            if idx in self._stream_quarantined:
                return
            self._stream_quarantined.add(idx)
            self.stats["streams"][idx]["quarantined"] = True
            self.stats["streams"][idx]["error"] = repr(exc)
            self._stream_load[idx] = 0.0
            while self._tickets[idx]:
                requeued.append(self._tickets[idx].popleft())
            self._cond.notify_all()
        for _model_id, batcher, taken, _est in requeued:
            batcher.requeue(taken)

    def _degrade_stream(self, idx: int, model_id: str,
                        batcher: MicroBatcher, exc: Exception) -> None:
        """The multi-stream failure ladder: the model's retry rung first
        (the requeued requests re-dispatch — often to a different
        stream, which is what separates a poisoned device from a
        poisoned model), then stream quarantine while other streams are
        healthy, then the model's own fallback/quarantine rungs."""
        policy = self.retry_policy
        with self._cond:
            self._stream_streak[idx] += 1
            self.stats["streams"][idx]["launch_failures"] += 1
            stream_streak = self._stream_streak[idx]
            others_active = len(self._active_streams()) > 1
        if policy is not None and policy.quarantine and \
                not isinstance(exc, IntegrityError) and \
                stream_streak > policy.max_retries and others_active:
            # (corrupted weights follow the *model* across streams —
            # an IntegrityError never indicts the stream that ran it,
            # it goes straight to the model's recovery rung)
            self._quarantine_stream(idx, exc)
            with self._cond:
                # fresh ladder for the model on the surviving streams:
                # its failures so far are attributed to the bad stream.
                self._fail_streak.pop(model_id, None)
            return
        self._degrade(model_id, batcher, exc)

    def _worker_stream(self, idx: int, dev, plan):
        """Worker ``idx``'s own CUDA stream on the device it launches on
        (``dev``, else the plan's), made once; None off CUDA."""
        target = dev if dev is not None else \
            getattr(plan, "device", torch.device("cpu"))
        if target.type != "cuda":
            return None
        index = target.index if target.index is not None \
            else torch.cuda.current_device()
        key = (idx, index)
        stream = self._cuda_streams.get(key)
        if stream is None:
            stream = torch.cuda.Stream(device=index)
            self._cuda_streams[key] = stream
        return stream

    def _worker(self, idx: int) -> None:
        try:
            self._worker_inner(idx)
        except BaseException as exc:          # noqa: BLE001
            self._fatal(exc)

    def _worker_inner(self, idx: int) -> None:
        while True:
            with self._cond:
                while True:
                    if idx in self._stream_quarantined:
                        return
                    if self._tickets[idx] and not (
                            self._workers_stop and not self._draining):
                        model_id, batcher, taken, est = \
                            self._tickets[idx].popleft()
                        self._stream_inflight += 1
                        break
                    if self._workers_stop:
                        return
                    self._cond.wait()
            t0 = time.perf_counter()
            with self._cond:
                ss = self.stats["streams"][idx]
                ss["last_launch_s"] = self.clock()   # watchdog heartbeat
                ss["inflight"] = True
            try:
                dev = self._devices[idx]
                done, _bucket, _dt = batcher.execute(
                    taken, device=dev,
                    stream=self._worker_stream(idx, dev, batcher.plan))
            except Exception as exc:          # noqa: BLE001
                with self._cond:
                    ss["inflight"] = False
                    self._stream_load[idx] = max(
                        0.0, self._stream_load[idx] - est)
                    self._stream_inflight -= 1
                    self._cond.notify_all()
                self._degrade_stream(idx, model_id, batcher, exc)
                continue
            finish = self.clock()
            dt = time.perf_counter() - t0
            with self._cond:
                ss["inflight"] = False
                self._stream_load[idx] = max(
                    0.0, self._stream_load[idx] - est)
                self._stream_inflight -= 1
                self._stream_streak[idx] = 0
                self._fail_streak.pop(model_id, None)
                self.stats["launches"] += 1
                self._model_stats(model_id)["launches"] += 1
                ss = self.stats["streams"][idx]
                ss["launches"] += 1
                ss["busy_s"] += dt
                for c in done:
                    fut = self._futures.pop((model_id, c.rid), None)
                    if fut is not None and not fut.cancelled():
                        fut.set_result(Served(
                            model_id, c.rid, c.y, c.arrival, finish,
                            finish - c.arrival, c.bucket, c.batched_rows,
                            stream=idx))
                self._cond.notify_all()

    def _loop_multi(self) -> None:
        with self._cond:
            self._workers_stop = False
        workers = [threading.Thread(target=self._worker, args=(i,),
                                    name=f"serving-stream-{i}",
                                    daemon=True)
                   for i in range(self.streams)]
        for w in workers:
            w.start()
        try:
            while True:
                with self._cond:
                    if not self._running:
                        if not self._draining:
                            break
                        pick = next(
                            ((m, b) for m, b in self.registry.items()
                             if b.pending_rows
                             and m not in self._quarantined), None)
                        if pick is None:
                            if self._stream_inflight or any(
                                    self._tickets[i]
                                    for i in self._active_streams()):
                                # a failing launch may requeue during the
                                # drain — re-check for pending rows after
                                # every completion instead of blocking on
                                # an empty-queue forever wait.
                                self._cond.wait(0.05)
                                continue
                            break
                    else:
                        now = self.clock()
                        pick = self._pick(now)
                        if pick is None:
                            deadline = self.registry.next_deadline()
                            self._cond.wait(
                                None if deadline is None
                                else max(deadline - now, 0.0))
                            continue
                model_id, batcher = pick
                taken = batcher.take()
                if taken is None:
                    continue
                try:
                    # costing the bucket resolves a cache-backed plan here,
                    # on the dispatch thread: a model whose decode fails
                    # (a corrupt cold tier) walks its own ladder instead of
                    # killing the dispatch thread for every model
                    est = batcher.admission.launch_estimate(taken.rows)
                except Exception as exc:          # noqa: BLE001
                    batcher.requeue(taken)
                    if model_id in self.registry:  # else: unregistered,
                        self._degrade(model_id, batcher, exc)  # futures done
                    continue
                if est is None:
                    est = 1e-3      # unmeasured: any small constant ranks
                with self._cond:
                    idx = self._assign_stream()
                    self._tickets[idx].append(
                        (model_id, batcher, taken, est))
                    self._stream_load[idx] += est
                    self._cond.notify_all()
        finally:
            with self._cond:
                self._workers_stop = True
                self._cond.notify_all()
            for w in workers:
                w.join()
