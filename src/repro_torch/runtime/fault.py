"""Fault tolerance for the training loop, and fault injection for the
serving frontend's degradation ladder.

The port of the JAX package's ``runtime/fault.py``:

* **checkpoint/restart** — :class:`FaultTolerantLoop` checkpoints every
  ``ckpt_every`` steps through the atomic ``CheckpointManager``; on
  (re)start it resumes from the latest step found.  Data is step-seeded
  (``data/synthetic.py``), so skip-ahead is exact with zero replay.
* **preemption** — :class:`PreemptionGuard`: SIGTERM/SIGINT set a flag;
  the loop checkpoints at the next step boundary and exits cleanly.
* **transient-failure retry** — a step that raises one of
  :data:`TRANSIENT_ERRORS` is retried up to ``max_retries`` times from the
  last good state before the job surrenders.
* **bounded-stale metrics** — a step's metrics are copied to pinned host
  memory without blocking and read ``metrics_every`` steps later, so the
  host never waits for the step it has just queued.

:class:`InjectedFault` and :class:`FaultInjector` wrap any
``serving.ServableProgram`` (an ``ExecutionPlan``, a ``CachedPlan``
handle) so launches raise synthetic errors probabilistically or on
schedule, and land seeded bit flips in the live operands or the cold
tier — what the retry / chain-fallback / quarantine ladder and the
integrity layer (``runtime.integrity`` + the frontend's recovery rung)
exist to handle.
"""
from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from .integrity import entry_layers, unwrap_chain

log = logging.getLogger(__name__)


class PreemptionGuard:
    """Converts SIGTERM/SIGINT into a checkpoint-at-next-boundary flag."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:      # not the main thread
                pass

    def _handler(self, signum, frame):
        log.warning("preemption signal %s received", signum)
        self.requested = True

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


class InjectedFault(RuntimeError):
    """Synthetic launch failure: stands in for the errors a real device
    raises (a refused launch, exhausted memory) without needing the device
    to misbehave.  The serving retry policy treats any ``Exception`` from
    a launch as retryable, so the distinction does not matter to the
    ladder."""


class FaultInjector:
    """Wrap a ``ServableProgram`` so launches fail on demand.

    Proxies every attribute to the wrapped program (a batcher or frontend
    cannot tell the difference) but intercepts the two launch surfaces —
    ``entry(bucket)`` and ``run(x)`` — and raises :class:`InjectedFault`
    *before* the kernel runs when the configured trigger fires:

    * ``rate`` — probabilistic: each launch fails with this probability
      (seeded ``numpy`` generator, so a given seed is a reproducible
      fault schedule).
    * ``fail_nth`` — on schedule: launch indices (0-based, counted across
      all buckets) that fail deterministically.
    * ``fail_buckets`` — systematic per entry: these bucket sizes always
      fail — the "poisoned (bucket, schedule)" case.
    * ``only_fused`` — restrict injection to launches whose bucket is
      currently bound to a fused path: after the frontend demotes the
      poisoned bucket to the per-layer chain, injection stops.

    Beyond raising, the injector models **silent data corruption**:
    seeded bit flips landed in the live bytes:

    * ``flip_rate`` / ``flip_nth`` — when a launch flips (probabilistic
      per launch, or deterministic launch indices);
    * ``flip_targets`` — where the flip lands, drawn uniformly per
      event: ``"packed"`` (one bit of a resolved plan's packed code
      tensor), ``"epilogue"`` (one bit of omega/alpha1/bias fp32),
      ``"staged"`` (one bit of the codes of a sealed copy the kernels
      read in place of the pack, ``kernels.staged``: the chain's or a
      layer table's slice-major codes, the stacked codes), or ``"cold"`` (one bit of a
      cold-tier ``CompressedTensor`` payload, reached through a wrapped
      :class:`~repro_torch.serving.pack_cache.CachedPlan`).

    A ``"packed"`` or ``"epilogue"`` flip copies the tensor to the host,
    flips one bit there, puts the flipped copy back on the device in the
    layer dict the plan reads, and drops the kernel operand memos of that
    layer list (``ops.forget_pack_operands``), so the corrupted bytes
    reach the next launch and not a memoized clean copy.  A ``"staged"``
    flip lands in place in device memory, in a copy memoized for that
    layer list, and forgets nothing: the flip the kernels' own operands
    would take (the JAX package has no such copies and no such target).
    Before any copy is built it lands in place in the packed codes the
    copies will be built from.  A hot flip lands in the layers of the
    entry being launched (``integrity.entry_layers``).
    :meth:`last_launch` gives a thread the index of its last launch.

    The failure schedule draws from ``seed`` and the flip schedule from a
    child of ``seed``, so enabling flips never perturbs the failure
    sequence.  ``launches`` counts every launch attempt, ``injected`` the
    fired faults; ``failures`` / ``flips`` log the schedule (launch
    index, and for flips the target / layer / field / byte / bit).  A
    lock serializes the draws and flips: stream workers launch the same
    program from several threads.
    """

    FLIP_TARGETS = ("packed", "epilogue", "staged", "cold")

    def __init__(self, plan, *, rate: float = 0.0, seed: int = 0,
                 fail_nth: tuple = (), fail_buckets: tuple = (),
                 only_fused: bool = False, flip_rate: float = 0.0,
                 flip_nth: tuple = (), flip_targets: tuple = ("packed",)):
        self._plan = plan
        self.rate = rate
        self.fail_nth = frozenset(fail_nth)
        self.fail_buckets = frozenset(fail_buckets)
        self.only_fused = only_fused
        self.flip_rate = flip_rate
        self.flip_nth = frozenset(flip_nth)
        for t in flip_targets:
            if t not in self.FLIP_TARGETS:
                raise ValueError(f"unknown flip target {t!r}; choose "
                                 f"from {self.FLIP_TARGETS}")
        self.flip_targets = tuple(flip_targets)
        self._rng = np.random.default_rng(seed)
        self._flip_rng = np.random.default_rng(
            np.random.SeedSequence((int(seed), 0x4B17F11B)))
        self._lock = threading.Lock()
        self._thread = threading.local()
        self.launches = 0
        self.injected = 0
        self.failures: list = []    # launch indices that raised
        self.flips: list = []       # (launch, target, layer, field, byte, bit)

    @property
    def flipped(self) -> int:
        return len(self.flips)

    def last_launch(self):
        """Index of the last launch made on the calling thread (None
        before its first)."""
        return getattr(self._thread, "launch", None)

    @property
    def plan(self):
        """The wrapped plan (unwrap for parity baselines)."""
        return self._plan

    def __getattr__(self, name):
        return getattr(self._plan, name)

    def _maybe_fail(self, bucket: int, layers=None) -> None:
        if self.only_fused:
            bp = getattr(self._plan, "buckets", {}).get(bucket)
            if bp is None or not bp.path.startswith("fused"):
                return
        with self._lock:
            idx = self.launches
            self.launches += 1
            self._thread.launch = idx
            self._maybe_flip(idx, layers)
            fire = (bucket in self.fail_buckets or idx in self.fail_nth
                    or (self.rate > 0 and self._rng.random() < self.rate))
            if fire:
                self.injected += 1
                self.failures.append(idx)
        if fire:
            raise InjectedFault(
                f"injected launch failure (launch {idx}, bucket {bucket})")

    # ------------------------------------------------- silent corruption

    def _maybe_flip(self, idx: int, layers=None) -> None:
        fire = idx in self.flip_nth
        if self.flip_rate > 0 and \
                self._flip_rng.random() < self.flip_rate:
            fire = True
        if not fire:
            return
        target = self.flip_targets[
            int(self._flip_rng.integers(len(self.flip_targets)))]
        if target == "cold":
            self._flip_cold(idx)
        elif target == "staged":
            self._flip_staged(
                idx, self._plan.layers if layers is None else layers)
        else:
            self._flip_hot(idx, target,
                           self._plan.layers if layers is None else layers)

    def _flip_hot(self, idx: int, target: str, layers) -> None:
        """Flip one bit of a resolved plan's live operands: the packed
        bit-plane bytes or an epilogue fp32."""
        from ..kernels import ops as kops

        li = int(self._flip_rng.integers(len(layers)))
        layer = layers[li]
        if target == "packed":
            field = "packed"
        else:
            field = ("omega", "alpha1", "bias")[
                int(self._flip_rng.integers(3))]
        live = layer[field]
        host = live.detach().cpu().numpy().copy() \
            if isinstance(live, torch.Tensor) else np.array(live)
        flat = host.reshape(-1).view(np.uint8)
        byte = int(self._flip_rng.integers(flat.size))
        bit = int(self._flip_rng.integers(8))
        flat[byte] ^= np.uint8(1 << bit)
        layer[field] = torch.from_numpy(host).to(live.device) \
            if isinstance(live, torch.Tensor) else host
        # the kernel-level operand memos are keyed by layer-list identity
        # under a no-mutation assumption this flip just violated — drop
        # them so the corrupted bytes reach the next launch
        kops.forget_pack_operands(layers)
        self.flips.append((idx, target, li, field, byte, bit))

    def _flip_staged(self, idx: int, layers) -> None:
        """Flip one bit, in place on its device, of the codes of a sealed
        copy the kernels read (or of a layer's packed codes before any
        copy is built): nothing is rebuilt or forgotten.  Only codes: a
        flipped pointer or size in a layer table would make the kernel
        read outside its operands, not compute a wrong result."""
        from ..kernels import ops as kops

        copies = [(s.what, s.codes) for s in kops.staged_operands(layers)
                  if s.codes is not None] or \
            [(f"layer {li} packed", l["packed"])
             for li, l in enumerate(layers)]
        # one draw whatever the number of copies: the schedule of later
        # flips does not depend on which copies exist
        what, t = copies[int(self._flip_rng.random() * len(copies))]
        flat = t.reshape(-1).view(torch.uint8)
        byte = int(self._flip_rng.integers(flat.numel()))
        bit = int(self._flip_rng.integers(8))
        flat[byte] ^= 1 << bit
        self.flips.append((idx, "staged", None, what, byte, bit))

    def _flip_cold(self, idx: int) -> None:
        """Flip one bit of the cold-tier compressed payload backing a
        wrapped CachedPlan (in place: the cache's ColdPack references
        the same arrays)."""
        from ..serving.pack_cache import CachedPlan
        cached = next((p for p in unwrap_chain(self._plan)
                       if isinstance(p, CachedPlan)), None)
        if cached is None:
            raise ValueError(
                'flip target "cold" needs a cache-backed plan '
                "(CachedPlan) somewhere in the wrapped chain")
        cold = cached.cache.cold(cached.model_id)
        li = int(self._flip_rng.integers(len(cold.layers)))
        ct = cold.layers[li].codes
        items = [(key, arr) for key, arr in ct.canonical_items()
                 if arr.nbytes > 0]
        key, arr = items[int(self._flip_rng.integers(len(items)))]
        flat = ct.payload[key].view(np.uint8).reshape(-1)
        byte = int(self._flip_rng.integers(flat.size))
        bit = int(self._flip_rng.integers(8))
        flat[byte] ^= np.uint8(1 << bit)
        self.flips.append((idx, "cold", li, key, byte, bit))

    def entry(self, bucket: int):
        inner = self._plan.entry(bucket)
        layers = entry_layers(inner)

        def faulty_entry(xb):
            self._maybe_fail(bucket, layers)
            return inner(xb)

        faulty_entry.layers = layers
        return faulty_entry

    def run(self, x):
        self._maybe_fail(int(x.shape[0]))
        return self._plan.run(x)


#: the errors a step is retried on: the port's counterpart of the
#: reference's ``jax.errors.JaxRuntimeError``.  Exhausted device memory
#: and an injected fault leave the device usable; a sticky CUDA error (an
#: illegal address, a launch failure) does not, so it is not retried.
TRANSIENT_ERRORS = (torch.OutOfMemoryError, InjectedFault)


class _Pending:
    """One step's metrics on their way to the host: each CUDA tensor is
    copied without blocking into pinned memory and an event recorded
    after the copies; :meth:`fetch` waits for that event only."""

    def __init__(self, step: int, metrics: dict):
        self.step = step
        self.event = None
        self.values = {}
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                host.copy_(v.detach(), non_blocking=True)
                self.event = self.event or torch.cuda.Event()
                self.values[k] = host
            elif isinstance(v, torch.Tensor):
                self.values[k] = v.detach().clone()
            else:
                self.values[k] = v
        if self.event is not None:
            self.event.record()

    def fetch(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in self.values.items()}


class FaultTolerantLoop:
    """Run ``step_fn(state, batch) -> (state, metrics)`` with checkpoints,
    preemption, retries and bounded-stale metrics.

    A step that raises one of :data:`TRANSIENT_ERRORS` is retried from
    the last good state; after ``max_retries`` the state is checkpointed
    and the run ends as ``"failed"``.  Any other error propagates
    unchanged — a sticky CUDA error (illegal address, launch failure)
    leaves the CUDA context unusable, so it is neither retried nor
    swallowed.  ``on_metrics(step, metrics)`` gets every
    ``metrics_every``-th step's metrics as numpy values, read
    ``metrics_every`` steps after that step was queued.  ``saves`` logs
    (step, seconds) of every checkpoint written; a step already
    checkpointed by this loop is not written again at the end of a run.
    """

    def __init__(self, step_fn: Callable, manager, *,
                 ckpt_every: int = 100, metrics_every: int = 10,
                 max_retries: int = 3,
                 on_metrics: Optional[Callable] = None):
        self.step_fn = step_fn
        self.manager = manager
        self.ckpt_every = ckpt_every
        self.metrics_every = metrics_every
        self.max_retries = max_retries
        self.on_metrics = on_metrics or (lambda step, m: None)
        self.saves: list = []

    def resume_or(self, init_state: Any) -> tuple:
        """(state, start_step): the latest checkpoint restored into
        ``init_state``'s structure and devices if one exists, else
        ``init_state`` and 0."""
        step = self.manager.latest_step()
        if step is None:
            return init_state, 0
        state, meta = self.manager.restore(init_state, step)
        log.info("resumed from step %d", meta["step"])
        return state, meta["step"]

    def _save(self, step: int, state: Any) -> None:
        if self.saves and self.saves[-1][0] == step:
            return
        t0 = time.perf_counter()
        self.manager.save(step, state)
        self.saves.append((step, time.perf_counter() - t0))

    def run(self, state: Any, batches: Iterator, *, start_step: int = 0,
            total_steps: int = 1000) -> tuple:
        """Returns (state, last_step, reason) with reason in
        {"done", "preempted", "failed"}."""
        guard = PreemptionGuard()
        pending: Optional[_Pending] = None
        step = start_step
        try:
            while step < total_steps:
                if guard.requested:
                    self._save(step, state)
                    return state, step, "preempted"
                batch = next(batches)
                retries = 0
                while True:
                    try:
                        new_state, metrics = self.step_fn(state, batch)
                        break
                    except TRANSIENT_ERRORS as e:
                        retries += 1
                        log.warning("step %d failed (%s), retry %d/%d",
                                    step, e, retries, self.max_retries)
                        if retries > self.max_retries:
                            self._save(step, state)
                            return state, step, "failed"
                        time.sleep(0.1 * retries)
                state = new_state
                step += 1
                # bounded-stale metrics: read those of N steps ago
                if step % self.metrics_every == 0:
                    if pending is not None:
                        self.on_metrics(pending.step, pending.fetch())
                    pending = _Pending(step, metrics)
                if step % self.ckpt_every == 0:
                    self._save(step, state)
            if pending is not None:
                self.on_metrics(pending.step, pending.fetch())
            self._save(step, state)
            return state, step, "done"
        finally:
            guard.restore()
