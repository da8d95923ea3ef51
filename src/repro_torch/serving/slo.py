"""SLO tiers, typed rejection, and cost-model admission control.

A serving frontend without tiers treats every model the same:
one global ``max_delay``, unbounded queues, accept-everything intake.
That is the opposite of the always-on edge-multi-tenant deployment
FantastIC4 §V targets — a box serving many compact MLPs has *classes* of
traffic (interactive keyword spotting next to bulk scoring), and under
overload it must degrade **measurably, never silently**.  This module is
the policy half of that robustness layer:

* :class:`SLOTier` — a latency class: the batching budget (``max_delay``,
  how long a partial bucket may wait for coalescing), the end-to-end
  deadline budget (``deadline``, the SLO a request must complete within
  counted from arrival), and a bounded dispatch-priority ``weight`` the
  frontend's tier-weighted oldest-deadline pick uses (see
  ``frontend._pick``: a latency-tier deadline preempts throughput-tier
  full tiles, but only by ``weight`` seconds — a throughput request older
  than that still wins, so no tier can starve another).
* :class:`Rejected` — the typed outcome of admission control.  A shed or
  rejected request resolves its future **with this exception**, carrying
  the machine-readable reason — never a hang, never a silent drop.
* :class:`AdmissionController` — the cost model.  The FPGA latency-model
  idiom (SNIPPETS.md §2) applied to serving: predict whether an offered
  request fits *before* accepting it, from the plan's measured per-bucket
  service times (a seeded table from the autotune/benchmark sweep, kept
  current by a running EWMA of live launches).  A request whose predicted
  completion provably exceeds its tier's deadline is shed at submit time,
  while the queue slot it would have wasted serves traffic that can still
  make its SLO.

The mechanics (bounded queues, requeue-on-failure, retry/fallback/
quarantine) live in ``batcher``/``frontend``; everything here is pure
policy and host-side arithmetic — no tensors, no clocks.  A copy of the
JAX package's ``serving/slo.py``, so the port imports nothing of it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

#: reasons a request can be rejected with (machine-readable contract)
REJECT_QUEUE_FULL = "queue_full"        # bounded queue at capacity
REJECT_DEADLINE = "deadline"            # cost model: SLO provably missed
REJECT_QUARANTINED = "quarantined"      # model isolated after faults
REJECT_UNREGISTERED = "unregistered"    # model removed while request queued
REJECT_CORRUPTED = "corrupted"          # weights failed integrity checks
                                        # and cold-tier recovery


class Rejected(RuntimeError):
    """A request the serving stack refused to take (or had to drop).

    Admission control *resolves the future* with this exception — the
    caller always learns promptly, with a typed reason, instead of
    hanging until a timeout.  ``reason`` is one of ``REJECT_QUEUE_FULL``
    / ``REJECT_DEADLINE`` / ``REJECT_QUARANTINED`` /
    ``REJECT_UNREGISTERED``; ``est_wait`` carries the cost model's
    predicted wait for deadline sheds."""

    def __init__(self, reason: str, detail: str = "", *,
                 model_id: Optional[str] = None,
                 est_wait: Optional[float] = None):
        self.reason = reason
        self.model_id = model_id
        self.est_wait = est_wait
        msg = f"request rejected ({reason})"
        if model_id:
            msg += f" for model {model_id!r}"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


@dataclasses.dataclass(frozen=True)
class SLOTier:
    """One latency class.  All budgets in seconds.

    ``max_delay``  — coalescing budget: how long the oldest queued request
                     may wait before a partial bucket flushes.
    ``deadline``   — end-to-end SLO counted from arrival; the admission
                     controller sheds a request whose predicted completion
                     exceeds it, and benchmarks report the fraction served
                     within it.
    ``weight``     — dispatch-priority credit: the frontend compares fired
                     batchers by ``head_deadline - weight``, so this tier
                     preempts others' full tiles by up to ``weight``
                     seconds of queue age — bounded, hence starvation-free.
    """
    name: str
    max_delay: float
    deadline: float
    weight: float = 0.0

    def scaled(self, unit: float) -> "SLOTier":
        """This tier with every budget multiplied by ``unit`` — the
        trace benchmarks derive host-independent tiers from the measured
        top-bucket service time instead of wall-clock constants."""
        return dataclasses.replace(
            self, max_delay=self.max_delay * unit,
            deadline=self.deadline * unit, weight=self.weight * unit)


#: the built-in latency classes.  ``standard`` reproduces the pre-tier
#: default (max_delay 2 ms, no priority credit) so registration without a
#: tier behaves exactly as before; ``latency`` trades batching efficiency
#: for response time and carries a 20 ms preemption credit; ``throughput``
#: batches aggressively and yields priority.
TIERS: Dict[str, SLOTier] = {
    "latency": SLOTier("latency", max_delay=5e-4, deadline=2.5e-2,
                       weight=2e-2),
    "standard": SLOTier("standard", max_delay=2e-3, deadline=1e-1),
    "throughput": SLOTier("throughput", max_delay=8e-3, deadline=4e-1),
}


def resolve_tier(tier) -> SLOTier:
    """``None`` → standard, a name → the built-in, an SLOTier → itself
    (build custom tiers with ``dataclasses.replace`` / ``SLOTier(...)``)."""
    if tier is None:
        return TIERS["standard"]
    if isinstance(tier, SLOTier):
        return tier
    try:
        return TIERS[tier]
    except KeyError:
        raise ValueError(f"unknown SLO tier {tier!r}; have "
                         f"{sorted(TIERS)} (or pass an SLOTier)") from None


class AdmissionController:
    """Per-batcher service cost model: measured per-bucket launch times.

    ``seed`` it with a measured table (the benchmark/autotune sweep's
    per-bucket service times) and/or let :meth:`observe` maintain a
    running EWMA from live launches.  :meth:`wait_estimate` predicts how
    long a newly arriving request would wait until *its* bucket's launch
    completes, assuming the queue ahead of it drains in full-tile
    launches — the work-conserving lower bound, so a rejection is
    conservative: if even the lower bound busts the deadline, the SLO is
    provably unattainable.  With no measurement yet for a needed bucket
    the controller abstains (returns ``None`` → admit): it only sheds
    what it can *prove* it cannot serve.
    """

    def __init__(self, bucket_for: Callable[[int], Optional[int]],
                 max_bucket: int, *,
                 service_times: Optional[Dict[int, float]] = None,
                 alpha: float = 0.25):
        self._bucket_for = bucket_for
        self._max_bucket = max_bucket
        self._alpha = alpha
        self._svc: Dict[int, float] = dict(service_times or {})

    def seed(self, service_times: Dict[int, float]) -> None:
        self._svc.update(
            {int(b): float(t) for b, t in service_times.items()})

    def observe(self, bucket: int, dt: float) -> None:
        """Fold one live launch measurement into the EWMA."""
        old = self._svc.get(bucket)
        self._svc[bucket] = dt if old is None else \
            (1.0 - self._alpha) * old + self._alpha * dt

    def estimate(self, bucket: int) -> Optional[float]:
        return self._svc.get(bucket)

    def launch_estimate(self, rows: int) -> Optional[float]:
        """Predicted service seconds for one launch of ``rows`` rows —
        the multi-stream frontend's join-shortest-estimated-work input.
        Unlike :meth:`admit` this never gates anything, so it may be
        loose: with no measurement for the exact bucket it scales the
        nearest measured bucket linearly by row count (the launch cost
        of these kernels is close to linear in the row tile), and only
        abstains (``None``) when nothing was ever measured."""
        bucket = self._bucket_for(rows) or rows
        est = self._svc.get(bucket)
        if est is not None:
            return est
        if not self._svc:
            return None
        nearest = min(self._svc, key=lambda b: abs(b - bucket))
        return self._svc[nearest] * (bucket / max(nearest, 1))

    def service_times(self) -> Dict[int, float]:
        return dict(self._svc)

    def wait_estimate(self, queued_rows: int,
                      new_rows: int) -> Optional[float]:
        """Predicted seconds until a ``new_rows``-row request admitted
        behind ``queued_rows`` queued rows completes (lower bound)."""
        total = queued_rows + new_rows
        full, rem = divmod(total, self._max_bucket)
        t = 0.0
        if full:
            top = self._bucket_for(self._max_bucket) or self._max_bucket
            svc = self._svc.get(top)
            if svc is None:
                return None
            t += full * svc
        if rem:
            b = self._bucket_for(rem)
            svc = self._svc.get(b) if b is not None else None
            if svc is None:
                return None
            t += svc
        return t

    def admit(self, queued_rows: int, new_rows: int,
              tier: SLOTier) -> None:
        """Raise :class:`Rejected` when the cost model proves the request
        cannot complete within ``tier.deadline``; otherwise return."""
        est = self.wait_estimate(queued_rows, new_rows)
        if est is not None and est > tier.deadline:
            raise Rejected(
                REJECT_DEADLINE,
                f"predicted wait {est * 1e3:.2f} ms exceeds tier "
                f"{tier.name!r} deadline {tier.deadline * 1e3:.2f} ms "
                f"({queued_rows} rows queued)",
                est_wait=est)
