"""The port's ServingFrontend, fault injector and replay driver against the
contracts of the JAX package's ``test_serving_frontend.py``,
``test_serving_fault.py`` and ``test_integrity.py`` (frontend recovery),
run on the port's CPU plans:

* per-model results equal the same request served alone (the oracle plan
  on the CPU: ``atol=rtol=1e-5``, the JAX tests' tolerance; bitwise where
  the JAX tests are bitwise: retries, recovery, eviction);
* typed rejections; ``unregister`` fails futures with a typed cause;
  ``close`` drains; quarantine keeps the typed rejection;
* flips are detected and recovered bitwise; cold corruption quarantines
  with reason ``corrupted``;
* ``asubmit`` hands the root cause to the caller in 20 of 20 runs (the
  port's deliberate difference: the JAX frontend does not when the
  dispatch thread dies before the submit);
* ``replay`` gives the same completions (request id, bucket, batched
  rows, finish time) as the JAX ``replay`` on the same arrivals and
  service-time table; the injector's flip schedule equals the JAX
  injector's on equal shapes.

Deadlines fire from a fake clock where the JAX tests use one; no test
sleeps on a real clock to wait for a race.
"""
import asyncio
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import fault as jfault
from repro.serving import batcher as jbatcher
from repro.serving import plans as jplans
from repro_torch import serving
from repro_torch.memo import MISS, IdentityMemo
from repro_torch.runtime.fault import FaultInjector, InjectedFault
from repro_torch.runtime.integrity import (GuardedPlan, IntegrityError,
                                           stamp_pack_crcs, unwrap_chain)
from test_torch_integrity import _jax_layers
from test_torch_mlp_serving import _rand_pack

DIMS_A = (16, 12, 4)
DIMS_B = (16, 8, 6)
TOL = dict(atol=1e-5, rtol=1e-5)


def _plan(dims=DIMS_A, seed=0, mode="oracle", **kw):
    return serving.build_plan(_rand_pack(dims, seed=seed), mode=mode,
                              device="cpu", **kw)


def _rows(n, seed=0, d=DIMS_A[0]):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, d)).astype(np.float32) for _ in range(n)]


def _alone(plan, x):
    return plan.run(torch.from_numpy(x)).numpy()


class _FakeClock:
    """Deterministically auto-advancing clock: every read moves time
    forward, so deadlines fire from clock reads instead of wall sleeps."""

    def __init__(self, step=1e-3):
        self._t = 0.0
        self._step = step
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            self._t += self._step
            return self._t


class BoomPlan:
    """Plan proxy whose every launch raises — systematic model failure."""

    def __init__(self, plan):
        self._plan = plan

    def __getattr__(self, name):
        return getattr(self._plan, name)

    def entry(self, bucket):
        def boom(xb):
            raise ValueError("kernel exploded")
        return boom

    def run(self, x):
        raise ValueError("kernel exploded")


# ------------------------------------------------------------ frontend

@pytest.mark.parametrize("streams", [1, 2])
def test_frontend_serves_each_model_like_its_plan_alone(streams):
    plan_a, plan_b = _plan(DIMS_A), _plan(DIMS_B, seed=3, mode="auto")
    fe = serving.ServingFrontend(clock=_FakeClock(), streams=streams)
    fe.register("a", plan_a)
    fe.register("b", plan_b, tier="throughput")
    rng = np.random.default_rng(0)
    reqs = [("a" if i % 3 else "b",
             rng.normal(size=(1 + i % 4, 16)).astype(np.float32))
            for i in range(40)]
    with fe:
        futs = [(mid, x, fe.submit(mid, x)) for mid, x in reqs]
        served = [(mid, x, f.result(30.0)) for mid, x, f in futs]
    for mid, x, s in served:
        plan = plan_a if mid == "a" else plan_b
        np.testing.assert_allclose(s.y, _alone(plan, x), **TOL)
        assert s.model_id == mid and s.latency >= 0
        assert 0 <= s.stream < streams
    assert fe.stats["by_model"]["a"]["requests"] == 26
    assert fe.stats["by_model"]["b"]["requests"] == 14
    assert fe.stats["launches"] == sum(
        ss["launches"] for ss in fe.stats["streams"]) or streams == 1


def test_pick_is_oldest_fired_deadline_across_models():
    """Fairness: a due trickle request outranks another model's full tile
    that arrived later (deadline-FIFO across models)."""
    t = [0.0]
    fe = serving.ServingFrontend(clock=lambda: t[0])
    busy = fe.register("busy", _plan(), max_delay=1.0, max_bucket=4)
    quiet = fe.register("quiet", _plan(DIMS_B, seed=3), max_delay=1e-3)
    quiet.submit(np.zeros((1, 16), np.float32), now=0.0)
    t[0] = 0.5
    for _ in range(4):
        busy.submit(np.zeros((1, 16), np.float32), now=0.5)
    assert fe._pick(0.5)[0] == "quiet"            # its deadline is oldest
    quiet.drop_all()
    assert fe._pick(0.5)[0] == "busy"             # full tile fires
    busy.drop_all()
    busy.submit(np.zeros((1, 16), np.float32), now=0.5)
    assert fe._pick(0.6) is None                  # nothing due, not full


def test_asyncio_face_serves_concurrent_awaits():
    plan = _plan()
    fe = serving.ServingFrontend(clock=_FakeClock())
    fe.register("m", plan)
    xs = _rows(6, seed=5)

    async def go():
        with fe:
            return await asyncio.gather(*[fe.asubmit("m", x) for x in xs])

    for x, s in zip(xs, asyncio.run(go())):
        np.testing.assert_allclose(s.y, _alone(plan, x), **TOL)


def test_asubmit_hands_the_root_cause_over_every_time():
    """20 of 20: whether the dispatch thread dies before or after the
    submit, the awaiting caller gets the scheduler's own exception."""
    def boom_pick(now):
        raise RuntimeError("scheduler bug")

    outcomes = []
    for i in range(20):
        fe = serving.ServingFrontend(clock=_FakeClock())
        fe.register("m", _plan(), max_delay=0.05)

        async def go():
            with fe:
                fe._pick = boom_pick
                if i % 2:        # let the thread die before the submit
                    with fe._cond:
                        fe._cond.notify_all()
                    fe._thread.join(10.0)
                    assert fe._error is not None
                return await fe.asubmit("m", np.zeros((1, 16), np.float32))

        with pytest.raises(RuntimeError) as e:
            asyncio.run(go())
        outcomes.append(str(e.value))
        assert isinstance(fe._error, RuntimeError)
    assert outcomes == ["scheduler bug"] * 20
    # the synchronous face keeps the JAX contract
    with pytest.raises(RuntimeError, match="dispatch thread died"):
        fe.submit("m", np.zeros((1, 16), np.float32))


def test_registry_and_lifecycle_errors():
    plan = _plan()
    fe = serving.ServingFrontend()
    fe.register("m", plan)
    with pytest.raises(ValueError):
        fe.register("m", plan)
    with pytest.raises(KeyError):
        fe.submit("nope", np.zeros((1, 16), np.float32))
    with pytest.raises(RuntimeError):
        fe.submit("m", np.zeros((1, 16), np.float32))   # not started
    assert "m" in fe.registry and len(fe.registry) == 1
    with pytest.raises(ValueError):
        serving.ServingFrontend(streams=0)
    with pytest.raises(ValueError):
        serving.ServingFrontend(streams=2, devices=["cpu"])


def test_systematic_failure_quarantines_one_model_only():
    fe = serving.ServingFrontend(clock=_FakeClock())
    fe.register("m", BoomPlan(_plan()))
    fe.register("ok", _plan(DIMS_B, seed=3))
    with fe:
        fut = fe.submit("m", np.zeros((1, 16), np.float32))
        with pytest.raises(ValueError, match="kernel exploded"):
            fut.result(30.0)
        with pytest.raises(serving.Rejected, match="quarantined"):
            fe.submit("m", np.zeros((1, 16), np.float32)).result(30.0)
        s = fe.submit("ok", np.zeros((1, 16), np.float32)).result(30.0)
        assert s.y.shape == (1, DIMS_B[-1])
        assert "m" not in fe.registry
        fe.register("m", _plan())          # a fresh model under the id
        assert fe.submit("m", np.zeros((1, 16), np.float32)).result(
            30.0).y.shape == (1, DIMS_A[-1])
    assert fe.stats["quarantined"] == ["m"]
    assert fe.stats["by_model"]["m"]["retries"] >= 1


def test_legacy_fatal_contract_without_retry_policy():
    fe = serving.ServingFrontend(retry_policy=None, clock=_FakeClock())
    fe.register("m", BoomPlan(_plan()))
    with fe:
        fut = fe.submit("m", np.zeros((1, 16), np.float32))
        with pytest.raises(ValueError, match="kernel exploded"):
            fut.result(30.0)
        with pytest.raises(RuntimeError, match="dispatch thread died"):
            fe.submit("m", np.zeros((1, 16), np.float32))


def test_close_drains_and_batchers_keep_no_results():
    fe = serving.ServingFrontend()
    batcher = fe.register("m", _plan(), max_delay=30.0)   # nothing due
    fe.start()
    futs = [fe.submit("m", np.zeros((1, 16), np.float32)) for _ in range(3)]
    fe.close(drain=True)
    for f in futs:
        assert f.result(0.0).y.shape == (1, DIMS_A[-1])
    assert not batcher._results


def test_unregister_fails_outstanding_futures_with_typed_cause():
    fe = serving.ServingFrontend()
    fe.register("m", _plan(), max_delay=30.0)
    fe.register("other", _plan(DIMS_B, seed=3))
    with fe:
        futs = [fe.submit("m", np.zeros((1, 16), np.float32))
                for _ in range(3)]
        fe.unregister("m")
        for f in futs:
            with pytest.raises(serving.Rejected, match="unregistered"):
                f.result(10.0)
        with pytest.raises(KeyError):
            fe.submit("m", np.zeros((1, 16), np.float32))
        with pytest.raises(KeyError):
            fe.unregister("m")
        assert fe.submit("other", np.zeros((1, 16), np.float32)).result(
            30.0).model_id == "other"


def test_queue_bound_rejects_typed():
    fe = serving.ServingFrontend()
    fe.register("m", _plan(), max_delay=30.0, max_queued_rows=2)
    with fe:
        ok = [fe.submit("m", np.zeros((1, 16), np.float32))
              for _ in range(2)]
        with pytest.raises(serving.Rejected) as e:
            fe.submit("m", np.zeros((1, 16), np.float32)).result(10.0)
        assert e.value.reason == "queue_full" and e.value.model_id == "m"
    for f in ok:
        f.result(10.0)
    assert fe.stats["rejected"] == 1


def test_cache_churn_race_never_drops_requests():
    n_models, n_reqs = 4, 48
    cache = serving.PackCache(max_hot=2, device="cpu")
    fe = serving.ServingFrontend(clock=_FakeClock(), cache=cache, streams=2)
    refs = {}
    for i in range(n_models):
        fe.register_pack(f"m{i}", _rand_pack(DIMS_A, seed=i),
                         plan_kwargs={"mode": "oracle"})
        x_i = np.full((1, 16), float(i + 1), np.float32)
        refs[f"m{i}"] = (x_i, _alone(_plan(seed=i), x_i))
    stop = threading.Event()
    errors = []

    def churner():
        try:
            while not stop.is_set():
                for i in range(n_models):
                    cache.evict(f"m{i}")
        except Exception as exc:                   # noqa: BLE001
            errors.append(exc)

    t = threading.Thread(target=churner)
    t.start()
    try:
        with fe:
            futs = [(f"m{r % n_models}", fe.submit(f"m{r % n_models}",
                                                   refs[f"m{r % n_models}"][0]))
                    for r in range(n_reqs)]
            for mid, f in futs:
                np.testing.assert_array_equal(f.result(60.0).y, refs[mid][1])
    finally:
        stop.set()
        t.join(30.0)
    assert not t.is_alive() and errors == []
    assert cache.stats["evictions"] > 0
    assert cache.stats["resolves"] > n_models


# ------------------------------------------------------- fault injection

def test_injector_proxies_and_triggers():
    plan = _plan()
    x = torch.zeros((1, 16))
    inj = FaultInjector(plan, rate=1.0)
    assert inj.d_in == plan.d_in and inj.plan is plan
    with pytest.raises(InjectedFault):
        inj.entry(1)(x)
    assert inj.injected == 1 and inj.launches == 1
    nth = FaultInjector(plan, fail_nth=(1,))
    e = nth.entry(1)
    e(x)
    with pytest.raises(InjectedFault):
        e(x)
    e(x)
    byb = FaultInjector(plan, fail_buckets=(2,))
    byb.entry(1)(x)
    with pytest.raises(InjectedFault):
        byb.entry(2)(torch.zeros((2, 16)))


def test_only_fused_spares_a_demoted_bucket():
    plan = _plan(mode="fused")
    inj = FaultInjector(plan, fail_buckets=(1,), only_fused=True)
    x = torch.zeros((1, 16))
    assert plan.buckets[1].path.startswith("fused")
    with pytest.raises(InjectedFault):
        inj.entry(1)(x)
    plan.demote_bucket(1)
    assert inj.entry(1)(x).shape == (1, DIMS_A[-1])
    assert plan.buckets[1].source.startswith("degraded")


def test_failed_launch_requeues_in_order_and_drop_all():
    plan = _plan()
    inj = FaultInjector(plan, rate=1.0)
    b = serving.MicroBatcher(inj, max_delay=30.0)
    rids = [b.submit(x) for x in _rows(3)]
    with pytest.raises(InjectedFault):
        b.run_one()
    assert b.pending_rows == 3 and b.stats["launch_failures"] == 1
    assert b.last_failed_bucket == plan.bucket_for(3)
    inj.rate = 0.0
    assert [c.rid for c in b.flush()] == rids
    for x in _rows(2):
        b.submit(x)
    assert len(b.drop_all()) == 2 and b.next_deadline() is None


def test_retry_parity_at_10pct_faults_is_bitwise():
    xs = _rows(24, seed=3)
    plan = _plan()

    def serve_all(wrapped):
        fe = serving.ServingFrontend(
            retry_policy=serving.RetryPolicy(max_retries=10),
            clock=_FakeClock())
        fe.register("m", wrapped, max_delay=1e-4)
        with fe:
            return [fe.submit("m", x).result(30.0).y for x in xs]

    baseline = serve_all(plan)
    inj = FaultInjector(plan, rate=0.10, seed=42)
    faulted = serve_all(inj)
    assert inj.injected > 0
    for a, b in zip(baseline, faulted):
        np.testing.assert_array_equal(a, b)


def test_poisoned_fused_bucket_falls_back_to_chain():
    plan = _plan(mode="fused")
    inj = FaultInjector(plan, fail_buckets=(1,), only_fused=True)
    fe = serving.ServingFrontend(
        retry_policy=serving.RetryPolicy(max_retries=1), clock=_FakeClock())
    fe.register("m", inj, max_delay=1e-3)
    x = _rows(1, seed=5)[0]
    with fe:
        s = fe.submit("m", x).result(60.0)
    assert plan.buckets[1].path == "per_layer"
    assert fe.stats["fallbacks"] == 1 and fe.stats["retries"] >= 1
    assert "m" not in fe.stats["quarantined"]
    np.testing.assert_allclose(s.y, _alone(_plan(), x), atol=1e-3,
                               rtol=1e-4)


def _drive(inj, n, x):
    for _ in range(n):
        try:
            inj.run(x)
        except (InjectedFault, jfault.InjectedFault, IntegrityError):
            pass


def test_flip_schedule_equals_the_jax_injector_and_is_seeded():
    """Same seed and same shapes: the port's failure and flip schedules
    (launch, target, layer, field, byte, bit) equal the JAX injector's."""
    pack = _rand_pack(DIMS_A, seed=3)
    kw = dict(rate=0.15, seed=7, flip_rate=0.3,
              flip_targets=("packed", "epilogue"))
    tinj = FaultInjector(serving.build_plan(pack, mode="oracle",
                                            device="cpu"), **kw)
    jinj = jfault.FaultInjector(
        jplans.build_plan(_jax_layers(_rand_pack(DIMS_A, seed=3)),
                          mode="oracle"), **kw)
    _drive(tinj, 25, torch.zeros((1, 16)))
    _drive(jinj, 25, jnp.zeros((1, 16)))
    assert tinj.failures == jinj.failures and tinj.flips == jinj.flips
    assert tinj.flips
    again = FaultInjector(_plan(seed=3), **kw)
    _drive(again, 25, torch.zeros((1, 16)))
    assert again.flips == tinj.flips
    quiet = FaultInjector(_plan(seed=3), **{**kw, "flip_rate": 0.0})
    _drive(quiet, 25, torch.zeros((1, 16)))
    assert quiet.failures == tinj.failures       # flips never move faults


def test_watchdog_flags_a_stalled_stream_on_a_fake_clock():
    t = [0.0]
    fe = serving.ServingFrontend(clock=lambda: t[0], stall_threshold_s=5.0)
    fe.register("m", _plan(), max_delay=1e-3)
    ss = fe.stats["streams"][0]
    with fe._cond:
        ss["last_launch_s"] = 0.0
        ss["inflight"] = True
    t[0] = 4.0
    assert fe.check_stalls() == [] and not ss["stalled"]
    t[0] = 6.0
    assert fe.check_stalls() == [0] and ss["stalled"]
    with fe._cond:
        ss["inflight"] = False
    assert fe.check_stalls() == [] and not ss["stalled"]


# ------------------------------------------- integrity: recovery

def _guarded_frontend(pack, streams=1, **kw):
    fe = serving.ServingFrontend(
        cache=serving.PackCache(device="cpu"), streams=streams,
        clock=_FakeClock())
    fe.register_pack("m", pack,
                     plan_kwargs={"mode": "oracle", "act_dtype": "int8"},
                     max_delay=1e-4, integrity=True, **kw)
    return fe


@pytest.mark.parametrize("streams", [1, 2])
def test_flips_detected_and_recovered_bitwise(streams):
    pack = _rand_pack(DIMS_A, seed=12)
    injector = None

    def wrap(plan):
        nonlocal injector
        injector = FaultInjector(plan, seed=11, flip_rate=0.06,
                                 flip_targets=("packed", "epilogue"))
        return injector

    xs = _rows(80)
    ref = serving.build_plan(
        serving.decode_pack(serving.compress_pack(pack), "cpu"),
        mode="oracle", act_dtype="int8", device="cpu")
    baseline = [_alone(ref, x) for x in xs]
    fe = _guarded_frontend(pack, streams=streams, wrap=wrap)
    with fe:
        ys = [fe.submit("m", x).result(60.0).y for x in xs]
    integ = fe.stats["integrity"]
    assert injector.flipped > 0
    assert integ["detected"] == injector.flipped
    assert integ["recovered"] == integ["detected"]
    assert not fe.stats["quarantined"]
    for y, b in zip(ys, baseline):
        np.testing.assert_array_equal(y, b)


def test_staged_flip_before_any_copy_lands_in_the_packed_codes():
    """With no sealed copy built yet (the oracle reads the pack itself), a
    ``"staged"`` flip lands in place in a layer's packed codes: the same
    tensor object, one bit changed, caught by the guard."""
    plan = serving.build_plan(stamp_pack_crcs(_rand_pack(DIMS_A, seed=8)),
                              mode="oracle", device="cpu")
    before = [l["packed"] for l in plan.layers]
    clean = [p.clone() for p in before]
    inj = FaultInjector(plan, flip_nth=(0,), flip_targets=("staged",))
    guard = GuardedPlan(inj, model_id="m")
    with pytest.raises(IntegrityError):
        guard.entry(1)(torch.zeros((1, DIMS_A[0])))
    (idx, target, li, what, byte, bit), = inj.flips
    assert (idx, target, li) == (0, "staged", None)
    assert what.endswith("packed")
    assert all(l["packed"] is p for l, p in zip(plan.layers, before))
    diff = [int((p ^ c).ne(0).sum()) for p, c in zip(before, clean)]
    assert sorted(diff) == [0, 1]


@pytest.mark.parametrize("streams", [1, 2])
def test_flips_in_the_copies_the_kernels_read_detected_and_recovered(
        streams):
    """``"staged"`` flips land in place in the stacked codes that the ws
    buckets read (the pack itself stays clean, nothing is forgotten):
    each is caught by the launch that runs on it and recovered bitwise."""
    pack = _rand_pack(DIMS_A, seed=21)
    injector = None

    def wrap(plan):
        nonlocal injector
        injector = FaultInjector(plan, seed=5, flip_rate=0.1,
                                 flip_targets=("staged",))
        return injector

    xs = _rows(60, seed=4)
    ref = serving.build_plan(
        serving.decode_pack(serving.compress_pack(pack), "cpu"),
        mode="fused", device="cpu")
    assert ref.buckets[1].path == "fused_ws"
    baseline = [_alone(ref, x) for x in xs]
    fe = serving.ServingFrontend(cache=serving.PackCache(device="cpu"),
                                 streams=streams)
    fe.register_pack("m", pack, plan_kwargs={"mode": "fused"},
                     max_delay=1e-4, integrity=True, wrap=wrap)
    with fe:
        ys = [fe.submit("m", x).result(60.0).y for x in xs]
    integ = fe.stats["integrity"]
    assert injector.flipped > 0
    assert {f[3] for f in injector.flips} == {"stacked operands"}
    assert integ["detected"] == injector.flipped
    assert integ["recovered"] == integ["detected"]
    assert not fe.stats["quarantined"]
    for y, b in zip(ys, baseline):
        np.testing.assert_array_equal(y, b)


def test_scrub_recovers_hot_and_quarantines_cold_corruption():
    pack = _rand_pack(DIMS_A, seed=13)
    fe = _guarded_frontend(pack)
    x = np.zeros((1, 16), np.float32)
    with fe:
        y0 = fe.submit("m", x).result(60.0).y
        plan = fe.registry.cache.plan("m")
        host = plan.layers[0]["packed"].numpy().copy()
        host.reshape(-1)[0] ^= 2
        plan.layers[0]["packed"] = torch.from_numpy(host)
        report = fe.scrub_once()
        assert report["detected"] == 1 and report["recovered"] == 1
        np.testing.assert_array_equal(fe.submit("m", x).result(60.0).y, y0)
        ct = fe.registry.cache.cold("m").layers[0].codes
        key, _ = ct.canonical_items()[0]
        ct.payload[key].view(np.uint8).reshape(-1)[0] ^= 1
        report = fe.scrub_once()
        assert report["quarantined"] == ["m"]
        with pytest.raises(serving.Rejected) as e:
            fe.submit("m", x).result(60.0)
    assert e.value.reason == "corrupted"
    assert fe.stats["scrub"]["cycles"] == 2


def test_hot_and_cold_corrupted_quarantines_instead_of_looping():
    pack = _rand_pack(DIMS_A, seed=15)
    fe = _guarded_frontend(pack)
    x = np.zeros((1, 16), np.float32)
    with fe:
        fe.submit("m", x).result(60.0)
        ct = fe.registry.cache.cold("m").layers[1].codes
        key, _ = ct.canonical_items()[0]
        ct.payload[key].view(np.uint8).reshape(-1)[0] ^= 1
        plan = fe.registry.cache.plan("m")
        plan.layers[1]["bias"] = plan.layers[1]["bias"] + 1.0
        with pytest.raises(IntegrityError):
            fe.submit("m", x).result(60.0)
        assert fe.stats["quarantined"] == ["m"]
        assert fe.stats["integrity"]["recovery_failed"] == 1
        with pytest.raises(serving.Rejected) as e:
            fe.submit("m", x).result(60.0)
        assert e.value.reason == "corrupted"


def test_unregister_unwraps_guard_and_injector_chain():
    fe = _guarded_frontend(_rand_pack(DIMS_A, seed=16),
                           wrap=lambda p: FaultInjector(p))
    chain = unwrap_chain(dict(fe.registry.items())["m"].plan)
    assert [type(p).__name__ for p in chain] == \
        ["GuardedPlan", "FaultInjector", "CachedPlan"]
    assert chain[0].device == torch.device("cpu")
    fe.registry.unregister("m")
    with pytest.raises(KeyError):
        fe.registry.cache.cold("m")


# ------------------------------------------------------------ replay

class _SpyBatcher(jbatcher.MicroBatcher):
    """Records what each JAX launch served and when it started."""
    log = []

    def run_one(self, now=None):
        done, bucket, dt = super().run_one(now)
        _SpyBatcher.log.append((now, bucket, done))
        return done, bucket, dt


@pytest.mark.parametrize("n_streams", [1, 2])
def test_replay_completions_equal_the_jax_replay(monkeypatch, n_streams):
    pack = _rand_pack(DIMS_A, seed=4)
    rng = np.random.default_rng(8)
    xs = [rng.normal(size=(int(rng.integers(1, 4)), 16)).astype(np.float32)
          for _ in range(60)]
    arrivals = np.cumsum(rng.exponential(4e-4, size=60))
    table = {b: 1e-4 * (1 + b / 8) for b in (1, 2, 4, 8, 16, 32, 64, 128,
                                             256)}
    kw = dict(max_delay=1e-3, max_bucket=16, service_times=table,
              n_streams=n_streams)
    port = serving.replay(_plan(seed=4), xs, arrivals, **kw)
    _SpyBatcher.log = []
    monkeypatch.setattr(jbatcher, "MicroBatcher", _SpyBatcher)
    jrep = jbatcher.replay(
        jplans.build_plan(_jax_layers(pack), mode="oracle"),
        [jnp.asarray(x) for x in xs], arrivals, **kw)
    order = np.argsort(arrivals, kind="stable")
    req_of_rid = {rid: int(i) for rid, i in enumerate(order)}
    jax_done = {}
    for start, bucket, done in _SpyBatcher.log:
        for c in done:
            jax_done[req_of_rid[c.rid]] = (c.rid, c.bucket, c.batched_rows,
                                           start + table[bucket])
    for i, c in enumerate(port["completions"]):
        assert (c.rid, c.bucket, c.batched_rows, port["finish"][i]) == \
            jax_done[i], i
        np.testing.assert_allclose(port["results"][i],
                                   np.asarray(jrep["results"][i]), **TOL)
    assert port["stream_launches"] == jrep["stream_launches"]
    assert port["makespan_s"] == jrep["makespan_s"]
    assert port["latency_max_ms"] == jrep["latency_max_ms"]


# ------------------------------------------------- thread safety

def test_identity_memo_is_safe_under_threads():
    """More threads than cores, a short switch interval: puts past the
    bound, gets and drops interleave; no iteration error, every hit is
    the value put for its key, and pinned entries survive eviction."""
    memo = IdentityMemo(max_entries=4)
    keys = [object() for _ in range(16)]
    pinned = object()
    memo.put((pinned,), (), "pinned", pin=True)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(3000):
                k = keys[int(rng.integers(len(keys)))]
                op = rng.integers(3)
                if op == 0:
                    memo.put((k,), (), id(k))
                elif op == 1:
                    hit = memo.get((k,))
                    assert hit is MISS or hit == id(k)
                else:
                    memo.drop(k)
        except Exception as exc:                   # noqa: BLE001
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert memo.get((pinned,)) == "pinned"
    assert len(memo._entries) - len(memo._pinned) <= memo.max_entries


def test_corrupt_cold_tier_met_on_dispatch_quarantines_one_model():
    """With two streams the dispatch thread costs each bucket, which
    decodes a cold model: a corrupt cold tier there quarantines that
    model (typed causes) and the dispatch thread lives on for the
    others (the JAX frontend's dispatch thread dies here)."""
    cache = serving.PackCache(device="cpu")
    fe = serving.ServingFrontend(cache=cache, streams=2, clock=_FakeClock())
    fe.register_pack("bad", _rand_pack(DIMS_A, seed=20),
                     plan_kwargs={"mode": "oracle"}, integrity=True)
    fe.register_pack("ok", _rand_pack(DIMS_B, seed=21),
                     plan_kwargs={"mode": "oracle"})
    ct = cache.cold("bad").layers[0].codes
    key, _ = ct.canonical_items()[0]
    ct.payload[key].view(np.uint8).reshape(-1)[0] ^= 1
    x = np.zeros((1, 16), np.float32)
    with fe:
        with pytest.raises(IntegrityError) as e:
            fe.submit("bad", x).result(30.0)
        assert e.value.kind == "cold"
        assert fe.submit("ok", x).result(30.0).y.shape == (1, DIMS_B[-1])
        with pytest.raises(serving.Rejected) as r:
            fe.submit("bad", x).result(30.0)
    assert r.value.reason == "corrupted" and fe._error is None
    assert fe.stats["quarantined"] == ["bad"]
