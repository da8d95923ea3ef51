"""The port's autotuner (``repro_torch.kernels.autotune``) and the plan's
sweep wiring, on the CPU with fake measures.

The contracts of ``tests/test_autotune.py`` against the port; on shared
cases the JAX package's function and the port's, given the same inputs
and the same measure closure (the reference with an explicit
``backend=``), return the same ``(schedule, block_m, source, swept)``.
The shared cases keep to buckets of at most 8 rows, or to measures that
prefer the largest tile, where the two ladders give the same winner (the
port's row tiles are 8 / 16 / 32, the TPU's 32 … 256).  Then the port's
documented differences: nothing is written off the card, and a candidate
whose measure raises raises.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro_torch.core import bitplanes as tbp
from repro_torch.convert import pack_from_numpy
from repro_torch.kernels import autotune as tat
from repro_torch.serving import plans as tplans

ALL = ("batch_tiled", "db", "stream", "ws")


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Both packages' cache files in a temporary directory, both memory
    caches empty."""
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    monkeypatch.setenv(jat.ENV_CACHE, str(jpath))
    monkeypatch.setenv(tat.ENV_CACHE, str(tpath))
    jat.clear_memory_cache()
    tat.clear_memory_cache()
    yield jpath, tpath
    jat.clear_memory_cache()
    tat.clear_memory_cache()


def _key(cfg):
    return (cfg.schedule, cfg.block_m, cfg.source, cfg.swept)


def _both(fn_name, *args, **kwargs):
    """The reference's and the port's answer to the same call."""
    return (getattr(jat, fn_name)(*args, **kwargs),
            getattr(tat, fn_name)(*args, **kwargs))


def _raise(*_):
    raise AssertionError("a warm hit measured")


# ---------------------------------------------------------- key formats

def test_port_has_every_module_function_of_the_reference():
    import inspect
    ref = {n for n, f in vars(jat).items()
           if inspect.isfunction(f) and f.__module__ == jat.__name__}
    assert len(ref) == 20
    missing = sorted(n for n in ref if not inspect.isfunction(
        getattr(tat, n, None)))
    assert missing == []
    for name in ("swept", "as_tuple", "same_blocks"):
        assert hasattr(tat.BlockConfig(8, 0, 0), name)


@pytest.mark.parametrize("kw", [
    dict(m=8, k=512, n=12, dtype="float32", fused=True, backend="x"),
    dict(m=64, k=512, n=256, dtype="float32", fused=False, backend="x",
         act_dtype="int8", extra="stack512x12"),
])
def test_key_formats_are_the_references(kw):
    m, k, n = kw.pop("m"), kw.pop("k"), kw.pop("n")
    assert tat.cache_key(m, k, n, **kw) == jat.cache_key(m, k, n, **kw)
    for rows in (1, 32):
        assert tat.bucket_cache_key(rows, k, n, backend="x", stack="s") == \
            jat.bucket_cache_key(rows, k, n, backend="x", stack="s")
    assert tat.ws_crossover_key(k, n, backend="x", act_dtype="int8") == \
        jat.ws_crossover_key(k, n, backend="x", act_dtype="int8")


@pytest.mark.parametrize("key", [
    "cpu|m8|k16|n32|float32|fused1|e",
    "cpu|m8|k16|n32|float32|fused0",
    "cpu|m8|k16|n32|float32|fused1|actint8|e",
    "no-fused-segment",
])
def test_migrate_key_matches_reference(key):
    assert tat._migrate_key(key) == jat._migrate_key(key)


def test_backend_keys():
    assert tat.default_backend("cpu") == "cpu"
    assert tat.default_backend("meta") == "cpu"
    assert tat.tuning("cpu") == "prior"


def test_card_name_is_sanitised(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3|x")
    assert tat.default_backend("cuda") == "NVIDIA_H100_80GB_HBM3_x"


def test_tuning_on_the_card_follows_the_environment(monkeypatch):
    """The device decides: a CUDA device sweeps, any other binds from the
    prior; no environment variable overrides it."""
    monkeypatch.setenv("FANTASTIC4_TORCH_AUTOTUNE", "prior")
    assert tat.tuning("cuda") == tat.tuning(torch.device("cuda", 0)) \
        == "sweep"
    assert tat.tuning("meta") == tat.tuning("cpu") == "prior"


def test_own_cache_file_never_the_references(caches, monkeypatch):
    monkeypatch.delenv(tat.ENV_CACHE)
    assert tat.cache_path().endswith(os.path.join("fantastic4",
                                                  "autotune_torch.json"))
    assert tat.cache_path() != jat.cache_path()


def test_reference_cache_entries_are_not_read(caches):
    jpath, _ = caches
    key = jat.bucket_cache_key(2, 512, 12, backend="x", stack="s")
    jpath.write_text(json.dumps({key: {"block_m": 8, "block_n": 0,
                                       "block_k": 0, "source": "sweep",
                                       "schedule": "ws"}}))
    cfg = tat.get_schedule_config(2, 512, 12, schedules=("batch_tiled",),
                                  prior="batch_tiled", backend="x",
                                  stack="s")
    assert (cfg.schedule, cfg.source) == ("batch_tiled", "heuristic")


# ------------------------------------------------------------ candidates

def test_candidates_are_the_cuda_launches_knobs():
    assert tat.ROW_TILES == (8, 16, 32)
    assert tat.candidate_schedule_blocks(32, ALL) == [
        ("batch_tiled", 8), ("batch_tiled", 16), ("batch_tiled", 32),
        ("db", 16), ("db", 32),
        ("stream", 8), ("stream", 16), ("stream", 32), ("ws", 32)]
    assert tat.candidate_schedule_blocks(3, ALL) == [
        ("batch_tiled", 8), ("stream", 8), ("ws", 8)]
    assert [c.block_m for c in tat.candidate_blocks(256, 512, 12,
                                                    fused=True)] == \
        [8, 16, 32]
    # the chain's tiles are the wrapper's: one configuration, no sweep
    assert len(tat.candidate_blocks(256, 512, 12)) == 1
    # up to 8 rows both ladders collapse to the rounded bucket
    for rows in (1, 2, 5, 8):
        assert tat.candidate_schedule_blocks(rows, ALL) == \
            list(jat.candidate_schedule_blocks(rows, ALL))


def test_heuristics_clamp_to_the_problem():
    assert tat.heuristic_blocks(1, 784, 12).block_m == 8
    assert tat.heuristic_blocks(300, 784, 12).block_m == 32
    assert tat.heuristic_blocks(300, 784, 12, fused=True).block_m == 256
    e = tat.heuristic_elementwise_blocks(5, 30)
    assert (e.block_m, e.block_n, e.block_k) == (8, 128, 0)
    for rows in (1, 8, 100, 256, 999):
        assert tat.heuristic_blocks(rows, 64, 64, fused=True).block_m == \
            jat.heuristic_blocks(rows, 64, 64, fused=True,
                                 backend="interpret").block_m


# --------------------------------------------- shared with the reference

@pytest.mark.parametrize("rows,schedules", [
    (8, ("batch_tiled", "stream", "ws")),
    (2, ALL),
    (32, ALL),
])
def test_cold_sweep_then_warm_hit_match_reference(caches, rows, schedules):
    jpath, tpath = caches
    calls = {"jax": 0, "torch": 0}

    def measure(who):
        def m(s, bm):
            calls[who] += 1
            # stream first, then the largest tile
            return {"stream": 1.0, "batch_tiled": 2.0, "db": 3.0,
                    "ws": 4.0}[s] + 1e-3 / bm
        return m

    kw = dict(schedules=schedules, prior="batch_tiled", backend="x",
              stack="stack512x12")
    j = jat.get_schedule_config(rows, 512, 12, measure=measure("jax"), **kw)
    t = tat.get_schedule_config(rows, 512, 12, measure=measure("torch"),
                                **kw)
    assert _key(t) == _key(j)
    assert t.source == "sweep" and t.schedule == "stream"
    assert calls["torch"] == len(tat.candidate_schedule_blocks(rows,
                                                               schedules))
    key = tat.bucket_cache_key(rows, 512, 12, backend="x",
                               stack="stack512x12")
    assert json.loads(tpath.read_text())[key]["schedule"] == "stream"
    jat.clear_memory_cache()
    tat.clear_memory_cache()
    calls.update(jax=0, torch=0)
    j2 = jat.get_schedule_config(rows, 512, 12, measure=_raise, **kw)
    t2 = tat.get_schedule_config(rows, 512, 12, measure=_raise, **kw)
    assert _key(t2) == _key(j2) == _key(t)


def test_union_convergence_matches_reference(caches):
    times = {"batch_tiled": 2.0, "ws": 1.0, "stream": 3.0, "db": 4.0}
    out = []
    for mod in (jat, tat):
        seen = []

        def measure(s, bm):
            seen.append(s)
            return times[s]
        a = mod.get_schedule_config(
            2, 512, 12, schedules=("batch_tiled", "ws"),
            prior="batch_tiled", backend="x", stack="s", measure=measure)
        seen.clear()
        b = mod.get_schedule_config(
            2, 512, 12, schedules=("batch_tiled", "stream"),
            prior="batch_tiled", backend="x", stack="s", measure=measure)
        assert "ws" in seen
        a2 = mod.get_schedule_config(
            2, 512, 12, schedules=("batch_tiled", "ws"),
            prior="batch_tiled", backend="x", stack="s", measure=_raise)
        out.append([_key(c) for c in (a, b, a2)])
    assert out[0] == out[1]
    assert [k[0] for k in out[1]] == ["ws", "batch_tiled", "ws"]
    _, tpath = caches
    raw = json.loads(tpath.read_text())[tat.bucket_cache_key(
        2, 512, 12, backend="x", stack="s")]
    assert raw["schedule"] == "ws"
    assert set(raw["swept"]) == {"batch_tiled", "ws", "stream"}


def test_forbidden_winner_bypassed_not_clobbered_matches_reference(caches):
    out = []
    for mod in (jat, tat):
        swept = mod.get_schedule_config(
            2, 512, 12, schedules=("batch_tiled", "ws"),
            prior="batch_tiled", backend="x", stack="stack512x12",
            measure=lambda s, bm: 1.0 if s == "ws" else 2.0)
        restricted = mod.get_schedule_config(
            2, 512, 12, schedules=("batch_tiled",), prior="batch_tiled",
            backend="x", stack="stack512x12")
        out.append((_key(swept), _key(restricted)))
    assert out[0] == out[1]
    assert out[1][0][0] == "ws" and out[1][1][0] == "batch_tiled"
    _, tpath = caches
    key = tat.bucket_cache_key(2, 512, 12, backend="x", stack="stack512x12")
    assert json.loads(tpath.read_text())[key]["schedule"] == "ws"


def test_restricted_sweep_does_not_shadow_broader_eligibility(caches):
    t = {"batch_tiled": 1.0, "stream": 2.0, "ws": 0.5}
    out = []
    for mod in (jat, tat):
        first = mod.get_schedule_config(
            2, 512, 12, schedules=("batch_tiled", "stream"),
            prior="batch_tiled", backend="x", stack="s",
            measure=lambda s, bm: t[s])
        full = mod.get_schedule_config(
            2, 512, 12, schedules=("batch_tiled", "stream", "ws"),
            prior="batch_tiled", backend="x", stack="s",
            measure=lambda s, bm: t[s])
        again = mod.get_schedule_config(
            2, 512, 12, schedules=("batch_tiled", "stream", "ws"),
            prior="batch_tiled", backend="x", stack="s", measure=_raise)
        out.append([_key(c) for c in (first, full, again)])
    assert out[0] == out[1]
    assert out[1][0][3] == ("batch_tiled", "stream")
    assert out[1][2][0] == "ws"


def _legacy_file(path, backend):
    key = jat.cache_key(256, 512, 12, dtype="float32", fused=True,
                        backend=backend, extra="stack512x12")
    path.write_text(json.dumps({key: {"block_m": 64, "block_n": 1024,
                                      "block_k": 2048, "source": "sweep"}}))
    return key


def test_legacy_migration_matches_reference(caches):
    jpath, tpath = caches
    _legacy_file(jpath, "x")
    legacy_key = _legacy_file(tpath, "x")
    out = []
    for mod in (jat, tat):
        mod.clear_memory_cache()
        a = mod.get_schedule_config(
            8, 512, 12, schedules=("batch_tiled", "ws"),
            prior="batch_tiled", backend="x", stack="stack512x12",
            legacy_m=256)
        b = mod.get_schedule_config(
            128, 512, 12, schedules=("batch_tiled",), prior="batch_tiled",
            backend="x", stack="stack512x12", legacy_m=256)
        out.append((_key(a), _key(b)))
    assert out[0] == out[1]
    assert out[1] == (("batch_tiled", 8, "migrated", None),
                      ("batch_tiled", 64, "migrated", None))
    # the legacy entry survives a later save untouched
    tat.record_ws_crossover(8, 512, 12, backend="x", stack="stack512x12")
    raw = json.loads(tpath.read_text())
    assert raw[legacy_key]["block_m"] == 64
    assert "schedule" not in raw[legacy_key]


def test_crossover_round_trip_matches_reference(caches):
    for mod in (jat, tat):
        kw = dict(backend="x", stack="stack512x12")
        assert mod.get_ws_crossover(512, 12, **kw) is None
        mod.record_ws_crossover(16, 512, 12, **kw)
        assert mod.get_ws_crossover(512, 12, **kw) == 16
        mod.clear_memory_cache()
        assert mod.get_ws_crossover(512, 12, **kw) == 16
        assert mod.get_ws_crossover(512, 12, backend="y",
                                    stack="stack512x12") is None
        assert mod.get_ws_crossover(512, 12, backend="x",
                                    stack="stack256x12") is None


def test_crossover_first_touch_keeps_existing_file(caches):
    _, tpath = caches
    tat.get_schedule_config(8, 512, 12, schedules=("batch_tiled", "ws"),
                            prior="ws", backend="x", stack="s",
                            measure=lambda s, bm: 1.0)
    tat.clear_memory_cache()
    tat.record_ws_crossover(4, 512, 12, backend="x", stack="s")
    raw = json.loads(tpath.read_text())
    assert tat.bucket_cache_key(8, 512, 12, backend="x", stack="s") in raw
    assert tat.get_ws_crossover(512, 12, backend="x", stack="s") == 4


def test_pre_act_key_migration_matches_reference(caches):
    payload = json.dumps({
        "x|m64|k512|n256|float32|fused0": {
            "block_m": 32, "block_n": 128, "block_k": 256,
            "source": "sweep"},
        "x|m64|k512|n12|float32|fused1|stack512x256x12": {
            "block_m": 64, "block_n": 1024, "block_k": 2048,
            "source": "sweep"},
        "corrupt-entry": {"nope": 1},
    })
    for path in caches:
        path.write_text(payload)
    out = []
    for mod in (jat, tat):
        mod.clear_memory_cache()
        a = mod.get_block_config(64, 512, 256, dtype="float32", fused=False,
                                 backend="x", measure=_raise)
        b = mod.get_block_config(64, 512, 12, dtype="float32", fused=True,
                                 backend="x", extra="stack512x256x12",
                                 measure=_raise)
        out.append((a.as_tuple(), a.source, b.as_tuple(), b.source))
    assert out[0] == out[1] == ((32, 128, 256), "sweep",
                                (64, 1024, 2048), "sweep")
    # an int8 lookup of the same stack does not inherit the fp32 entry
    seen = []
    c = tat.get_block_config(64, 512, 12, dtype="float32", fused=True,
                             backend="x", act_dtype="int8",
                             extra="stack512x256x12",
                             measure=lambda cfg: seen.append(cfg) or 1.0)
    assert seen and c.source == "sweep"


def test_failed_sweep_falls_back_to_prior_matches_reference(caches):
    j, t = _both("get_schedule_config", 8, 64, 64,
                 schedules=("batch_tiled", "ws"), prior="ws", backend="x",
                 stack="s", measure=lambda s, bm: float("inf"))
    assert _key(t) == _key(j) == ("ws", 8, "heuristic", None)


def test_prior_answers_without_measure_and_is_not_cached(caches):
    _, tpath = caches
    j, t = _both("get_schedule_config", 4, 512, 12,
                 schedules=("batch_tiled", "ws"), prior="ws",
                 backend="x", stack="s")
    assert _key(t) == _key(j) == ("ws", 8, "heuristic", None)
    t2 = tat.get_schedule_config(4, 512, 12, schedules=("batch_tiled",),
                                 prior="batch_tiled", backend="x",
                                 stack="s")
    assert t2.schedule == "batch_tiled"
    assert not tpath.exists()


def test_block_sweep_persists_and_warm_hit(caches):
    _, tpath = caches
    seen = []

    def measure(cfg):
        seen.append(cfg.block_m)
        return 1.0 / cfg.block_m
    cold = tat.get_block_config(256, 512, 12, fused=True, backend="x",
                                extra="stack512x12", measure=measure)
    assert seen == [8, 16, 32] and cold.block_m == 32
    assert cold.source == "sweep"
    tat.clear_memory_cache()
    warm = tat.get_block_config(256, 512, 12, fused=True, backend="x",
                                extra="stack512x12", measure=_raise)
    assert warm.same_blocks(cold)
    key = tat.cache_key(256, 512, 12, dtype="float32", fused=True,
                        backend="x", extra="stack512x12")
    assert json.loads(tpath.read_text())[key]["block_m"] == 32


def test_elementwise_sweep_persists_and_warm_hit(caches):
    cold = tat.get_elementwise_config(
        300, 700, backend="x",
        measure=lambda c: 1.0 / (c.block_m * 1e3 + c.block_n))
    assert cold.source == "sweep" and cold.block_k == 0
    tat.clear_memory_cache()
    warm = tat.get_elementwise_config(300, 700, backend="x", measure=_raise)
    assert warm.same_blocks(cold)


# ------------------------------------------- the documented differences

def test_nothing_is_written_without_a_measurement(caches):
    _, tpath = caches
    tat.get_block_config(8, 512, 256, fused=False, backend="cpu")
    tat.get_block_config(8, 512, 12, fused=True, backend="cpu",
                         act_dtype="int8", extra="s")
    tat.get_elementwise_config(256, 512, backend="cpu")
    tat.get_schedule_config(8, 512, 12, schedules=ALL, prior="ws",
                            backend="cpu", stack="s", legacy_m=256)
    tat.get_block_config(16, 64, 64, backend="cpu",
                         measure=lambda c: float("inf"))
    assert not tpath.exists()


def test_a_raising_candidate_raises(caches):
    _, tpath = caches

    def boom(*_):
        raise RuntimeError("launch failed")
    with pytest.raises(RuntimeError, match="launch failed"):
        tat.get_schedule_config(8, 512, 12, schedules=ALL, prior="ws",
                                backend="x", stack="s", measure=boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        tat.get_block_config(256, 512, 12, fused=True, backend="x",
                             measure=boom)
    assert not tpath.exists()


# ------------------------------------------------------- the plan's sweep

def _pack(dims=(40, 48, 34, 10), seed=0):
    rng = np.random.default_rng(seed)
    layers = []
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        codes = rng.integers(0, 16, size=(k, n)).astype(np.uint8)
        layers.append({
            "packed": tbp.pack_codes_rows(torch.from_numpy(codes)).numpy(),
            "omega": (rng.normal(size=4) / np.sqrt(k)).astype(np.float32),
            "alpha1": (rng.normal(size=n) * 0.5).astype(np.float32),
            "bias": (rng.normal(size=n) * 0.1).astype(np.float32),
            "alpha2": np.float32(1.0), "shape": (k, n),
            "activation": "relu" if i < len(dims) - 2 else None})
    return pack_from_numpy({"layers": layers, "act_bits": None},
                           device="cpu")


def _fake(rows, s, bm):
    """ws wins up to 4 rows, stream past them, at the smallest tile."""
    ws = 1.0 if rows <= 4 else 5.0
    return {"ws": ws, "stream": 2.0, "batch_tiled": 3.0,
            "db": 4.0}[s] + 1e-3 * bm


@pytest.fixture
def swept_plans(caches, monkeypatch):
    """Plans on the CPU that take the card's path: the sweep on, each
    candidate measured by :func:`_fake` and counted."""
    calls = []
    monkeypatch.setattr(tat, "tuning", lambda device: "sweep")

    def schedule_measure(plan, rows):
        def m(s, bm):
            calls.append((rows, s, bm))
            return _fake(rows, s, bm)
        return m

    def block_measure(plan, rows):
        def m(cfg):
            calls.append((rows, "block", cfg.block_m))
            return 1.0 / cfg.block_m
        return m
    monkeypatch.setattr(tplans.ExecutionPlan, "_schedule_measure",
                        schedule_measure)
    monkeypatch.setattr(tplans.ExecutionPlan, "_block_measure",
                        block_measure)
    return calls


@pytest.mark.parametrize("act", ["float32", "int8"])
def test_plan_binds_every_bucket_to_the_sweeps_winner(swept_plans, caches,
                                                       act):
    calls = swept_plans
    pack = _pack()
    plan = tplans.ExecutionPlan(pack, act_dtype=act, device="cpu")
    d = plan.describe()
    assert d["tuning"] == "sweep" and d["block_source"] == "sweep"
    assert plan.block_m == 32
    assert plan.bucket_sizes == (1, 2, 4, 8, 16, 32)
    for b, bp in plan.buckets.items():
        assert bp.source == "sweep"
        assert plan.schedule_for(b) == ("ws" if b <= 4 else "stream")
        if b > 4:
            assert bp.block_m == 8
    # one measure a candidate: the block sweep, then each bucket's
    want = len(tat.candidate_blocks(256, 40, 10, fused=True)) + sum(
        len(tat.candidate_schedule_blocks(b, plan._eligible_schedules(b)))
        for b in plan.bucket_sizes)
    assert len(calls) == want
    assert plan.ws_crossover_rows == 4
    assert tat.get_ws_crossover(40, 10, backend="cpu", act_dtype=act,
                                stack=plan._stack_extra) == 4
    # served outputs follow the bindings and stay within the fp32 gate
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(5, 40)).astype(np.float32))
    oracle = tplans.ExecutionPlan(pack, mode="oracle", act_dtype=act,
                                  device="cpu")
    if act == "float32":
        torch.testing.assert_close(plan(x), oracle(x), atol=1e-3,
                                   rtol=1e-4)
    # a warm build over the same file: no measure, the same bindings
    tat.clear_memory_cache()
    calls.clear()
    warm = tplans.ExecutionPlan(pack, act_dtype=act, device="cpu")
    assert calls == []
    assert {b: (p.path, p.block_m, p.source) for b, p in
            warm.buckets.items()} == \
        {b: (p.path, p.block_m, p.source) for b, p in plan.buckets.items()}
    assert warm.ws_prior_source == "measured" and warm.ws_prior_rows == 4


def test_restricted_plan_records_no_crossover(swept_plans, caches):
    pack = _pack()
    plan = tplans.ExecutionPlan(pack, ws_bucket_rows=0, device="cpu")
    assert all(p.path != "fused_ws" for p in plan.buckets.values())
    assert all(p.source == "sweep" for p in plan.buckets.values())
    assert tat.get_ws_crossover(40, 10, backend="cpu",
                                stack=plan._stack_extra) is None


def test_plan_off_the_card_binds_the_prior_and_writes_nothing(caches):
    _, tpath = caches
    pack = _pack()
    for kw in ({}, {"act_dtype": "int8"}, {"double_buffer": True},
               {"ws_bucket_rows": 0}):
        plan = tplans.ExecutionPlan(pack, device="cpu", **kw)
        assert plan.describe()["tuning"] == "prior"
        assert all(p.source == "heuristic" for p in plan.buckets.values())
        assert plan.block_source == "heuristic"
    assert plan.ws_prior_source == "explicit"
    assert not tpath.exists()
