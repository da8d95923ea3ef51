"""The port's checkpoints, exports, input feed and fault-tolerant loop on
the CPU, against the JAX package's contracts.

* ``CheckpointManager``: the counterparts of ``tests/test_checkpoint.py``
  (round trip, keep-k, shape guard, no partial directories after a
  failed save, the export compresses, ``load_quantized`` round trip), and
  checkpoints and exports that cross between the packages both ways:
  a JAX train-state checkpoint of the ``smollm-360m`` smoke config
  restores bitwise in the port and the reverse; a JAX
  ``export_quantized`` artifact loads in the port's ``load_quantized`` and
  the reverse, codes and ω equal.
* ``ShardedFeed`` and ``FaultTolerantLoop``: the counterparts of
  ``tests/test_data_fault.py`` (skip-ahead, checkpoint and resume, retry
  then fail hard, preemption), with the port's ``InjectedFault`` as the
  transient error; a sticky error is not retried; metrics come back
  bounded-stale.
"""
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jman
from repro.configs import get_config as jget_config
from repro.core import qat as jqat
from repro.nn import transformer as JT
from repro.optim import ec4t as jec4t
from repro_torch import convert, tree
from repro_torch.checkpoint import manager as tman
from repro_torch.configs import get_config
from repro_torch.core import bitplanes as tbp
from repro_torch.core import ecl as tecl
from repro_torch.core import qat as tqat
from repro_torch.data import pipeline, synthetic
from repro_torch.runtime import fault


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"lin": tqat.make_quant_param(
                torch.randn((16, 8), generator=g)),
                       "norm": torch.ones((8,))},
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal_trees(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ---------------------------------------------------- CheckpointManager

def test_save_restore_roundtrip(tmp_path):
    mgr = tman.CheckpointManager(str(tmp_path), keep=2)
    state = _state()
    mgr.save(7, state, extra={"note": "hi"})
    restored, meta = mgr.restore(_state(seed=1))
    assert meta["step"] == 7 and meta["note"] == "hi"
    _equal_trees(restored, state)
    assert restored["step"].shape == ()
    with np.load(tmp_path / "step_00000007" / "state.npz") as z:
        assert sorted(z.files) == ["params//lin//omega", "params//lin//w",
                                   "params//norm", "step"]


def test_keep_k_gc(tmp_path):
    mgr = tman.CheckpointManager(str(tmp_path), keep=2)
    state = _state()
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_shape_mismatch_rejected(tmp_path):
    mgr = tman.CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones((4,))})
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.ones((5,))})
    with pytest.raises(KeyError, match="missing v"):
        mgr.restore({"v": torch.ones((4,))})
    with pytest.raises(FileNotFoundError):
        tman.CheckpointManager(str(tmp_path / "empty")).restore({})


def test_no_partial_dirs_after_failure(tmp_path):
    mgr = tman.CheckpointManager(str(tmp_path))

    class Boom:
        """un-serialisable leaf forces a mid-save failure"""
    with pytest.raises(Exception):
        mgr.save(1, {"bad": Boom()})
    leftovers = [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    assert leftovers == []
    assert mgr.all_steps() == []


def test_restore_places_on_the_named_device(tmp_path):
    mgr = tman.CheckpointManager(str(tmp_path))
    state = _state()
    mgr.save(3, state)
    restored, _ = mgr.restore(state, device="cpu")
    assert all(t.device.type == "cpu" for t in tree.leaves(restored))
    _equal_trees(restored, state)


def test_export_quantized_compresses(tmp_path):
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=(256, 256)).astype(np.float32) * 0.05)
    params = {"lin": tqat.make_quant_param(w)}
    qs = tqat.build_qstate(params)
    report = tman.export_quantized(str(tmp_path / "exp"), params, qs,
                                   lam=0.05)
    assert report["compression_ratio"] > 7.0   # ~8x from 4 bits + formats
    assert (tmp_path / "exp" / "export.npz").exists()
    assert (tmp_path / "exp" / "report.json").exists()


def test_load_quantized_roundtrips_export(tmp_path):
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=(64, 32)).astype(np.float32) * 0.05)
    params = {"lin": tqat.make_quant_param(w), "norm": torch.ones((32,))}
    qs = tqat.build_qstate(params)
    tman.export_quantized(str(tmp_path / "exp"), params, qs, lam=0.05)
    loaded = tman.load_quantized(str(tmp_path / "exp"))
    codes_ref = tecl.assign(params["lin"]["w"], params["lin"]["omega"],
                            qs["lin"]["probs"], 0.05).numpy()
    np.testing.assert_array_equal(loaded["lin"]["codes"], codes_ref)
    np.testing.assert_array_equal(loaded["lin"]["omega"],
                                  params["lin"]["omega"].numpy())
    np.testing.assert_array_equal(loaded["norm"], np.ones((32,)))


def test_export_assigns_every_tensor_in_one_grouped_call(tmp_path,
                                                          monkeypatch):
    calls = []
    orig = tecl.quantize_many
    monkeypatch.setattr(tecl, "quantize_many",
                        lambda *a: calls.append(len(a[0])) or orig(*a))
    params, qstate = _smoke_port_state()
    tman.export_quantized(str(tmp_path / "exp"), params, qstate, lam=0.05)
    assert calls == [7]


# -------------------------------------------- across the two packages

def _jax_smoke_state():
    cfg = jget_config("smollm-360m").smoke()
    state = jec4t.init_train_state(JT.lm_init(jax.random.PRNGKey(1), cfg))
    rng = np.random.default_rng(7)
    # moments, probabilities and a step counter that are not all zeros
    state["opt"]["m"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
        state["opt"]["m"])
    state["qstate"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.dirichlet(np.ones(16), a.shape[:-1])
                              .astype(np.float32))
        if a.ndim and a.shape[-1] == 16 and a.dtype == jnp.float32 else a,
        state["qstate"])
    state["opt"]["step"] = jnp.asarray(13, jnp.int32)
    return state


def _smoke_port_state():
    js = _jax_smoke_state()
    ts = convert.lm_train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), device="cpu")
    return ts["params"], ts["qstate"]


def test_jax_checkpoint_restores_in_the_port_and_back(tmp_path):
    js = _jax_smoke_state()
    jman.CheckpointManager(str(tmp_path / "j")).save(13, js)
    template = convert.lm_train_state_from_numpy(
        jax.tree_util.tree_map(lambda a: np.zeros_like(np.asarray(a)), js),
        device="cpu")
    restored, meta = tman.CheckpointManager(str(tmp_path / "j")).restore(
        template)
    assert meta["step"] == 13
    want = convert.lm_train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), device="cpu")
    _equal_trees(restored, want)

    tman.CheckpointManager(str(tmp_path / "t")).save(14, restored)
    back, meta = jman.CheckpointManager(str(tmp_path / "t")).restore(js)
    assert meta["step"] == 14
    for a, b in zip(jax.tree_util.tree_leaves(js),
                    jax.tree_util.tree_leaves(back)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert sorted(os.listdir(tmp_path / "t" / "step_00000014")) == \
        sorted(os.listdir(tmp_path / "j" / "step_00000013"))


def _codes(loaded):
    return {k: v for k, v in loaded.items() if isinstance(v, dict)}


def test_exports_load_in_the_other_package(tmp_path):
    js = _jax_smoke_state()
    params, qstate = _smoke_port_state()
    lam = 0.05
    jrep = jman.export_quantized(str(tmp_path / "j"), js["params"],
                                 js["qstate"], lam)
    trep = tman.export_quantized(str(tmp_path / "t"), params, qstate, lam)
    assert sorted(jrep["tensors"]) == sorted(trep["tensors"])
    for which in ("j", "t"):
        mine = tman.load_quantized(str(tmp_path / which))
        theirs = jman.load_quantized(str(tmp_path / which))
        assert sorted(mine) == sorted(theirs)
        for key, val in mine.items():
            if isinstance(val, dict):
                np.testing.assert_array_equal(val["codes"],
                                              theirs[key]["codes"])
                np.testing.assert_array_equal(val["omega"],
                                              theirs[key]["omega"])
            else:
                np.testing.assert_array_equal(val, theirs[key])
    # what each package wrote: the same codes (both assign with the
    # decode-order codebook at ω's power-of-two init) and the same ω
    j, t = _codes(tman.load_quantized(str(tmp_path / "j"))), \
        _codes(tman.load_quantized(str(tmp_path / "t")))
    for key in j:
        np.testing.assert_array_equal(j[key]["codes"], t[key]["codes"])
        np.testing.assert_array_equal(j[key]["omega"], t[key]["omega"])
    frozen = tqat.freeze_tree(params, qstate, lam)
    np.testing.assert_array_equal(
        t["stacks//dense//mlp//down//kernel"]["codes"],
        tbp.unpack_codes_rows(
            frozen["stacks"]["dense"]["mlp"]["down"]["kernel"]["packed"]
        ).numpy())


# ------------------------------------------------------------ the feed

def test_feed_skip_ahead_matches_direct():
    cfg = synthetic.LMDataCfg(vocab=64, seq_len=8, global_batch=2, seed=1)
    feed = pipeline.ShardedFeed(lambda s: synthetic.lm_batch(cfg, s),
                                start_step=10, device="cpu")
    try:
        got = next(feed)
        nxt = next(feed)
    finally:
        feed.close()
    assert isinstance(got["tokens"], torch.Tensor)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  synthetic.lm_batch(cfg, 10)["tokens"])
    np.testing.assert_array_equal(nxt["labels"].numpy(),
                                  synthetic.lm_batch(cfg, 11)["labels"])


def test_feed_raises_what_the_batch_function_raised():
    def batch_fn(step):
        if step == 2:
            raise ValueError("no batch 2")
        return {"x": np.full((2,), step, np.float32)}

    feed = pipeline.ShardedFeed(batch_fn, device="cpu")
    try:
        assert float(next(feed)["x"][0]) == 0.0
        assert float(next(feed)["x"][0]) == 1.0
        with pytest.raises(ValueError, match="no batch 2"):
            next(feed)
    finally:
        feed.close()
    assert not feed._thread.is_alive()


def test_place_and_feed_refuse_a_mesh():
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        pipeline.place({"x": np.zeros(2)}, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        pipeline.ShardedFeed(lambda s: {}, mesh=object(), device="cpu")
    got = pipeline.place({"x": np.arange(3, dtype=np.int32)}, device="cpu")
    assert got["x"].dtype == torch.int32 and got["x"].tolist() == [0, 1, 2]


# ------------------------------------------------- FaultTolerantLoop

def _toy_step(state, batch):
    loss = torch.sum(batch["x"]) * 0.0 + state["w"]
    return {"w": state["w"] + 1.0}, {"loss": loss}


def _batches():
    while True:
        yield {"x": torch.ones((2,))}


def test_loop_checkpoints_and_resumes(tmp_path):
    mgr = tman.CheckpointManager(str(tmp_path), keep=5)
    loop = fault.FaultTolerantLoop(_toy_step, mgr, ckpt_every=3,
                                   metrics_every=2)
    state = {"w": torch.zeros(())}
    state, step, reason = loop.run(state, _batches(), total_steps=7)
    assert reason == "done" and step == 7
    assert mgr.all_steps() == [3, 6, 7]
    assert [s for s, _ in loop.saves] == [3, 6, 7]
    # a fresh loop resumes from 7
    state2, start = loop.resume_or({"w": torch.zeros(())})
    assert start == 7 and float(state2["w"]) == 7.0
    state2, step2, _ = loop.run(state2, _batches(), start_step=start,
                                total_steps=10)
    assert step2 == 10 and float(state2["w"]) == 10.0


def test_loop_writes_a_step_once(tmp_path):
    mgr = tman.CheckpointManager(str(tmp_path), keep=5)
    loop = fault.FaultTolerantLoop(_toy_step, mgr, ckpt_every=3)
    loop.run({"w": torch.zeros(())}, _batches(), total_steps=6)
    assert mgr.all_steps() == [3, 6]
    assert [s for s, _ in loop.saves] == [3, 6]


def test_loop_retries_transient_then_fails_hard(tmp_path):
    mgr = tman.CheckpointManager(str(tmp_path))
    calls = {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        if calls["n"] == 2:       # fail exactly once (transient)
            raise fault.InjectedFault("injected")
        return _toy_step(state, batch)

    loop = fault.FaultTolerantLoop(flaky, mgr, ckpt_every=100,
                                   max_retries=2)
    state, step, reason = loop.run({"w": torch.zeros(())}, _batches(),
                                   total_steps=3)
    assert reason == "done" and step == 3 and float(state["w"]) == 3.0

    def always_fails(state, batch):
        raise fault.InjectedFault("hard")
    mgr2 = tman.CheckpointManager(str(tmp_path / "hard"))
    loop2 = fault.FaultTolerantLoop(always_fails, mgr2, max_retries=1)
    state, step, reason = loop2.run({"w": torch.zeros(())}, _batches(),
                                    total_steps=3)
    assert reason == "failed" and step == 0
    assert mgr2.latest_step() == 0     # state-at-failure checkpointed


def test_loop_retries_exhausted_memory_and_not_a_sticky_error(tmp_path):
    calls = {"n": 0}

    def oom_once(state, batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.OutOfMemoryError("out of memory")
        return _toy_step(state, batch)

    loop = fault.FaultTolerantLoop(
        oom_once, tman.CheckpointManager(str(tmp_path / "oom")),
        max_retries=1)
    assert loop.run({"w": torch.zeros(())}, _batches(),
                    total_steps=2)[1:] == (2, "done")

    def sticky(state, batch):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    mgr = tman.CheckpointManager(str(tmp_path / "sticky"))
    loop = fault.FaultTolerantLoop(sticky, mgr, max_retries=3)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        loop.run({"w": torch.zeros(())}, _batches(), total_steps=3)
    assert mgr.all_steps() == []


def test_metrics_are_bounded_stale(tmp_path):
    seen = []
    loop = fault.FaultTolerantLoop(
        _toy_step, tman.CheckpointManager(str(tmp_path)), ckpt_every=100,
        metrics_every=3, on_metrics=lambda s, m: seen.append(
            (s, float(m["loss"]), type(m["loss"]))))
    loop.run({"w": torch.zeros(())}, _batches(), total_steps=10)
    # step 3's metrics are read at step 6, step 6's at 9, 9's at the end
    assert [(s, v) for s, v, _ in seen] == [(3, 2.0), (6, 5.0), (9, 8.0)]
    assert all(t is np.ndarray for _, _, t in seen)


def test_preemption_checkpoint(tmp_path):
    mgr = tman.CheckpointManager(str(tmp_path))

    def slow_step(state, batch):
        time.sleep(0.02)
        return _toy_step(state, batch)

    loop = fault.FaultTolerantLoop(slow_step, mgr, ckpt_every=10**6)
    killer = threading.Timer(0.15,
                             lambda: os.kill(os.getpid(), signal.SIGTERM))
    killer.start()
    try:
        state, step, reason = loop.run({"w": torch.zeros(())}, _batches(),
                                       total_steps=10**6)
    finally:
        killer.join(5)
    assert reason == "preempted"
    assert mgr.latest_step() == step
    assert float(state["w"]) == step
