"""The port's MLP freeze and serving stack vs the JAX package.

Weights are carried across as numpy (``repro_torch.convert``), so both
packages see the same parameters.  Tolerances: codes exact; α₁ and b
``rtol=1e-6`` (the same numpy float32 fold); int8 scales ``rtol=1e-6``;
served logits at the serving gates (fp32 ``atol=1e-3, rtol=1e-4``, int8
relative ``< 5e-3``).  Everything runs on ``device="cpu"``, where the
kernels' plain versions serve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_mlps import MLPS, MLPConfig
from repro.core import qat as jqat
from repro.models import mlp as jmlp
from repro.serving import plans as jplans
from repro_torch import resolve_device
from repro_torch.configs.paper_mlps import MLPS as TMLPS
from repro_torch.convert import pack_from_numpy, params_from_numpy
from repro_torch.core import bitplanes as tbp
from repro_torch.core import qat as tqat
from repro_torch.kernels import fantastic4_fused_mlp as ffm
from repro_torch.launch import serve as tserve
from repro_torch.models import mlp as tmlp
from repro_torch.serving import plans as tplans
from repro_torch.serving.batcher import MicroBatcher
from repro_torch.serving.slo import Rejected

TINY = MLPConfig("tiny", (48, 33, 10), d_in=40)
GSC_DIMS = (512, 512, 512, 256, 256, 128, 128, 12)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(cfg, seed=0):
    params, bn = jmlp.mlp_init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    # non-trivial BatchNorm state so the fold is exercised
    for layer, st in zip(params["layers"], bn["layers"]):
        if st:
            n = st["mean"].shape[0]
            layer["bn_gamma"] = jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)
            layer["bn_beta"] = jnp.asarray(rng.normal(size=n) * 0.1, jnp.float32)
            layer["bias"] = jnp.asarray(rng.normal(size=n) * 0.1, jnp.float32)
            st["mean"] = jnp.asarray(rng.normal(size=n) * 0.2, jnp.float32)
            st["var"] = jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32)
    return params, jqat.build_qstate(params), bn


def _rand_pack(dims, seed=0):
    rng = np.random.default_rng(seed)
    layers = []
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        codes = rng.integers(0, 16, size=(k + k % 2, n)).astype(np.uint8)
        if k % 2:
            codes[-1] = 0
        layers.append({
            "packed": tbp.pack_codes_rows(torch.from_numpy(codes)).numpy(),
            "omega": (rng.normal(size=4) / np.sqrt(k)).astype(np.float32),
            "alpha1": (rng.normal(size=n) * 0.5).astype(np.float32),
            "bias": (rng.normal(size=n) * 0.1).astype(np.float32),
            "alpha2": np.float32(1.0), "shape": (k, n),
            "activation": "relu" if i < len(dims) - 2 else None})
    return pack_from_numpy({"layers": layers, "act_bits": None}, device="cpu")


@pytest.fixture(scope="module")
def tiny_packs():
    params, qs, bn = _jax_params(TINY)
    jpack = jmlp.freeze_mlp(params, qs, bn, lam=TINY.lam)
    tp, tq, tb = params_from_numpy(_np(params), _np(qs), _np(bn),
                                   device="cpu")
    return jpack, tmlp.freeze_mlp(tp, tq, tb, lam=TINY.lam)


def test_configs_are_copies():
    assert {k: v.features for k, v in TMLPS.items()} == \
        {k: v.features for k, v in MLPS.items()}
    n_w = sum(a * b for a, b in zip(GSC_DIMS[:-1], GSC_DIMS[1:]))
    assert n_w == 771_584 and n_w // 2 == 385_792


def test_freeze_mlp_matches_jax(tiny_packs):
    jpack, tpack = tiny_packs
    for jl, tl in zip(jpack["layers"], tpack["layers"]):
        assert tuple(jl["shape"]) == tl["shape"]
        assert jl["activation"] == tl["activation"]
        np.testing.assert_array_equal(tl["packed"].numpy(),
                                      np.asarray(jl["packed"]))
        np.testing.assert_array_equal(tl["omega"].numpy(),
                                      np.asarray(jl["omega"]))
        np.testing.assert_allclose(tl["alpha1"].numpy(),
                                   np.asarray(jl["alpha1"]), rtol=1e-6)
        np.testing.assert_allclose(tl["bias"].numpy(),
                                   np.asarray(jl["bias"]), rtol=1e-6,
                                   atol=1e-7)
        assert float(tl["alpha2"]) == float(jl["alpha2"])
    # odd K (33) carries one zero code row
    assert tpack["layers"][2]["packed"].shape == (17, 10)


def test_mlp_init_is_seeded():
    a, _ = tmlp.mlp_init(TMLPS["mlp-hr"], seed=3, device="cpu")
    b, _ = tmlp.mlp_init(TMLPS["mlp-hr"],
                         generator=torch.Generator().manual_seed(3),
                         device="cpu")
    torch.testing.assert_close(a["layers"][1]["kernel"]["w"],
                               b["layers"][1]["kernel"]["w"], rtol=0, atol=0)
    assert a["layers"][0]["kernel"]["omega"].shape == (4,)
    assert tqat.build_qstate(a)["layers"][0]["kernel"]["probs"].shape == (16,)


def test_calibrate_act_scales_matches_jax(tiny_packs):
    jpack, _ = tiny_packs
    tpack = pack_from_numpy(_np(jpack), device="cpu")
    x = np.random.default_rng(1).normal(size=(16, TINY.d_in)).astype(
        np.float32)
    want = jplans.calibrate_act_scales(jpack, jnp.asarray(x))["act_scales"]
    got = tplans.calibrate_act_scales(tpack, torch.from_numpy(x))["act_scales"]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the default synthetic calibration batch is the same numpy draw
    np.testing.assert_array_equal(tplans._default_calib_x(40),
                                  np.asarray(jplans._default_calib_x(40)))


def test_plan_binds_ws_then_batch_tiled():
    plan = tplans.ExecutionPlan(_rand_pack(GSC_DIMS), device="cpu")
    d = plan.describe()
    assert d["resolved_mode"] == "fused" and plan.block_m == 32
    assert d["bucket_schedules"] == {1: "ws", 2: "ws", 4: "ws", 8: "ws",
                                     16: "batch_tiled", 32: "batch_tiled"}
    assert plan.oversize_binding(256).path == "fused"
    assert plan.schedule_for(200) == "batch_tiled"
    assert "weight-stationary" in plan.mode_label(3)


def test_plan_db_on_request():
    plan = tplans.ExecutionPlan(_rand_pack(GSC_DIMS), double_buffer=True,
                                device="cpu")
    assert plan.describe()["bucket_schedules"][16] == "db"
    assert plan.describe()["bucket_schedules"][32] == "db"
    assert plan.describe()["bucket_schedules"][8] == "ws"


def test_plan_stream_when_batch_tiled_does_not_fit():
    plan = tplans.ExecutionPlan(
        _rand_pack(GSC_DIMS), device="cpu",
        smem_budget_bytes=ffm.CORE_SMEM_BYTES + 1024)
    sch = plan.describe()["bucket_schedules"]
    assert plan.resolved_mode == "fused"
    assert all(sch[b] == "ws" for b in (1, 2, 4, 8))
    assert all(sch[b] == "stream" for b in (16, 32, 64, 128, 256))
    assert plan.buckets[64].block_m == tplans.STREAM_BLOCK_M
    assert any("stream/ws" in n for n in plan.notes)


def test_plan_budget_one_is_per_layer():
    plan = tplans.ExecutionPlan(_rand_pack((40, 48, 33, 10)), device="cpu",
                                smem_budget_bytes=1)
    assert plan.resolved_mode == "per_layer"
    assert set(plan.describe()["bucket_schedules"].values()) == {"per_layer"}


def test_plan_sharded_not_ported():
    with pytest.raises(NotImplementedError, match="item 10"):
        tplans.ExecutionPlan(_rand_pack((40, 48, 10)), mode="sharded",
                             device="cpu")


@pytest.mark.parametrize("act_dtype", ["float32", "int8"])
def test_demote_bucket_keeps_results(act_dtype):
    pack = _rand_pack((40, 48, 33, 10), seed=2)
    plan = tplans.ExecutionPlan(pack, act_dtype=act_dtype, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(16, 40)).astype(np.float32))
    before = plan.run(x)
    assert plan.schedule_for(16) == "batch_tiled"
    bp = plan.demote_bucket(16, reason="test")
    assert bp.path == "per_layer" and bp.source == "degraded:test"
    after = plan.run(x)
    np.testing.assert_array_equal(after.numpy(), before.numpy())
    with pytest.raises(KeyError):
        plan.demote_bucket(3)


def test_whole_slice_gsc_matches_jax():
    """MLP-GSC at full width, frozen by the JAX package, served by the
    port's ``mlp_serve``/``mlp_serve_int8`` on the CPU."""
    params, qs, bn = _jax_params(MLPS["mlp-gsc"], seed=5)
    jpack = jmlp.freeze_mlp(params, qs, bn, lam=MLPS["mlp-gsc"].lam)
    tpack = pack_from_numpy(_np(jpack), device="cpu")
    x = np.random.default_rng(5).normal(size=(16, 512)).astype(np.float32)
    want = np.asarray(jmlp.mlp_serve(jpack, jnp.asarray(x), use_kernel=False))
    got = tmlp.mlp_serve(tpack, torch.from_numpy(x), device="cpu").numpy()
    assert got.shape == (16, 12) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)
    calib = jmlp.calibrate_act_scales(jpack, jnp.asarray(x))
    want8 = np.asarray(jmlp.mlp_serve_int8(jpack, calib, jnp.asarray(x),
                                           use_kernel=False))
    got8 = tmlp.mlp_serve_int8(tpack, calib, torch.from_numpy(x),
                               device="cpu").numpy()
    rel = np.abs(got8 - want8).max() / np.abs(want8).max()
    assert rel < 5e-3, rel


@pytest.mark.parametrize("act_dtype", ["float32", "int8"])
def test_batcher_ragged_requests_equal_batch(act_dtype):
    pack = _rand_pack((40, 48, 33, 10), seed=3)
    plan = tplans.ExecutionPlan(pack, act_dtype=act_dtype, device="cpu")
    rng = np.random.default_rng(3)
    reqs = [rng.normal(size=(int(rng.integers(1, 6)), 40)).astype(np.float32)
            for _ in range(24)]
    batcher = MicroBatcher(plan)
    rids = [batcher.submit(r) for r in reqs]
    done = {c.rid: c for c in batcher.flush()}
    assert set(done) == set(rids)
    whole = plan.run(np.concatenate(reqs)).numpy()
    off = 0
    for rid, r in zip(rids, reqs):
        c = done[rid]
        # bit-identical to the same rows served alone through its bucket
        xb = torch.nn.functional.pad(torch.from_numpy(r),
                                     (0, 0, 0, c.bucket - r.shape[0]))
        alone = plan.entry(c.bucket)(xb)[:r.shape[0]].numpy()
        np.testing.assert_array_equal(c.y, alone)
        np.testing.assert_allclose(c.y, whole[off:off + r.shape[0]],
                                   atol=1e-5, rtol=1e-5)
        off += r.shape[0]
    assert batcher.stats["requests"] == 24
    bounded = MicroBatcher(plan, max_queued_rows=4)
    bounded.submit(reqs[0][:2])
    with pytest.raises(Rejected):
        bounded.submit(np.zeros((3, 40), np.float32))


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pack = _rand_pack((40, 48, 10))
    x = torch.zeros((2, 40))
    calls = [
        lambda: resolve_device(None),
        lambda: tmlp.mlp_init(TMLPS["mlp-hr"]),
        lambda: tplans.ExecutionPlan(pack),
        lambda: tmlp.mlp_serve(pack, x),
        lambda: tmlp.mlp_serve_int8(pack, {"act_scales": [1.0]}, x),
        lambda: pack_from_numpy({"layers": []}),
        lambda: params_from_numpy({}, {}, {}),
        lambda: tserve.main(["--arch", "mlp-hr", "--batch", "2"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_serve_launcher_on_cpu(capsys):
    y = tserve.main(["--arch", "lenet-300-100", "--batch", "3", "--iters",
                     "1", "--int8", "--engine", "--device", "cpu"])
    out = capsys.readouterr().out
    assert y.shape == (3, 10)
    assert "bucket -> schedule" in out and "engine (ragged" in out
