"""EC4T training over a mesh (``repro_torch.launch.steps.build_train_step``
on ``launch.mesh``) on a gloo world of 4 CPU ranks, against the JAX
package's single-device step.

The reference's own sharded test (``tests/test_distributed_equivalence.py
::test_sharded_train_step_matches_single_device``) fails on some hosts, so
the port's mesh step is held to the single-device reference instead: the
JAX package's ``ec4t.make_train_step`` on ``smollm-360m``'s smoke config
(its state carried across with ``convert``, ω and the probabilities moved
off their init), one step at lr 1e-3 with λ ``cfg.lam``.  Meshes (4, 1)
and (2, 2), each rank fed its rows by ``ShardedFeed(mesh=)``.  Gates: in
fp32 the loss within ``rtol=1e-4`` and the params within the reference
test's ``atol=rtol=5e-3`` (they agree to ~1e-6); the JAX package's bf16
``_loss_fn(mesh=None, use_ep=False)`` step's loss within 1e-2 (the bf16
gate of ``test_torch_lm_training.py``); against the port's own
single-device step the fp32 gradients within 1e-5 of each leaf's largest;
remat ``full`` and ``dots`` and ZeRO-1 bitwise the plain replicated step;
every replicated leaf (params, m, v, probabilities) bitwise equal on every
rank.  A masked batch gives the global masked mean.  The int8 path: with
the same rows on every data rank the mesh step equals the port's
single-device ``compress_grads`` step on those rows bit for bit (and the
reference's within 1e-5); with distinct rows the int8 gradients are
within half the shared scale of the exact mean, and over 20 steps the
error feedback keeps the applied sum within half a scale of the true one.
One step of every other family's smoke config over (2, 2) against the
port's single-device step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import qat as jqat
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.nn import transformer as JT
from repro.nn.module import QuantCtx as JQuantCtx
from repro.optim import adam as jadam
from repro.optim import ec4t as jec4t
from repro.optim import grad_compress as jgc
from repro_torch import convert, tree
from repro_torch.configs import get_config
from repro_torch.core import qat
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import ranks
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import lm_batch_fn
from repro_torch.models import whisper as W
from repro_torch.nn import transformer as T
from repro_torch.optim import adam as tadam
from repro_torch.optim import ec4t as tec4t
from repro_torch.optim import grad_compress as tgc

ARCH = "smollm-360m"
LR = 1e-3
MESHES = [(4, 1), (2, 2)]
MIN_SIZE = 4096          # smoke leaves of 8,192+ elements go through int8


@pytest.fixture(scope="module")
def world():
    with tmesh.RankPool(4, device="cpu", timeout=300) as pool:
        yield pool


@pytest.fixture(scope="module")
def smollm():
    """The JAX state (ω and the probabilities perturbed), its numpy tree,
    two global batches of 8 x 16 and the JAX fp32 step's result."""
    cfg = jget_config(ARCH).smoke()
    state = jec4t.init_train_state(JT.lm_init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(100)
    state["params"] = jax.tree_util.tree_map(
        lambda n: {**n, "omega": n["omega"] * jnp.asarray(
            rng.uniform(0.8, 1.2, n["omega"].shape).astype(np.float32))}
        if jqat.is_quant_leaf(n) else n, state["params"],
        is_leaf=jqat.is_quant_leaf)
    state["qstate"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.dirichlet(np.ones(16) * 2, a.shape[:-1])
                              .astype(np.float32))
        if a.ndim and a.shape[-1] == 16 and a.dtype == jnp.float32 else a,
        state["qstate"])
    np_state = jax.tree_util.tree_map(np.asarray, state)
    tcfg = get_config(ARCH).smoke()
    batches = [lm_batch_fn(tcfg, batch=8, seq=16)(i) for i in range(2)]

    def jloss(p, qs, batch, lam):
        ctx = JQuantCtx(quant=True, lam=lam, compute_dtype=jnp.float32)
        return jlm.lm_forward_loss(p, qs, batch, ctx, cfg)
    jstep = jax.jit(jec4t.make_train_step(jloss, jadam.AdamConfig(lr=LR),
                                          lam=cfg.lam))
    jnew, jm = jstep(state, batches[0])
    return {"cfg": tcfg, "jcfg": cfg, "jstate": state, "np": np_state,
            "batches": batches, "jnew": jax.tree_util.tree_map(np.asarray,
                                                               jnew),
            "jloss": float(jm["loss"])}


def _port_state(np_state):
    return convert.lm_train_state_from_numpy(
        {"params": np_state["params"], "qstate": np_state["qstate"]},
        device="cpu")


def _port_single(cfg, np_state, batch, compress=None, grads=False):
    """The port's single-device step (fp32, λ ``cfg.lam``) from the state;
    with ``grads`` also its gradients."""
    st = _port_state(np_state)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_fn = tsteps._loss_fn(cfg, dtype=torch.float32)
    out = {}
    if grads:
        out["grads"] = tec4t.local_grads(loss_fn, st["params"],
                                         st["qstate"], tb, cfg.lam)[1]
    state = tec4t.init_train_state(st["params"], compress)
    state["qstate"] = st["qstate"]
    step = tec4t.make_train_step(loss_fn, tadam.AdamConfig(lr=LR),
                                 lam=cfg.lam, compress=compress)
    out["state"], out["metrics"] = step(state, tb)
    return out


def _replicas_equal(res, run):
    """Every rank's digests of the run's params, probabilities and (not
    with ZeRO-1) moments equal rank 0's."""
    digests = [r["runs"][run]["digests"] for r in res]
    return all(d == digests[0] for d in digests)


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_step_matches_the_single_device_references(world, smollm,
                                                        mesh, tmp_path):
    cfg, np_state = smollm["cfg"], smollm["np"]
    batch = smollm["batches"][0]
    res = world.run(ranks.dp_train, cfg, mesh, [batch],
                    params=np_state["params"], qstate=np_state["qstate"],
                    grads=True, lr=LR, out_dir=str(tmp_path),
                    runs=[{"state": True}, {"zero1": True},
                          {"remat": "full"}, {"remat": "dots"}])
    # the JAX package's single-device fp32 step
    for rank, r in enumerate(res):
        m = r["runs"][0]["metrics"][0]
        np.testing.assert_allclose(m["loss"], smollm["jloss"], rtol=1e-4,
                                   err_msg=f"rank {rank}")
    got = ranks.load_dump(str(tmp_path / "run0"))
    want = dict(ranks.named_leaves(smollm["jnew"]["params"]))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=5e-3,
                                   rtol=5e-3, err_msg=name)
        np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                   err_msg=name)
    # the port's single-device step: gradients and the new state
    single = _port_single(cfg, np_state, batch, grads=True)
    mesh_grads = ranks.load_dump(str(tmp_path / "grads"))
    for name, g in ranks.named_leaves(convert.tree_to_numpy(single["grads"])):
        mine = mesh_grads[name]
        scale = max(float(np.abs(g).max()), 1e-30)
        assert float(np.abs(mine - g).max()) <= 1e-5 * scale, name
    np.testing.assert_allclose(res[0]["runs"][0]["metrics"][0]["grad_norm"],
                               float(single["metrics"]["grad_norm"]),
                               rtol=1e-5)
    # replicas, ZeRO-1 and remat, bit for bit
    for run in range(4):
        assert _replicas_equal(res, run), run
    assert all(r["grad_digests"] == res[0]["grad_digests"] for r in res)
    for r in res:
        for run in (2, 3):
            assert r["runs"][run]["digests"] == r["runs"][0]["digests"], run
        for run in (1, 2, 3):
            assert r["runs"][run]["block_digests"] == \
                r["runs"][0]["block_digests"], run
        # ZeRO-1: the same params and probabilities, no whole moments
        zero1 = r["runs"][1]["digests"]
        assert zero1 == {k: v for k, v in r["runs"][0]["digests"].items()
                         if k.split("/")[1] != "opt"}
        # no card here: the kernel counter stays 0 on the plain version
        assert r["runs"][0]["ecl_launches"] == [0]


def test_bf16_mesh_step_matches_the_reference_loss_fn(world, smollm):
    """The JAX package's ``_loss_fn(mesh=None, use_ep=False)`` (bf16) as
    the launcher builds it, against the port's bf16 step on (2, 2)."""
    jloss = jsteps._loss_fn(smollm["jcfg"], mesh=None, use_ep=False,
                            remat="none")
    jstep = jax.jit(jec4t.make_train_step(jloss, jadam.AdamConfig(lr=LR),
                                          lam=smollm["jcfg"].lam))
    _, jm = jstep(smollm["jstate"], smollm["batches"][1])
    res = world.run(ranks.dp_train, smollm["cfg"], (2, 2),
                    smollm["batches"][1:], params=smollm["np"]["params"],
                    qstate=smollm["np"]["qstate"], lr=LR,
                    runs=[{"dtype": torch.bfloat16, "remat": "full",
                           "zero1": True}])
    for r in res:
        np.testing.assert_allclose(r["runs"][0]["metrics"][0]["loss"],
                                   float(jm["loss"]), rtol=1e-2)
        assert np.isfinite(r["runs"][0]["metrics"][0]["grad_norm"])
    assert _replicas_equal(res, 0)


def test_masked_loss_is_the_global_masked_mean(world, smollm, tmp_path):
    cfg, np_state = smollm["cfg"], smollm["np"]
    batch = dict(smollm["batches"][0])
    mask = np.zeros((8, 16), np.float32)
    for row, keep in enumerate((16, 3, 9, 0, 1, 16, 5, 12)):
        mask[row, :keep] = 1.0
    batch["mask"] = mask
    single = _port_single(cfg, np_state, batch)
    res = world.run(ranks.dp_train, cfg, (4, 1), [batch],
                    params=np_state["params"], qstate=np_state["qstate"],
                    lr=LR, runs=[{"state": True}], out_dir=str(tmp_path))
    want = float(single["metrics"]["ce"])
    for r in res:
        np.testing.assert_allclose(r["runs"][0]["metrics"][0]["ce"], want,
                                   rtol=1e-5)
    # the mean of the ranks' own masked means is another number
    st = _port_state(np_state)
    loss_fn = tsteps._loss_fn(cfg, dtype=torch.float32)
    means = [float(loss_fn(st["params"], st["qstate"], {
        k: torch.from_numpy(v[i * 2:i * 2 + 2]) for k, v in batch.items()},
        cfg.lam)[1]["ce"]) for i in range(4)]
    assert abs(np.mean(means) - want) > 1e-3
    got = ranks.load_dump(str(tmp_path / "run0"))
    for name, t in ranks.named_leaves(convert.tree_to_numpy(
            single["state"]["params"])):
        np.testing.assert_allclose(got[name], t, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mesh", MESHES)
def test_int8_on_replicated_rows_is_the_single_device_round_trip(
        world, smollm, mesh, tmp_path):
    cfg, np_state = smollm["cfg"], smollm["np"]
    dp = mesh[0]
    local = {k: v[:8 // dp] for k, v in smollm["batches"][0].items()}
    tiled = {k: np.concatenate([v] * dp) for k, v in local.items()}
    gcfg = tgc.GradCompressCfg(min_size=MIN_SIZE)
    res = world.run(ranks.dp_train, cfg, mesh, [tiled],
                    params=np_state["params"], qstate=np_state["qstate"],
                    lr=LR, runs=[{"compress": gcfg, "state": True},
                                 {"compress": gcfg, "int8_local": True}],
                    out_dir=str(tmp_path))
    if mesh[1] == 1:
        single = _port_single(cfg, np_state, local, compress=gcfg)
        want = single["state"]
        want = {"params": want["params"], "qstate": want["qstate"],
                "opt": {"m": want["opt"]["m"], "v": want["opt"]["v"]},
                "err": want["err"]}
        want_digests = {n: ranks.digest(t)
                        for n, t in ranks.named_leaves(want)}
    else:
        # tensor-parallel ranks compute the single device's gradient in
        # another order: the round trip is of the mesh's exact gradient
        assert res[0]["layout"] == "tensor parallel"
        want_digests = res[0]["runs"][1]["digests"]
    for rank, r in enumerate(res):
        assert r["runs"][0]["digests"] == want_digests, rank
        assert r["runs"][1]["digests"] == want_digests, rank
    # and the reference's int8 step on those rows
    jstate = jec4t.init_train_state(smollm["jstate"]["params"],
                                    compress=jgc.GradCompressCfg(
                                        min_size=MIN_SIZE))
    jstate["qstate"] = smollm["jstate"]["qstate"]

    def jloss(p, qs, batch, lam):
        ctx = JQuantCtx(quant=True, lam=lam, compute_dtype=jnp.float32)
        return jlm.lm_forward_loss(p, qs, batch, ctx, smollm["jcfg"])
    jnew, _ = jax.jit(jec4t.make_train_step(
        jloss, jadam.AdamConfig(lr=LR), lam=cfg.lam,
        compress=jgc.GradCompressCfg(min_size=MIN_SIZE)))(jstate, local)
    got = ranks.load_dump(str(tmp_path / "run0"))
    for name, t in ranks.named_leaves(jax.tree_util.tree_map(np.asarray,
                                                       jnew["params"])):
        np.testing.assert_allclose(got[name], t, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mesh", MESHES)
def test_int8_on_distinct_rows_is_within_half_a_scale(world, smollm, mesh):
    cfg, np_state = smollm["cfg"], smollm["np"]
    res = world.run(ranks.dp_train, cfg, mesh, smollm["batches"][:1],
                    params=np_state["params"], qstate=np_state["qstate"],
                    lr=LR, runs=[],
                    compress_check=tgc.GradCompressCfg(min_size=MIN_SIZE))
    for r in res:
        assert 0 < r["int8_err_over_half_scale"] <= 1.0 + 1e-5
        assert r["int8_digests"] == res[0]["int8_digests"]


def test_int8_error_feedback_stays_bounded(world):
    res = world.run(ranks.int8_feedback, (64, 64), 20, 3, (4, 1))
    for r in res:
        np.testing.assert_array_equal(r["applied"], res[0]["applied"])
        drift = np.abs(r["applied"] - r["exact"]).max()
        # Σ applied − Σ exact = (e_0 − e_T) / n summed over the data ranks
        assert drift <= max(r["scales"]) / 2 * (1 + 1e-4), drift
        assert r["err_max"] <= r["scales"][-1] / 2 * (1 + 1e-6)


def test_indivisible_batch_and_unknown_axes_raise(world, smollm):
    rows = world.run(ranks.rank_rows, {"tokens": np.zeros((6, 4))}, (4, 1))
    assert all("does not divide" in r["error"] for r in rows)
    rows = world.run(ranks.rank_rows, {"tokens": np.arange(8)[:, None]},
                     (2, 2))
    assert [r["tokens"][:, 0].tolist() for r in rows] == \
        [[0, 1, 2, 3], [0, 1, 2, 3], [4, 5, 6, 7], [4, 5, 6, 7]]
    mesh = tmesh.Mesh((1, 1), device="cpu")
    with pytest.raises(ValueError, match="mesh has no axes"):
        tsteps.build_train_step(smollm["cfg"], mesh, compress=tgc.
                                GradCompressCfg(data_axes=("bogus",)))


def test_replica_axes_and_zero1_specs_follow_the_ports_layout():
    """Non-expert leaves and whole banks are replicated over the mesh, a
    share's banks over the data axes; ZeRO-1 cuts the first dim that
    divides over the data axes.  A dense arch's tensor-parallel blocks are
    replicated over the data axes, their ω over the mesh."""
    from repro_torch.runtime.sharding import replica_axes, zero1_specs
    cfg = get_config("grok-1-314b").smoke()
    spec = tmesh.MeshSpec((2, 2), tmesh.AXES)
    whole = T.lm_init(cfg, seed=0, device="cpu")
    share = T.lm_init(dataclasses.replace(cfg, experts_held=(0, 2)), seed=0,
                      device="cpu")
    every, data = frozenset({"data", "model"}), frozenset({"data"})
    for params, bank_axes in ((whole, every), (share, data)):
        axes = replica_axes(params, spec)
        for name, a in ranks.named_leaves(axes):
            want = bank_axes if "/moe/experts/" in name else every
            assert a == want, name
    specs = zero1_specs(whole, spec)
    assert specs["embed"]["table"] == ("data", None)
    assert specs["stacks"]["moe"]["moe"]["router"]["bias_correction"] == \
        ("data", None)
    odd = {"w": torch.zeros(3, 5), "v": torch.zeros(3, 4)}
    assert zero1_specs(odd, spec) == {"w": (None, None), "v": (None, "data")}
    # the dense family over model > 1: the reference's layout, a rank's
    # block of a sharded leaf summed over the data axes only, ZeRO-1 of a
    # row-sharded (K, N) leaf cut on N
    from repro_torch.runtime.sharding import layout_specs, opt_specs
    dense = get_config("smollm-360m").smoke()
    tree = T.lm_init(dense, device="meta")
    lay = layout_specs(tree, dense, spec)
    axes = replica_axes(tree, spec, lay)
    mlp = lay["stacks"]["dense"]["mlp"]
    assert mlp["down"]["kernel"]["w"] == (None, "model", None)
    assert mlp["gate"]["kernel"]["w"] == (None, None, "model")
    assert axes["stacks"]["dense"]["mlp"]["down"]["kernel"]["w"] == data
    assert axes["stacks"]["dense"]["mlp"]["down"]["kernel"]["omega"] == every
    assert axes["embed"]["table"] == data
    assert axes["final_norm"]["scale"] == every
    assert opt_specs(tree, spec, lay)["stacks"]["dense"]["mlp"]["down"][
        "kernel"]["w"] == ("data", "model", None)
    assert zero1_specs(tree, spec, lay)["stacks"]["dense"]["mlp"]["down"][
        "kernel"]["w"] == ("data", None, None)
    with pytest.raises(ValueError, match="pass mesh"):
        tec4t.make_train_step(lambda *a: None, tadam.AdamConfig(),
                              zero1=True)


FAMILIES = ["grok-1-314b", "deepseek-v3-671b", "mamba2-1.3b", "hymba-1.5b",
            "qwen2-vl-2b", "whisper-base"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_steps_over_a_mesh(world, arch, tmp_path):
    cfg = get_config(arch).smoke()
    if cfg.n_experts:      # nothing drops: the EP layer is the whole one
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                  / cfg.top_k)
    init = W.whisper_init if cfg.family == "audio" else T.lm_init
    params = init(cfg, seed=5, device="cpu")
    np_state = {"params": convert.tree_to_numpy(params),
                "qstate": convert.tree_to_numpy(qat.build_qstate(params))}
    batch = lm_batch_fn(cfg, batch=4, seq=8)(0)
    single = _port_single(cfg, np_state, batch)
    res = world.run(ranks.dp_train, cfg, (2, 2), [batch],
                    params=np_state["params"], qstate=np_state["qstate"],
                    lr=LR, runs=[{"state": True}], out_dir=str(tmp_path))
    assert _replicas_equal(res, 0)
    m = res[0]["runs"][0]["metrics"][0]
    np.testing.assert_allclose(m["ce"], float(single["metrics"]["ce"]),
                               rtol=1e-4)
    if not cfg.n_experts:
        # no exchange: the mesh's step is the single device's
        np.testing.assert_allclose(m["loss"],
                                   float(single["metrics"]["loss"]),
                                   rtol=1e-4)
        got = ranks.load_dump(str(tmp_path / "run0"))
        for name, t in ranks.named_leaves(convert.tree_to_numpy(
                single["state"]["params"])):
            np.testing.assert_allclose(got[name], t, atol=5e-3, rtol=5e-3,
                                       err_msg=name)
    assert all(np.isfinite(list(r["runs"][0]["metrics"][0].values())).all()
               for r in res)
