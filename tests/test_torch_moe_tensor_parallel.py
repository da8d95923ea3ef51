"""Tensor parallelism over the 'model' axis for the MoE family
(grok-1-314b: GQA and 8 experts; deepseek-v3-671b: MLA, a shared expert,
dense layers and 256 routed experts) on a gloo world of 4 CPU ranks,
against the JAX package.

The port's layout (``repro_torch.runtime.sharding.layout_specs`` /
``model_tp``) is the reference's ``Rules.param_specs``, leaf for leaf, at
published and smoke widths on meshes (1, 2) (1, 4) (2, 2) (2, 4); its
ZeRO-1 moment specs are ``Rules.opt_specs`` and its cache specs
``Rules.cache_specs``.  At smoke widths and capacity factor E / k (no
assignment drops) the gathered fp32 logits of the JAX package's
``lm_init`` tree, cut by ``convert.shard_from_numpy``, are within 1e-5 of
its single-device ``lm_apply``: grok over (1, 4) (2 KV heads: sequence-
parallel attention; 4 experts: expert parallelism), over (2, 2) (tp 2:
head-sharded) and with 2 experts over (1, 4) (each expert's FFN width
cut: expert TP); deepseek over (1, 4) and (2, 2) (MLA by heads, its
down-projections column-cut, the shared expert and the dense layer cut,
expert parallelism).  One EC4T step (ZeRO-1 on (2, 2)) is held to the
JAX single-device step (loss ``rtol=1e-4``, gathered gradients within
1e-4 of each leaf's largest, params within ``atol=rtol=5e-3``) and its
probabilities, the expert banks' included, are bitwise one process's
``update_qstate`` of the same params.  A frozen tree's greedy tokens
equal one process's, with a rank's KV heads or the whole latent cache;
``lm_init(mesh=)`` holds exactly a rank's blocks of one process's
``lm_init``, bitwise, and each rank's freeze is its blocks of one
process's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import qat as jqat
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro.nn import moe as jmoe
from repro.nn import transformer as JT
from repro.nn.module import QuantCtx as JQuantCtx
from repro.optim import adam as jadam
from repro.optim import ec4t as jec4t
from repro.runtime import sharding as jsh
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import qat
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import ranks
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import lm_batch_fn
from repro_torch.models import lm as LM
from repro_torch.nn import transformer as T
from repro_torch.nn.module import FP32_CTX
from repro_torch.runtime import sharding as tsh

MOE = ("grok-1-314b", "deepseek-v3-671b")
SPEC_MESHES = [(1, 2), (1, 4), (2, 2), (2, 4)]
LR = 1e-3
EP_BLOCKS = 4      # token blocks the expert-parallel ranks route, 4 ranks


@pytest.fixture(scope="module")
def world():
    with tmesh.RankPool(4, device="cpu", timeout=300) as pool:
        yield pool


def _ptuple(tree):
    return jax.tree_util.tree_map(
        tuple, tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))


def _flat(tree):
    return dict(ranks.named_leaves(tree))


def _spec_leaves(tree):
    """(name, spec tuple) of a tree whose leaves are spec tuples."""
    out = {}

    def walk(node, name):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{name}/{k}")
        else:
            out[name] = tuple(node)
    walk(tree, "")
    return out


def _no_drops(cfg, **kw):
    """``cfg`` (either package's) with ``kw`` and capacity factor E / k:
    no assignment drops, so the exchanges' per-rank capacity is moot."""
    cfg = dataclasses.replace(cfg, **kw)
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                               / cfg.top_k)


def _block(w, spec, i, tp):
    """Model rank ``i``'s block of ``w`` under ``spec`` (model-only)."""
    return w[tuple(slice(None) if a is None else slice(
        i * (n // tp), (i + 1) * (n // tp)) for a, n in zip(spec, w.shape))]


@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
@pytest.mark.parametrize("arch", MOE)
def test_layout_is_the_references_rules(arch, smoke):
    """(1) params, ZeRO-1 moments and the cache (and the frozen tree, its
    (L, E, K/2, N) packed banks included, at smoke widths), the replica
    axes and the ZeRO-1 cut of a rank's leaves."""
    jcfg = jget_config(arch).smoke() if smoke else jget_config(arch)
    cfg = get_config(arch).smoke() if smoke else get_config(arch)
    a = jspecs.abstract_params(jcfg)
    jcache = jax.eval_shape(functools.partial(JT.init_cache, jcfg, 4, 16))
    mine = T.lm_init(cfg, device="meta")
    mine_cache = T.init_cache(cfg, 4, 16, dtype=torch.float32, device="meta")
    frozen = mine_frozen = None
    if smoke:
        frozen = jax.eval_shape(functools.partial(
            jqat.freeze_tree, lam=jcfg.lam), a,
            jax.eval_shape(jqat.build_qstate, a))
        mine_frozen = qat.freeze_tree(mine, qat.build_qstate(mine), cfg.lam)
    for shape in SPEC_MESHES:
        mesh = tmesh.MeshSpec(shape, tmesh.AXES)
        rules = jsh.Rules(("data", "model"), dict(zip(tmesh.AXES, shape)),
                          jcfg)
        assert tsh.tensor_parallel(cfg, mesh)
        specs = tsh.layout_specs(mine, cfg, mesh)
        got = _spec_leaves(specs)
        assert got == _spec_leaves(_ptuple(rules.param_specs(a))), shape
        assert _spec_leaves(tsh.opt_specs(mine, mesh, specs)) == \
            _spec_leaves(_ptuple(rules.opt_specs(a))), shape
        if smoke:
            assert _spec_leaves(tsh.layout_specs(mine_frozen, cfg, mesh)) \
                == _spec_leaves(_ptuple(rules.param_specs(frozen))), shape
        assert _spec_leaves(tsteps._cache_specs(
            tsteps.make_rules(cfg, mesh), mine_cache, cfg, mesh)) == \
            _spec_leaves(_ptuple(rules.cache_specs(jcache))), shape
        axes = _flat(tsh.replica_axes(mine, mesh, specs))
        z = _spec_leaves(tsh.zero1_specs(mine, mesh, specs))
        for name, spec in got.items():
            cut = {x for x in spec if x is not None}
            assert axes[name] == frozenset(tmesh.AXES) - cut, name
            assert "model" not in z[name], name
        # the banks: the experts when they divide 'model', else each
        # expert's FFN width; ω and the router replicated
        banks = specs["stacks"]["moe"]["moe"]["experts"]
        e, tp = cfg.n_experts, shape[1]
        want = (None, "model", None, None) if e % tp == 0 else \
            (None, None, None, "model")
        assert banks["gate"]["w"] == want, shape
        assert banks["gate"]["omega"] == (None, None, None)
        tpc = tsh.model_tp(cfg, mesh)
        assert tpc.experts == ("ep" if e % tp == 0 else "tp")
        assert tpc.shared == bool(cfg.n_shared_experts)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed, **kw):
    cfg = _no_drops(jget_config(arch).smoke(), **kw)
    return cfg, JT.lm_init(jax.random.PRNGKey(seed), cfg)


FORWARD = [("grok-1-314b", (1, 4), {}, True, "ep"),
           ("grok-1-314b", (2, 2), {}, False, "ep"),
           ("grok-1-314b", (1, 4), {"n_experts": 2}, True, "tp"),
           ("deepseek-v3-671b", (1, 4), {}, False, "ep"),
           ("deepseek-v3-671b", (2, 2), {}, False, "ep")]


@pytest.mark.parametrize("arch,mesh,kw,reshard,experts", FORWARD,
                         ids=["grok-seq-ep", "grok-heads-ep", "grok-seq-tp",
                              "deepseek-1x4", "deepseek-2x2"])
def test_forward_matches_the_single_device_lm_apply(world, arch, mesh, kw,
                                                    reshard, experts):
    """(2) the sequence-parallel, head-sharded, EP, expert-TP and MLA
    paths."""
    jcfg, params = _jax_params(arch, 0, **kw)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 16)
                                               ).astype(np.int32)
    want, _, _ = JT.lm_apply(params, 0, jnp.asarray(tokens),
                             JQuantCtx(compute_dtype=jnp.float32), jcfg)
    want = np.asarray(want)
    res = world.run(ranks.tp_forward, _no_drops(get_config(arch).smoke(),
                                                **kw),
                    jax.tree_util.tree_map(np.asarray, params), tokens, mesh)
    for r in res:
        assert r["reshard"] is reshard and r["experts"] == experts
        assert r["local_vocab"] == jcfg.padded_vocab // mesh[1]
        np.testing.assert_allclose(r["logits"], want, atol=1e-5, rtol=0)


def _perturbed_state(jcfg, seed):
    """The JAX train state with ω and the probabilities moved off their
    init (as test_torch_tensor_parallel.py's)."""
    state = jec4t.init_train_state(JT.lm_init(jax.random.PRNGKey(seed), jcfg))
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
    return state


def _blocked_route(route):
    """The JAX package's ``route`` with the load-balance aux of the
    expert-parallel exchange: the mean of each token block's, as the
    reference's ``local_moe`` takes it over the blocks its ranks route
    (its ids and weights are the whole batch's)."""
    def blocked(logits, bias_correction, **kw):
        ids, w, _ = route(logits, bias_correction, **kw)
        aux = sum(route(b, bias_correction, **kw)[2]
                  for b in jnp.split(logits, EP_BLOCKS)) / EP_BLOCKS
        return ids, w, aux
    return blocked


@pytest.fixture(scope="module")
def deepseek_step():
    """deepseek-v3's smoke state (MLA, a shared expert, a dense layer), a
    global batch of 8 x 16, and the JAX package's single-device fp32
    step's loss, gradients and params, its aux that of the 4 token blocks
    the mesh's expert-parallel ranks route."""
    arch = "deepseek-v3-671b"
    jcfg = _no_drops(jget_config(arch).smoke())
    cfg = _no_drops(get_config(arch).smoke())
    state = _perturbed_state(jcfg, 2)
    batch = lm_batch_fn(cfg, batch=8, seq=16)(0)

    def jloss(p, qs, b, lam):
        ctx = JQuantCtx(quant=True, lam=lam, compute_dtype=jnp.float32)
        return jlm.lm_forward_loss(p, qs, b, ctx, jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmoe, "route", _blocked_route(jmoe.route))
        grads = jax.jit(jax.grad(lambda p: jloss(
            p, state["qstate"], batch, jcfg.lam)[0]))(state["params"])
        new, m = jax.jit(jec4t.make_train_step(
            jloss, jadam.AdamConfig(lr=LR), lam=jcfg.lam))(state, batch)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return {"cfg": cfg, "np": to_np(state), "batch": batch,
            "loss": float(m["loss"]), "grads": _flat(to_np(grads)),
            "params": _flat(to_np(new["params"]))}


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_ec4t_step_matches_the_single_device_step(world, deepseek_step, mesh,
                                                  tmp_path):
    """(3) one step (ZeRO-1 on (2, 2)): the JAX step's gates; the
    probabilities, the expert banks' (L, E, 16) included, bitwise one
    process's update of the same params; no kernel launch on the CPU."""
    d = deepseek_step
    res = world.run(ranks.dp_train, d["cfg"], mesh, [d["batch"]],
                    params=d["np"]["params"], qstate=d["np"]["qstate"],
                    lr=LR, grads=True, out_dir=str(tmp_path),
                    runs=[{"zero1": mesh[0] > 1, "state": True,
                           "probs_check": True}])
    for r in res:
        assert r["layout"] == "tensor parallel"
        run = r["runs"][0]
        np.testing.assert_allclose(run["metrics"][0]["loss"], d["loss"],
                                   rtol=1e-4)
        assert run["probs_bitwise"]
        assert run["digests"] == res[0]["runs"][0]["digests"]
        assert run["model_bytes"][0] > 0 and run["ecl_launches"] == [0]
    grads = ranks.load_dump(str(tmp_path / "grads"))
    assert sorted(grads) == sorted(d["grads"])
    for name, want in d["grads"].items():
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(grads[name] - want).max()) <= 1e-4 * scale, name
    got = ranks.load_dump(str(tmp_path / "run0"))
    for name, want in d["params"].items():
        np.testing.assert_allclose(got[name], want, atol=5e-3, rtol=5e-3,
                                   err_msg=name)


@pytest.mark.parametrize("arch,mesh", [("grok-1-314b", (2, 2)),
                                       ("deepseek-v3-671b", (1, 4))])
def test_frozen_tree_serves_the_single_process_tokens(world, arch, mesh):
    """(4) prefill + 4 decode steps from each rank's blocks of one frozen
    tree: grok over (2, 2) caches its KV heads (half of one process's),
    deepseek over (1, 4) the whole latent."""
    cfg = _no_drops(get_config(arch).smoke())
    params = T.lm_init(cfg, seed=4, device="cpu")
    frozen = qat.freeze_tree(params, qat.build_qstate(params), cfg.lam)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, (4, 6)
                                               ).astype(np.int32)
    new = 5
    want = LM.generate(frozen, 0, torch.from_numpy(prompt), FP32_CTX, cfg,
                       max_new=new).numpy()
    one = T.init_cache(cfg, 4, 6 + new, dtype=torch.float32, device="cpu")
    res = world.run(ranks.tp_serve, cfg, convert.tree_to_numpy(frozen),
                    prompt, new, mesh)
    kind = "moe"
    for r in res:
        np.testing.assert_array_equal(r["tokens"], want)
        np.testing.assert_array_equal(r["generate"], want)
        cache = r["cache"][kind]["attn"]
        rows = 4 // mesh[0]
        if cfg.mla is not None:
            for k in ("ckv", "krope"):
                assert cache[k].shape == (1, rows) + tuple(
                    one[kind]["attn"][k].shape[2:])
        else:
            assert cache["k"].nbytes * mesh[1] * mesh[0] == \
                one[kind]["attn"]["k"].numel() * 4


@pytest.mark.parametrize("arch,kw", [("grok-1-314b", {"n_experts": 2}),
                                     ("deepseek-v3-671b", {})],
                         ids=["expert-tp", "expert-parallel"])
def test_each_rank_holds_exactly_its_blocks(world, arch, kw):
    """(5) ``lm_init(mesh=)`` on (1, 4): every leaf is this rank's block of
    one process's ``lm_init`` with the same seed, bitwise (each expert
    drawn from a generator of its own; ω of a bank block the whole
    bank's), the ZeRO-1 state's moments the same blocks, and each rank's
    freeze its blocks of one process's codes."""
    cfg = _no_drops(get_config(arch).smoke(), **kw)
    params = T.lm_init(cfg, seed=6, device="cpu")
    whole = _flat(convert.tree_to_numpy(params))
    mesh = tmesh.MeshSpec((1, 4), tmesh.AXES)
    meta = T.lm_init(cfg, device="meta")
    specs = _spec_leaves(tsh.layout_specs(meta, cfg, mesh))
    res = world.run(ranks.tp_blocks, cfg, 6, (1, 4))
    for r in res:
        i = r["coords"]["model"]
        assert sorted(r["params"]) == sorted(whole)
        for name, t in r["params"].items():
            np.testing.assert_array_equal(t, _block(whole[name], specs[name],
                                                    i, 4), err_msg=name)
            assert r["m"][name] == t.shape, name
        bank = r["params"]["/stacks/moe/moe/experts/down/w"]
        full = whole["/stacks/moe/moe/experts/down/w"]
        assert bank.size * 4 == full.size
    one = _flat(convert.tree_to_numpy(qat.freeze_tree(
        params, qat.build_qstate(params), cfg.lam)))
    fspecs = _spec_leaves(tsh.layout_specs(qat.freeze_tree(
        meta, qat.build_qstate(meta), cfg.lam), cfg, mesh))
    for r in res:
        i = r["coords"]["model"]
        for name, t in _flat(r["frozen"]).items():
            np.testing.assert_array_equal(
                t, _block(one[name], fspecs[name], i, 4), err_msg=name)


def test_a_share_over_a_tensor_parallel_mesh_raises():
    """The layout decides which experts a rank holds: a config naming its
    own share (``experts_held``) raises there; over model = 1 a share
    keeps its banks."""
    cfg = get_config("grok-1-314b").smoke()
    mesh = tmesh.MeshSpec((1, 4), tmesh.AXES)
    with pytest.raises(ValueError, match="the layout decides"):
        tsh.tensor_parallel(dataclasses.replace(cfg, experts_held=(0, 1)),
                            mesh)
    assert not tsh.tensor_parallel(
        dataclasses.replace(cfg, experts_held=(0, 2)),
        tmesh.MeshSpec((4, 1), tmesh.AXES))
