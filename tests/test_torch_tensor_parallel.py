"""Tensor parallelism over the 'model' axis for the dense family
(``repro_torch.runtime.sharding.layout_specs`` / ``dense_tp``, the
sharded ``lm_apply``, the vocabulary-parallel loss and greedy step, and
EC4T on a rank's blocks) on a gloo world of 4 CPU ranks, against the JAX
package.

The port's layout is the reference's ``Rules.param_specs``, leaf for
leaf, on every dense config at published and smoke widths; its ZeRO-1
moment specs are ``Rules.opt_specs`` and its cache specs
``Rules.cache_specs``; ``_attn_batch_reshard`` is the reference's
predicate.  Over meshes (2, 2) (tp 2: the heads divide, so attention is
head-sharded) and (1, 4) (the smoke configs' 2 KV heads do not divide 4:
sequence-parallel attention at seq 16) the gathered fp32 logits of the
JAX package's ``lm_init`` tree, cut by ``convert.shard_from_numpy``, are
within 1e-5 of its single-device ``lm_apply``; one EC4T step with ZeRO-1
is held to the JAX single-device step (loss ``rtol=1e-4``, gathered
gradients within 1e-4 of each leaf's largest, params within the
reference test's ``atol=rtol=5e-3``) and its probabilities are bitwise one
process's ``update_qstate`` of the same params; a frozen tree's greedy
tokens equal one process's and each rank's KV cache is its slice of one
process's; each rank holds exactly its block of every sharded leaf.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_configs
from repro.core import qat as jqat
from repro.launch import specs as jspecs
from repro.models import lm as jlm
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

DENSE = ("smollm-360m", "h2o-danube-1.8b", "codeqwen1.5-7b", "glm4-9b")
SPEC_MESHES = [(1, 2), (1, 4), (2, 2), (2, 4)]
LR = 1e-3


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


def _jax_trees(arch, smoke):
    """The reference's abstract params, frozen tree (smoke widths only)
    and cache."""
    cfg = jget_config(arch)
    cfg = cfg.smoke() if smoke else cfg
    a = jspecs.abstract_params(cfg)
    frozen = jax.eval_shape(functools.partial(jqat.freeze_tree, lam=cfg.lam),
                            a, jax.eval_shape(jqat.build_qstate, a)) \
        if smoke else None
    cache = jax.eval_shape(functools.partial(JT.init_cache, cfg, 4, 16))
    return cfg, a, frozen, cache


@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
@pytest.mark.parametrize("arch", DENSE)
def test_layout_is_the_references_rules(arch, smoke):
    """(1) params, ZeRO-1 moments and the KV cache (and the frozen tree at
    smoke widths)."""
    jcfg, a, frozen, cache = _jax_trees(arch, smoke)
    cfg = get_config(arch).smoke() if smoke else get_config(arch)
    mine = T.lm_init(cfg, device="meta")
    mine_frozen = qat.freeze_tree(mine, qat.build_qstate(mine), cfg.lam)
    mine_cache = T.init_cache(cfg, 4, 16, dtype=torch.float32, device="meta")
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
        if frozen is not None:
            assert _spec_leaves(tsh.layout_specs(mine_frozen, cfg, mesh)) \
                == _spec_leaves(_ptuple(rules.param_specs(frozen))), shape
        assert _spec_leaves(tsteps._cache_specs(
            tsteps.make_rules(cfg, mesh), mine_cache, cfg, mesh)) == \
            _spec_leaves(_ptuple(rules.cache_specs(cache))), shape
        # the replica axes and the ZeRO-1 cut of a rank's leaves follow
        axes = _flat(tsh.replica_axes(mine, mesh, specs))
        z = _spec_leaves(tsh.zero1_specs(mine, mesh, specs))
        for name, spec in got.items():
            cut = {x for x in spec if x is not None}
            assert axes[name] == frozenset(tmesh.AXES) - cut, name
            assert "model" not in z[name], name


def test_attn_batch_reshard_is_the_references_predicate():
    """(2) every config x tp x seq."""
    for arch in list_configs():
        jcfg, cfg = jget_config(arch), get_config(arch)
        assert T._attn_batch_reshard(cfg, None, 16) is False
        for tp in (1, 2, 4, 8, 16):
            mesh = tmesh.MeshSpec((2, tp), tmesh.AXES)
            for seq in (15, 16, 64):
                assert T._attn_batch_reshard(cfg, mesh, seq) == \
                    JT._attn_batch_reshard(jcfg, mesh, seq), (arch, tp, seq)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed):
    cfg = jget_config(arch).smoke()
    return cfg, JT.lm_init(jax.random.PRNGKey(seed), cfg)


FORWARD = [("h2o-danube-1.8b", (2, 2), False), ("h2o-danube-1.8b", (1, 4),
                                                 True),
           ("smollm-360m", (2, 2), False), ("smollm-360m", (1, 4), True),
           ("codeqwen1.5-7b", (1, 4), False)]


@pytest.mark.parametrize("arch,mesh,reshard", FORWARD)
def test_forward_matches_the_single_device_lm_apply(world, arch, mesh,
                                                    reshard):
    """(3) head-sharded (tp 2; codeqwen's 4 heads and QKV bias at tp 4) and
    sequence-parallel (2 KV heads at tp 4) forwards."""
    jcfg, params = _jax_params(arch, 0)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 16)
                                               ).astype(np.int32)
    want, _, _ = JT.lm_apply(params, 0, jnp.asarray(tokens),
                             JQuantCtx(compute_dtype=jnp.float32), jcfg)
    want = np.asarray(want)
    res = world.run(ranks.tp_forward, get_config(arch).smoke(),
                    jax.tree_util.tree_map(np.asarray, params), tokens, mesh)
    for r in res:
        assert r["reshard"] is reshard
        assert r["local_vocab"] == jcfg.padded_vocab // mesh[1]
        np.testing.assert_allclose(r["logits"], want, atol=1e-5, rtol=0)


def test_sequence_parallel_attention_with_whole_weights(world):
    """Weights a layout keeps whole (q / k / v: 2 KV heads do not divide
    4), and the reference's predicate runs their attention
    sequence-parallel: qwen2-vl's smoke config (vlm: patch embeddings,
    M-RoPE cos / sin cut with the rows; o, the FFN and the vocabulary cut
    since the vlm family takes the layout) over (1, 4) at seq 16, against
    one process."""
    cfg = get_config("qwen2-vl-2b").smoke()
    params = T.lm_init(cfg, seed=8, device="cpu")
    embeds = np.random.default_rng(9).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        want, _, _ = T.lm_apply(params, 0, None, FP32_CTX, cfg,
                                embeds=torch.from_numpy(embeds))
    res = world.run(ranks.tp_forward, cfg, convert.tree_to_numpy(params),
                    None, (1, 4), embeds=embeds)
    for r in res:
        assert r["reshard"] and r["local_vocab"] == cfg.padded_vocab // 4
        np.testing.assert_allclose(r["logits"], want.numpy(), atol=1e-5,
                                   rtol=0)


def _perturbed_state(jcfg, seed):
    """The JAX train state with ω and the probabilities moved off their
    init (as test_torch_mesh_training.py's)."""
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


@pytest.fixture(scope="module")
def danube_step():
    """h2o-danube's smoke state, a global batch of 8 x 16, and the JAX
    package's single-device fp32 step's loss, gradients and params."""
    arch = "h2o-danube-1.8b"
    jcfg = jget_config(arch).smoke()
    state = _perturbed_state(jcfg, 2)
    batch = lm_batch_fn(get_config(arch).smoke(), batch=8, seq=16)(0)

    def jloss(p, qs, b, lam):
        ctx = JQuantCtx(quant=True, lam=lam, compute_dtype=jnp.float32)
        return jlm.lm_forward_loss(p, qs, b, ctx, jcfg)
    grads = jax.jit(jax.grad(lambda p: jloss(p, state["qstate"], batch,
                                             jcfg.lam)[0]))(state["params"])
    new, m = jax.jit(jec4t.make_train_step(jloss, jadam.AdamConfig(lr=LR),
                                           lam=jcfg.lam))(state, batch)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return {"cfg": get_config(arch).smoke(), "np": to_np(state),
            "batch": batch, "loss": float(m["loss"]),
            "grads": _flat(to_np(grads)), "params": _flat(to_np(
                new["params"]))}


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_ec4t_step_matches_the_single_device_step(world, danube_step, mesh,
                                                  tmp_path):
    """(4) one step with ZeRO-1: the JAX step's gates; the probabilities
    bitwise one process's update of the same params."""
    d = danube_step
    res = world.run(ranks.dp_train, d["cfg"], mesh, [d["batch"]],
                    params=d["np"]["params"], qstate=d["np"]["qstate"],
                    lr=LR, grads=True, out_dir=str(tmp_path),
                    runs=[{"zero1": True, "state": True,
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


def _cache_slice(cache, coords, mesh, b):
    """One process's cache cut to a rank's rows (data) and KV heads."""
    rows = b // mesh[0]
    r0 = coords["data"] * rows

    def cut(name, t):
        if name.endswith(("/k", "/v")):
            heads = t.shape[3] // mesh[1]
            h0 = coords["model"] * heads
            return t[:, r0:r0 + rows, :, h0:h0 + heads]
        return t
    return {n: cut(n, t) for n, t in ranks.named_leaves(cache)}


def test_frozen_tree_serves_the_single_process_tokens(world):
    """(5) prefill + 4 decode steps over (2, 2) (tp 2: the cache is
    head-sharded)."""
    cfg = get_config("h2o-danube-1.8b").smoke()
    params = T.lm_init(cfg, seed=4, device="cpu")
    frozen = qat.freeze_tree(params, qat.build_qstate(params), cfg.lam)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, (4, 6)
                                               ).astype(np.int32)
    new = 5
    want = LM.generate(frozen, 0, torch.from_numpy(prompt), FP32_CTX, cfg,
                       max_new=new).numpy()
    # one process's cache after the same steps
    b, s = prompt.shape
    cache = T.init_cache(cfg, b, s + new, dtype=torch.float32, device="cpu")
    x = torch.from_numpy(prompt)
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    with torch.no_grad():
        nxt, cache = LM.greedy_step(frozen, 0, x, FP32_CTX, cfg,
                                    positions=pos, cache=cache)
        for t in range(new - 1):
            nxt, cache = LM.greedy_step(
                frozen, 0, nxt, FP32_CTX, cfg, cache=cache,
                positions=torch.full((b, 1), s + t, dtype=torch.int32))
    one = convert.tree_to_numpy(cache)
    res = world.run(ranks.tp_serve, cfg, convert.tree_to_numpy(frozen),
                    prompt, new, (2, 2))
    for r in res:
        np.testing.assert_array_equal(r["tokens"], want)
        np.testing.assert_array_equal(r["generate"], want)
        mine = dict(ranks.named_leaves(r["cache"]))
        theirs = _cache_slice(one, r["coords"], (2, 2), b)
        assert sorted(mine) == sorted(theirs)
        for name, t in theirs.items():
            assert mine[name].shape == t.shape, name
            np.testing.assert_allclose(mine[name], t, atol=1e-5, rtol=1e-5,
                                       err_msg=name)
        k = mine["/dense/attn/k"]
        assert k.nbytes * 4 == one["dense"]["attn"]["k"].nbytes


def test_each_rank_holds_exactly_its_blocks(world):
    """(6) ``lm_init(mesh=)`` on (1, 4): every sharded leaf is this rank's
    block of the one-process tree (values and size), no whole copy; the
    ZeRO-1 state's moments are the same blocks; each rank's freeze is its
    blocks of one process's, bitwise."""
    cfg = get_config("h2o-danube-1.8b").smoke()
    whole = _flat(convert.tree_to_numpy(T.lm_init(cfg, seed=6,
                                                  device="cpu")))
    mesh = tmesh.MeshSpec((1, 4), tmesh.AXES)
    specs = _spec_leaves(tsh.layout_specs(T.lm_init(cfg, device="meta"),
                                          cfg, mesh))
    res = world.run(ranks.tp_blocks, cfg, 6, (1, 4))
    cut = 0
    for r in res:
        i = r["coords"]["model"]
        assert sorted(r["params"]) == sorted(whole)
        for name, t in r["params"].items():
            spec, w = specs[name], whole[name]
            index = tuple(slice(None) if a is None else slice(
                i * (n // 4), (i + 1) * (n // 4))
                for a, n in zip(spec, w.shape))
            np.testing.assert_array_equal(t, w[index], err_msg=name)
            if any(a is not None for a in spec):
                assert t.size * 4 == w.size, name
                cut += 1
            assert r["m"][name] == t.shape, name
    # embed, head, o, gate, up, down (2 KV heads: q, k, v whole at tp 4)
    assert cut == 4 * 6
    # each rank's freeze (mean(w²) and the probabilities over 'model'):
    # its blocks of one process's codes, bitwise
    params = T.lm_init(cfg, seed=6, device="cpu")
    one = _flat(convert.tree_to_numpy(qat.freeze_tree(
        params, qat.build_qstate(params), cfg.lam)))
    fspecs = _spec_leaves(tsh.layout_specs(qat.freeze_tree(
        T.lm_init(cfg, device="meta"), qat.build_qstate(
            T.lm_init(cfg, device="meta")), cfg.lam), cfg, mesh))
    for r in res:
        i = r["coords"]["model"]
        for name, t in _flat(r["frozen"]).items():
            w = one[name]
            index = tuple(slice(None) if a is None else slice(
                i * (n // 4), (i + 1) * (n // 4))
                for a, n in zip(fspecs[name], w.shape))
            np.testing.assert_array_equal(t, w[index], err_msg=name)


def test_row_parallel_bias_is_added_once(world):
    """A row-sharded projection's bias (``mlp//fc2//bias``, replicated)
    is added once, after the sum over 'model'."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    res = world.run(ranks.row_parallel_linear, x, w, b, (1, 4))
    for r in res:
        np.testing.assert_allclose(r["y"], x @ w + b, atol=1e-5, rtol=1e-5)


def test_dry_run_counts_a_ranks_share_and_its_model_exchanges():
    """The dry run on a (1, 4) shape-only mesh: the bundle's arguments are
    rank 0's blocks, and the step's all-reduces and gathers over 'model'
    are counted (``ShapeMesh.bytes_over``)."""
    from repro_torch.launch import op_analysis
    from repro_torch.launch.mesh import ShapeMesh
    cfg = get_config("smollm-360m").smoke()
    mesh = ShapeMesh((1, 4))
    b = tsteps.build_train_step(cfg, mesh, remat="none", zero1=False,
                                dtype=torch.float32)
    assert b.describe()["layout"] == "tensor parallel"
    assert tsteps.build_train_step(cfg, ShapeMesh((4, 1))).describe()[
        "layout"] == "replicated"
    params = b.args[0]["params"]
    assert tuple(params["stacks"]["dense"]["mlp"]["gate"]["kernel"]["w"]
                 .shape) == (cfg.n_layers, cfg.d_model, cfg.d_ff // 4)
    assert tuple(params["embed"]["table"].shape) == \
        (cfg.padded_vocab // 4, cfg.d_model)
    assert b.in_specs[0]["params"]["embed"]["table"] == ("model", None)
    batch = {k: torch.empty((8, 16), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    op_analysis.analyze(b.fn, b.args[0], batch)
    over = mesh.bytes_over("model")
    # 2 kv heads at tp 4, seq 16: sequence-parallel attention gathers K,
    # V and the output; the FFN and the vocabulary all-reduce
    assert over["all-gather"] > 0 and over["all-reduce"] > 0
    assert over == {k: v for k, v in mesh.collectives.items()
                    if k in over}
