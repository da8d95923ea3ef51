"""Tensor parallelism over the 'model' axis for the ssm, hybrid and vlm
families (mamba2-1.3b: attention-free SSD blocks; hymba-1.5b: attention
and an SSD block side by side, then an MLP; qwen2-vl-2b: a dense stack fed
patch embeddings, M-RoPE) on a gloo world of 4 CPU ranks, against the JAX
package.

The port's layout (``repro_torch.runtime.sharding.layout_specs`` /
``model_tp``) is the reference's ``Rules.param_specs``, leaf for leaf, at
published and smoke widths on meshes (1, 2) (1, 4) (2, 2) (2, 4); its
ZeRO-1 moment specs are ``Rules.opt_specs``, its cache specs
``Rules.cache_specs`` and ``init_cache(mesh=)`` holds exactly their
blocks (the SSM state cut on its heads where they divide).  An SSD block
runs in one of two modes: "heads" (the state and the scan cut on heads)
or "rows" (only in_proj's and out_proj's rows cut, the scan whole on each
rank).  At smoke widths the gathered fp32 logits of the JAX package's
``lm_init`` tree, cut by ``convert.shard_from_numpy``, are within 1e-5 of
its single-device ``lm_apply``; one hymba EC4T step (ZeRO-1 on (2, 2)) is
held to the JAX single-device step (loss ``rtol=1e-4``, gathered
gradients within 1e-4 of each leaf's largest, params within
``atol=rtol=5e-3``) and its probabilities are bitwise one process's
``update_qstate`` of the same params.  A frozen tree's greedy tokens
equal one process's, each rank's SSM state its heads of one process's;
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
from repro.nn import transformer as JT
from repro.nn.module import QuantCtx as JQuantCtx
from repro.optim import adam as jadam
from repro.optim import ec4t as jec4t
from repro.runtime import sharding as jsh
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import qat
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import op_analysis, ranks
from repro_torch.launch import specs as tspecs
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import lm_batch_fn
from repro_torch.models import lm as LM
from repro_torch.nn import transformer as T
from repro_torch.nn.module import FP32_CTX
from repro_torch.runtime import sharding as tsh

SPEC_MESHES = [(1, 2), (1, 4), (2, 2), (2, 4)]
LR = 1e-3
# (arch, config overrides): mamba2's smoke heads are 8 of 16 dims; with
# ssm_headdim 64 it has 2, which 4 does not divide ("rows" at tp 4)
ROWS = ("mamba2-1.3b", {"ssm_headdim": 64})


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


def _configs(arch, smoke, kw=None):
    """Both packages' configs of ``arch`` (smoke widths or published),
    with ``kw`` replaced in each."""
    pair = (jget_config(arch), get_config(arch))
    if smoke:
        pair = tuple(c.smoke() for c in pair)
    return tuple(dataclasses.replace(c, **(kw or {})) for c in pair)


def _block(w, spec, i, tp):
    """Model rank ``i``'s block of ``w`` under ``spec`` (its 'model' cuts
    only)."""
    return w[tuple(slice(i * (n // tp), (i + 1) * (n // tp))
                   if a == "model" else slice(None)
                   for a, n in zip(spec, w.shape))]


# the mode each SSD block takes at each tp: mamba2's 64 heads divide 2
# and 4; hymba's 50 divide 2 only; the smoke configs' 8 divide both, 2
# (headdim 64) 2 only
MODES = {("mamba2-1.3b", "rows"): {2: "heads", 4: "rows"},
         ("mamba2-1.3b", False): {2: "heads", 4: "heads"},
         ("hymba-1.5b", False): {2: "heads", 4: "rows"},
         ("qwen2-vl-2b", False): {2: None, 4: None},
         ("mamba2-1.3b", True): {2: "heads", 4: "heads"},
         ("hymba-1.5b", True): {2: "heads", 4: "heads"},
         ("qwen2-vl-2b", True): {2: None, 4: None}}
LAYOUTS = [(a, s, {}) for a in ("mamba2-1.3b", "hymba-1.5b", "qwen2-vl-2b")
           for s in (False, True)] + [(ROWS[0], True, ROWS[1])]


@pytest.mark.parametrize("arch,smoke,kw", LAYOUTS, ids=[
    f"{a}-{'smoke' if s else 'published'}{'-rows' if kw else ''}"
    for a, s, kw in LAYOUTS])
def test_layout_is_the_references_rules(arch, smoke, kw):
    """(1) params, ZeRO-1 moments, the frozen tree's ``//packed`` row pairs
    (smoke widths), the cache specs and ``init_cache(mesh=)``'s blocks,
    the replica axes, the ZeRO-1 cut of a rank's leaves and the mode."""
    jcfg, cfg = _configs(arch, smoke, kw)
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
        assert tsteps.layout_name(cfg, mesh) == "tensor parallel"
        specs = tsh.layout_specs(mine, cfg, mesh)
        got = _spec_leaves(specs)
        assert got == _spec_leaves(_ptuple(rules.param_specs(a))), shape
        assert _spec_leaves(tsh.opt_specs(mine, mesh, specs)) == \
            _spec_leaves(_ptuple(rules.opt_specs(a))), shape
        if smoke:
            assert _spec_leaves(tsh.layout_specs(mine_frozen, cfg, mesh)) \
                == _spec_leaves(_ptuple(rules.param_specs(frozen))), shape
        cspecs = _spec_leaves(_ptuple(rules.cache_specs(jcache)))
        assert _spec_leaves(tsteps._cache_specs(
            tsteps.make_rules(cfg, mesh), mine_cache, cfg, mesh)) == \
            cspecs, shape
        # a rank's cache: every 'model' cut of the reference's specs (the
        # batch is the caller's rows)
        rank_cache = _flat(T.init_cache(cfg, 4, 16, dtype=torch.float32,
                                        device="meta", mesh=mesh))
        for name, t in _flat(mine_cache).items():
            want = tuple(n // shape[1] if a == "model" else n
                         for a, n in zip(cspecs[name], t.shape))
            assert tuple(rank_cache[name].shape) == want, (shape, name)
        axes = _flat(tsh.replica_axes(mine, mesh, specs))
        z = _spec_leaves(tsh.zero1_specs(mine, mesh, specs))
        for name, spec in got.items():
            cut = {x for x in spec if x is not None}
            assert axes[name] == frozenset(tmesh.AXES) - cut, name
            assert "model" not in z[name], name
        mode = ranks.ssm_mode(tsh.model_tp(cfg, mesh))
        assert mode == MODES[arch, "rows" if kw else smoke][shape[1]], shape


def test_an_attention_free_arch_names_no_attention_or_ffn_cut():
    """mamba2's config has no heads and no FFN (n_heads = d_ff = 0 at
    published widths): ``model_tp`` names its SSM cuts only and raises
    nothing; groups that do not split with the heads raise."""
    for cfg in (get_config("mamba2-1.3b"), get_config("mamba2-1.3b").smoke()):
        for shape in ((1, 2), (1, 4), (4, 16)):
            tp = tsh.model_tp(cfg, tmesh.MeshSpec(shape, tmesh.AXES))
            assert (tp.heads, tp.o_rows, tp.mlp, tp.shared, tp.experts) == \
                (False, False, False, False, None)
            assert tp.vocab and tp.ssm_in and tp.ssm_out
    tp16 = tsh.model_tp(get_config("mamba2-1.3b"),
                        tmesh.MeshSpec((16, 16), tmesh.AXES))
    assert tp16.ssm_heads      # 64 heads over 16
    assert not tsh.model_tp(get_config("mamba2-1.3b").smoke(),
                            tmesh.MeshSpec((16, 16), tmesh.AXES)).ssm_heads
    grouped = dataclasses.replace(get_config("mamba2-1.3b").smoke(),
                                  ssm_groups=2)
    with pytest.raises(ValueError, match="groups do not split"):
        tsh.model_tp(grouped, tmesh.MeshSpec((1, 4), tmesh.AXES))
    assert tsh.model_tp(grouped, tmesh.MeshSpec((2, 2), tmesh.AXES)
                        ).ssm_heads


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed, **kw):
    jcfg, _ = _configs(arch, True, kw)
    return jcfg, JT.lm_init(jax.random.PRNGKey(seed), jcfg)


FORWARD = [("mamba2-1.3b", (1, 4), {}, "heads", False),
           (ROWS[0], (1, 4), ROWS[1], "rows", False),
           ("hymba-1.5b", (1, 4), {}, "heads", True),
           ("hymba-1.5b", (2, 2), {}, "heads", False),
           ("qwen2-vl-2b", (1, 4), {}, None, True),
           ("qwen2-vl-2b", (2, 2), {}, None, False)]


@pytest.mark.parametrize("arch,mesh,kw,mode,reshard", FORWARD,
                         ids=["mamba2-heads", "mamba2-rows", "hymba-seq",
                              "hymba-heads", "qwen2-vl-o", "qwen2-vl-heads"])
def test_forward_matches_the_single_device_lm_apply(world, arch, mesh, kw,
                                                    mode, reshard):
    """(2) both SSD modes, hymba's attention sequence-parallel (2 KV heads
    at tp 4) or head-sharded, qwen2-vl's patch embeddings (whole on every
    rank) with o alone cut (tp 4) or every head (tp 2)."""
    jcfg, params = _jax_params(arch, 0, **kw)
    _, cfg = _configs(arch, True, kw)
    rng = np.random.default_rng(1)
    tokens = embeds = None
    if cfg.family == "vlm":
        embeds = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    else:
        tokens = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    want, _, _ = JT.lm_apply(
        params, 0, None if tokens is None else jnp.asarray(tokens),
        JQuantCtx(compute_dtype=jnp.float32), jcfg,
        embeds=None if embeds is None else jnp.asarray(embeds))
    want = np.asarray(want)
    res = world.run(ranks.tp_forward, cfg,
                    jax.tree_util.tree_map(np.asarray, params), tokens, mesh,
                    embeds=embeds)
    for r in res:
        assert r["ssm"] == mode and r["reshard"] is reshard
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


@pytest.fixture(scope="module")
def hymba_step():
    """hymba's smoke state, a global batch of 8 x 16, and the JAX
    package's single-device fp32 step's loss, gradients and params (one
    jitted function)."""
    jcfg, cfg = _configs("hymba-1.5b", True)
    state = _perturbed_state(jcfg, 2)
    batch = lm_batch_fn(cfg, batch=8, seq=16)(0)

    def jloss(p, qs, b, lam):
        ctx = JQuantCtx(quant=True, lam=lam, compute_dtype=jnp.float32)
        return jlm.lm_forward_loss(p, qs, b, ctx, jcfg)
    step = jec4t.make_train_step(jloss, jadam.AdamConfig(lr=LR),
                                 lam=jcfg.lam)

    @jax.jit
    def both(st, b):
        grads = jax.grad(lambda p: jloss(p, st["qstate"], b, jcfg.lam)[0])(
            st["params"])
        return grads, step(st, b)
    grads, (new, m) = both(state, batch)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return {"cfg": cfg, "np": to_np(state), "batch": batch,
            "loss": float(m["loss"]), "grads": _flat(to_np(grads)),
            "params": _flat(to_np(new["params"]))}


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_ec4t_step_matches_the_single_device_step(world, hymba_step, mesh,
                                                  tmp_path):
    """(3) one hymba step (ZeRO-1 on (2, 2)): the JAX step's gates; the
    probabilities bitwise one process's update of the same params; no
    kernel launch on the CPU."""
    d = hymba_step
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


def _one_process_cache(frozen, prompt, cfg, new):
    """One process's cache after the prefill and ``new - 1`` greedy steps
    (numpy)."""
    b, s = prompt.shape
    cache = T.init_cache(cfg, b, s + new, dtype=torch.float32, device="cpu")
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    with torch.no_grad():
        nxt, cache = LM.greedy_step(frozen, 0, torch.from_numpy(prompt),
                                    FP32_CTX, cfg, positions=pos, cache=cache)
        for t in range(new - 1):
            nxt, cache = LM.greedy_step(
                frozen, 0, nxt, FP32_CTX, cfg, cache=cache,
                positions=torch.full((b, 1), s + t, dtype=torch.int32))
    return _flat(convert.tree_to_numpy(cache))


@pytest.mark.parametrize("arch,mesh", [("mamba2-1.3b", (1, 4)),
                                       ("hymba-1.5b", (2, 2))])
def test_frozen_tree_serves_the_single_process_tokens(world, arch, mesh):
    """(4) prefill + 4 decode steps (``ssm_step`` on a rank's heads of the
    state) from each rank's blocks of one frozen tree: the tokens, and
    each rank's cache its rows and heads of one process's (mamba2's state
    a quarter, hymba's state and KV heads a half; the conv tails whole)."""
    cfg = get_config(arch).smoke()
    params = T.lm_init(cfg, seed=4, device="cpu")
    frozen = qat.freeze_tree(params, qat.build_qstate(params), cfg.lam)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, (4, 6)
                                               ).astype(np.int32)
    new = 5
    want = LM.generate(frozen, 0, torch.from_numpy(prompt), FP32_CTX, cfg,
                       max_new=new).numpy()
    one = _one_process_cache(frozen, prompt, cfg, new)
    cspecs = _spec_leaves(tsteps._cache_specs(
        tsteps.make_rules(cfg, tmesh.MeshSpec(mesh, tmesh.AXES)),
        T.init_cache(cfg, 4, 6 + new, device="meta"), cfg,
        tmesh.MeshSpec(mesh, tmesh.AXES)))
    res = world.run(ranks.tp_serve, cfg, convert.tree_to_numpy(frozen),
                    prompt, new, mesh)
    rows = 4 // mesh[0]
    for r in res:
        np.testing.assert_array_equal(r["tokens"], want)
        np.testing.assert_array_equal(r["generate"], want)
        mine = _flat(r["cache"])
        assert sorted(mine) == sorted(one)
        d = r["coords"]["data"]
        for name, t in one.items():
            if t.ndim >= 4:          # batched: (L, B, ...)
                t = t[:, d * rows:(d + 1) * rows]
            theirs = _block(t, cspecs[name], r["coords"]["model"], mesh[1])
            np.testing.assert_allclose(mine[name], theirs, atol=1e-5,
                                       rtol=1e-5, err_msg=name)
        kind = cfg.family
        assert mine[f"/{kind}/ssm/ssm"].nbytes * mesh[1] * mesh[0] == \
            one[f"/{kind}/ssm/ssm"].nbytes
        assert mine[f"/{kind}/ssm/conv"].nbytes * mesh[0] == \
            one[f"/{kind}/ssm/conv"].nbytes


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b", "qwen2-vl-2b"])
def test_each_rank_holds_exactly_its_blocks(world, arch):
    """(5) ``lm_init(mesh=)`` on (1, 4): every leaf is this rank's block of
    one process's ``lm_init`` with the same seed, bitwise, the ZeRO-1
    state's moments the same blocks, and each rank's freeze its blocks of
    one process's codes."""
    cfg = get_config(arch).smoke()
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
    one = _flat(convert.tree_to_numpy(qat.freeze_tree(
        params, qat.build_qstate(params), cfg.lam)))
    fspecs = _spec_leaves(tsh.layout_specs(qat.freeze_tree(
        meta, qat.build_qstate(meta), cfg.lam), cfg, mesh))
    for r in res:
        i = r["coords"]["model"]
        frozen = _flat(r["frozen"])
        assert sorted(frozen) == sorted(one)
        for name, t in frozen.items():
            np.testing.assert_array_equal(
                t, _block(one[name], fspecs[name], i, 4), err_msg=name)


def test_dry_run_of_a_sub_quadratic_decode_counts_its_model_exchanges(
        monkeypatch):
    """The long_500k decode step (cut to a 64-deep cache) of hymba's smoke
    config on a (1, 4) shape-only mesh: rank 0's blocks, its heads of the
    SSM state, and the all-reduces over 'model' counted."""
    monkeypatch.setattr(tspecs, "SHAPES", {
        **tspecs.SHAPES, "long_500k": dict(tspecs.SHAPES["long_500k"],
                                           seq=64)})
    cfg = get_config("hymba-1.5b").smoke()
    mesh = tmesh.ShapeMesh((1, 4))
    b = tsteps.build_step(cfg, mesh, "long_500k")
    assert b.describe()["layout"] == "tensor parallel"
    params, batch = b.args
    assert tuple(params["stacks"]["hybrid"]["ssm"]["in_proj"]["kernel"][
        "packed"].shape[1:]) == (cfg.d_model // 8, 2 * cfg.d_inner + 2
                                 * cfg.ssm_state + cfg.ssm_heads)
    assert batch["cache"]["hybrid"]["ssm"]["ssm"].shape[2] == \
        cfg.ssm_heads // 4
    op_analysis.analyze(b.fn, *b.args)
    over = mesh.bytes_over("model")
    assert over["all-reduce"] > 0
