"""Tensor parallelism over the 'model' axis for the audio family
(whisper-base: the encoder-decoder with cross-attention) on a gloo world
of 4 CPU ranks, against the JAX package.

The port's layout (``repro_torch.runtime.sharding.layout_specs`` /
``model_tp``) is the reference's ``Rules.param_specs`` of the JAX whisper
tree, leaf for leaf, at published and smoke widths on meshes (1, 2)
(1, 4) (2, 2) (2, 4) and (16, 16), where whisper's 8 heads do not divide
and attention stays whole while fc1, fc2 and the vocabulary are cut; its
ZeRO-1 moment specs are ``Rules.opt_specs``, its self-attention cache
specs ``Rules.cache_specs`` and ``init_dec_cache(mesh=)`` holds their
blocks.  The cross K/V is cut on its heads, where the reference's
``cache_specs`` names no cut (a documented difference).  At smoke widths
(vocabulary 250, padded to 256, so that the padded rows are masked by
their global index) the gathered fp32 encoder states, cross K/V and
logits of the JAX ``whisper_init`` tree, cut by
``convert.shard_from_numpy``, are within 1e-5 of the JAX single-device
``whisper_encode``, ``precompute_cross`` and ``whisper_decode``; one EC4T
step on (1, 4) and on (2, 2) with ZeRO-1 is held to the JAX
single-device step (loss ``rtol=1e-4``, gathered gradients within 1e-4
of each leaf's largest, params ``atol=rtol=5e-3``) and its
probabilities are bitwise one process's ``update_qstate`` of the same
params.  A frozen tree's greedy tokens equal one process's, each rank's
self-attention cache and cross K/V its rows and heads of one process's;
``whisper_init(mesh=)`` holds exactly a rank's blocks of one process's
``whisper_init``, bitwise, and each rank's freeze its blocks of one
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
from repro.models import whisper as JW
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
from repro_torch.models import whisper as W
from repro_torch.nn.module import FP32_CTX
from repro_torch.runtime import sharding as tsh

ARCH = "whisper-base"
SPEC_MESHES = [(1, 2), (1, 4), (2, 2), (2, 4), (16, 16)]
LR = 1e-3
VOCAB = 250          # padded to 256: the readout masks 6 rows of a block
JCTX = JQuantCtx(compute_dtype=jnp.float32)


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


def _configs(smoke, **kw):
    pair = (jget_config(ARCH), get_config(ARCH))
    if smoke:
        pair = tuple(c.smoke() for c in pair)
    return tuple(dataclasses.replace(c, **kw) for c in pair)


def _block(w, spec, i, tp):
    """Model rank ``i``'s block of ``w`` under ``spec`` (its 'model' cuts
    only)."""
    return w[tuple(slice(i * (n // tp), (i + 1) * (n // tp))
                   if a == "model" else slice(None)
                   for a, n in zip(spec, w.shape))]


@pytest.mark.parametrize("smoke", [False, True],
                         ids=["published", "smoke"])
def test_layout_is_the_references_rules(smoke):
    """(1) params, ZeRO-1 moments, the frozen tree's ``//packed`` row pairs
    (smoke), the self-attention cache's specs and ``init_dec_cache(mesh=)``
    blocks, the cross K/V's head cut, the replica axes and ZeRO-1's cut of
    a rank's leaves; at (16, 16) the 8 heads stay whole."""
    jcfg, cfg = _configs(smoke)
    a = jspecs.abstract_params(jcfg)
    jcache = jax.eval_shape(functools.partial(JW.init_dec_cache, jcfg, 4, 16))
    mine = W.whisper_init(cfg, device="meta")
    mine_cache = W.init_dec_cache(cfg, 4, 16, dtype=torch.float32,
                                  device="meta")
    cross = (torch.empty((cfg.n_layers, 4, cfg.enc_len, cfg.n_kv,
                          cfg.resolved_head_dim), device="meta"),) * 2
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
        tp = tsh.model_tp(cfg, mesh)
        heads = cfg.n_heads % shape[1] == 0
        assert (tp.heads, tp.o_rows, tp.mlp, tp.vocab) == \
            (heads, heads, True, True), shape
        specs = tsh.layout_specs(mine, cfg, mesh)
        got = _spec_leaves(specs)
        assert got == _spec_leaves(_ptuple(rules.param_specs(a))), shape
        assert got["/dec_layers/cross/k/kernel/w"][2] == \
            ("model" if heads else None)
        assert got["/dec_layers/mlp/fc2/bias"] == (None, None)
        assert got["/dec_pos"] == (None, None)
        assert _spec_leaves(tsh.opt_specs(mine, mesh, specs)) == \
            _spec_leaves(_ptuple(rules.opt_specs(a))), shape
        if smoke:
            assert _spec_leaves(tsh.layout_specs(mine_frozen, cfg, mesh)) \
                == _spec_leaves(_ptuple(rules.param_specs(frozen))), shape
        r = tsteps.make_rules(cfg, mesh)
        cspecs = _spec_leaves(_ptuple(rules.cache_specs(jcache)))
        assert _spec_leaves(tsteps._cache_specs(r, mine_cache, cfg, mesh)) \
            == cspecs, shape
        rank_cache = _flat(W.init_dec_cache(cfg, 4, 16, dtype=torch.float32,
                                            device="meta", mesh=mesh))
        for name, t in _flat(mine_cache).items():
            want = tuple(n // shape[1] if s == "model" else n
                         for s, n in zip(cspecs[name], t.shape))
            assert tuple(rank_cache[name].shape) == want, (shape, name)
        # the documented difference: the reference names no cut for the
        # cross tuple (leaves 0 and 1); the port cuts its heads
        jcross = rules.cache_specs(tuple(
            jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32) for t in cross))
        assert all("model" not in tuple(s) for s in jcross)
        bx = "data" if 4 % shape[0] == 0 else None
        assert tsteps._cache_specs(r, cross, cfg, mesh) == \
            ((None, bx, None, "model" if heads else None, None),) * 2
        axes = _flat(tsh.replica_axes(mine, mesh, specs))
        z = _spec_leaves(tsh.zero1_specs(mine, mesh, specs))
        for name, spec in got.items():
            cut = {x for x in spec if x is not None}
            assert axes[name] == frozenset(tmesh.AXES) - cut, name
            assert "model" not in z[name], name


@functools.lru_cache(maxsize=None)
def _jax_params(seed):
    jcfg, _ = _configs(True, vocab=VOCAB)
    return JW.whisper_init(jax.random.PRNGKey(seed), jcfg)


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_forward_matches_the_single_device_whisper(world, mesh):
    """(2) the encoder states, every layer's cross K and V (each rank its
    heads, gathered) and the decoder's logits (each rank its block of the
    vocabulary, its padded rows masked, gathered) within 1e-5 of the JAX
    single-device functions."""
    jcfg, cfg = _configs(True, vocab=VOCAB)
    params = _jax_params(0)
    rng = np.random.default_rng(1)
    frames = rng.normal(size=(2, cfg.enc_len, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, VOCAB, (2, 6)).astype(np.int32)
    enc = JW.whisper_encode(params, 0, jnp.asarray(frames), JCTX, jcfg)
    cross = JW.precompute_cross(params, 0, enc, JCTX, jcfg)
    logits, _ = JW.whisper_decode(params, 0, jnp.asarray(tokens), cross,
                                  JCTX, jcfg)
    res = world.run(ranks.whisper_tp_forward, cfg,
                    jax.tree_util.tree_map(np.asarray, params), frames,
                    tokens, mesh)
    for r in res:
        assert r["local_vocab"] == jcfg.padded_vocab // mesh[1]
        assert r["local_kv"] == cfg.n_kv // mesh[1]
        np.testing.assert_allclose(r["enc"], np.asarray(enc), atol=1e-5,
                                   rtol=0)
        for got, want in zip(r["cross"], cross):
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                       rtol=0)
        np.testing.assert_allclose(r["logits"], np.asarray(logits),
                                   atol=1e-5, rtol=0)
        assert (r["logits"][..., VOCAB:] == -1e30).all()


@pytest.fixture(scope="module")
def whisper_step():
    """whisper's smoke state (ω and the probabilities moved off their
    init), a global batch of 8 x (16 frames + 16 tokens), and the JAX
    package's single-device fp32 step's loss, gradients and params (one
    jitted function)."""
    jcfg, cfg = _configs(True)
    state = jec4t.init_train_state(JW.whisper_init(jax.random.PRNGKey(2),
                                                   jcfg))
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
    batch = lm_batch_fn(cfg, batch=8, seq=16)(0)

    def jloss(p, qs, b, lam):
        ctx = JQuantCtx(quant=True, lam=lam, compute_dtype=jnp.float32)
        return JW.whisper_forward_loss(p, qs, b, ctx, jcfg)
    step = jec4t.make_train_step(jloss, jadam.AdamConfig(lr=LR),
                                 lam=jcfg.lam)

    @jax.jit
    def both(st, b):
        grads = jax.grad(lambda p: jloss(p, st["qstate"], b, jcfg.lam)[0])(
            st["params"])
        return grads, step(st, b)
    grads, (new, m) = both(state, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return {"cfg": cfg, "np": to_np(state), "batch": batch,
            "loss": float(m["loss"]), "grads": _flat(to_np(grads)),
            "params": _flat(to_np(new["params"]))}


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_ec4t_step_matches_the_single_device_step(world, whisper_step, mesh,
                                                  tmp_path):
    """(3) one whisper step (ZeRO-1 on (2, 2)): the JAX step's gates; the
    probabilities bitwise one process's update of the same params; bytes
    all-reduced over 'model'; no kernel launch on the CPU."""
    d = whisper_step
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


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_frozen_tree_serves_the_single_process_tokens(world, mesh):
    """(4) the reference's serving bodies (prefill, then 4 cached decode
    steps) from each rank's blocks of one frozen tree: the tokens and the
    last logits, and each rank's self-attention cache and cross K/V its
    rows and heads of one process's."""
    cfg = dataclasses.replace(get_config(ARCH).smoke(), vocab=VOCAB)
    params = W.whisper_init(cfg, seed=4, device="cpu")
    frozen = qat.freeze_tree(params, qat.build_qstate(params), cfg.lam)
    rng = np.random.default_rng(5)
    frames = rng.normal(size=(4, cfg.enc_len, cfg.d_model)).astype(
        np.float32)
    prompt = rng.integers(0, VOCAB, (4, 4)).astype(np.int32)
    new = 5
    one, cache, cross = ranks.whisper_serve_timed(
        frozen, torch.from_numpy(frames), torch.from_numpy(prompt), cfg,
        FP32_CTX, new)
    one_cache = _flat(convert.tree_to_numpy(cache))
    r_ = tsteps.make_rules(cfg, tmesh.MeshSpec(mesh, tmesh.AXES))
    cspecs = _spec_leaves(tsteps._cache_specs(
        r_, W.init_dec_cache(cfg, 4, W.MAX_TGT, device="meta"), cfg,
        tmesh.MeshSpec(mesh, tmesh.AXES)))
    res = world.run(ranks.whisper_tp_serve, cfg,
                    convert.tree_to_numpy(frozen), frames, prompt, new, mesh)
    rows = 4 // mesh[0]
    for r in res:
        np.testing.assert_array_equal(r["tokens"], one["tokens"])
        d, i = r["coords"]["data"], r["coords"]["model"]
        mine_rows = slice(d * rows, (d + 1) * rows)
        np.testing.assert_allclose(r["logits"], one["logits"][mine_rows],
                                   atol=1e-5, rtol=0)
        mine = _flat(r["cache"])
        assert sorted(mine) == sorted(one_cache)
        for name, t in one_cache.items():
            if t.ndim >= 4:          # batched: (L, B, ...)
                t = t[:, mine_rows]
            np.testing.assert_allclose(
                mine[name], _block(t, cspecs[name], i, mesh[1]), atol=1e-5,
                rtol=1e-5, err_msg=name)
        for got, want in zip(r["cross"], cross):
            want = want.numpy()[:, mine_rows]
            np.testing.assert_allclose(
                got, _block(want, (None, None, None, "model", None), i,
                            mesh[1]), atol=1e-5, rtol=1e-5)
            assert got.nbytes * mesh[0] * mesh[1] == want.nbytes * mesh[0]


def test_each_rank_holds_exactly_its_blocks(world):
    """(5) ``whisper_init(mesh=)`` on (1, 4): every leaf is this rank's
    block of one process's ``whisper_init`` with the same seed, bitwise,
    the ZeRO-1 state's moments the same blocks, and each rank's freeze its
    blocks of one process's codes."""
    cfg = get_config(ARCH).smoke()
    params = W.whisper_init(cfg, seed=6, device="cpu")
    whole = _flat(convert.tree_to_numpy(params))
    mesh = tmesh.MeshSpec((1, 4), tmesh.AXES)
    meta = W.whisper_init(cfg, device="meta")
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


def test_dry_run_of_a_decode_step_cuts_the_cross_kv_on_its_heads(
        monkeypatch):
    """The decode_32k step (cut to 8 rows) of whisper's smoke config on a
    (1, 4) shape-only mesh: rank 0's blocks, its heads of the cache and of
    the cross K/V, and all-reduces over 'model' counted."""
    monkeypatch.setattr(tspecs, "SHAPES", {
        **tspecs.SHAPES, "decode_32k": dict(tspecs.SHAPES["decode_32k"],
                                            batch=8)})
    cfg = get_config(ARCH).smoke()
    mesh = tmesh.ShapeMesh((1, 4))
    b = tsteps.build_step(cfg, mesh, "decode_32k")
    assert b.describe()["layout"] == "tensor parallel"
    params, batch = b.args
    assert tuple(params["embed"]["table"].shape) == (
        cfg.padded_vocab // 4, cfg.d_model)
    assert batch["cache"]["attn"]["k"].shape[3] == cfg.n_kv // 4
    assert all(t.shape[3] == cfg.n_kv // 4 for t in batch["cross_kv"])
    assert b.in_specs[1]["cross_kv"][0][3] == "model"
    op_analysis.analyze(b.fn, *b.args)
    over = mesh.bytes_over("model")
    assert over["all-reduce"] > 0 and over["all-gather"] > 0
