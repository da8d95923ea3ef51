"""The port's MoE EC4T training against the JAX package, on the CPU at
smoke size: ``grok-1-314b.smoke()`` (2 layers, 4 experts, top-2, softmax
gate) and ``deepseek-v3-671b.smoke()`` with MLA and without it, built
identically in both packages (a leading dense layer, then a MoE layer
with a sigmoid gate, a bias correction and a shared expert; with MLA the
step runs at seq 40, three KV chunks of the smoke's 16, the last one
padded, and the gradients of every MLA projection and its ω are held as
the banks' are).

The JAX train state (params with ω moved off its init and a nonzero
routing bias, probabilities off uniform, Adam ``m``, ``v`` and ``step``)
is carried across with ``convert.lm_train_state_from_numpy``, so both
packages step from the same state, in fp32.  Tolerances: one step's loss
and aux within 1e-5; the gradients of the router ``w``, every (L, E) bank
and its (L, E, 4) ω within 1e-4 relative (read from the step's first
moment, ``m = (1 - β1) · clip · g`` from ``m = 0``, so its relative error
is the clipped gradient's); the new params, ``m`` and ``v`` within 1e-5;
the (L, E, 16) probabilities within 1e-6; five steps' losses within 1e-4
relative.  The router's ``bias_correction`` is left bit for bit by a step
in both packages.  One device's share of the experts
(``experts_held``) is held against JAX's whole ``moe_apply``: two shares,
the shared expert counted once, within 1e-6; ``experts_held=None``
equals the layer as it was before shares, bit for bit.  Also:
``update_moe_bias`` exactly as JAX's, the backward run twice bitwise,
checkpoint and export round trips of a MoE state (export ==
``freeze_tree`` bitwise, served tokens equal), the launcher's LM branch
on grok smoke, and the histogram exact past 2**24 codes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jman
from repro.configs import get_config as jget_config
from repro.core import ecl as jecl
from repro.core import qat as jqat
from repro.models import lm as jlm
from repro.nn import moe as jmoe
from repro.nn import transformer as JT
from repro.nn.module import FP32_CTX as JFP32
from repro.nn.module import QuantCtx as JQuantCtx
from repro.optim import adam as jadam
from repro.optim import ec4t as jec4t
from repro.optim import schedule as jsched
from repro_torch import convert, tree
from repro_torch.checkpoint import manager as tman
from repro_torch.configs import get_config
from repro_torch.core import ecl as tecl
from repro_torch.core import qat as tqat
from repro_torch.data import synthetic
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.nn import moe
from repro_torch.nn import transformer as TT
from repro_torch.nn.layers import subtree, swiglu
from repro_torch.nn.module import FP32_CTX, QuantCtx
from repro_torch.optim import adam as tadam
from repro_torch.optim import ec4t as tec4t
from repro_torch.optim import schedule as tsched

LR, LAM, RAMP, TOTAL = 1e-3, 0.3, 3, 5
BATCH, SEQ = 2, 16
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_REL = 1e-4
STATE_ATOL = 1e-5
PROBS_ATOL = 1e-6
SHARE_TOL = dict(atol=1e-6, rtol=1e-6)
VARIANTS = ("grok", "deepseek_no_mla", "deepseek")
SEQS = {"deepseek": 40}       # 3 KV chunks of attn_chunk 16


def _configs(variant):
    """(JAX config, port config) of a variant, built the same way."""
    if variant == "grok":
        return (jget_config("grok-1-314b").smoke(),
                get_config("grok-1-314b").smoke())
    if variant == "deepseek":
        return (jget_config("deepseek-v3-671b").smoke(),
                get_config("deepseek-v3-671b").smoke())
    return (dataclasses.replace(jget_config("deepseek-v3-671b").smoke(),
                                mla=None),
            dataclasses.replace(get_config("deepseek-v3-671b").smoke(),
                                mla=None))


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _jax_state(variant, seed=0):
    """A JAX train state with ω scaled off its init, probabilities off
    uniform and a nonzero routing bias, as training leaves them."""
    cfg, _ = _configs(variant)
    state = jec4t.init_train_state(JT.lm_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 100)
    state["params"] = jax.tree_util.tree_map(
        lambda n: {**n, "omega": n["omega"] * jnp.asarray(
            rng.uniform(0.8, 1.2, n["omega"].shape).astype(np.float32))}
        if jqat.is_quant_leaf(n) else n, state["params"],
        is_leaf=jqat.is_quant_leaf)
    state["qstate"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.dirichlet(np.ones(16) * 2, a.shape[:-1])
                              .astype(np.float32))
        if a.ndim and a.shape[-1] == 16 and a.dtype == jnp.float32
        else a, state["qstate"])
    router = state["params"]["stacks"]["moe"]["moe"]["router"]
    router["bias_correction"] = jnp.asarray(
        rng.normal(size=router["bias_correction"].shape).astype(np.float32)
        * 0.05)
    return cfg, state


def _carry(state):
    return convert.lm_train_state_from_numpy(_np(state), device="cpu")


def _lam(s):
    return jsched.lambda_ramp(s, lam=LAM, ramp_steps=RAMP)


@functools.lru_cache(maxsize=None)
def _jax_step(variant):
    cfg, _ = _configs(variant)

    def loss(p, qs, batch, lam):
        ctx = JQuantCtx(quant=True, lam=lam, compute_dtype=jnp.float32)
        return jlm.lm_forward_loss(p, qs, batch, ctx, cfg)
    return jax.jit(jec4t.make_train_step(
        loss, jadam.AdamConfig(lr=LR), lam=_lam,
        lr_schedule=lambda s: jsched.warmup_cosine(
            s, base_lr=1.0, warmup=1, total=TOTAL)))


def _port_step(variant):
    _, cfg = _configs(variant)
    return tec4t.make_train_step(
        tsteps._loss_fn(cfg, dtype=torch.float32), tadam.AdamConfig(lr=LR),
        lam=lambda s: tsched.lambda_ramp(s, lam=LAM, ramp_steps=RAMP),
        lr_schedule=lambda s: tsched.warmup_cosine(
            s, base_lr=1.0, warmup=1, total=TOTAL))


def _batch(vocab, step, seq=SEQ):
    b = synthetic.lm_batch(synthetic.LMDataCfg(vocab=vocab, seq_len=seq,
                                               global_batch=BATCH), step)
    return ({"tokens": b["tokens"], "labels": b["labels"]},
            {"tokens": torch.from_numpy(b["tokens"]),
             "labels": torch.from_numpy(b["labels"])})


def _named(tree_, prefix=""):
    """(dotted path, numpy array) of every leaf, keys sorted."""
    if isinstance(tree_, dict):
        for k in sorted(tree_):
            yield from _named(tree_[k], f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, np.asarray(tree_)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _one_step(variant):
    """One step of each package from the same state at step 2 of the λ
    ramp (λ > 0): (state before as numpy, JAX's new state and metrics,
    the port's), all numpy."""
    _, jstate = _jax_state(variant)
    jstate["opt"]["step"] = jnp.asarray(2, jnp.int32)
    tstate = _carry(jstate)
    jb, tb = _batch(_configs(variant)[0].vocab, 0,
                    SEQS.get(variant, SEQ))
    jnew, jm = _jax_step(variant)(jstate, jb)
    tnew, tm = _port_step(variant)(tstate, tb)
    return (dict(_named(_np(jstate))), dict(_named(_np(jnew))),
            {k: float(v) for k, v in jm.items()},
            dict(_named(convert.tree_to_numpy(tnew))),
            {k: float(v) for k, v in tm.items()})


# ------------------------------------------------------- the EC4T step

@pytest.mark.parametrize("variant", VARIANTS)
def test_one_ec4t_step_matches_reference(variant):
    _, want, jm, got, tm = _one_step(variant)
    for key in ("loss", "ce", "aux", "grad_norm", "lam", "lr_scale"):
        np.testing.assert_allclose(tm[key], jm[key], **LOSS_TOL,
                                   err_msg=key)
    assert tm["lam"] > 0 and tm["aux"] > 0
    assert sorted(got) == sorted(want)
    moe_m = "opt.m.stacks.moe.moe."
    graded = [n for n in want if n.startswith(moe_m + "experts.")
              or n == moe_m + "router.w"]
    # the (L, E) banks and their (L, E, 4) ω, and the router
    cfg = _configs(variant)[1]
    assert len(graded) == 7 and want[moe_m + "experts.down.omega"].shape \
        == (cfg.n_layers - cfg.n_dense_layers, cfg.n_experts, 4)
    if variant == "deepseek":     # every MLA projection of both stacks
        mla = [n for n in want if n.startswith("opt.m.stacks.")
               and ".attn." in n]
        assert len(mla) == 2 * 5 * 2
        graded += mla
    for name in graded:
        assert np.abs(want[name]).max() > 0, name
        assert _rel(got[name], want[name]) <= GRAD_REL, name
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        if name.startswith("qstate"):
            np.testing.assert_allclose(got[name], want[name],
                                       atol=PROBS_ATOL, rtol=0,
                                       err_msg=name)
        elif name.startswith(("params", "opt.m", "opt.v")):
            np.testing.assert_allclose(got[name], want[name],
                                       atol=STATE_ATOL, rtol=0,
                                       err_msg=name)
    assert got["opt.step"] == 3


@pytest.mark.parametrize("variant", VARIANTS)
def test_a_step_leaves_the_routing_bias_bitwise(variant):
    """``bias_correction`` is detached in ``route``: a zero gradient, so
    Adam leaves it bit for bit, in both packages."""
    before, want, _, got, _ = _one_step(variant)
    name = "params.stacks.moe.moe.router.bias_correction"
    assert np.abs(before[name]).max() > 0
    np.testing.assert_array_equal(want[name], before[name])
    np.testing.assert_array_equal(got[name], before[name])
    for moment in ("opt.m", "opt.v"):
        key = name.replace("params", moment, 1)
        assert not got[key].any() and not want[key].any()


def test_five_step_trajectory():
    _, jstate = _jax_state("grok", seed=1)
    tstate = _carry(jstate)
    jstep, tstep = _jax_step("grok"), _port_step("grok")
    want, got, aux = [], [], []
    for i in range(5):
        jb, tb = _batch(_configs("grok")[0].vocab, i)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        want.append(float(jm["loss"]))
        got.append(float(tm["loss"]))
        aux.append(float(tm["aux"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.isfinite(aux).all()


def test_a_share_step_quantizes_every_segment_in_one_pass(monkeypatch):
    """A share of grok smoke (experts 0-1 of 4) in one grouped ECL pass a
    forward and one in ``update_qstate``: L x (q, k, v, o) + L x 3 banks
    x 2 held experts = 20 segments, one launch on the card (at full width,
    depth 1: 10 segments)."""
    cfg = dataclasses.replace(get_config("grok-1-314b").smoke(),
                              experts_held=(0, 2))
    state = tec4t.init_train_state(TT.lm_init(cfg, seed=0, device="cpu"))
    assert state["qstate"]["stacks"]["moe"]["moe"]["experts"]["up"][
        "probs"].shape == (2, 2, 16)
    calls = []
    orig = tecl.quantize_many
    monkeypatch.setattr(tecl, "quantize_many", lambda ws, oms, pens: calls.append(
        sum(o.shape[:-1].numel() for o in oms)) or orig(ws, oms, pens))
    step = tec4t.make_train_step(tsteps._loss_fn(cfg, dtype=torch.float32),
                                 tadam.AdamConfig(lr=LR), lam=0.1)
    new, m = step(state, _batch(cfg.vocab, 0)[1])
    assert calls == [20, 20]
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["aux"]))


def test_moe_backward_is_deterministic():
    """The port's MoE loss differentiated twice from one state: every
    gradient equal bit for bit (the expand in place of the repeated-token
    gather, the sink row in place of the clamped slot)."""
    _, jstate = _jax_state("grok", seed=2)
    state = _carry(jstate)
    _, cfg = _configs("grok")
    loss_fn = tsteps._loss_fn(cfg, dtype=torch.float32)
    batch = _batch(cfg.vocab, 3)[1]

    def grads():
        leaves = [t.detach().requires_grad_() for t in
                  tree.leaves(state["params"])]
        loss, _ = loss_fn(tree.unflatten(state["params"], leaves),
                          state["qstate"], batch, 0.2)
        return torch.autograd.grad(loss, leaves, allow_unused=True)
    first, second = grads(), grads()
    assert sum(g is not None for g in first) > 10
    for a, b in zip(first, second):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


# ------------------------------------------------------------ the share

def _moe_apply_before_shares(p, q_state, x, ctx, *, top_k, gate="softmax",
                             capacity_factor=1.25, routed_scaling=1.0):
    """``nn.moe.moe_apply`` as it was before ``experts_held`` (the token
    gather by a repeated index, dropped assignments read from a clamped
    slot and multiplied by 0)."""
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    n = xt.shape[0]
    e = p["router"]["w"].shape[1]
    logits = xt.to(torch.float32) @ p["router"]["w"]
    ids, w, aux = moe.route(logits, p["router"]["bias_correction"].detach(),
                            top_k=top_k, gate=gate,
                            routed_scaling=routed_scaling)
    cap = moe._capacity(n * top_k, e, capacity_factor)
    slot, keep = moe._dispatch_indices(ids.reshape(-1), e, cap)
    token_of = torch.arange(n, device=x.device).repeat_interleave(top_k)
    buf = torch.zeros((e * cap + 1, d), dtype=ctx.dtype, device=x.device)
    buf[torch.where(keep, slot, e * cap)] = xt[token_of].to(ctx.dtype)
    out = moe._expert_ffn(p["experts"], subtree(q_state, "experts"),
                          buf[:e * cap].view(e, cap, d), ctx
                          ).reshape(e * cap, d)
    gathered = (out[slot] * (w.reshape(-1, 1) * keep[:, None]).to(ctx.dtype)
                ).view(n, top_k, d)
    y = torch.zeros((n, d), dtype=ctx.dtype, device=x.device)
    for j in range(top_k):
        y = y + gathered[:, j]
    if "shared" in p:
        y = y + swiglu(p["shared"], subtree(q_state, "shared"), xt, ctx)
    return y.reshape(shape), aux


SHARE_CASES = {
    # gate: (routed_scaling, n_shared); capacity factor 0.5 drops some
    "softmax": (1.0, 0),
    "sigmoid": (2.5, 1),
}


def _share_layer(gate):
    scaling, n_shared = SHARE_CASES[gate]
    p = jmoe.moe_init(jax.random.PRNGKey(11), 16, 32, 4, quantize=False,
                      n_shared=n_shared)
    p["router"]["bias_correction"] = jnp.asarray(
        np.random.default_rng(12).normal(size=(4,)).astype(np.float32) * 0.05)
    x = np.random.default_rng(13).normal(size=(3, 6, 16)).astype(np.float32)
    kw = dict(top_k=2, gate=gate, capacity_factor=0.5,
              routed_scaling=scaling)
    tp = convert.lm_tree_from_numpy(_np(p), device="cpu")
    return p, tp, x, kw


@pytest.mark.parametrize("gate", sorted(SHARE_CASES))
def test_shares_add_up_to_the_reference_layer(gate):
    p, tp, x, kw = _share_layer(gate)
    want, jaux = jmoe.moe_apply(p, 0, jnp.asarray(x), JFP32, **kw)
    xt = torch.from_numpy(x)
    total, auxes = None, []
    for first in (0, 2):
        y, aux = moe.moe_ffn(convert.take_experts(tp, first, 2, axis=0), 0,
                             xt, FP32_CTX, experts_held=(first, 2), **kw)
        total = y if total is None else total + y
        auxes.append(float(aux))
    if "shared" in tp:     # each share adds the shared expert: keep one
        total = total - swiglu(tp["shared"], 0, xt.reshape(-1, 16),
                               FP32_CTX).reshape(xt.shape)
    np.testing.assert_allclose(total.numpy(), np.asarray(want), **SHARE_TOL)
    np.testing.assert_allclose(auxes, [float(jaux)] * 2, **SHARE_TOL)
    _, keep = moe._dispatch_indices(
        moe.route(xt.reshape(-1, 16) @ tp["router"]["w"],
                  tp["router"]["bias_correction"], top_k=2, gate=gate,
                  routed_scaling=kw["routed_scaling"])[0].reshape(-1), 4,
        moe._capacity(36, 4, 0.5))
    assert not keep.all()           # the capacity drops some


@pytest.mark.parametrize("gate", sorted(SHARE_CASES))
def test_every_expert_held_is_the_layer_before_shares(gate):
    _, tp, x, kw = _share_layer(gate)
    xt = torch.from_numpy(x)
    got, aux = moe.moe_apply(tp, 0, xt, FP32_CTX, **kw)
    want, want_aux = _moe_apply_before_shares(tp, 0, xt, FP32_CTX, **kw)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    held, _ = moe.moe_apply(tp, 0, xt, FP32_CTX, experts_held=(0, 4), **kw)
    assert torch.equal(held, want)


def test_a_share_refuses_banks_of_another_size():
    _, tp, x, kw = _share_layer("softmax")
    with pytest.raises(ValueError, match="banks hold 4 experts"):
        moe.moe_apply(tp, 0, torch.from_numpy(x), FP32_CTX,
                      experts_held=(0, 2), **kw)
    with pytest.raises(ValueError, match="not a slice of 4 experts"):
        moe.held_experts((3, 2), 4)


def test_take_experts_cuts_a_train_state():
    _, jstate = _jax_state("grok")
    share = convert.take_experts(_np(jstate), 1, 2)
    full = _np(jstate)
    bank = ("stacks", "moe", "moe", "experts", "down")
    for part in ("params", "opt"):
        node, whole = share[part], full[part]
        if part == "opt":
            node, whole = node["m"], whole["m"]
        for k in bank:
            node, whole = node[k], whole[k]
        assert node["w"].shape == (2, 2, 128, 64)
        np.testing.assert_array_equal(node["w"], whole["w"][:, 1:3])
        assert node["omega"].shape == (2, 2, 4)
    assert share["qstate"]["stacks"]["moe"]["moe"]["experts"]["gate"][
        "probs"].shape == (2, 2, 16)
    router = share["params"]["stacks"]["moe"]["moe"]["router"]
    assert router["w"].shape == (2, 64, 4)


# ---------------------------------------------------- update_moe_bias

def test_update_moe_bias_matches_reference():
    _, jstate = _jax_state("deepseek_no_mla")
    params = jstate["params"]
    # overloaded, underloaded and exactly on target (sign 0)
    load = np.array([0.25, 0.5, 0.1, 0.15], np.float32)
    want = jec4t.update_moe_bias(params, jnp.asarray(load), gamma=1e-3)
    got = tec4t.update_moe_bias(
        convert.lm_tree_from_numpy(_np(params), device="cpu"),
        torch.from_numpy(load), gamma=1e-3)
    want, got = dict(_named(_np(want))), dict(_named(
        convert.tree_to_numpy(got)))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    bias = "stacks.moe.moe.router.bias_correction"
    before = np.asarray(params["stacks"]["moe"]["moe"]["router"][
        "bias_correction"])
    np.testing.assert_array_equal(np.sign(got[bias] - before),
                                  [[0, -1, 1, 1]])


# ---------------------------------------------- checkpoints and exports

def test_moe_checkpoint_roundtrip(tmp_path):
    """A MoE train state ((L, E) banks and moments, (L, E, 16)
    probabilities) saved by the port restores bitwise into a fresh state,
    and into the JAX package's state."""
    _, jstate = _jax_state("grok", seed=3)
    state = _carry(jstate)
    state, _ = _port_step("grok")(state, _batch(256, 0)[1])
    mgr = tman.CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    _, cfg = _configs("grok")
    fresh = tec4t.init_train_state(TT.lm_init(cfg, seed=5, device="cpu"))
    restored, meta = mgr.restore(fresh)
    assert meta["step"] == 3
    want, got = dict(_named(convert.tree_to_numpy(state))), \
        dict(_named(convert.tree_to_numpy(restored)))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    theirs, _ = jman.CheckpointManager(str(tmp_path)).restore(jstate)
    for name, value in _named(_np(theirs)):
        np.testing.assert_array_equal(value, want[name], err_msg=name)


def _flat(tree_):
    return dict(tman._paths(tree_))


def test_moe_export_equals_freeze_tree_and_serves(tmp_path):
    _, jstate = _jax_state("deepseek_no_mla", seed=4)
    state = _carry(jstate)
    _, cfg = _configs("deepseek_no_mla")
    p, qs = state["params"], state["qstate"]
    tman.export_quantized(str(tmp_path), p, qs, 0.2)
    frozen = tman.frozen_tree(tman.load_quantized(str(tmp_path)),
                              device="cpu")
    want = _flat(tqat.freeze_tree(p, qs, 0.2))
    # loaded as numpy, or as tensors on a named device: the same tree
    for loaded in (frozen, tman.frozen_tree(
            tman.load_quantized(str(tmp_path), device="cpu"),
            device="cpu")):
        got = _flat(loaded)
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            assert torch.equal(got[name], want[name]), name
    assert got["stacks//moe//moe//experts//gate//packed"].shape == \
        (1, 4, 32, 128)
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 6)))
    served = [tlm.generate(t, 0, prompt, FP32_CTX, cfg, max_new=4)
              for t in (frozen, tqat.freeze_tree(p, qs, 0.2))]
    assert torch.equal(served[0], served[1])


# ------------------------------------------------------- the launcher

def test_train_launcher_trains_grok_smoke(tmp_path, capsys):
    ttrain.main(["--arch", "grok-1-314b", "--smoke", "--device", "cpu",
                 "--steps", "4", "--ckpt-dir", str(tmp_path / "ckpt"),
                 "--export", str(tmp_path / "export")])
    out = capsys.readouterr().out
    assert "finished: done at step 4" in out and "export:" in out
    assert (tmp_path / "ckpt" / "step_00000004" / "state.npz").exists()
    loaded = tman.load_quantized(str(tmp_path / "export"))
    assert loaded["stacks//moe//moe//experts//up"]["codes"].shape == \
        (2, 4, 64, 128)
    # the launcher trains every family now; what it refuses is whisper's
    # decoder past MAX_TGT positions
    with pytest.raises(ValueError, match="MAX_TGT"):
        ttrain.main(["--arch", "whisper-base", "--smoke", "--device", "cpu",
                     "--seq", "449"])


# ----------------------------------------------- the histogram past 2**24

def test_histogram_is_exact_past_2_pow_24():
    """One segment holding 2**24 + 3 equal codes: the port's counts are
    exact, and its histogram agrees with JAX's within JAX's own fp32
    rounding (each of its one-hot sums past 2**24 is off by at most a
    unit in 2**-23 of the count, so rtol 1e-6)."""
    n_equal = (1 << 24) + 3
    codes = np.full(n_equal + 5, 9, np.uint8)
    codes[:3] = 2
    codes[3:5] = 15
    counts = tecl.code_counts(torch.from_numpy(codes))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(codes, minlength=16))
    assert int(counts[9]) == n_equal and counts.dtype == torch.int64
    hist = tecl.histogram(torch.from_numpy(codes)).numpy()
    total = np.float32(codes.size)
    np.testing.assert_array_equal(
        hist, np.bincount(codes, minlength=16).astype(np.float32) / total)
    np.testing.assert_allclose(hist, np.asarray(jecl.histogram(
        jnp.asarray(codes))), rtol=1e-6, atol=0)
    # (L, E) leads: one count per (layer, expert)
    lead = tecl.code_counts(torch.from_numpy(codes[:24].reshape(2, 3, 4)),
                            lead_ndim=2)
    assert lead.shape == (2, 3, 16) and int(lead.sum()) == 24


def test_unflatten_keeps_no_leaf_alive():
    """``tree.unflatten`` (a train step rebuilds its gradients with it)
    leaves no reference cycle behind: with the cyclic collector off, a
    leaf dies with the last tree that holds it."""
    import gc
    import weakref
    gc.disable()
    try:
        leaf = torch.zeros(3)
        ref = weakref.ref(leaf)
        out = tree.unflatten({"a": 0, "b": [0, {"c": 0}]},
                             [leaf, torch.ones(1), torch.ones(2)])
        assert out["a"] is leaf
        del leaf, out
        assert ref() is None
    finally:
        gc.enable()
