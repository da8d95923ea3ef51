"""The port's LM EC4T training against the JAX package, at the
``smollm-360m`` smoke config on the CPU.

The JAX package's train state (``ec4t.init_train_state``: params, qstate,
opt ``{m, v, step}``) is carried across as numpy
(``convert.lm_train_state_from_numpy``), so both packages step from the
same state.  Tolerances: one fp32 step's loss, ``ce`` and ``grad_norm``
within ``rtol=1e-5``, the new params, ω and probabilities within
``atol=1e-5``; five fp32 steps with the λ ramp and the learning-rate
schedule within ``rtol=1e-4``, loss by loss; one bf16 step (the
launcher's dtype) within 1e-2 relative.  Inside the port the grouped
fake-quant of ``lm_apply`` is bitwise equal to the per-leaf path, in one
``ecl.quantize_many`` call a forward.  Also: ``grad_compress`` against
the reference's numbers, ``core/acm.py`` and ``ecl.assign_general``
against the reference, and the launcher's LM branch end to end on the
CPU (checkpoint, export, resume).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import acm as jacm
from repro.core import ecl as jecl
from repro.core import qat as jqat
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.nn import transformer as JT
from repro.nn.module import QuantCtx as JQuantCtx
from repro.optim import adam as jadam
from repro.optim import ec4t as jec4t
from repro.optim import grad_compress as jgc
from repro.optim import schedule as jsched
from repro_torch import convert, tree
from repro_torch.configs import get_config
from repro_torch.core import acm as tacm
from repro_torch.core import ecl as tecl
from repro_torch.core import qat as tqat
from repro_torch.data import synthetic
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.nn import transformer as TT
from repro_torch.nn.module import QuantCtx
from repro_torch.optim import adam as tadam
from repro_torch.optim import ec4t as tec4t
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim import schedule as tsched

ARCH = "smollm-360m"
LR, LAM, RAMP, TOTAL = 1e-3, 0.3, 3, 5
BATCH, SEQ = 2, 16


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _jax_state(seed=0, perturb=True):
    """A JAX train state of the smoke config; ``perturb`` moves ω off its
    power-of-two init and the probabilities off uniform, as training
    leaves them, so the entropy penalty and ω's gradient both matter."""
    cfg = jget_config(ARCH).smoke()
    state = jec4t.init_train_state(JT.lm_init(jax.random.PRNGKey(seed), cfg))
    if perturb:
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
    return cfg, state


def _carry(state):
    return convert.lm_train_state_from_numpy(_np(state), device="cpu")


def _jax_step(cfg, dtype):
    def loss(p, qs, batch, lam):
        ctx = JQuantCtx(quant=True, lam=lam, compute_dtype=dtype)
        return jlm.lm_forward_loss(p, qs, batch, ctx, cfg)
    if dtype == jnp.bfloat16:
        loss = jsteps._loss_fn(cfg, mesh=None, use_ep=False, remat="none")
    return jax.jit(jec4t.make_train_step(
        loss, jadam.AdamConfig(lr=LR),
        lam=lambda s: jsched.lambda_ramp(s, lam=LAM, ramp_steps=RAMP),
        lr_schedule=lambda s: jsched.warmup_cosine(
            s, base_lr=1.0, warmup=1, total=TOTAL)))


def _port_step(dtype=torch.float32):
    cfg = get_config(ARCH).smoke()
    return tec4t.make_train_step(
        tsteps._loss_fn(cfg, dtype=dtype), tadam.AdamConfig(lr=LR),
        lam=lambda s: tsched.lambda_ramp(s, lam=LAM, ramp_steps=RAMP),
        lr_schedule=lambda s: tsched.warmup_cosine(
            s, base_lr=1.0, warmup=1, total=TOTAL))


def _batch(vocab, step):
    b = synthetic.lm_batch(synthetic.LMDataCfg(vocab=vocab, seq_len=SEQ,
                                               global_batch=BATCH), step)
    return ({"tokens": b["tokens"], "labels": b["labels"]},
            {"tokens": torch.from_numpy(b["tokens"]),
             "labels": torch.from_numpy(b["labels"])})


def _named(tree_, prefix=""):
    if isinstance(tree_, dict):
        for k in sorted(tree_):
            yield from _named(tree_[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree_)


# ------------------------------------------------------- the EC4T step

def test_one_ec4t_step_matches_reference():
    cfg, jstate = _jax_state()
    tstate = _carry(jstate)
    jb, tb = _batch(cfg.vocab, 0)
    # step 2 of the ramp: λ > 0 from the first step taken here
    jstate["opt"]["step"] = jnp.asarray(2, jnp.int32)
    tstate["opt"]["step"] = torch.tensor(2, dtype=torch.int32)
    jnew, jm = _jax_step(cfg, jnp.float32)(jstate, jb)
    tnew, tm = _port_step()(tstate, tb)
    for key in ("loss", "ce", "grad_norm", "lam", "lr_scale"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    assert float(tm["lam"]) > 0
    want = dict(_named(_np(jnew)))
    got = dict(_named(convert.tree_to_numpy(tnew)))
    assert sorted(got) == sorted(want)
    for name in want:
        if name.startswith(("/params", "/qstate")):
            np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                       rtol=0, err_msg=name)
            assert got[name].dtype == want[name].dtype, name
    assert int(tnew["opt"]["step"]) == 3
    assert all(t.device.type == "cpu" for t in tree.leaves(tnew))


def test_five_step_trajectory():
    cfg, jstate = _jax_state(seed=1)
    tstate = _carry(jstate)
    jstep, tstep = _jax_step(cfg, jnp.float32), _port_step()
    want, got = [], []
    for i in range(5):
        jb, tb = _batch(cfg.vocab, i)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        want.append(float(jm["loss"]))
        got.append(float(tm["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_bf16_step_loss():
    """The launcher's compute dtype on both sides (``_loss_fn``)."""
    cfg, jstate = _jax_state(seed=2)
    tstate = _carry(jstate)
    jb, tb = _batch(cfg.vocab, 3)
    _, jm = _jax_step(cfg, jnp.bfloat16)(jstate, jb)
    _, tm = _port_step(torch.bfloat16)(tstate, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-2)
    assert np.isfinite(float(tm["grad_norm"]))


def test_grad_compress_step_matches_reference():
    """A step with the int8 error-feedback round trip: the state gains
    ``err`` in both packages and the new params agree."""
    cfg, jstate0 = _jax_state(seed=3)
    gcfg = jgc.GradCompressCfg(min_size=4096)
    jstate = jec4t.init_train_state(jstate0["params"], compress=gcfg)
    jstate["qstate"] = jstate0["qstate"]
    tstate = _carry(jstate)
    assert sorted(tstate) == ["err", "opt", "params", "qstate"]

    def jloss(p, qs, batch, lam):
        return jlm.lm_forward_loss(
            p, qs, batch, JQuantCtx(quant=True, lam=lam,
                                    compute_dtype=jnp.float32), cfg)
    jstep = jax.jit(jec4t.make_train_step(jloss, jadam.AdamConfig(lr=LR),
                                          lam=0.1, compress=gcfg))
    tstep = tec4t.make_train_step(
        tsteps._loss_fn(get_config(ARCH).smoke(), dtype=torch.float32),
        tadam.AdamConfig(lr=LR), lam=0.1,
        compress=tgc.GradCompressCfg(min_size=4096))
    jb, tb = _batch(cfg.vocab, 1)
    jnew, jm = jstep(jstate, jb)
    tnew, tm = tstep(tstate, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = dict(_named(_np(jnew)))
    got = dict(_named(convert.tree_to_numpy(tnew)))
    assert sorted(got) == sorted(want)
    for name in want:
        if name.startswith("/params"):
            np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                       rtol=0, err_msg=name)
        elif name.startswith("/err"):
            # the residual of the int8 rounding: a gradient ~1e-7 apart
            # can round one element to the next int8 step, which moves
            # its residual by one step (≤ 2·max|residual|); at most 0.1%
            # of the elements may do so, the rest agree within 1e-5
            diff = np.abs(got[name] - want[name])
            step = 2.0 * np.abs(want[name]).max() * (1 + 1e-3)
            assert (diff <= step).all(), name
            assert np.mean(diff > 1e-5) <= 1e-3, name


def test_step_refuses_a_mesh_and_remat():
    # a one-rank mesh: the mesh step runs and is the plain step bit for
    # bit; a compression axis the mesh does not have raises
    cfg, jstate = _jax_state(seed=5)
    mesh = tmesh.Mesh((1, 1), device="cpu")
    _, batch = _batch(cfg.vocab, 1)
    tcfg = get_config(ARCH).smoke()
    plain, _ = tec4t.make_train_step(
        tsteps._loss_fn(tcfg, dtype=torch.float32),
        tadam.AdamConfig(lr=LR), lam=0.1)(_carry(jstate), batch)
    for zero1 in (False, True):
        state = _carry(jstate)
        step = tec4t.make_train_step(
            tsteps._loss_fn(tcfg, mesh, dtype=torch.float32),
            tadam.AdamConfig(lr=LR), lam=0.1, mesh=mesh, zero1=zero1)
        new, _ = step(state, batch)
        for a, b in zip(tree.leaves(new), tree.leaves(plain)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="mesh has no axes"):
        tec4t.make_train_step(lambda *a: None, tadam.AdamConfig(),
                              mesh=mesh, compress=tgc.GradCompressCfg(
                                  data_axes=("bogus",)))
    with pytest.raises(ValueError, match="remat='bogus': one of none, full, "
                       "dots"):
        tsteps._loss_fn(get_config(ARCH).smoke(), remat="bogus")
    # every registered family has a loss now (vlm and audio included);
    # a family the port does not know is refused
    tsteps._loss_fn(get_config("qwen2-vl-2b").smoke())
    with pytest.raises(NotImplementedError, match="family 'bogus'"):
        tsteps._loss_fn(dataclasses.replace(get_config(ARCH).smoke(),
                                            family="bogus"))
    # full runs (held bitwise to none in tests/test_torch_mla_training.py)
    cfg, jstate = _jax_state(perturb=False)
    state = _carry(jstate)
    loss, _ = tsteps._loss_fn(cfg, remat="full", dtype=torch.float32)(
        state["params"], state["qstate"], _batch(cfg.vocab, 0)[1], 0.1)
    assert np.isfinite(float(loss))


# --------------------------------------------- grouped fake-quant path

def _traced_step(state, batch, monkeypatch, grouped: bool):
    """One port train step in fp32, recording every ŵ the forward made
    (per layer and leaf) and every ``ecl.quantize_many`` call."""
    calls, w_hats = [], []
    orig_qm = tecl.quantize_many
    monkeypatch.setattr(tecl, "quantize_many",
                        lambda *a: calls.append(len(a[0])) or orig_qm(*a))
    if grouped:
        orig_qs = TT.quantize_stack

        def record(sp, sq, ctx):
            out = orig_qs(sp, sq, ctx)
            w_hats.append(out)
            return out
        monkeypatch.setattr(TT, "quantize_stack", record)
    else:
        # the per-leaf path: each layer's view of each leaf quantized
        # where the layer reads it (module.materialize -> apply_quant)
        monkeypatch.setattr(TT, "quantize_stack", lambda sp, sq, ctx: sp)
        orig_aq = tqat.apply_quant

        def record_leaf(*a, **k):
            out = orig_aq(*a, **k)
            w_hats.append(out)
            return out
        monkeypatch.setattr(tqat, "apply_quant", record_leaf)
    cfg = get_config(ARCH).smoke()
    params = tree.map_(lambda t: t.detach().requires_grad_(),
                       state["params"])
    ctx = QuantCtx(quant=True, lam=0.2, compute_dtype=torch.float32)
    loss, _ = _lm_loss(params, state["qstate"], batch, ctx, cfg)
    grads = torch.autograd.grad(loss, tree.leaves(params))
    forward_calls = list(calls)
    tqat.update_qstate(params, state["qstate"], 0.2)
    monkeypatch.undo()
    return loss, grads, w_hats, forward_calls, calls[len(forward_calls):]


def _lm_loss(params, qstate, batch, ctx, cfg):
    return tlm.lm_forward_loss(params, qstate, batch, ctx, cfg)


def test_grouped_fake_quant_equals_per_leaf(monkeypatch):
    cfg, jstate = _jax_state(seed=4)
    state = _carry(jstate)
    _, batch = _batch(cfg.vocab, 2)
    g_loss, g_grads, g_hat, g_fwd, g_upd = _traced_step(
        state, batch, monkeypatch, grouped=True)
    p_loss, p_grads, p_hat, p_fwd, p_upd = _traced_step(
        state, batch, monkeypatch, grouped=False)
    n_layers = cfg.n_layers
    leaves = [("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"),
              ("mlp", "gate"), ("mlp", "up"), ("mlp", "down")]
    # one grouped call a forward over all 7 stacked leaves (L segments
    # each), one in update_qstate; the per-leaf path makes L x 7
    assert g_fwd == [7] and g_upd == [7]
    assert p_fwd == [1] * (n_layers * len(leaves)) and p_upd == [7]
    assert len(g_hat) == 1 and len(p_hat) == n_layers * len(leaves)
    stacked = g_hat[0]
    for i, (l, (grp, name)) in enumerate(
            (l, leaf) for l in range(n_layers) for leaf in leaves):
        assert torch.equal(stacked["dense"][grp][name]["kernel"][l],
                           p_hat[i]), \
            (l, grp, name)
    assert torch.equal(g_loss, p_loss)
    for a, b in zip(g_grads, p_grads):
        assert torch.equal(a, b)


# ------------------------------------------------------- grad_compress

def test_grad_compress_error_feedback_is_unbiased_over_time():
    cfg = tgc.GradCompressCfg(min_size=16)
    rng = np.random.default_rng(0)
    g_true_sum = np.zeros((64, 64), np.float32)
    g_appl_sum = np.zeros((64, 64), np.float32)
    err = tgc.init_error_state({"w": torch.zeros((64, 64))}, cfg)
    jerr = jgc.init_error_state({"w": jnp.zeros((64, 64))},
                                jgc.GradCompressCfg(min_size=16))
    for _ in range(30):
        g = rng.normal(size=(64, 64)).astype(np.float32)
        cg, err = tgc.compress_grads({"w": torch.from_numpy(g)}, err, cfg)
        jcg, jerr = jgc.compress_grads({"w": jnp.asarray(g)}, jerr,
                                       jgc.GradCompressCfg(min_size=16))
        # the reference's numbers, step by step
        np.testing.assert_allclose(cg["w"].numpy(), np.asarray(jcg["w"]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(err["w"].numpy(), np.asarray(jerr["w"]),
                                   atol=1e-6, rtol=0)
        g_true_sum += g
        g_appl_sum += cg["w"].numpy()
    drift = np.abs(g_appl_sum - g_true_sum).max()
    one_step_q = np.abs(g_true_sum).max() / 127
    assert drift < 10 * one_step_q, (drift, one_step_q)


def test_grad_compress_skips_small_tensors_and_refuses_a_mesh():
    cfg = tgc.GradCompressCfg(min_size=1000)
    grads = {"small": torch.tensor([1.234567]),
             "big": torch.linspace(-1, 1, 2000)}
    err = tgc.init_error_state(grads, cfg)
    assert err["small"].ndim == 0 and err["big"].shape == (2000,)
    cg, _ = tgc.compress_grads(grads, err, cfg)
    assert torch.equal(cg["small"], grads["small"])          # exact
    assert not torch.equal(cg["big"], grads["big"])          # int8 grid
    # a one-rank mesh gives the local round trip bit for bit; an axis the
    # mesh does not have raises
    mesh = tmesh.Mesh((1, 1), device="cpu")
    mg, merr = tgc.compress_grads(grads, err, cfg, mesh=mesh)
    _, lerr = tgc.compress_grads(grads, err, cfg)
    for a, b in zip(tree.leaves((mg, merr)), tree.leaves((cg, lerr))):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="mesh has no axes"):
        tgc.compress_grads(grads, err, tgc.GradCompressCfg(
            min_size=1000, data_axes=("bogus",)), mesh=mesh)


# -------------------------------------------------- acm, assign_general

def _quant_node(seed, k, n):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    node = jqat.make_quant_param(jnp.asarray(w))
    probs = rng.dirichlet(np.ones(16) * 2).astype(np.float32)
    return (node, {"probs": jnp.asarray(probs)},
            {"w": torch.from_numpy(w),
             "omega": torch.from_numpy(np.array(node["omega"]))},
            {"probs": torch.from_numpy(probs)})


def test_acm_linear_qat_freeze_and_serving_match_reference():
    jnode, jqs, tnode, tqs = _quant_node(0, 48, 24)
    x = np.random.default_rng(1).normal(size=(5, 48)).astype(np.float32)
    bias = np.linspace(-1, 1, 24).astype(np.float32)
    lam = 0.3
    y_j = jacm.linear_qat(jnp.asarray(x), jnode, jqs, lam,
                          bias=jnp.asarray(bias))
    y_t = tacm.linear_qat(torch.from_numpy(x), tnode, tqs, lam,
                          bias=torch.from_numpy(bias))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5,
                               rtol=1e-5)
    fj = jacm.freeze_linear(jnode, jqs, lam)
    ft = tacm.freeze_linear(tnode, tqs, lam)
    np.testing.assert_array_equal(ft["packed"].numpy(),
                                  np.asarray(fj["packed"]))
    np.testing.assert_array_equal(ft["omega"].numpy(),
                                  np.asarray(fj["omega"]))
    assert tuple(ft["shape"]) == tuple(fj["shape"]) == (48, 24)
    alpha1 = np.linspace(0.5, 1.5, 24).astype(np.float32)
    for act in (None, "relu"):
        sj = jacm.linear_serving(jnp.asarray(x[None]), fj,
                                 bias=jnp.asarray(bias),
                                 alpha1=jnp.asarray(alpha1), alpha2=0.5,
                                 activation=act, use_kernel=False)
        st = tacm.linear_serving(torch.from_numpy(x[None]), ft,
                                 bias=torch.from_numpy(bias),
                                 alpha1=torch.from_numpy(alpha1),
                                 alpha2=0.5, activation=act)
        assert st.shape == (1, 5, 24)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("sparsity", [0.0, 0.6])
def test_acm_flop_count_matches_reference(sparsity):
    assert tacm.acm_flop_count(8, 512, 256, sparsity) == \
        jacm.acm_flop_count(8, 512, 256, sparsity)


@pytest.mark.parametrize("c,lam", [(3, 0.05), (16, 0.3), (5, 0.0)])
def test_assign_general_matches_reference(c, lam):
    rng = np.random.default_rng(c)
    w = (rng.laplace(size=(40, 33)) * 0.05).astype(np.float32)
    book = np.sort(rng.normal(size=c) * 0.05).astype(np.float32)
    if c == 3:
        book = np.array([-0.04, 0.0, 0.04], np.float32)   # EC2T ternary
    probs = rng.dirichlet(np.ones(c)).astype(np.float32)
    want = np.asarray(jecl.assign_general(jnp.asarray(w), jnp.asarray(book),
                                          jnp.asarray(probs), lam))
    got = tecl.assign_general(torch.from_numpy(w), torch.from_numpy(book),
                              torch.from_numpy(probs), lam)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------- the launcher

def test_lm_launcher_end_to_end(tmp_path, capsys):
    """The counterpart of ``tests/test_drivers.py``'s train driver:
    checkpoint, export, then a second run resumes from the checkpoint."""
    hist = ttrain.main([
        "--arch", ARCH, "--smoke", "--steps", "25", "--batch", "4",
        "--seq", "32", "--ckpt-dir", str(tmp_path / "ckpt"),
        "--ckpt-every", "10", "--export", str(tmp_path / "export"),
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert [h["step"] for h in hist] == [10, 20]
    assert all(np.isfinite(h["loss"]) and h["loss"] > 0 for h in hist)
    assert "step    10 loss" in out and "gnorm" in out and " lam " in out
    assert "finished: done at step 25" in out
    assert os.path.exists(tmp_path / "export" / "export.npz")
    assert os.path.exists(tmp_path / "export" / "report.json")
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "step_00000010", "step_00000020", "step_00000025"]
    hist2 = ttrain.main([
        "--arch", ARCH, "--smoke", "--steps", "30", "--batch", "4",
        "--seq", "32", "--ckpt-dir", str(tmp_path / "ckpt"),
        "--device", "cpu"])
    assert [h["step"] for h in hist2] == [30]
    assert "finished: done at step 30" in capsys.readouterr().out


def test_lm_launcher_resumes_where_an_uninterrupted_run_ends(tmp_path):
    """A run restarted from its step-5 checkpoint takes steps 6-10 as the
    uninterrupted run took them, bit for bit (step-seeded data, exact
    skip-ahead, the schedules read from the restored step counter)."""
    import shutil
    cfg = ttrain.lm_config(ARCH, smoke=True)
    kw = dict(steps=10, batch=2, seq=16, lr=1e-3, lam=0.05, lam_ramp=4,
              ckpt_every=5, device="cpu", metrics_every=1, log=lambda s: 0)
    whole = ttrain.train_lm(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_00000005",
                    tmp_path / "b" / "step_00000005")
    rest = ttrain.train_lm(cfg, ckpt_dir=str(tmp_path / "b"), **kw)
    assert rest["start"] == 5 and rest["reason"] == "done"
    assert [h["step"] for h in rest["history"]] == list(range(6, 11))
    assert [h["loss"] for h in whole["history"][5:]] == \
        [h["loss"] for h in rest["history"]]
    for a, b in zip(tree.leaves(whole["state"]), tree.leaves(rest["state"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,remat,seq", [
    ("grok-1-314b", "none", 16),
    # MLA at 3 KV chunks of attn_chunk 16, each layer rematerialised
    ("deepseek-v3-671b", "full", 40)])
def test_moe_launcher_resumes_where_an_uninterrupted_run_ends(
        tmp_path, arch, remat, seq):
    """The same for the moe family's smoke configs (the aux loss in the
    step, (L, E) banks, ω and probabilities in the checkpoint; deepseek-v3
    with MLA, a dense layer and a shared expert): steps 6-10 after a
    restart from step 5 bit for bit, and the router's bias correction
    untouched."""
    import shutil
    cfg = ttrain.lm_config(arch, smoke=True)
    kw = dict(steps=10, batch=2, seq=seq, lr=1e-3, lam=0.05, lam_ramp=4,
              ckpt_every=5, device="cpu", metrics_every=1, log=lambda s: 0,
              remat=remat)
    whole = ttrain.train_lm(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_00000005",
                    tmp_path / "b" / "step_00000005")
    rest = ttrain.train_lm(cfg, ckpt_dir=str(tmp_path / "b"), **kw)
    assert rest["start"] == 5 and rest["reason"] == "done"
    assert [h["loss"] for h in whole["history"][5:]] == \
        [h["loss"] for h in rest["history"]]
    assert all(np.isfinite(h["aux"]) and h["aux"] > 0
               for h in whole["history"])
    for a, b in zip(tree.leaves(whole["state"]), tree.leaves(rest["state"])):
        assert torch.equal(a, b)
    router = whole["state"]["params"]["stacks"]["moe"]["moe"]["router"]
    assert not router["bias_correction"].any()


def test_lm_launcher_flags_per_branch(tmp_path, capsys):
    with pytest.raises(SystemExit):
        ttrain.main(["--arch", ARCH, "--smoke", "--remat", "bogus",
                     "--device", "cpu"])
    assert "invalid choice: 'bogus'" in capsys.readouterr().err
    hist = ttrain.main(["--arch", ARCH, "--smoke", "--remat", "full",
                        "--steps", "2", "--batch", "2", "--seq", "16",
                        "--log-every", "1", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in hist] == [1, 2]
    with pytest.raises(SystemExit):
        ttrain.main(["--arch", "mlp-hr", "--smoke", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain.main(["--arch", ARCH, "--smoke", "--steps", "1"])
