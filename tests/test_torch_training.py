"""The port's EC4T training path vs the JAX package, on the CPU.

Both packages get the same seeded numpy inputs; on the CPU the port's
fused ECL op takes its plain version, and the JAX side runs the real
Pallas body with ``interpret=True`` where it reaches the kernel.
Tolerances, each stated where it is checked:

* ECL codes and ŵ: exact (the plain version rounds every term as the
  reference does).
* ``fake_quant``: forward and ∂/∂w exact; ∂/∂ω ``rtol=1e-5`` (a sum over
  every weight, taken in another order than XLA's).
* ``mlp_apply`` logits ``atol=1e-5``, BatchNorm stats ``atol=1e-6``.
* Adam: params, m, v ``rtol=1e-6`` of each leaf's largest magnitude (an
  ulp of difference in the global norm, summed in another order, moves
  the elements where β₁m and (1−β₁)g cancel); the gradient norm
  ``rtol=1e-6``.
* Schedules ``rtol=1e-6``; ``cls_batch`` bitwise.
* One train step from a carried-across state: loss ``rtol=1e-5``, params
  and probs ``atol=1e-6``, codes after the step equal (the linear bias in
  front of BatchNorm, whose gradient is rounding noise, within 4·lr); a
  5-step trajectory: every loss ``rtol=1e-4``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_mlps import MLPConfig
from repro.core import ecl as jecl
from repro.core import qat as jqat
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops
from repro.models import mlp as jmlp
from repro.nn.module import QuantCtx as JQuantCtx
from repro.optim import adam as jadam
from repro.optim import schedule as jsched
from repro_torch import tree
from repro_torch.configs.paper_mlps import MLPConfig as TMLPConfig
from repro_torch.convert import train_state_from_numpy
from repro_torch.core import ecl as tecl
from repro_torch.core import qat as tqat
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ecl_quant as teq
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as ttrain
from repro_torch.models import mlp as tmlp
from repro_torch.nn.module import QuantCtx
from repro_torch.optim import adam as tadam
from repro_torch.optim import schedule as tsched

TINY = MLPConfig("tiny", (32, 16, 10), d_in=24)
TTINY = TMLPConfig("tiny", (32, 16, 10), d_in=24)
BATCH = 16
LR = 5e-3


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ecl_inputs(shape, lam, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape) * 0.1).astype(np.float32)
    amax = max(float(np.abs(w).max()), 1e-8)
    omega = (np.array([1, 2, 4, -8]) * amax / 8
             * rng.uniform(0.8, 1.2, 4)).astype(np.float32)
    probs = rng.dirichlet(np.ones(16)).astype(np.float32)
    pen = tecl.penalty(_t(w), _t(probs), lam).numpy()
    return w, omega, probs, pen


@pytest.mark.parametrize("lam", [0.0, 0.3])
@pytest.mark.parametrize("shape", [(1, 5), (37, 129), (64, 48)])
def test_ecl_quant_plain_matches_pallas(shape, lam):
    """Codes and ŵ exact against the Pallas body in interpret mode."""
    w, omega, _, pen = _ecl_inputs(shape, lam, seed=shape[0] + shape[1])
    want_c, want_w = jops.ecl_quant(jnp.asarray(w), jnp.asarray(omega),
                                    jnp.asarray(pen), use_kernel=True,
                                    interpret=True)
    got_c, got_w = teq.ecl_quant_plain(_t(w), _t(omega), _t(pen))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    assert got_c.dtype == torch.uint8 and got_w.dtype == torch.float32
    # the dispatching wrapper takes the plain version for a CPU tensor
    c2, w2 = teq.ecl_quant(_t(w), _t(omega), _t(pen))
    assert torch.equal(c2, got_c) and torch.equal(w2, got_w)


@pytest.mark.parametrize("shape", [(7,), (3, 4, 5)])
def test_ops_ecl_quant_reshapes_like_jax(shape):
    """1-D w runs as one row, N-D w as (w.shape[0], -1); exact."""
    w, omega, _, pen = _ecl_inputs(shape, 0.3, seed=9)
    want_c, want_w = jops.ecl_quant(jnp.asarray(w), jnp.asarray(omega),
                                    jnp.asarray(pen), use_kernel=True,
                                    interpret=True)
    got_c, got_w = tops.ecl_quant(_t(w), _t(omega), _t(pen))
    assert tuple(got_c.shape) == shape
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


def test_ecl_quant_kernel_wrapper_rejects_cpu_and_bad_shapes():
    w, omega, _, pen = _ecl_inputs((4, 4), 0.3, seed=1)
    with pytest.raises(ValueError):
        teq.ecl_quant_plain(_t(w)[None], _t(omega), _t(pen))
    with pytest.raises(ValueError):
        teq.ecl_quant_plain(_t(w), _t(omega)[:3], _t(pen))


@pytest.mark.parametrize("lam", [0.02, 0.3])
@pytest.mark.parametrize("shape", [(24, 32), (37, 129)])
def test_fake_quant_forward_and_grads(shape, lam):
    """Forward and ∂/∂w exact; ∂/∂ω rtol=1e-5 from the same cotangent."""
    w, omega, probs, _ = _ecl_inputs(shape, lam, seed=shape[1])
    ct = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: jqat.fake_quant(a, b, jnp.asarray(probs),
                                                    lam),
                       jnp.asarray(w), jnp.asarray(omega))
    gw, gom = vjp(jnp.asarray(ct))
    tw = _t(w).requires_grad_()
    tom = _t(omega).requires_grad_()
    got = tqat.fake_quant(tw, tom, _t(probs), lam)
    got.backward(_t(ct))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(gw))
    np.testing.assert_allclose(tom.grad.numpy(), np.asarray(gom), rtol=1e-5)


def _tiny_state(seed=0):
    """A JAX init with non-trivial BatchNorm state, as numpy."""
    params, bn = jmlp.mlp_init(jax.random.PRNGKey(seed), TINY)
    rng = np.random.default_rng(seed)
    for layer, st in zip(params["layers"], bn["layers"]):
        n = st["mean"].shape[0]
        layer["bn_gamma"] = jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)
        layer["bn_beta"] = jnp.asarray(rng.normal(size=n) * 0.1, jnp.float32)
        layer["bias"] = jnp.asarray(rng.normal(size=n) * 0.1, jnp.float32)
        st["mean"] = jnp.asarray(rng.normal(size=n) * 0.2, jnp.float32)
        st["var"] = jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32)
    qs = jqat.build_qstate(params)
    return params, qs, bn, jadam.init(params)


def _batch(step, batch=BATCH):
    cfg = jsyn.ClsDataCfg(d_in=TINY.d_in, n_classes=TINY.features[-1],
                          batch=batch, margin=3.0, seed=0)
    return jsyn.cls_batch(cfg, step)


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("train", [True, False])
def test_mlp_apply_matches(train, quant):
    """Logits atol=1e-5, new BatchNorm stats atol=1e-6."""
    params, qs, bn, _ = _tiny_state()
    x = _batch(0)["x"]
    want, want_bn = jmlp.mlp_apply(
        params, qs, bn, jnp.asarray(x),
        JQuantCtx(quant=quant, lam=0.3, compute_dtype=jnp.float32),
        train=train)
    tp, tq, tb, _ = train_state_from_numpy(*_np((params, qs, bn,
                                                 jadam.init(params))),
                                           device="cpu")
    got, got_bn = tmlp.mlp_apply(
        tp, tq, tb, _t(x),
        QuantCtx(quant=quant, lam=0.3, compute_dtype=torch.float32),
        train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for g, w in zip(tree.leaves(got_bn), jax.tree_util.tree_leaves(want_bn)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_cross_entropy_and_accuracy():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(BATCH, 10)).astype(np.float32)
    labels = rng.integers(0, 10, size=BATCH).astype(np.int32)
    np.testing.assert_allclose(
        float(tmlp.cross_entropy(_t(logits), _t(labels))),
        float(jmlp.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)
    assert float(tmlp.accuracy(_t(logits), _t(labels))) == float(
        jmlp.accuracy(jnp.asarray(logits), jnp.asarray(labels)))


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_adam_apply_matches(grad_scale):
    """One Adam step from the same grads and state: params, m, v rtol=1e-6
    of each leaf's largest magnitude, grad_norm rtol=1e-6 (grad_scale 10
    makes the global-norm clip bite)."""
    params, _, _, _ = _tiny_state()
    rng = np.random.default_rng(3)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape) * grad_scale,
                              jnp.float32), params)
    m = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape) * 0.01, jnp.float32),
        params)
    v = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.uniform(0, 1e-3, size=p.shape), jnp.float32),
        params)
    state = {"m": m, "v": v, "step": jnp.asarray(4, jnp.int32)}
    cfg = dict(lr=LR)
    want_p, want_s, want_m = jadam.apply(params, grads, state,
                                         jadam.AdamConfig(**cfg))
    tp, tg, ts = (train_state_from_numpy(*_np((params, grads, state, {})),
                                         device="cpu")[:3])
    got_p, got_s, got_m = tadam.apply(tp, tg, ts, tadam.AdamConfig(**cfg))
    for got, want in ((got_p, want_p), (got_s["m"], want_s["m"]),
                      (got_s["v"], want_s["v"])):
        for g, w in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())
    assert int(got_s["step"]) == int(want_s["step"]) == 5
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-6)


def test_schedules_match():
    """lambda_ramp and warmup_cosine rtol=1e-6."""
    for step in (0, 1, 7, 30, 59, 60, 61, 200):
        np.testing.assert_allclose(
            float(tsched.lambda_ramp(step, lam=0.3, ramp_steps=60)),
            float(jsched.lambda_ramp(step, lam=0.3, ramp_steps=60)),
            rtol=1e-6)
        np.testing.assert_allclose(
            float(tsched.warmup_cosine(step, base_lr=1.0, warmup=10,
                                       total=100)),
            float(jsched.warmup_cosine(step, base_lr=1.0, warmup=10,
                                       total=100)), rtol=1e-6)
    assert isinstance(tsched.lambda_ramp(3, lam=0.3, ramp_steps=60),
                      torch.Tensor)


def test_cls_batch_bitwise():
    cfg = dict(d_in=24, n_classes=10, batch=BATCH, margin=3.0, seed=4)
    for step in (0, 17, 10_000):
        want = jsyn.cls_batch(jsyn.ClsDataCfg(**cfg), step)
        got = tsyn.cls_batch(tsyn.ClsDataCfg(**cfg), step)
        for k in ("x", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_update_qstate_and_stats_match():
    """Probs atol=1e-6; sparsity and entropy rtol=1e-6."""
    params, qs, _, _ = _tiny_state()
    want_q = jqat.update_qstate(params, qs, 0.3)
    want_st = jqat.stats(params, want_q, 0.3)
    tp, tq = train_state_from_numpy(*_np((params, qs, {}, {})),
                                    device="cpu")[:2]
    got_q = tqat.update_qstate(tp, tq, 0.3)
    got_st = tqat.stats(tp, got_q, 0.3)
    for i, layer in enumerate(want_q["layers"]):
        np.testing.assert_allclose(
            got_q["layers"][i]["kernel"]["probs"].numpy(),
            np.asarray(layer["kernel"]["probs"]), atol=1e-6)
    assert got_st["quant_params"] == int(want_st["quant_params"])
    for k in ("sparsity", "entropy_bits_per_weight"):
        np.testing.assert_allclose(float(got_st[k]), float(want_st[k]),
                                   rtol=1e-6)


@jax.jit
def _jax_step(params, qs, bn, opt, x, y, lam_t):
    """The step of the JAX package's ``benchmarks/common.py`` train_mlp."""
    ctx = JQuantCtx(quant=True, lam=lam_t, compute_dtype=jnp.float32)

    def loss_fn(params):
        logits, bn2 = jmlp.mlp_apply(params, qs, bn, x, ctx, train=True)
        return jmlp.cross_entropy(logits, y), bn2
    (loss, bn2), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
    params, opt, _ = jadam.apply(params, g, opt, jadam.AdamConfig(lr=LR))
    qs = jqat.update_qstate(params, qs, lam_t)
    return params, qs, bn2, opt, loss


def _jax_run(state, steps, start, lam, lam_ramp):
    params, qs, bn, opt = state
    losses = []
    for i in range(start, start + steps):
        b = _batch(i, batch=128)
        lam_t = float(jsched.lambda_ramp(i, lam=lam, ramp_steps=lam_ramp))
        params, qs, bn, opt, loss = _jax_step(
            params, qs, bn, opt, jnp.asarray(b["x"]),
            jnp.asarray(b["labels"]), lam_t)
        losses.append(float(loss))
    return (params, qs, bn, opt), losses


def test_one_train_step_from_carried_state():
    """After 3 JAX steps the state (weights, BN, probs, Adam m/v/step) is
    carried across and both take step 3: loss rtol=1e-5, params and probs
    atol=1e-6 (pre-BN biases 4·lr), codes after the step equal."""
    state, _ = _jax_run(_tiny_state(), 3, 0, lam=0.3, lam_ramp=4)
    carried = train_state_from_numpy(*_np(state), device="cpu")
    (jp, jq, _, _), (want_loss,) = _jax_run(state, 1, 3, lam=0.3, lam_ramp=4)
    b = _batch(3, batch=128)
    lam_t = float(tsched.lambda_ramp(3, lam=0.3, ramp_steps=4))
    tp, tq, _, topt, loss = ttrain.train_step(
        *carried, _t(b["x"]), _t(b["labels"]).long(), lam_t, lr=LR)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert int(topt["step"]) == 4
    paths = jax.tree_util.tree_flatten_with_path(jp)[0]
    for (path, w), g in zip(paths, tree.leaves(tp)):
        # The linear bias in front of BatchNorm has a zero gradient up to
        # rounding (BN subtracts the batch mean), and Adam's normalised
        # step turns that noise into moves of O(lr) in either package.
        pre_bn_bias = jax.tree_util.keystr(path).endswith("['bias']")
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=4 * LR if pre_bn_bias else 1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    for i, layer in enumerate(jp["layers"]):
        probs = jq["layers"][i]["kernel"]["probs"]
        np.testing.assert_allclose(
            tq["layers"][i]["kernel"]["probs"].numpy(), np.asarray(probs),
            atol=1e-6)
        want_codes = jecl.assign(layer["kernel"]["w"],
                                 layer["kernel"]["omega"], probs, 0.3)
        node = tp["layers"][i]["kernel"]
        got_codes = tecl.assign(node["w"], node["omega"],
                                tq["layers"][i]["kernel"]["probs"], 0.3)
        np.testing.assert_array_equal(got_codes.numpy(),
                                      np.asarray(want_codes))


def test_five_step_trajectory():
    """train_mlp from the same carried-across init as a JAX loop of the
    reference's step: every loss rtol=1e-4."""
    init = _tiny_state(seed=1)
    carried = train_state_from_numpy(*_np(init), device="cpu")
    _, want = _jax_run(init, 5, 0, lam=0.3, lam_ramp=2)
    _, _, _, metrics = ttrain.train_mlp(TTINY, lam=0.3, steps=5, lr=LR,
                                        lam_ramp=2, device="cpu",
                                        state=carried)
    assert len(metrics["losses"]) == 5
    np.testing.assert_allclose(metrics["losses"], want, rtol=1e-4)
    assert 0.0 <= metrics["sparsity"] <= 1.0
    assert 0.0 <= metrics["entropy_bits"] <= 4.0


def test_train_cli_on_cpu(capsys):
    metrics = ttrain.main(["--arch", "mlp-hr", "--steps", "3",
                           "--device", "cpu", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "step     2" in out and "frozen and served" in out
    assert len(metrics["losses"]) == 3
    assert np.isfinite(metrics["losses"]).all()
    assert metrics["serve_max_abs_err"] <= 1e-2


def test_train_cli_needs_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--arch", "mlp-hr", "--steps", "3"])


@pytest.mark.parametrize("arch,batch_keys", [
    ("qwen2-vl-2b", ["embeds", "labels"]),
    ("whisper-base", ["embeds", "labels", "tokens"])], ids=["vlm", "audio"])
def test_train_cli_refuses_lm_families(arch, batch_keys, tmp_path):
    """The LM branch refuses no family now: the vlm and audio smoke archs
    train a few steps on the reference's batches (vlm: patch embeddings
    and labels; audio: frame embeddings beside the decoder's tokens)."""
    hist = ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "2", "--seq", "8", "--batch", "2",
                        "--log-every", "1", "--ckpt-dir",
                        str(tmp_path / "ckpt")])
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    cfg = ttrain.lm_config(arch, smoke=True)
    assert sorted(ttrain.lm_batch_fn(cfg, batch=2, seq=8)(0)) == batch_keys
