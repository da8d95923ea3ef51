"""EC4T training of the ssm and hybrid families (mamba2-1.3b and
hymba-1.5b at their smoke configs) against the JAX package on the CPU.

The JAX package's train state is carried across as numpy
(``convert.lm_train_state_from_numpy``), so both packages step from the
same state.  Tolerances: one fp32 step's loss, ``ce`` and ``grad_norm``
within ``rtol=1e-5`` of JAX's jitted ``make_train_step``; the gradients,
read from Adam's first moment (m = (1 - β1)·g from m = 0), within
``rtol=1e-4`` and 1e-4 of each leaf's largest |m|.  Within the port:
``remat`` full and dots bitwise ``none``'s, a checkpoint restored
bitwise, the 4-bit export equal to ``freeze_tree`` and serving its
tokens, and the launcher (train, checkpoint, export, resume bitwise).
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.nn import transformer as JT
from repro.nn.module import QuantCtx as JQuantCtx
from repro.optim import adam as jadam
from repro.optim import ec4t as jec4t
from repro_torch import convert, tree
from repro_torch.checkpoint import manager as tman
from repro_torch.configs import get_config
from repro_torch.core import qat as tqat
from repro_torch.data import synthetic
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.nn import transformer as TT
from repro_torch.nn.module import FP32_CTX
from repro_torch.optim import adam as tadam
from repro_torch.optim import ec4t as tec4t

ARCHS = ("mamba2-1.3b", "hymba-1.5b")
LR, LAM = 1e-3, 0.1
BATCH, SEQ = 2, 20          # 20 tokens: two chunks of 8 and a ragged 4


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _named(tree_, prefix=""):
    if isinstance(tree_, dict):
        for k in sorted(tree_):
            yield from _named(tree_[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree_)


def _batch(vocab, step, seq=SEQ):
    b = synthetic.lm_batch(synthetic.LMDataCfg(vocab=vocab, seq_len=seq,
                                               global_batch=BATCH), step)
    return ({"tokens": b["tokens"], "labels": b["labels"]},
            {"tokens": torch.from_numpy(b["tokens"]),
             "labels": torch.from_numpy(b["labels"])})


def _port_step(arch, remat="none"):
    return tec4t.make_train_step(
        tsteps._loss_fn(get_config(arch).smoke(), remat=remat,
                        dtype=torch.float32),
        tadam.AdamConfig(lr=LR), lam=LAM)


# ------------------------------------------------------- the EC4T step

@pytest.mark.parametrize("arch", ARCHS)
def test_one_ec4t_step_matches_reference(arch):
    cfg = jget_config(arch).smoke()
    jstate = jec4t.init_train_state(JT.lm_init(jax.random.PRNGKey(0), cfg))
    tstate = convert.lm_train_state_from_numpy(_np(jstate), device="cpu")

    def jloss(p, qs, batch, lam):
        return jlm.lm_forward_loss(
            p, qs, batch, JQuantCtx(quant=True, lam=lam,
                                    compute_dtype=jnp.float32), cfg)
    jstep = jax.jit(jec4t.make_train_step(jloss, jadam.AdamConfig(lr=LR),
                                          lam=LAM))
    jb, tb = _batch(cfg.vocab, 0)
    jnew, jm = jstep(jstate, jb)
    tnew, tm = _port_step(arch)(tstate, tb)
    for key in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    want = dict(_named(_np(jnew["opt"]["m"])))
    got = dict(_named(convert.tree_to_numpy(tnew["opt"]["m"])))
    assert sorted(got) == sorted(want)
    ssm_leaves = [k for k in want if "/ssm/" in k]
    assert {k.split("/")[-1] for k in ssm_leaves} >= {
        "A_log", "D", "conv_b", "conv_w", "dt_bias", "norm_scale", "w",
        "omega"}
    for name in want:
        scale = float(np.abs(want[name]).max())
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
        # every SSD leaf takes a gradient
        if name in ssm_leaves:
            assert scale > 0, name


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_reduces_loss_direction(arch):
    """The port's mirror of tests/test_archs_smoke.py: three EC4T steps on
    the same batch, finite losses that descend."""
    cfg = get_config(arch).smoke()
    state = tec4t.init_train_state(TT.lm_init(cfg, seed=1, device="cpu"))
    step = tec4t.make_train_step(tsteps._loss_fn(cfg),
                                 tadam.AdamConfig(lr=1e-3), lam=cfg.lam)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 8)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_remat_is_bitwise_none_on_mamba2():
    """The loss and every gradient under ``full`` and ``dots`` equal
    ``none``'s bit for bit (each layer's SSD block recomputed in the
    backward), with the same ECL passes."""
    cfg = get_config("mamba2-1.3b").smoke()
    params = TT.lm_init(cfg, seed=2, device="cpu")
    qstate = tqat.build_qstate(params)
    batch = _batch(cfg.vocab, 3)[1]
    runs = {}
    for remat in TT.REMAT:
        leaves = [t.detach().requires_grad_() for t in tree.leaves(params)]
        p = tree.unflatten(params, leaves)
        loss, _ = tsteps._loss_fn(cfg, remat=remat, dtype=torch.float32)(
            p, qstate, batch, LAM)
        runs[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    base_loss, base_grads = runs["none"]
    assert all(torch.isfinite(g).all() for g in base_grads)
    for remat in ("full", "dots"):
        loss, grads = runs[remat]
        assert torch.equal(loss, base_loss), remat
        assert all(torch.equal(a, b) for a, b in zip(grads, base_grads)), \
            remat


# ---------------------------------------------- checkpoints and exports

def test_checkpoint_roundtrip_is_bitwise(tmp_path):
    """hymba's train state (both branches, the fp32 conv / A_log / D
    leaves and their moments) saved after a step restores bitwise into a
    fresh state."""
    cfg = get_config("hymba-1.5b").smoke()
    state = tec4t.init_train_state(TT.lm_init(cfg, seed=3, device="cpu"))
    state, _ = _port_step("hymba-1.5b")(state, _batch(cfg.vocab, 0)[1])
    mgr = tman.CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    fresh = tec4t.init_train_state(TT.lm_init(cfg, seed=5, device="cpu"))
    restored, meta = mgr.restore(fresh)
    assert meta["step"] == 1
    want = dict(_named(convert.tree_to_numpy(state)))
    got = dict(_named(convert.tree_to_numpy(restored)))
    assert sorted(got) == sorted(want)
    assert any(k.endswith("/ssm/conv_w") for k in want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_export_equals_freeze_tree_and_serves(arch, tmp_path):
    cfg = get_config(arch).smoke()
    params = TT.lm_init(cfg, seed=4, device="cpu")
    qs = tqat.build_qstate(params)
    report = tman.export_quantized(str(tmp_path), params, qs, 0.2)
    assert report["compression_ratio"] > 1
    frozen = tman.frozen_tree(tman.load_quantized(str(tmp_path),
                                                  device="cpu"),
                              device="cpu")
    want = dict(tman._paths(tqat.freeze_tree(params, qs, 0.2)))
    got = dict(tman._paths(frozen))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 10)))
    served = [tlm.generate(t, 0, prompt, FP32_CTX, cfg, max_new=4)
              for t in (frozen, tqat.freeze_tree(params, qs, 0.2))]
    assert torch.equal(served[0], served[1])


# ------------------------------------------------------- the launcher

@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_trains_checkpoints_and_exports(arch, tmp_path,
                                                       capsys):
    hist = ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "3", "--batch", "2", "--seq", "16",
                        "--log-every", "1", "--ckpt-dir",
                        str(tmp_path / "ckpt"), "--export",
                        str(tmp_path / "export")])
    out = capsys.readouterr().out
    assert [h["step"] for h in hist] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)
    assert "finished: done at step 3" in out and "export:" in out
    assert os.path.exists(tmp_path / "export" / "export.npz")
    assert os.listdir(tmp_path / "ckpt") == ["step_00000003"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain.main(["--arch", arch, "--smoke", "--steps", "1"])


def test_launcher_resumes_where_an_uninterrupted_run_ends(tmp_path):
    """mamba2 under ``--remat full``: a run restarted from its step-3
    checkpoint takes steps 4-6 as the uninterrupted run took them, bit
    for bit."""
    cfg = ttrain.lm_config("mamba2-1.3b", smoke=True)
    kw = dict(steps=6, batch=2, seq=16, lr=1e-3, lam=0.05, lam_ramp=2,
              ckpt_every=3, device="cpu", metrics_every=1, log=lambda s: 0,
              remat="full")
    whole = ttrain.train_lm(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_00000003",
                    tmp_path / "b" / "step_00000003")
    rest = ttrain.train_lm(cfg, ckpt_dir=str(tmp_path / "b"), **kw)
    assert rest["start"] == 3 and rest["reason"] == "done"
    assert [h["loss"] for h in whole["history"][3:]] == \
        [h["loss"] for h in rest["history"]]
    for a, b in zip(tree.leaves(whole["state"]), tree.leaves(rest["state"])):
        assert torch.equal(a, b)
