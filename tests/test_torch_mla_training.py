"""MLA training and activation rematerialisation in the port against the
JAX package, on the CPU at smoke size.

* ``chunked_attention`` under autograd checkpoints each KV chunk's body,
  as the reference wraps its scan body in ``jax.checkpoint``: the same
  operations in the same order, so its outputs and gradients (q, k, v,
  and the MLA up-projection ``w_up`` read by ``kv_chunk_fn``) are bitwise
  those of the same loop without the checkpoint, and within 1e-5 of
  ``jax.grad`` of the reference's ``chunked_attention``; what it keeps
  for the backward is the chunks' inputs and carries, below half of one
  (B, H, Sq, Skv) fp32 tensor, where the loop without it keeps O(Sq·Skv).
* ``lm_apply(remat=...)``: ``full`` and ``dots`` give the loss and every
  gradient bitwise ``none``'s on smollm and deepseek-v3 (MLA) smoke, with
  the same grouped ECL passes (one a forward over every stack), and one
  fp32 EC4T step under ``full`` matches the reference's ``remat="full"``
  step (loss 1e-5, moments 1e-4 relative, probabilities 1e-6, params
  1e-5 where the gradient stands above fp32 noise).

The one fp32 EC4T step of deepseek-v3 smoke with MLA against
``repro.optim.ec4t`` is the ``"deepseek"`` case of
``tests/test_torch_moe_training.py``; the launcher's resume with
``--remat full`` a case of
``test_torch_lm_training.py::test_moe_launcher_resumes_where_an_uninterrupted_run_ends``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro.nn import transformer as JT
from repro.nn.module import QuantCtx as JQuantCtx
from repro.optim import adam as jadam
from repro.optim import ec4t as jec4t
from repro_torch import convert, tree
from repro_torch.configs import get_config
from repro_torch.core import ecl as tecl
from repro_torch.data import synthetic
from repro_torch.launch import steps as tsteps
from repro_torch.nn import attention as tattn
from repro_torch.nn import transformer as TT
from repro_torch.optim import adam as tadam
from repro_torch.optim import ec4t as tec4t

TOL = dict(atol=1e-5, rtol=1e-5)
LR, LAM = 1e-3, 0.2
STATE_ATOL, PROBS_ATOL, GRAD_REL = 1e-5, 1e-6, 1e-4
# smoke configs: deepseek-v3's with MLA, seq 40 = 3 KV chunks of its
# attn_chunk 16, the last one padded
ARCHS = ("smollm-360m", "deepseek-v3-671b")
BATCH, SEQ = 2, 40


# --------------------------------------- the chunk body's checkpoint

B, S, H, D, DV, R, ROPE = 2, 13, 4, 8, 6, 5, 3      # S = 13: chunks padded


def _attention_inputs(mla):
    rng = np.random.default_rng(20 + mla)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    if mla:     # the latent, the shared rope key and the up-projection
        parts = (rng.normal(size=(B, S, R)).astype(np.float32),
                 rng.normal(size=(B, S, ROPE)).astype(np.float32),
                 (rng.normal(size=(R, H, D - ROPE + DV)) * 0.5
                  ).astype(np.float32))
    else:       # GQA: 2 KV heads
        parts = (rng.normal(size=(B, S, 2, D)).astype(np.float32),
                 rng.normal(size=(B, S, 2, DV)).astype(np.float32))
    go = rng.normal(size=(B, S, H, DV)).astype(np.float32)
    return q, parts, go


def _decompress(xp, w_up):
    """MLA's ``kv_chunk_fn``: a chunk of (latent, rope key) to (K, V)."""
    nope = D - ROPE

    def fn(parts_c):
        ckv, kr = parts_c
        kvu = xp.einsum("bkr,rhd->bkhd", ckv, w_up)
        kr = xp.broadcast_to(kr[:, :, None, :], (*kr.shape[:2], H, ROPE))
        return (xp.concatenate([kvu[..., :nope], kr], axis=-1),
                kvu[..., nope:])
    return fn


class _TorchOps:
    einsum = staticmethod(torch.einsum)
    broadcast_to = staticmethod(torch.broadcast_to)

    @staticmethod
    def concatenate(ts, axis):
        return torch.cat(ts, dim=axis)


def _port_attention(q, parts, mla, chunk):
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    if mla:
        ckv, kr, w_up = parts
        return tattn.chunked_attention(
            q, (ckv, kr), q_pos=pos, kv_pos=pos, chunk=chunk, scale=0.3,
            n_kv=H, dv=DV, kv_chunk_fn=_decompress(_TorchOps, w_up))
    return tattn.chunked_attention(q, parts, q_pos=pos, kv_pos=pos,
                                   chunk=chunk, scale=0.3, n_kv=2, dv=DV)


def _port_grads(mla, chunk):
    q, parts, go = _attention_inputs(mla)
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, *parts)]
    out = _port_attention(ins[0], ins[1:], mla, chunk)
    return out, torch.autograd.grad(out, ins, torch.from_numpy(go))


@functools.lru_cache(maxsize=None)
def _jax_grads(mla, chunk):
    q, parts, go = _attention_inputs(mla)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))

    def f(q, *parts):
        if mla:
            ckv, kr, w_up = parts
            out = jattn.chunked_attention(
                q, (ckv, kr), q_pos=pos, kv_pos=pos, chunk=chunk, scale=0.3,
                n_kv=H, dv=DV, kv_chunk_fn=_decompress(jnp, w_up))
        else:
            out = jattn.chunked_attention(q, parts, q_pos=pos, kv_pos=pos,
                                          chunk=chunk, scale=0.3, n_kv=2,
                                          dv=DV)
        return jnp.sum(out * go), out
    argnums = tuple(range(1 + len(parts)))
    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=argnums, has_aux=True))(q, *parts)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _without_checkpoint(monkeypatch):
    """The loop as it ran before the checkpoint: the body called as is."""
    monkeypatch.setattr(tattn, "checkpoint",
                        lambda fn, *a, use_reentrant: fn(*a))


@pytest.mark.parametrize("chunk", [4, 7])
@pytest.mark.parametrize("mla", [False, True], ids=["gqa", "mla"])
def test_chunk_checkpoint_keeps_the_gradients_bitwise(monkeypatch, mla,
                                                      chunk):
    out, grads = _port_grads(mla, chunk)
    _without_checkpoint(monkeypatch)
    plain_out, plain_grads = _port_grads(mla, chunk)
    assert torch.equal(out, plain_out)
    assert len(grads) == (4 if mla else 3)       # q, k, v / q, ckv, kr, w_up
    for got, want in zip(grads, plain_grads):
        assert torch.equal(got, want)
    jout, jgrads = _jax_grads(mla, chunk)
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def _saved_bytes():
    """Bytes of the distinct storages autograd keeps for the backward of
    ``chunked_attention`` at B 1, Sq = Skv = 512, 16 heads of 16, chunk
    64, over one (B, H, Sq, Skv) fp32 tensor."""
    b, s, h, d = 1, 512, 16, 16
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=g).requires_grad_()
               for _ in range(3))
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tattn.chunked_attention(q, (k, v), q_pos=pos, kv_pos=pos,
                                      chunk=64, scale=d ** -0.5, n_kv=h,
                                      dv=d)
    assert out.requires_grad
    return sum(seen.values()) / (b * h * s * s * 4)


def test_chunk_checkpoint_keeps_only_the_chunks_inputs(monkeypatch):
    assert _saved_bytes() < 0.5
    _without_checkpoint(monkeypatch)
    assert _saved_bytes() > 2.0           # every chunk's scores and p


def test_serving_runs_the_loop_without_a_checkpoint(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("checkpoint under no_grad")
    monkeypatch.setattr(tattn, "checkpoint", refuse)
    q, parts, _ = _attention_inputs(True)
    with torch.no_grad():
        out = _port_attention(torch.from_numpy(q),
                              [torch.from_numpy(a) for a in parts], True, 4)
    np.testing.assert_allclose(out.numpy(), _jax_grads(True, 4)[0], **TOL)


# ------------------------------------------------------------- remat

def _batch(vocab, step):
    b = synthetic.lm_batch(synthetic.LMDataCfg(vocab=vocab, seq_len=SEQ,
                                               global_batch=BATCH), step)
    return ({"tokens": b["tokens"], "labels": b["labels"]},
            {"tokens": torch.from_numpy(b["tokens"]),
             "labels": torch.from_numpy(b["labels"])})


@functools.lru_cache(maxsize=None)
def _jax_world(arch):
    """A JAX train state of the smoke config, as numpy, and the state
    after one fp32 EC4T step of the reference with ``remat="full"``."""
    cfg = jget_config(arch).smoke()
    state = jec4t.init_train_state(JT.lm_init(jax.random.PRNGKey(5), cfg))

    def loss(p, qs, batch, lam):
        ctx = JQuantCtx(quant=True, lam=lam, compute_dtype=jnp.float32)
        return jlm.lm_forward_loss(p, qs, batch, ctx, cfg, remat="full")
    step = jax.jit(jec4t.make_train_step(loss, jadam.AdamConfig(lr=LR),
                                         lam=LAM))
    new, m = step(state, _batch(cfg.vocab, 0)[0])
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return as_np(state), as_np(new), float(m["loss"])


def _named(tree_, prefix=""):
    if isinstance(tree_, dict):
        for k in sorted(tree_):
            yield from _named(tree_[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree_)


class _CountMM(TorchDispatchMode):
    """Counts the 2-D products (``aten.mm``) run while in use."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _loss_and_grads(arch, remat, monkeypatch):
    """The port's fp32 loss and every gradient from the carried JAX state
    under ``remat``, with the segments of each grouped ECL pass and the
    products the backward ran."""
    state = convert.lm_train_state_from_numpy(_jax_world(arch)[0],
                                              device="cpu")
    cfg = get_config(arch).smoke()
    calls = []
    orig = tecl.quantize_many
    monkeypatch.setattr(tecl, "quantize_many", lambda ws, oms, pens: calls.append(
        sum(o[..., 0].numel() for o in oms)) or orig(ws, oms, pens))
    leaves = [t.detach().requires_grad_() for t in
              tree.leaves(state["params"])]
    loss, _ = tsteps._loss_fn(cfg, remat=remat, dtype=torch.float32)(
        tree.unflatten(state["params"], leaves), state["qstate"],
        _batch(cfg.vocab, 0)[1], LAM)
    with _CountMM() as mm:
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    monkeypatch.undo()
    return loss, grads, calls, mm.n


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_keeps_the_loss_and_every_gradient_bitwise(arch, monkeypatch):
    loss, grads, calls, mm = _loss_and_grads(arch, "none", monkeypatch)
    # one grouped pass a forward over every stack: smollm 2 layers x 7;
    # deepseek 5 MLA + 3 FFN (dense) + 5 MLA + 3 banks x 4 + 3 (MoE)
    assert calls == [{"smollm-360m": 14, "deepseek-v3-671b": 28}[arch]]
    assert sum(g is not None for g in grads) > 10
    recomputed = {}
    for remat in ("full", "dots"):
        r_loss, r_grads, r_calls, recomputed[remat] = _loss_and_grads(
            arch, remat, monkeypatch)
        assert torch.equal(r_loss, loss) and r_calls == calls
        for a, b in zip(r_grads, grads):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b)
    # full runs each layer's products again in the backward; dots keeps
    # them (dots_with_no_batch_dims_saveable)
    assert recomputed["dots"] == mm < recomputed["full"]


@pytest.mark.parametrize("arch", ARCHS)
def test_a_full_remat_step_matches_the_reference(arch):
    """Loss 1e-5; every moment within 1e-4 of its leaf's largest (the
    gradients' tolerance); probabilities 1e-6; params 1e-5 where the
    gradient stands above fp32 noise.  Adam's first update is
    lr·g/(|g| + eps): where the reference's |m| is under 1e-6 of its
    leaf's largest, both packages' g is rounding noise and the update
    may take any size up to lr, so there only |Δ| ≤ 2·lr is held."""
    before, want, jloss = _jax_world(arch)
    cfg = get_config(arch).smoke()
    state = convert.lm_train_state_from_numpy(before, device="cpu")
    step = tec4t.make_train_step(
        tsteps._loss_fn(cfg, remat="full", dtype=torch.float32),
        tadam.AdamConfig(lr=LR), lam=LAM)
    new, m = step(state, _batch(cfg.vocab, 0)[1])
    np.testing.assert_allclose(float(m["loss"]), jloss, **TOL)
    want = dict(_named(want))
    got = dict(_named(convert.tree_to_numpy(new)))
    assert sorted(got) == sorted(want)
    for name in want:
        diff = np.abs(got[name] - want[name])
        if name.startswith("/qstate"):
            assert diff.max() <= PROBS_ATOL, name
        elif name.startswith(("/opt/m", "/opt/v")):
            assert diff.max() <= GRAD_REL * np.abs(want[name]).max(), name
        elif name.startswith("/params"):
            moment = np.abs(want[name.replace("/params", "/opt/m", 1)])
            noise = moment < 1e-6 * moment.max()
            assert diff[~noise].max(initial=0) <= STATE_ATOL, name
            assert diff[noise].max(initial=0) <= 2 * LR, name


def test_remat_refuses_another_name():
    with pytest.raises(ValueError, match="remat='scan'"):
        tsteps._loss_fn(get_config("deepseek-v3-671b").smoke(),
                        remat="scan")
    with pytest.raises(ValueError, match="one of"):
        TT._remat(lambda: None, "bogus")
