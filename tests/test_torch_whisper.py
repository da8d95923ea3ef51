"""The port's whisper-base (``models/whisper.py``: the encoder-decoder with
cross-attention) and its layers against the JAX package, at the smoke
config on the CPU.

The same inputs, drawn from numpy seeds, go through both packages; JAX's
trees are carried across with ``convert.lm_tree_from_numpy`` and the
reference's functions are jitted.  Tolerances: ``sinusoidal_positions``
within 1e-6 (at whisper's 1,500 x 512 too); ``gqa_apply(kv_override=)``,
the encoder, the cross K/V and the decoder with and without a cache
within 1e-5; freeze codes bitwise, or a cost tie within 4 ulp; greedy
tokens equal to the reference's prefill and decode bodies; the EC4T loss
within 1e-5 and every gradient within 1e-4 (of the leaf's largest |g|)
of ``jax.grad`` of ``whisper_forward_loss``.  Also: one grouped ECL call
a train forward, the reference's clamp of decoder positions past
``MAX_TGT``, and the launchers (train, resume bitwise, export ==
``freeze_tree``; serve exits with the reference's message).
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import bitplanes as jbp
from repro.core import qat as jqat
from repro.models import whisper as JW
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn.module import QuantCtx as JQuantCtx
from repro.optim import ec4t as jec4t
from repro_torch import convert, tree
from repro_torch.checkpoint import manager as tman
from repro_torch.configs import get_config
from repro_torch.convert import lm_tree_from_numpy, tree_to_numpy
from repro_torch.core import bitplanes as tbp
from repro_torch.core import ecl as tecl
from repro_torch.core import qat as tqat
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import whisper as W
from repro_torch.nn import attention as tattn
from repro_torch.nn import layers as tlayers
from repro_torch.nn.module import FP32_CTX, QuantCtx

ARCH = "whisper-base"
JCTX = JQuantCtx(quant=False, compute_dtype=jnp.float32)
TOL = dict(atol=1e-5, rtol=1e-5)
LAM = 0.1
_WORLD = {}


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _t(tree_):
    return lm_tree_from_numpy(_np(tree_), device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol)


def _named(tree_, prefix=""):
    if isinstance(tree_, dict):
        for k in sorted(tree_):
            yield from _named(tree_[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree_)


def _world():
    """(cfg, params, qstate, frozen) of the JAX package at smoke size."""
    if not _WORLD:
        cfg = jget_config(ARCH).smoke()
        params = JW.whisper_init(jax.random.PRNGKey(0), cfg)
        qstate = jqat.build_qstate(params)
        _WORLD.update(cfg=cfg, params=params, qstate=qstate,
                      frozen=jqat.freeze_tree(params, qstate, cfg.lam))
    w = _WORLD
    return w["cfg"], w["params"], w["qstate"], w["frozen"]


def _frames(seed, b, t, d):
    return np.random.default_rng(seed).standard_normal(
        (b, t, d)).astype(np.float32)


_jencode = jax.jit(lambda p, q, f, cfg: JW.whisper_encode(p, q, f, JCTX, cfg),
                   static_argnums=3)
_jcross = jax.jit(lambda p, q, e, cfg: JW.precompute_cross(p, q, e, JCTX, cfg),
                  static_argnums=3)
_jdecode = jax.jit(lambda p, q, tok, cross, pos, c, cfg: JW.whisper_decode(
    p, q, tok, cross, JCTX, cfg, positions=pos, cache=c), static_argnums=6)


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("n,d", [(1500, 512), (16, 64)])
def test_sinusoidal_positions_match_reference(n, d):
    want = np.asarray(jlayers.sinusoidal_positions(n, d))
    got = tlayers.sinusoidal_positions(n, d)
    assert got.shape == (n, d) and got.dtype == torch.float32
    _close(got, want, dict(atol=1e-6, rtol=0))
    assert tlayers.sinusoidal_positions(n, d, torch.bfloat16).dtype == \
        torch.bfloat16


def test_gqa_cross_attention_matches_reference():
    """Queries from x (with their bias), K and V supplied: no rotary, no
    causal mask, no cache update (a cache passed is left alone), key
    positions 0 .. Skv - 1; 21 keys in chunks of 8 (a padded chunk)."""
    rng = np.random.default_rng(3)
    p = jattn.gqa_init(jax.random.PRNGKey(3), 32, 4, 2, 8, quantize=False,
                       qkv_bias=True)
    p = jax.tree_util.tree_map(lambda a: a + 0.1, p)     # non-zero biases
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 21, 2, 8)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(30, 35, dtype=np.int32), (2, 5)).copy()
    cos_sin = tuple(jnp.asarray(a) for a in jlayers.rope_cos_sin(
        jnp.asarray(pos), 8, 1e4))
    want, none = jax.jit(lambda p, x, cs, pos, kv: jattn.gqa_apply(
        p, 0, x, JCTX, n_heads=4, n_kv=2, head_dim=8, cos_sin=cs,
        positions=pos, kv_override=kv, chunk=8))(
            p, jnp.asarray(x), cos_sin, jnp.asarray(pos),
            (jnp.asarray(k), jnp.asarray(v)))
    assert none is None
    cache = tattn.init_kv_cache(2, 8, 2, 8, torch.float32, device="cpu")
    got, new = tattn.gqa_apply(
        _t(p), 0, torch.from_numpy(x), FP32_CTX, n_heads=4, n_kv=2,
        head_dim=8, cos_sin=tuple(torch.tensor(np.asarray(a))
                                  for a in cos_sin),
        positions=torch.from_numpy(pos), cache=cache,
        kv_override=(torch.from_numpy(k), torch.from_numpy(v)), chunk=8)
    assert new is None and int(cache["len"]) == 0
    _close(got, want)


# ----------------------------------------------------------------- the model

def test_tree_round_trips_through_convert():
    """The whisper tree (``enc_layers``, ``dec_layers``, ``enc_ln``,
    ``dec_ln``, ``embed``, ``dec_pos``), its qstate, its frozen tree and
    its Adam state across and back, every array and dtype intact; the
    port's ``whisper_init`` builds the same keys and shapes."""
    cfg, params, _, frozen = _world()
    state = jec4t.init_train_state(params)
    for t in (state, frozen):
        want = _np(t)
        got = tree_to_numpy(convert.lm_train_state_from_numpy(want,
                                                             device="cpu"))
        flat_w, wdef = jax.tree_util.tree_flatten(want)
        flat_g, gdef = jax.tree_util.tree_flatten(got)
        assert wdef == gdef
        for a, b in zip(flat_w, flat_g):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    mine = dict(_named(tree_to_numpy(W.whisper_init(
        get_config(ARCH).smoke(), device="cpu"))))
    want = dict(_named(_np(params)))
    assert sorted(mine) == sorted(want)
    for k in want:
        assert mine[k].shape == want[k].shape and \
            mine[k].dtype == want[k].dtype, k


def test_init_dec_cache_matches_reference():
    cfg = jget_config(ARCH).smoke()
    jc = JW.init_dec_cache(cfg, 2, W.MAX_TGT)
    tc = W.init_dec_cache(get_config(ARCH).smoke(), 2, W.MAX_TGT,
                          device="cpu")
    assert jc["attn"]["k"].dtype == jnp.bfloat16 and \
        tc["attn"]["k"].dtype == torch.bfloat16
    want = dict(_named(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                             else a), jc)))
    got = dict(_named(tree_to_numpy(tree.map_(
        lambda t: t.float() if t.dtype == torch.bfloat16 else t, tc))))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("weights", ["fp32", "frozen"])
def test_encode_cross_and_decode_match_reference(weights):
    """21 frames (a padded KV chunk of the encoder's bidirectional
    attention), the cross K/V, then the decoder: a 4-token prefill into a
    ``MAX_TGT`` cache and 3 decode steps, and a no-cache decode of all 7
    tokens; logits and the cache within 1e-5 of the reference's."""
    cfg, params, qstate, frozen = _world()
    tcfg = get_config(ARCH).smoke()
    if weights == "frozen":
        params, qstate = frozen, 0
    tp, tq = _t(params), _t(qstate)
    b = 2
    frames = _frames(5, b, 21, cfg.d_model)
    jenc = _jencode(params, qstate, jnp.asarray(frames), cfg)
    tenc = W.whisper_encode(tp, tq, torch.from_numpy(frames), FP32_CTX, tcfg)
    _close(tenc, jenc)
    jcross = _jcross(params, qstate, jenc, cfg)
    tcross = W.precompute_cross(tp, tq, tenc, FP32_CTX, tcfg)
    for g, w in zip(tcross, jcross):
        assert g.shape == (cfg.n_layers, b, 21, cfg.n_kv, 16)
        _close(g, w)

    toks = np.random.default_rng(6).integers(0, cfg.vocab, (b, 7)).astype(
        np.int32)
    jcache = JW.init_dec_cache(cfg, b, W.MAX_TGT, dtype=jnp.float32)
    tcache = _t(jcache)
    steps = [(0, 4)] + [(t, t + 1) for t in range(4, 7)]
    cached = []
    for t0, t1 in steps:
        pos = np.broadcast_to(np.arange(t0, t1, dtype=np.int32),
                              (b, t1 - t0)).copy()
        jl, jcache = _jdecode(params, qstate, jnp.asarray(toks[:, t0:t1]),
                              jcross, jnp.asarray(pos), jcache, cfg)
        tl, tcache = W.whisper_decode(tp, tq, torch.from_numpy(toks[:, t0:t1]),
                                      tcross, FP32_CTX, tcfg,
                                      positions=torch.from_numpy(pos),
                                      cache=tcache)
        _close(tl, jl)
        cached.append(tl[:, -1])
    want, got = dict(_named(_np(jcache))), dict(_named(tree_to_numpy(tcache)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    jl, none = _jdecode(params, qstate, jnp.asarray(toks), jcross, None,
                        None, cfg)
    tl, tnone = W.whisper_decode(tp, tq, torch.from_numpy(toks), tcross,
                                 FP32_CTX, tcfg)
    assert none is None and tnone is None
    _close(tl, jl)
    # the cached steps equal the no-cache decode at their positions
    _close(torch.stack(cached[1:], 1), tl[:, 4:].detach())


def test_positions_past_max_tgt_are_clamped_as_the_reference():
    """A no-cache decode at explicit positions 446-449: the reference's
    gather reads row 447 for 448 and 449, and so does the port."""
    cfg, _, _, frozen = _world()
    tcfg, tf = get_config(ARCH).smoke(), _t(frozen)
    frames = _frames(7, 1, 16, cfg.d_model)
    jcross = _jcross(frozen, 0, _jencode(frozen, 0, jnp.asarray(frames), cfg),
                     cfg)
    tcross = tuple(torch.tensor(np.asarray(a)) for a in jcross)
    toks = np.array([[3, 9, 27, 81]], np.int32)
    pos = np.array([[446, 447, 448, 449]], np.int32)
    jl, _ = _jdecode(frozen, 0, jnp.asarray(toks), jcross, jnp.asarray(pos),
                     None, cfg)
    tl, _ = W.whisper_decode(tf, 0, torch.from_numpy(toks), tcross, FP32_CTX,
                             tcfg, positions=torch.from_numpy(pos))
    _close(tl, jl)
    clamped, _ = W.whisper_decode(
        tf, 0, torch.from_numpy(toks), tcross, FP32_CTX, tcfg,
        positions=torch.tensor([[446, 447, 447, 447]], dtype=torch.int32))
    assert torch.equal(tl, clamped)


# ---------------------------------------------------------------- freezing

def _costs(w, omega, probs, lam):
    w, omega, probs = (torch.from_numpy(np.asarray(a)) for a in
                       (w, omega, probs))
    pen = tecl.penalty(w, probs, lam)
    book = tbp.codebook(omega)
    return (w[..., None] - book[..., None, None, :]) ** 2 \
        + pen[..., None, None, :]


def test_freeze_tree_codes_match_reference():
    """Both stacks' 16 quantized leaves (encoder q, k, v, o, fc1, fc2;
    decoder the same and the cross q, k, v, o): ω equal, codes equal but
    for cost ties within 4 ulp; every other leaf kept."""
    _, params, qstate, _ = _world()
    rng = np.random.default_rng(4)
    qstate = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.dirichlet(np.ones(16), a.shape[:-1])
                              .astype(np.float32))
        if a.ndim and a.shape[-1] == 16 and a.dtype == jnp.float32 else a,
        qstate)
    want = dict(_named(_np(jqat.freeze_tree(params, qstate, 0.3))))
    got = dict(_named(tree_to_numpy(tqat.freeze_tree(_t(params), _t(qstate),
                                                     0.3))))
    assert sorted(got) == sorted(want)
    src, qs = dict(_named(_np(params))), dict(_named(_np(qstate)))
    packed = [k for k in want if k.endswith("/packed")]
    assert len(packed) == 16
    for k in want:
        if not k.endswith("/packed"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            continue
        jc = np.asarray(jbp.unpack_codes_rows(jnp.asarray(want[k])))
        tc = tbp.unpack_codes_rows(torch.from_numpy(got[k])).numpy()
        base = k[:-len("/packed")]
        diff = np.argwhere(jc != tc)
        if len(diff):
            cost = _costs(src[base + "/w"], src[base + "/omega"],
                          qs[base + "/probs"], 0.3).numpy()
            for idx in map(tuple, diff):
                x, y = cost[idx + (jc[idx],)], cost[idx + (tc[idx],)]
                assert abs(x - y) <= 4 * np.spacing(
                    np.float32(max(abs(x), abs(y)))), (k, idx)


# ---------------------------------------------------------------- serving

def _jprefill_body(params, frames, prompt, cfg):
    """The reference's prefill step body (``build_prefill_step``, audio),
    in fp32 with an fp32 cache."""
    enc = JW.whisper_encode(params, 0, frames, JCTX, cfg)
    cross = JW.precompute_cross(params, 0, enc, JCTX, cfg)
    cache = JW.init_dec_cache(cfg, frames.shape[0], JW.MAX_TGT,
                              dtype=jnp.float32)
    logits, cache = JW.whisper_decode(params, 0, prompt, cross, JCTX, cfg,
                                      cache=cache)
    return jnp.argmax(logits[:, -1:, :cfg.vocab], -1).astype(jnp.int32), \
        cache, cross


def _jdecode_body(params, tokens, cross, positions, cache, cfg):
    """The reference's decode step body (``build_decode_step``, audio)."""
    logits, cache = JW.whisper_decode(params, 0, tokens, cross, JCTX, cfg,
                                      positions=positions, cache=cache)
    return jnp.argmax(logits[:, -1:, :cfg.vocab], -1).astype(jnp.int32), \
        cache


def test_greedy_tokens_equal_the_reference_step_bodies():
    """16 frames, a 4-token prompt, 6 greedy tokens: the port's encode,
    cross, ``init_dec_cache(MAX_TGT)``, prompt decode and cached decode
    steps give the reference's prefill and decode bodies' tokens."""
    cfg, _, _, frozen = _world()
    tcfg, tf = get_config(ARCH).smoke(), _t(frozen)
    b, s, new = 2, 4, 6
    frames = _frames(8, b, cfg.enc_len, cfg.d_model)
    prompt = np.random.default_rng(9).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)
    prefill = jax.jit(_jprefill_body, static_argnums=3)
    decode = jax.jit(_jdecode_body, static_argnums=5)
    nxt, cache, cross = prefill(frozen, jnp.asarray(frames),
                                jnp.asarray(prompt), cfg)
    want = [nxt]
    for t in range(new - 1):
        nxt, cache = decode(frozen, nxt, cross,
                            jnp.full((b, 1), s + t, jnp.int32), cache, cfg)
        want.append(nxt)
    want = np.concatenate([np.asarray(w) for w in want], 1)

    enc = W.whisper_encode(tf, 0, torch.from_numpy(frames), FP32_CTX, tcfg)
    tcross = W.precompute_cross(tf, 0, enc, FP32_CTX, tcfg)
    tcache = W.init_dec_cache(tcfg, b, W.MAX_TGT, dtype=torch.float32,
                              device="cpu")
    logits, tcache = W.whisper_decode(tf, 0, torch.from_numpy(prompt),
                                      tcross, FP32_CTX, tcfg, cache=tcache)
    got = [torch.argmax(logits[:, -1:, :tcfg.vocab], -1)]
    for t in range(new - 1):
        logits, tcache = W.whisper_decode(
            tf, 0, got[-1], tcross, FP32_CTX, tcfg,
            positions=torch.full((b, 1), s + t, dtype=torch.int32),
            cache=tcache)
        got.append(torch.argmax(logits[:, -1:, :tcfg.vocab], -1))
    np.testing.assert_array_equal(torch.cat(got, 1).numpy(), want)


def test_serve_launcher_exits_with_the_reference_message():
    from repro_torch.launch import serve
    assert ARCH not in serve.lm_archs()
    with pytest.raises(SystemExit, match="use examples/serve_whisper-style "
                       "driving for enc-dec"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


# ---------------------------------------------------------------- training

def test_loss_and_gradients_match_jax_grad():
    """``whisper_forward_loss`` under EC4T (fp32, λ 0.1) on the launcher's
    audio batch (frames, tokens, labels): the loss within 1e-5 and every
    gradient within 1e-4 of ``jax.grad``'s."""
    cfg, params, qstate, _ = _world()
    tcfg = get_config(ARCH).smoke()
    batch = ttrain.lm_batch_fn(tcfg, batch=2, seq=10)(0)
    assert batch["embeds"].shape == (2, cfg.enc_len, cfg.d_model)
    jctx = JQuantCtx(quant=True, lam=LAM, compute_dtype=jnp.float32)

    def jloss(p):
        return JW.whisper_forward_loss(p, qstate, {
            k: jnp.asarray(v) for k, v in batch.items()}, jctx, cfg)[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    tp = _t(params)
    leaves = [t.requires_grad_() for t in tree.leaves(tp)]
    loss, metrics = tsteps._loss_fn(tcfg, remat="full", dtype=torch.float32)(
        tree.unflatten(tp, leaves), _t(qstate),
        {k: torch.from_numpy(v) for k, v in batch.items()}, LAM)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert sorted(metrics) == ["aux", "ce", "loss"]
    grads = tree.unflatten(tp, list(torch.autograd.grad(loss, leaves)))
    want, got = dict(_named(_np(jg))), dict(_named(tree_to_numpy(grads)))
    assert sorted(got) == sorted(want)
    for name in want:
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_one_grouped_ecl_call_a_train_forward(monkeypatch):
    """The train forward quantizes both stacks once, in one grouped call
    over all 32 smoke segments (2 x 6 encoder + 2 x 10 decoder leaves):
    the cross k and v are not quantized again.  The encoder called alone
    on the masters quantizes leaf by leaf, one call a (layer, leaf), with
    the same result bit for bit."""
    calls = []
    orig = tecl.quantize_many
    monkeypatch.setattr(
        tecl, "quantize_many", lambda ws, oms, pens: calls.append(
            sum(o[..., 0].numel() for o in oms)) or orig(ws, oms, pens))
    cfg = get_config(ARCH).smoke()
    params = W.whisper_init(cfg, seed=1, device="cpu")
    qstate = tqat.build_qstate(params)
    batch = {k: torch.from_numpy(v) for k, v in
             ttrain.lm_batch_fn(cfg, batch=2, seq=6)(0).items()}
    ctx = QuantCtx(quant=True, lam=LAM, compute_dtype=torch.float32)
    loss, _ = W.whisper_forward_loss(params, qstate, batch, ctx, cfg)
    assert calls == [32] and torch.isfinite(loss)
    calls.clear()
    with torch.no_grad():
        alone = W.whisper_encode(params, qstate, batch["embeds"], ctx, cfg)
        assert calls == [1] * 12
        grouped = W.whisper_encode(W.quantize_layers(params, qstate, ctx),
                                   qstate, batch["embeds"], ctx, cfg)
    assert torch.equal(alone, grouped)


def test_train_launcher_resumes_bitwise_and_exports(tmp_path, capsys):
    """3 steps with checkpoints at 2 and 3 and an export; a run restarted
    from the step-2 checkpoint alone takes step 3 bit for bit, and the
    export loads as ``freeze_tree`` of the trained state.  ``--seq`` past
    ``MAX_TGT`` is refused."""
    cfg = ttrain.lm_config(ARCH, smoke=True)
    kw = dict(steps=3, batch=2, seq=8, lr=1e-3, lam=0.05, lam_ramp=2,
              ckpt_every=2, device="cpu", metrics_every=1, log=print)
    whole = ttrain.train_lm(cfg, ckpt_dir=str(tmp_path / "a"),
                            export=str(tmp_path / "export"), **kw)
    assert "export:" in capsys.readouterr().out
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_00000002",
                    tmp_path / "b" / "step_00000002")
    rest = ttrain.train_lm(cfg, ckpt_dir=str(tmp_path / "b"), **kw)
    assert rest["start"] == 2 and rest["reason"] == "done"
    assert [h["loss"] for h in whole["history"][2:]] == \
        [h["loss"] for h in rest["history"]]
    for a, b in zip(tree.leaves(whole["state"]), tree.leaves(rest["state"])):
        assert torch.equal(a, b)
    st = whole["state"]
    want = dict(tman._paths(tqat.freeze_tree(st["params"], st["qstate"],
                                             0.05)))
    got = dict(tman._paths(tman.frozen_tree(
        tman.load_quantized(str(tmp_path / "export"), device="cpu"),
        device="cpu")))
    assert sorted(got) == sorted(want) and len(want) > 16
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    with pytest.raises(ValueError, match="--seq 449: whisper-base-smoke's "
                       "decoder holds 448 positions"):
        ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--seq", "449", "--steps", "1"])
