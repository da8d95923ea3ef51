"""The port's vlm family (qwen2-vl-2b: M-RoPE, patch-embedding inputs)
against the JAX package, at its smoke config on the CPU.

The same inputs, drawn from numpy seeds, go through both packages; JAX's
trees are carried across with ``convert.lm_tree_from_numpy`` and the
reference's functions are jitted.  Tolerances: ``mrope_cos_sin`` within
1e-6 of the reference on distinct (t, h, w) streams and bitwise
``rope_cos_sin``'s on three identical ones; ``lm_apply(embeds=)`` logits
within 1e-5, with and without a cache; freeze codes bitwise, or a cost
tie within 4 ulp; greedy tokens equal to the reference's ``generate``;
the EC4T loss within 1e-5 and every gradient within 1e-4 (of the leaf's
largest |g|) of ``jax.grad`` of ``lm_forward_loss`` on the reference's
vlm batch (embeds and labels, no tokens).  Also the launchers on the CPU.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import bitplanes as jbp
from repro.core import qat as jqat
from repro.models import lm as jlm
from repro.nn import layers as jlayers
from repro.nn import transformer as JT
from repro.nn.module import QuantCtx as JQuantCtx
from repro_torch import tree
from repro_torch.checkpoint import manager as tman
from repro_torch.configs import get_config
from repro_torch.convert import lm_tree_from_numpy, tree_to_numpy
from repro_torch.core import bitplanes as tbp
from repro_torch.core import ecl as tecl
from repro_torch.core import qat as tqat
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.nn import layers as tlayers
from repro_torch.nn import transformer as TT
from repro_torch.nn.module import FP32_CTX

ARCH = "qwen2-vl-2b"
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
        params = JT.lm_init(jax.random.PRNGKey(0), cfg)
        qstate = jqat.build_qstate(params)
        _WORLD.update(cfg=cfg, params=params, qstate=qstate,
                      frozen=jqat.freeze_tree(params, qstate, cfg.lam))
    w = _WORLD
    return w["cfg"], w["params"], w["qstate"], w["frozen"]


def _embeds(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


# ------------------------------------------------------------------ M-RoPE

@pytest.mark.parametrize("sections,rotary_dim", [((16, 24, 24), 128),
                                                  ((2, 3, 3), 16)],
                         ids=["published", "smoke"])
def test_mrope_matches_reference_and_rope(sections, rotary_dim):
    """Distinct (t, h, w) streams up to position 8,207 at θ = 1e6: each
    pair's angle from its own stream, within 1e-6 of the reference; three
    identical streams give ``rope_cos_sin`` bit for bit."""
    rng = np.random.default_rng(sum(sections))
    pos = rng.integers(0, 8208, (3, 2, 9)).astype(np.int32)
    pos[:, 0, -1] = 8207
    want = jlayers.mrope_cos_sin(jnp.asarray(pos), rotary_dim, 1e6, sections)
    got = tlayers.mrope_cos_sin(torch.from_numpy(pos), rotary_dim, 1e6,
                                sections)
    for g, w in zip(got, want):
        assert g.shape == (2, 9, rotary_dim // 2) and g.dtype == torch.float32
        _close(g, w, dict(atol=1e-6, rtol=0))
    # each section equals rope_cos_sin of its own stream, bitwise
    start = 0
    for stream, width in enumerate(sections):
        ref = tlayers.rope_cos_sin(torch.from_numpy(pos[stream]), rotary_dim,
                                   1e6)
        for g, r in zip(got, ref):
            assert torch.equal(g[..., start:start + width],
                               r[..., start:start + width])
        start += width
    same = torch.from_numpy(pos[1])
    for g, r in zip(tlayers.mrope_cos_sin(torch.stack([same] * 3),
                                          rotary_dim, 1e6, sections),
                    tlayers.rope_cos_sin(same, rotary_dim, 1e6)):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="must sum to"):
        tlayers.mrope_cos_sin(torch.from_numpy(pos), rotary_dim + 2, 1e6,
                              sections)


# --------------------------------------------------------------- lm_apply

@pytest.mark.parametrize("weights", ["fp32", "frozen"])
def test_lm_apply_embeds_matches_reference(weights):
    """A prefill of 11 patch embeddings into a cache, then 3 decode steps
    by token id: logits within 1e-5 of the reference's, and the caches
    alike; a no-cache forward on the embeddings too."""
    cfg, params, qstate, frozen = _world()
    tcfg = get_config(ARCH).smoke()
    if weights == "frozen":
        params, qstate = frozen, 0
    tp, tq = _t(params), _t(qstate)
    b, s, steps = 2, 11, 3
    emb = _embeds(1, b, s, cfg.d_model)
    japply = jax.jit(lambda p, q, tok, emb, pos, c: JT.lm_apply(
        p, q, tok, JCTX, cfg, embeds=emb, positions=pos, cache=c))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    jl, _, _ = japply(params, qstate, None, jnp.asarray(emb),
                      jnp.asarray(pos), None)
    tl, none, _ = TT.lm_apply(tp, tq, None, FP32_CTX, tcfg,
                              embeds=torch.from_numpy(emb))
    assert none is None
    _close(tl, jl)

    toks = np.random.default_rng(2).integers(0, cfg.vocab, (b, steps))
    jcache = JT.init_cache(cfg, b, s + steps, dtype=jnp.float32)
    tcache = _t(jcache)
    jl, jcache, _ = japply(params, qstate, None, jnp.asarray(emb),
                           jnp.asarray(pos), jcache)
    tl, tcache, _ = TT.lm_apply(tp, tq, None, FP32_CTX, tcfg,
                                embeds=torch.from_numpy(emb),
                                positions=torch.from_numpy(pos),
                                cache=tcache)
    _close(tl, jl)
    for i in range(steps):
        tok = toks[:, i:i + 1].astype(np.int32)
        p_t = np.full((b, 1), s + i, np.int32)
        jl, jcache, _ = japply(params, qstate, jnp.asarray(tok), None,
                               jnp.asarray(p_t), jcache)
        tl, tcache, _ = TT.lm_apply(tp, tq, torch.from_numpy(tok), FP32_CTX,
                                    tcfg, positions=torch.from_numpy(p_t),
                                    cache=tcache)
        _close(tl, jl)
    want, got = dict(_named(_np(jcache))), dict(_named(tree_to_numpy(tcache)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_generate_matches_reference_tokens():
    """Greedy tokens from token prompts (the launcher's traffic) equal the
    reference's ``generate``."""
    cfg, _, _, frozen = _world()
    prompt = np.random.default_rng(6).integers(0, cfg.vocab, (2, 13))
    want = jlm.generate(frozen, 0, jnp.asarray(prompt, jnp.int32), JCTX, cfg,
                        max_new=4)
    got = tlm.generate(_t(frozen), 0, torch.from_numpy(prompt), FP32_CTX,
                       get_config(ARCH).smoke(), max_new=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- freezing

def _costs(w, omega, probs, lam):
    w, omega, probs = (torch.from_numpy(np.asarray(a)) for a in
                       (w, omega, probs))
    pen = tecl.penalty(w, probs, lam)
    book = tbp.codebook(omega)
    return (w[..., None] - book[..., None, None, :]) ** 2 \
        + pen[..., None, None, :]


def test_freeze_tree_codes_match_reference():
    """Every quantized leaf (q, k, v, o with their biases kept, gate, up,
    down): ω equal, codes equal but for cost ties within 4 ulp."""
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
    assert len(packed) == 7
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
    assert "/stacks/dense/attn/q/bias" in got


# ---------------------------------------------------------------- training

def test_loss_and_gradients_match_jax_grad():
    """The EC4T forward (fp32, λ 0.1) on the reference's vlm batch: the
    loss within 1e-5 and every gradient (masters, ω, biases, norms and
    the tied embedding, which only the readout reaches) within 1e-4 of
    ``jax.grad``'s."""
    cfg, params, qstate, _ = _world()
    tcfg = get_config(ARCH).smoke()
    batch = ttrain.lm_batch_fn(tcfg, batch=2, seq=12)(0)
    assert sorted(batch) == ["embeds", "labels"]
    jctx = JQuantCtx(quant=True, lam=LAM, compute_dtype=jnp.float32)

    def jloss(p):
        return jlm.lm_forward_loss(p, qstate, {k: jnp.asarray(v) for k, v in
                                               batch.items()}, jctx, cfg)[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    tp = _t(params)
    leaves = [t.requires_grad_() for t in tree.leaves(tp)]
    loss, metrics = tsteps._loss_fn(tcfg, dtype=torch.float32)(
        tree.unflatten(tp, leaves), _t(qstate),
        {k: torch.from_numpy(v) for k, v in batch.items()}, LAM)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert float(metrics["aux"]) == 0.0
    grads = tree.unflatten(tp, list(torch.autograd.grad(loss, leaves)))
    want, got = dict(_named(_np(jg))), dict(_named(tree_to_numpy(grads)))
    assert sorted(got) == sorted(want)
    for name in want:
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_train_launcher_trains_and_exports(tmp_path, capsys):
    """The LM branch on the vlm smoke config: 3 steps, a checkpoint, an
    export whose loaded tree equals ``freeze_tree`` of the trained state
    leaf for leaf."""
    cfg = ttrain.lm_config(ARCH, smoke=True)
    run = ttrain.train_lm(cfg, steps=3, batch=2, seq=12, lr=1e-3, lam=0.05,
                          lam_ramp=2, ckpt_dir=str(tmp_path / "ckpt"),
                          export=str(tmp_path / "export"), device="cpu",
                          metrics_every=1, log=print)
    out = capsys.readouterr().out
    assert "finished: done at step 3" in out and "export:" in out
    losses = [h["loss"] for h in run["history"]]
    assert len(losses) == 3 and np.isfinite(losses).all()
    st = run["state"]
    want = dict(tman._paths(tqat.freeze_tree(st["params"], st["qstate"],
                                             0.05)))
    got = dict(tman._paths(tman.frozen_tree(
        tman.load_quantized(str(tmp_path / "export"), device="cpu"),
        device="cpu")))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


def test_serve_launcher_serves_from_token_prompts(capsys):
    from repro_torch.launch import serve
    assert ARCH in serve.lm_archs()
    gen = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "6", "--max-new", "3"])
    assert gen.shape == (2, 3) and ((gen >= 0) & (gen < 256)).all()
    assert "M-RoPE sections (2, 3, 3)" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--engine: LMProgram serves "
                       "dense-family archs only, got 'vlm'"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--batch", "1", "--prompt-len", "4", "--max-new", "2",
                    "--engine"])
