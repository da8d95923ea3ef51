"""The port's Mamba2 SSD block (``nn/ssm.py``) and the ssm and hybrid
stacks (mamba2-1.3b, hymba-1.5b) against the JAX package, at small and
smoke sizes on the CPU.

The same inputs, drawn from numpy seeds, go through both packages; JAX's
parameter trees are carried across with ``convert.lm_tree_from_numpy``.
Tolerances: ``ssd_chunked`` within ``atol=rtol=1e-5`` of the reference
and of a sequential recurrence in fp64 (the port loops over the chunk
states where the reference runs an associative scan, so the sums differ
in order); its gradients within 1e-5 of ``jax.grad`` and finite;
``ssm_apply`` / ``ssm_step`` and whole-stack logits within 1e-5; freeze
codes bitwise, or a cost tie within 4 ulp; greedy tokens equal.  Also the
cache (``init_cache`` with and without ``cap_window``) against the
reference's, and the serve launcher on both archs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import bitplanes as jbp
from repro.core import qat as jqat
from repro.models import lm as jlm
from repro.nn import ssm as jssm
from repro.nn import transformer as JT
from repro.nn.module import QuantCtx as JQuantCtx
from repro_torch.configs import get_config
from repro_torch.convert import lm_tree_from_numpy, tree_to_numpy
from repro_torch.core import bitplanes as tbp
from repro_torch.core import qat as tqat
from repro_torch.models import lm as tlm
from repro_torch.nn import ssm as tssm
from repro_torch.nn import transformer as TT
from repro_torch.nn.module import FP32_CTX

JCTX = JQuantCtx(quant=False, compute_dtype=jnp.float32)
# the reference's functions jitted: one compile a shape instead of one
# per operation (the JAX side dominates these tests' time)
_jssd = jax.jit(jssm.ssd_chunked, static_argnums=4)
TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("mamba2-1.3b", "hymba-1.5b")
# the reference tests' small block: 2 groups, so a head-to-group mapping
# other than repeat_interleave's shows
SMALL = dict(d_model=16, d_inner=32, n_heads=4, d_state=8, n_groups=2,
             chunk=4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return lm_tree_from_numpy(_np(tree), device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol)


def _ssd_inputs(seed, b, s, with_init, h=4, p=3, g=2, n=5, decay=1.0):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(b, s, h, p)).astype(f)
    a = (-np.abs(rng.normal(size=(b, s, h))) * decay).astype(f)
    B = rng.normal(size=(b, s, g, n)).astype(f)
    C = rng.normal(size=(b, s, g, n)).astype(f)
    s0 = rng.normal(size=(b, h, p, n)).astype(f) if with_init else None
    return x, a, B, C, s0


def _naive(x, a, B, C, s0=None):
    """The sequential recurrence in fp64 (the reference test's ``_naive``):
    s_t = exp(a_t)·s_{t-1} + x_t ⊗ B_t, y_t = s_t · C_t, group g of B and C
    serving heads g·h/G .. (g+1)·h/G - 1."""
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    Bh, Ch = np.repeat(B, rep, 2), np.repeat(C, rep, 2)
    st = np.zeros((b, h, p, B.shape[3])) if s0 is None \
        else s0.astype(np.float64)
    ys = []
    for t in range(s):
        st = st * np.exp(a[:, t].astype(np.float64))[..., None, None] \
            + np.einsum("bhp,bhn->bhpn", x[:, t], Bh[:, t])
        ys.append(np.einsum("bhpn,bhn->bhp", st, Ch[:, t]))
    return np.stack(ys, 1), st


# ----------------------------------------------------------- the SSD scan

@pytest.mark.parametrize("b,s,chunk,with_init", [
    (1, 1, 2, False), (3, 7, 2, True), (3, 20, 8, True), (1, 20, 8, False),
    (3, 1, 8, True), (1, 16, 8, True)])
def test_ssd_chunked_matches_reference_and_naive(b, s, chunk, with_init):
    """Ragged last chunks (7 of 2, 20 of 8, 1 of 8), a carried-in state,
    2 groups over 4 heads."""
    x, a, B, C, s0 = _ssd_inputs(b * 100 + s, b, s, with_init)
    jy, jf = _jssd(*map(jnp.asarray, (x, a, B, C)), chunk,
                   None if s0 is None else jnp.asarray(s0))
    ty, tf = tssm.ssd_chunked(*map(torch.from_numpy, (x, a, B, C)), chunk,
                              init_state=None if s0 is None
                              else torch.from_numpy(s0))
    assert ty.shape == (b, s, 4, 3) and tf.shape == (b, 4, 3, 5)
    assert ty.dtype == tf.dtype == torch.float32
    _close(ty, jy)
    _close(tf, jf)
    ny, nf = _naive(x, a, B, C, s0)
    _close(ty, ny)
    _close(tf, nf)


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_gradients_are_finite_and_match_jax(with_init):
    """Strong decays (a down to about -100 a step) overflow exp above the
    diagonal of a chunk's decay matrix: the mask inside the exp keeps every
    gradient finite, and each equals ``jax.grad``'s within 1e-5."""
    x, a, B, C, s0 = _ssd_inputs(7, 2, 13, with_init, decay=40.0)
    rng = np.random.default_rng(8)
    wy = rng.normal(size=(2, 13, 4, 3)).astype(np.float32)
    wf = rng.normal(size=(2, 4, 3, 5)).astype(np.float32)
    args = [x, a, B, C] + ([s0] if with_init else [])

    def jloss(*xs):
        y, f = jssm.ssd_chunked(*xs[:4], 4,
                                init_state=xs[4] if with_init else None)
        return jnp.sum(y * wy) + jnp.sum(f * wf)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(len(args)))))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(v).requires_grad_() for v in args]
    y, f = tssm.ssd_chunked(*ts[:4], 4,
                            init_state=ts[4] if with_init else None)
    got = torch.autograd.grad((y * torch.from_numpy(wy)).sum()
                              + (f * torch.from_numpy(wf)).sum(), ts)
    for name, g, w in zip("x a B C s0".split(), got, want):
        assert torch.isfinite(g).all(), name
        _close(g, w)


def test_segsum_exp_masks_inside_the_exp():
    a = torch.tensor([[-1.0, -500.0, -2.0]], requires_grad=True)
    L = tssm._segsum_exp(a)
    assert torch.equal(L[0].triu(1), torch.zeros(3, 3))
    _close(L, jssm._segsum_exp(jnp.asarray(a.detach().numpy())))
    (g,) = torch.autograd.grad(L.sum(), a)
    assert torch.isfinite(g).all()


# ------------------------------------------------------------ the block

def _small_block(seed, weights):
    """The reference test's block (2 groups), from JAX's init, quantized:
    fp32 reads each projection's master weights, frozen its 4-bit codes."""
    cfg = jssm.SSMCfg(**SMALL)
    p = jssm.ssm_init(jax.random.PRNGKey(seed), cfg, quantize=True)
    q = jqat.build_qstate(p)
    if weights == "frozen":
        p, q = jqat.freeze_tree(p, q, 0.1), 0
    return cfg, tssm.SSMCfg(**SMALL), p, q


@pytest.mark.parametrize("weights", ["fp32", "frozen"])
def test_ssm_apply_and_step_match_reference(weights):
    """Sequence mode from zeros and from a carried state (11 steps: 2
    ragged chunks of 4 and 3), then 3 decode steps from the final state:
    outputs, the SSM state and the conv tail within 1e-5."""
    jcfg, tcfg, p, q = _small_block(0, weights)
    tp, tq = _t(p), _t(q)
    japply = jax.jit(lambda p, q, u, st: jssm.ssm_apply(p, q, u, JCTX, jcfg,
                                                        state=st))
    jstep = jax.jit(lambda p, q, u, st: jssm.ssm_step(p, q, u, JCTX, jcfg,
                                                      st))
    u = np.random.default_rng(1).normal(size=(2, 14, 16)).astype(np.float32)
    rng = np.random.default_rng(2)
    seed_state = {"ssm": rng.normal(size=(2, 4, 8, 8)).astype(np.float32),
                  "conv": rng.normal(size=(2, 3, 64)).astype(np.float32)}
    for state in (None, seed_state):
        jy, jst = japply(p, q, jnp.asarray(u[:, :11]),
                         None if state is None else _np(state))
        ty, tst = tssm.ssm_apply(tp, tq, torch.from_numpy(u[:, :11]),
                                 FP32_CTX, tcfg,
                                 state=None if state is None
                                 else _t(state))
        _close(ty, jy)
        for key in ("ssm", "conv"):
            _close(tst[key], jst[key])
    for t in range(11, 14):
        jy, jst = jstep(p, q, jnp.asarray(u[:, t:t + 1]), jst)
        ty, tst = tssm.ssm_step(tp, tq, torch.from_numpy(u[:, t:t + 1]),
                                FP32_CTX, tcfg, tst)
        assert ty.shape == (2, 1, 16)
        _close(ty, jy)
        for key in ("ssm", "conv"):
            _close(tst[key], jst[key])


def _port_block(seed, **kw):
    cfg = tssm.SSMCfg(**{**SMALL, **kw})
    g = torch.Generator().manual_seed(seed)
    return cfg, tssm.ssm_init(g, cfg, quantize=False)


def test_block_sequence_equals_decode():
    """The port's mirror of tests/test_ssm.py: 11 decode steps from zeros
    give the sequence mode's outputs and final state."""
    cfg, p = _port_block(0)
    u = torch.randn((2, 11, 16), generator=torch.Generator().manual_seed(0))
    yseq, fstate = tssm.ssm_apply(p, 0, u, FP32_CTX, cfg)
    st = tssm.init_ssm_state(2, cfg)
    ys = []
    for t in range(11):
        yt, st = tssm.ssm_step(p, 0, u[:, t:t + 1], FP32_CTX, cfg, st)
        ys.append(yt)
    _close(torch.cat(ys, 1), yseq.numpy(), dict(atol=1e-4, rtol=0))
    _close(st["ssm"], fstate["ssm"].numpy(), dict(atol=1e-4, rtol=0))
    _close(st["conv"], fstate["conv"].numpy())


def test_prefill_continuation():
    """apply(first 6) seeds apply(last 4) == apply(all 10)."""
    cfg, p = _port_block(1, d_model=8, d_inner=16, n_heads=2, d_state=4,
                         n_groups=1)
    u = torch.randn((1, 10, 8), generator=torch.Generator().manual_seed(1))
    full, _ = tssm.ssm_apply(p, 0, u, FP32_CTX, cfg)
    y1, st1 = tssm.ssm_apply(p, 0, u[:, :6], FP32_CTX, cfg)
    y2, _ = tssm.ssm_apply(p, 0, u[:, 6:], FP32_CTX, cfg, state=st1)
    _close(torch.cat([y1, y2], 1), full.numpy(), dict(atol=1e-4, rtol=0))


# -------------------------------------------------------- the whole stack

_WORLDS = {}


def _jax_world(arch):
    """(cfg, params, qstate, frozen) of the JAX package at smoke size, made
    once per arch in this process."""
    if arch not in _WORLDS:
        cfg = jget_config(arch).smoke()
        params = JT.lm_init(jax.random.PRNGKey(0), cfg)
        qstate = jqat.build_qstate(params)
        _WORLDS[arch] = (cfg, params, qstate,
                         jqat.freeze_tree(params, qstate, cfg.lam))
    return _WORLDS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_stack_has_the_reference_leaves(arch):
    """The port's ``lm_init`` builds the reference's tree: every key and
    shape (an ssm layer with no attention, FFN or ln2; a hybrid layer with
    both branches, their two RMS norms and an MLP)."""
    _, params, _, _ = _jax_world(arch)
    want = dict(_flat(_np(params)))
    got = dict(_flat(tree_to_numpy(
        TT.lm_init(get_config(arch).smoke(), device="cpu"))))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == \
            want[k].dtype, k
    kind = get_config(arch).family
    assert sorted(TT.lm_init(get_config(arch).smoke(), device="cpu")
                  ["stacks"]) == [kind]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch,weights", [
    (arch, weights) for arch in ARCHS for weights in ("fp32", "frozen")])
def test_lm_apply_matches_reference_prefill_and_cached_decode(arch, weights):
    """A prefill of 11 tokens (a ragged chunk of 8 and 3), then 3 decode
    steps through the cache: logits within 1e-5 of the reference's, and
    the caches alike."""
    cfg, params, qstate, frozen = _jax_world(arch)
    tcfg = get_config(arch).smoke()
    if weights == "frozen":
        params, qstate = frozen, 0
    tparams, tq = _t(params), _t(qstate)
    b, s, steps = 2, 11, 3
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (b, s + steps))
    jcache = JT.init_cache(cfg, b, s + steps, dtype=jnp.float32)
    tcache = _t(jcache)
    japply = jax.jit(lambda p, q, tok, pos, c: JT.lm_apply(
        p, q, tok, JCTX, cfg, positions=pos, cache=c))
    for t0, t1 in [(0, s)] + [(s + i, s + i + 1) for i in range(steps)]:
        tok = toks[:, t0:t1].astype(np.int32)
        pos = np.broadcast_to(np.arange(t0, t1, dtype=np.int32),
                              tok.shape).copy()
        jl, jcache, _ = japply(params, qstate, jnp.asarray(tok),
                               jnp.asarray(pos), jcache)
        tl, tcache, _ = TT.lm_apply(tparams, tq, torch.from_numpy(tok),
                                    FP32_CTX, tcfg,
                                    positions=torch.from_numpy(pos),
                                    cache=tcache)
        _close(tl, jl)
    want, got = dict(_flat(_np(jcache))), dict(_flat(tree_to_numpy(tcache)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_lm_apply_without_cache_matches_reference():
    cfg, _, _, frozen = _jax_world("mamba2-1.3b")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (3, 9))
    jl, _, _ = JT.lm_apply(frozen, 0, jnp.asarray(toks), JCTX, cfg)
    tl, none, _ = TT.lm_apply(_t(frozen), 0, torch.from_numpy(toks),
                              FP32_CTX, get_config("mamba2-1.3b").smoke())
    assert none is None
    _close(tl, jl)


def _costs(w, omega, probs, lam):
    from repro_torch.core import ecl
    w, omega, probs = (torch.from_numpy(np.asarray(a)) for a in
                       (w, omega, probs))
    pen = ecl.penalty(w, probs, lam)
    book = tbp.codebook(omega)
    return (w[..., None] - book[..., None, None, :]) ** 2 \
        + pen[..., None, None, :]


@pytest.mark.parametrize("arch,leaves", [("mamba2-1.3b", 2),
                                         ("hymba-1.5b", 9)])
def test_freeze_tree_codes_match_reference(arch, leaves):
    """Every quantized leaf (mamba2: in_proj and out_proj; hymba: q, k, v,
    o, the MLP's three and the SSD block's two): ω equal, codes equal but
    for cost ties within 4 ulp; the fp32 leaves (conv_w, A_log, ...) kept
    as they were."""
    cfg, params, qstate, _ = _jax_world(arch)
    rng = np.random.default_rng(4)
    qstate = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.dirichlet(np.ones(16), a.shape[:-1])
                              .astype(np.float32))
        if a.ndim and a.shape[-1] == 16 and a.dtype == jnp.float32 else a,
        qstate)
    jfrozen = jqat.freeze_tree(params, qstate, 0.3)
    tfrozen = tqat.freeze_tree(_t(params), _t(qstate), 0.3)
    want, got = dict(_flat(_np(jfrozen))), dict(_flat(
        tree_to_numpy(tfrozen)))
    assert sorted(got) == sorted(want)
    src, qs = dict(_flat(_np(params))), dict(_flat(_np(qstate)))
    packed = [k for k in want if k.endswith("/packed")]
    assert len(packed) == leaves
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
    assert got["/stacks/ssm/ssm/conv_w"].dtype == np.float32 \
        if arch == "mamba2-1.3b" else True


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_round_trips_through_convert(arch):
    """params, qstate and the frozen tree (the 2-D fp32 conv_w, the 1-D
    A_log / dt_bias / D, (L, d/2, n) packed codes) across and back, every
    array and dtype intact."""
    _, params, qstate, frozen = _jax_world(arch)
    for tree in (params, qstate, frozen):
        want = _np(tree)
        got = tree_to_numpy(_t(tree))
        flat_w, wdef = jax.tree_util.tree_flatten(want)
        flat_g, gdef = jax.tree_util.tree_flatten(got)
        assert wdef == gdef
        for x, y in zip(flat_w, flat_g):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------- caches

@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "hymba-1.5b",
                                  "mamba2-1.3b"])
@pytest.mark.parametrize("cap_window", [False, True])
def test_init_cache_matches_reference(arch, cap_window):
    """Keys, shapes, dtypes and values of ``init_cache`` against the
    reference's: danube (SWA, no global layer) gets a window-sized ring
    under ``cap_window``, hymba's global layer keeps the full length, and
    the SSM state is fp32 whatever the cache dtype."""
    jcfg, tcfg = jget_config(arch).smoke(), get_config(arch).smoke()
    want = dict(_flat(_np(JT.init_cache(jcfg, 2, 40, dtype=jnp.bfloat16,
                                        cap_window=cap_window))))
    tc = TT.init_cache(tcfg, 2, 40, dtype=torch.bfloat16,
                       cap_window=cap_window, device="cpu")
    got = {k: v for k, v in _flat(tc)}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert np.array_equal(got[k].to(torch.float32).numpy(),
                              v.astype(np.float32)), k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
    if arch == "h2o-danube-1.8b":
        slots = tcfg.window if cap_window else 40
        assert tc["dense"]["attn"]["k"].shape[2] == slots
    if arch == "hymba-1.5b":
        assert tc["hybrid"]["attn"]["k"].shape[2] == 40


def test_swa_window_ring_decode_matches_full_cache():
    """danube: greedy decode against the window-capped ring (writes wrap at
    ``len % window``) gives the tokens of decode against the full cache."""
    cfg = get_config("h2o-danube-1.8b").smoke()
    params = TT.lm_init(cfg, seed=3, device="cpu")
    frozen = tqat.freeze_tree(params, tqat.build_qstate(params), cfg.lam)
    b, s, new = 2, 10, 10                      # 20 > window 16
    prompt = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (b, s)))
    full = tlm.generate(frozen, 0, prompt, FP32_CTX, cfg, max_new=new)
    cache = TT.init_cache(cfg, b, s + new, dtype=torch.float32,
                          cap_window=True, device="cpu")
    assert cache["dense"]["attn"]["k"].shape[2] == cfg.window
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    nxt, cache = tlm.greedy_step(frozen, 0, prompt, FP32_CTX, cfg,
                                 positions=pos, cache=cache)
    outs = [nxt]
    for t in range(new - 1):
        p_t = torch.full((b, 1), s + t, dtype=torch.int32)
        nxt, cache = tlm.greedy_step(frozen, 0, nxt, FP32_CTX, cfg,
                                     positions=p_t, cache=cache)
        outs.append(nxt)
    assert torch.equal(torch.cat(outs, 1), full)
    assert int(cache["dense"]["attn"]["len"][0]) == s + new - 1


# ------------------------------------------------------------ generation

@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_and_one_shot_forward(arch):
    """18 prompt + 6 new tokens (hymba's window 16 slides past the prompt
    on its SWA layer): the port's greedy tokens equal JAX's
    ``models.lm.generate``, and each equals the argmax of a no-cache
    forward over everything before it (teacher forcing)."""
    cfg, _, _, frozen = _jax_world(arch)
    tcfg, tf = get_config(arch).smoke(), _t(frozen)
    prompt = np.random.default_rng(6).integers(0, cfg.vocab, (2, 18))
    want = jlm.generate(frozen, 0, jnp.asarray(prompt, jnp.int32), JCTX, cfg,
                        max_new=6)
    got = tlm.generate(tf, 0, torch.from_numpy(prompt), FP32_CTX, tcfg,
                       max_new=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    seq = torch.cat([torch.from_numpy(prompt).to(torch.int32), got], 1)
    for t in range(got.shape[1]):
        logits, _, _ = TT.lm_apply(tf, 0, seq[:, :18 + t], FP32_CTX, tcfg)
        assert torch.equal(torch.argmax(logits[:, -1, :tcfg.vocab], -1)
                           .to(torch.int32), got[:, t])


def test_the_decode_state_stays_one_size():
    """mamba2's cache after the prefill and after each decode step: the
    same keys, shapes and bytes (O(1) in the context length)."""
    cfg = get_config("mamba2-1.3b").smoke()
    frozen = tqat.freeze_tree(*(lambda p: (p, tqat.build_qstate(p)))(
        TT.lm_init(cfg, seed=1, device="cpu")), cfg.lam)
    cache = TT.init_cache(cfg, 2, 64, dtype=torch.float32, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in _flat(cache)}
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 20)))
    _, cache, _ = TT.lm_apply(frozen, 0, toks[:, :17], FP32_CTX, cfg,
                              positions=torch.arange(17).expand(2, 17),
                              cache=cache)
    for t in range(17, 20):
        assert {k: tuple(v.shape) for k, v in _flat(cache)} == shapes
        _, cache, _ = TT.lm_apply(frozen, 0, toks[:, t:t + 1], FP32_CTX,
                                  cfg, positions=torch.full((2, 1), t),
                                  cache=cache)
    assert sorted(cache["ssm"]) == ["ssm"] and shapes[
        "/ssm/ssm/ssm"] == (cfg.n_layers, 2, cfg.ssm_heads,
                            cfg.ssm_headdim, cfg.ssm_state)


# -------------------------------------------------------------- launcher

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_serves_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve
    assert arch in serve.lm_archs()
    gen = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12",
                      "--max-new", "4"])
    assert gen.shape == (2, 4)
    out = capsys.readouterr().out
    family = get_config(arch).family
    assert f"({family}):" in out and "decode state:" in out
    assert ("KV cache" in out) == (family == "hybrid")
    with pytest.raises(SystemExit, match="dense-family"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--batch", "1", "--prompt-len", "4", "--max-new", "2",
                    "--engine"])


def test_the_other_families_still_refuse():
    """No registered family is refused any more (vlm and audio are built,
    tests/test_torch_vlm.py and test_torch_whisper.py); only a family the
    port does not know is."""
    from repro_torch.configs import list_configs
    assert {get_config(n).family for n in list_configs()} == set(
        TT.FAMILIES)
    for name in ("qwen2-vl-2b", "whisper-base"):
        TT.check_supported(get_config(name).smoke())
    with pytest.raises(NotImplementedError, match="family 'bogus'"):
        TT.lm_init(dataclasses.replace(get_config("mamba2-1.3b").smoke(),
                                       family="bogus"), device="cpu")
    assert dataclasses.replace(get_config("mamba2-1.3b"),
                               n_layers=1).attention_free
