"""The port's multi-head latent attention (``nn/attention.py``) against the
JAX package's, at the smoke dims on the CPU.

The same inputs, drawn with numpy, and the same weights (JAX's ``mla_init``
tree, as trained fp32 masters or frozen to 4-bit codes, carried across as
numpy) go through both packages.  Each form is held to the reference's
form of the same name: the naive form (a prefill, or a decode step with
``force_absorbed=False``) to the reference's naive form, the absorbed
form (a decode step) to its absorbed form.  Tolerances: attention
outputs and caches ``atol=rtol=1e-5`` (the module tolerance of
``tests/test_torch_lm.py``: fp32 sums in another order in the two
frameworks), positions and lengths exact; the absorbed form against the
naive one ``atol=1e-5``, as the reference's own
``tests/test_attention.py::test_mla_absorbed_equals_naive``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qat as jqat
from repro.nn import attention as jattn
from repro.nn.layers import rope_cos_sin as jrope
from repro.nn.module import QuantCtx as JQuantCtx
from repro_torch.convert import lm_tree_from_numpy
from repro_torch.nn import attention as tattn
from repro_torch.nn.layers import rope_cos_sin as trope
from repro_torch.nn.module import FP32_CTX

JCTX = JQuantCtx(quant=False, compute_dtype=jnp.float32)
TOL = dict(atol=1e-5, rtol=1e-5)
THETA = 10000.0
# the smoke config's MLA dims (ArchConfig.smoke) at its d_model and heads
JCFG = jattn.MLACfg(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
TCFG = tattn.MLACfg(**{f: getattr(JCFG, f) for f in (
    "d_model", "n_heads", "q_lora_rank", "kv_lora_rank", "qk_nope_dim",
    "qk_rope_dim", "v_head_dim")})
B, S, CACHE = 2, 6, 10


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return lm_tree_from_numpy(_np(tree), device="cpu")


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol)


def _positions(t0, t1):
    return np.broadcast_to(np.arange(t0, t1, dtype=np.int32),
                           (B, t1 - t0)).copy()


@functools.partial(jax.jit, static_argnums=4)
def _jmla(p, x, pos, cache, force):
    return jattn.mla_apply(p, 0, x, JCTX, JCFG,
                           cos_sin=jrope(pos, JCFG.qk_rope_dim, THETA),
                           positions=pos, cache=cache, chunk=4,
                           force_absorbed=force)


def _japply(p, x, pos, cache, force=None):
    """The reference's ``mla_apply``, jitted (its eager calls compile
    every operation on first use)."""
    return _jmla(p, jnp.asarray(x), jnp.asarray(pos), cache, force)


def _tapply(p, x, pos, cache, force=None):
    tpos = torch.from_numpy(pos)
    return tattn.mla_apply(p, 0, torch.from_numpy(x), FP32_CTX, TCFG,
                           cos_sin=trope(tpos, TCFG.qk_rope_dim, THETA),
                           positions=tpos, cache=cache, chunk=4,
                           force_absorbed=force)


X = _rand(10, (B, S + 1, JCFG.d_model))
RING_X = _rand(11, (B, 6, JCFG.d_model))
RING_WRITES = ((0, 3), (3, 4), (4, 5), (5, 6))


@pytest.fixture(scope="module")
def world():
    """JAX's MLA weights (``mla_init``'s quantized masters, as fp32 and
    frozen) and every reference result the tests read, made once: the
    JAX side dominates the run time."""
    params = jattn.mla_init(jax.random.PRNGKey(3), JCFG, quantize=True)
    qstate = jqat.build_qstate(params)
    trees = {"fp32": jax.tree_util.tree_map(lambda n: n["w"], params,
                                            is_leaf=jqat.is_quant_leaf),
             "frozen": jqat.freeze_tree(params, qstate, 0.02)}
    out = {"trees": trees,
           "cache0": jattn.init_mla_cache(B, CACHE, JCFG, jnp.float32)}
    for weights, p in trees.items():
        pre = _positions(0, S)
        out["prefill", weights] = _japply(p, X[:, :S], pre, None)
        y, cache = _japply(p, X[:, :S], pre, out["cache0"])
        out["prefill_into_cache", weights] = (y, cache)
        for case, force in (("absorbed_decode", None),
                            ("naive_decode", False)):
            out[case, weights] = _japply(p, X[:, S:], _positions(S, S + 1),
                                         cache, force)
    cache, ring = jattn.init_mla_cache(B, 4, JCFG, jnp.float32), []
    for t0, t1 in RING_WRITES:
        y, cache = _japply(trees["frozen"], RING_X[:, t0:t1],
                           _positions(t0, t1), cache)
        ring.append((y, cache))
    out["ring"] = ring
    return out


def _cache_close(tc, jc):
    for key in ("ckv", "krope"):
        _close(tc[key], jc[key])
    for key in ("pos", "len"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]),
                                      err_msg=key)


# ------------------------------------------------- chunked attention

@pytest.mark.parametrize("chunk", [4, 7, 1024])
def test_chunked_attention_with_kv_chunk_fn_matches_reference(chunk):
    """A latent (c_kv, rope key) decompressed chunk by chunk inside the
    online softmax, in both packages, against the reference."""
    sq, skv, r, rope, h, nope, dv = 5, 11, 16, 8, 4, 16, 16
    ckv, kr = _rand(1, (B, skv, r)), _rand(2, (B, skv, rope))
    w_up = _rand(3, (r, h, nope + dv), 0.2)
    q = _rand(4, (B, sq, h, nope + rope))
    q_pos = _positions(skv - sq, skv)
    kv_pos = _positions(0, skv)

    def jdecomp(parts):
        c, k = parts
        kvu = jnp.einsum("bkr,rhd->bkhd", c, jnp.asarray(w_up))
        kb = jnp.broadcast_to(k[:, :, None, :], (*k.shape[:2], h, rope))
        return jnp.concatenate([kvu[..., :nope], kb], -1), kvu[..., nope:]

    def tdecomp(parts):
        c, k = parts
        kvu = torch.einsum("bkr,rhd->bkhd", c, torch.from_numpy(w_up))
        kb = k[:, :, None, :].expand(*k.shape[:2], h, rope)
        return torch.cat([kvu[..., :nope], kb], -1), kvu[..., nope:]

    kw = dict(causal=True, chunk=chunk, scale=(nope + rope) ** -0.5,
              n_kv=h, dv=dv)
    want = jattn.chunked_attention(
        jnp.asarray(q), (jnp.asarray(ckv), jnp.asarray(kr)),
        q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
        kv_chunk_fn=jdecomp, **kw)
    got = tattn.chunked_attention(
        torch.from_numpy(q), (torch.from_numpy(ckv), torch.from_numpy(kr)),
        q_pos=torch.from_numpy(q_pos), kv_pos=torch.from_numpy(kv_pos),
        kv_chunk_fn=tdecomp, **kw)
    assert got.shape == (B, sq, h, dv) and got.dtype == torch.float32
    _close(got, want)


# ------------------------------------------------------------ mla_apply

CASES = ("prefill", "prefill_into_cache", "absorbed_decode",
         "naive_decode")


@pytest.mark.parametrize("weights", ["fp32", "frozen"])
@pytest.mark.parametrize("case", CASES)
def test_mla_apply_matches_reference(world, case, weights):
    """Each form against the reference's form of the same name: a prefill
    without a cache and into one (naive), then a decode step through the
    cache (absorbed by default, naive when forced)."""
    p = _t(world["trees"][weights])
    pre = _positions(0, S)
    if case == "prefill":
        ty, tc = _tapply(p, X[:, :S], pre, None)
        assert tc is None
        _close(ty, world[case, weights][0])
        return
    ty, tcache = _tapply(p, X[:, :S], pre, _t(world["cache0"]))
    if case == "prefill_into_cache":
        jy, jcache = world[case, weights]
        _close(ty, jy)
        _cache_close(tcache, jcache)
        return
    force = False if case == "naive_decode" else None
    ty, tc = _tapply(p, X[:, S:], _positions(S, S + 1), tcache, force)
    jy, jc = world[case, weights]
    _close(ty, jy)
    _cache_close(tc, jc)


def test_init_mla_cache_and_ring_write_match_reference(world):
    """The empty cache (latent and rope key in the caller's dtype, ``pos``
    -1, ``len`` 0), then a 3-token prefill and three decode steps into a
    ring of 4 slots: ``len``, ``pos`` and every slot equal the
    reference's after each write, the last ones after the wrap."""
    for dtype, tdtype in ((jnp.bfloat16, torch.bfloat16),
                          (jnp.float32, torch.float32)):
        jc = jattn.init_mla_cache(B, 4, JCFG, dtype)
        tc = tattn.init_mla_cache(B, 4, TCFG, tdtype)
        for key in jc:
            assert tuple(tc[key].shape) == jc[key].shape, key
            assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype)
            np.testing.assert_array_equal(
                tc[key].to(torch.float32).numpy(),
                np.asarray(jc[key]).astype(np.float32), err_msg=key)
    p = _t(world["trees"]["frozen"])
    tc = tattn.init_mla_cache(B, 4, TCFG, torch.float32)
    for (t0, t1), (jy, jc) in zip(RING_WRITES, world["ring"]):
        ty, tc = _tapply(p, RING_X[:, t0:t1], _positions(t0, t1), tc)
        _close(ty, jy)
        _cache_close(tc, jc)
    assert int(tc["len"]) == 6
    assert tc["pos"].tolist() == [4, 5, 2, 3]


def test_mla_absorbed_equals_naive():
    """The port's mirror of the reference's test of the same name: at one
    decode step, the absorbed and the naive form agree."""
    cfg = tattn.MLACfg(d_model=64, n_heads=4, q_lora_rank=32,
                       kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=4,
                       v_head_dim=8)
    g = torch.Generator().manual_seed(0)
    p = tattn.mla_init(g, cfg, quantize=False)
    x = torch.randn((2, 1, 64), generator=g)
    pos = torch.zeros((2, 1), dtype=torch.int32)
    cs = trope(pos, cfg.qk_rope_dim, 1e4)
    cache = tattn.init_mla_cache(2, 8, cfg, torch.float32)
    y1, c1 = tattn.mla_apply(p, 0, x, FP32_CTX, cfg, cos_sin=cs,
                             positions=pos, cache=cache, force_absorbed=True)
    y2, c2 = tattn.mla_apply(p, 0, x, FP32_CTX, cfg, cos_sin=cs,
                             positions=pos, cache=cache,
                             force_absorbed=False)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)
    assert all(torch.equal(c1[k], c2[k]) for k in c1)
