"""The port's transformer stack vs the JAX package, at smoke size on the CPU.

The same parameters go through both packages: JAX's trees (``lm_init``
params, ``build_qstate`` state, ``freeze_tree`` frozen trees, caches) are
carried across as numpy (``repro_torch.convert.lm_tree_from_numpy``).
Tolerances: configs equal field by field; norms, rotary, MLPs and
attention ``atol=rtol=1e-5``; whole-stack logits ``atol=rtol=1e-4``
(deepseek-v3 with MLA among them: the naive form at the prefill, the
absorbed form at each decode step);
freeze codes bitwise, or a cost tie within 4 ulp where the reference's
batched codebook (an einsum) rounds differently from its own decode;
greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro.core import bitplanes as jbp
from repro.core import qat as jqat
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn import transformer as JT
from repro.nn.module import QuantCtx as JQuantCtx
from repro_torch.configs import get_config, list_configs
from repro_torch.convert import lm_tree_from_numpy
from repro_torch.core import bitplanes as tbp
from repro_torch.core import qat as tqat
from repro_torch.models import lm as tlm
from repro_torch.nn import attention as tattn
from repro_torch.nn import layers as tlayers
from repro_torch.nn import transformer as TT
from repro_torch.nn.module import FP32_CTX, QuantCtx, materialize

JCTX = JQuantCtx(quant=False, compute_dtype=jnp.float32)
TOL = dict(atol=1e-5, rtol=1e-5)
STACK_TOL = dict(atol=1e-4, rtol=1e-4)
AUX_TOL = dict(atol=1e-6, rtol=1e-6)
# built identically in both packages: deepseek-v3's smoke config without
# MLA (one dense layer, then MoE with the sigmoid gate and a shared expert)
DS_NOMLA = "deepseek-v3-671b-nomla"
# deepseek-v3's smoke config as registered: MLA in every layer
DS = "deepseek-v3-671b"
DENSE_ARCHS = ("smollm-360m", "h2o-danube-1.8b", "glm4-9b")
ARCHS = DENSE_ARCHS + ("grok-1-314b", DS_NOMLA, DS)


def _smoke(get, arch):
    """The smoke config of ``arch`` from one package's ``get_config``."""
    if arch == DS_NOMLA:
        return dataclasses.replace(get("deepseek-v3-671b").smoke(), mla=None)
    return get(arch).smoke()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return lm_tree_from_numpy(_np(tree), device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol)


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


# ------------------------------------------------------------- configs

def _fields(cfg):
    """A port config's fields, less ``experts_held``: the port's own
    field (one device's share of the experts), None in every registered
    config."""
    out = dataclasses.asdict(cfg)
    assert out.pop("experts_held") is None, cfg.name
    return out


def test_configs_equal_the_reference_field_by_field():
    assert list_configs() == jlist_configs()
    for name in list_configs():
        mine, ref = get_config(name), jget_config(name)
        assert _fields(mine) == dataclasses.asdict(ref), name
        assert _fields(mine.smoke()) == dataclasses.asdict(ref.smoke()), name
        assert (mine.padded_vocab, mine.resolved_head_dim) == \
            (ref.padded_vocab, ref.resolved_head_dim)


def test_non_dense_families_are_refused():
    for name in ("mamba2-1.3b", "hymba-1.5b", "qwen2-vl-2b",
                 "whisper-base"):
        with pytest.raises(NotImplementedError, match="queue 1 item 8"):
            TT.lm_init(get_config(name).smoke(), device="cpu")


# ------------------------------------------------------- building blocks

def test_norms_match_reference():
    x = _rand(0, (2, 5, 24))
    p = {"scale": _rand(1, (24,)), "bias": _rand(2, (24,))}
    tp = lm_tree_from_numpy(p, device="cpu")
    _close(tlayers.rms_norm(tp, torch.from_numpy(x)),
           jlayers.rms_norm(p, jnp.asarray(x)))
    _close(tlayers.layer_norm(tp, torch.from_numpy(x)),
           jlayers.layer_norm(p, jnp.asarray(x)))


def test_embed_and_tied_readout_match_reference():
    table = {"table": _rand(11, (40, 16), 0.02)}
    ids = np.random.default_rng(12).integers(0, 40, (2, 5))
    x = _rand(13, (2, 5, 16))
    tt = lm_tree_from_numpy(table, device="cpu")
    _close(tlayers.embed(tt, torch.from_numpy(ids), FP32_CTX),
           jlayers.embed(table, jnp.asarray(ids), JCTX))
    _close(tlayers.unembed(tt, torch.from_numpy(x), FP32_CTX),
           jlayers.unembed(table, jnp.asarray(x), JCTX))


@pytest.mark.parametrize("rotary_frac", [1.0, 0.5])
def test_rotary_matches_reference(rotary_frac):
    hd = 16
    rot = int(hd * rotary_frac)
    pos = np.random.default_rng(3).integers(0, 300, (2, 5)).astype(np.int32)
    x = _rand(4, (2, 5, 3, hd))
    jc, js = jlayers.rope_cos_sin(jnp.asarray(pos), rot, 10000.0)
    tc, ts = tlayers.rope_cos_sin(torch.from_numpy(pos), rot, 10000.0)
    _close(tc, jc, dict(atol=1e-6, rtol=1e-6))
    _close(ts, js, dict(atol=1e-6, rtol=1e-6))
    _close(tlayers.apply_rotary(torch.from_numpy(x), tc, ts),
           jlayers.apply_rotary(jnp.asarray(x), jc, js))


@pytest.mark.parametrize("weights", ["fp32", "quant", "frozen"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlps_match_reference(act, weights):
    key = jax.random.PRNGKey(5)
    init = jlayers.swiglu_init if act == "swiglu" else jlayers.gelu_mlp_init
    apply_j = jlayers.swiglu if act == "swiglu" else jlayers.gelu_mlp
    apply_t = tlayers.swiglu if act == "swiglu" else tlayers.gelu_mlp
    params = init(key, 24, 40, True)
    if act == "gelu":      # non-zero biases so the bias path is exercised
        params["fc1"]["bias"] = jnp.asarray(_rand(6, (40,), 0.1))
    qstate = jqat.build_qstate(params)
    jctx = JQuantCtx(quant=weights == "quant", lam=0.02,
                     compute_dtype=jnp.float32)
    tctx = QuantCtx(quant=weights == "quant", lam=0.02,
                    compute_dtype=torch.float32)
    if weights == "frozen":
        params, qstate = jqat.freeze_tree(params, qstate, 0.02), 0
    x = _rand(7, (3, 24))
    want = apply_j(params, qstate, jnp.asarray(x), jctx)
    got = apply_t(_t(params), _t(qstate), torch.from_numpy(x), tctx)
    _close(got, want)


def test_materialize_decodes_frozen_leaves_exactly():
    w = jnp.asarray(_rand(8, (2, 12, 6), 0.1))
    leaf = jqat.freeze_tree({"k": jqat.make_quant_param(w)},
                            {"k": jqat.init_qstate_leaf((2,))}, 0.02)["k"]
    tleaf = _t(leaf)
    assert tqat.is_frozen_leaf(tleaf) and not tqat.is_quant_leaf(tleaf)
    np.testing.assert_array_equal(
        materialize(tleaf, 0, FP32_CTX).numpy(),
        np.asarray(jqat.decode_frozen(leaf, jnp.float32)))


def test_quantize_tree_and_param_count_match_reference():
    """``quantize_tree`` codes (unbatched and L-stacked leaves, one grouped
    call) and ``param_count`` equal the JAX package's."""
    from repro.nn.module import param_count as jparam_count
    from repro_torch.nn.module import param_count
    params = {"a": jqat.make_quant_param(jnp.asarray(_rand(9, (12, 6)))),
              "b": jqat.make_quant_param(jnp.asarray(_rand(10, (2, 8, 4)))),
              "scale": jnp.ones((6,), jnp.float32)}
    qstate = jqat.build_qstate(params)
    want = jqat.quantize_tree(params, qstate, 0.3)
    got = tqat.quantize_tree(_t(params), _t(qstate), 0.3)
    for key in ("a", "b"):
        np.testing.assert_array_equal(got[key]["codes"].numpy(),
                                      np.asarray(want[key]["codes"]))
    np.testing.assert_array_equal(got["scale"].numpy(), params["scale"])
    assert param_count(_t(params)) == jparam_count(params)


ATTN_CASES = {
    # name: (Sq, Skv, window, chunk, q offset)
    "causal": (5, 5, None, 16, 0),
    "windowed": (6, 6, 3, 16, 0),
    "chunk_lt_kv": (4, 11, None, 4, 0),
    "fully_masked_row": (3, 8, 2, 4, -5),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention_matches_dense_and_reference(case):
    sq, skv, window, chunk, off = ATTN_CASES[case]
    b, h, n_kv, d = 2, 4, 2, 8
    q, k, v = (_rand(10 + i, shape) for i, shape in enumerate(
        ((b, sq, h, d), (b, skv, n_kv, d), (b, skv, n_kv, d))))
    q_pos = np.broadcast_to(np.arange(sq, dtype=np.int32) + max(off, 0)
                            + (skv - sq), (b, sq)).copy()
    kv_pos = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv)).copy()
    if off < 0:                  # queries before every key: rows fully masked
        q_pos[:] = np.arange(sq, dtype=np.int32) + off
    kw = dict(causal=True, window=window, chunk=chunk)
    want = jattn.softmax_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(q_pos),
                                   jnp.asarray(kv_pos), **kw)
    got = tattn.softmax_attention(*(torch.from_numpy(a) for a in
                                    (q, k, v, q_pos, kv_pos)), **kw)
    assert torch.isfinite(got).all()
    _close(got, want)
    if off >= 0:                 # the dense oracle is defined on these
        dense = tattn.dense_attention_ref(
            *(torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)),
            causal=True, window=window)
        _close(got, dense)


@pytest.mark.parametrize("writes", [(3, 1, 1, 1), (2, 2, 1)])
def test_cache_update_wraps_as_the_reference(writes):
    """Single-token writes wrap at ``len % size``; a multi-entry write is
    clamped so it does not wrap, as ``dynamic_update_slice`` clamps it."""
    jc = jattn.init_kv_cache(1, 4, 2, 3, jnp.float32)
    tc = _t(jc)
    start = 0
    for i, s in enumerate(writes):
        k, v = _rand(20 + i, (1, s, 2, 3)), _rand(30 + i, (1, s, 2, 3))
        pos = np.arange(start, start + s, dtype=np.int32)[None]
        jc = jattn._cache_update(jc, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos))
        tc = tattn._cache_update(tc, {"k": torch.from_numpy(k),
                                      "v": torch.from_numpy(v)},
                                 torch.from_numpy(pos))
        start += s
        for key in ("k", "v", "pos", "len"):
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]), err_msg=key)
    assert int(tc["len"]) == sum(writes) > 4


# -------------------------------------------------------- the whole stack

_WORLDS = {}


def _jax_world(arch):
    """(cfg, params, qstate, frozen) of the JAX package at smoke size, made
    once per arch in this process (the JAX side dominates the run time)."""
    if arch not in _WORLDS:
        cfg = _smoke(jget_config, arch)
        params = JT.lm_init(jax.random.PRNGKey(0), cfg)
        qstate = jqat.build_qstate(params)
        _WORLDS[arch] = (cfg, params, qstate,
                         jqat.freeze_tree(params, qstate, cfg.lam))
    return _WORLDS[arch]


@pytest.mark.parametrize("arch,weights", [
    (arch, weights) for arch in ARCHS for weights in ("fp32", "frozen")
    # the moe archs as served, frozen (the JAX side's eager cost)
    if weights == "frozen" or arch in DENSE_ARCHS])
def test_lm_apply_matches_reference_prefill_and_cached_decode(arch, weights):
    cfg, params, qstate, frozen = _jax_world(arch)
    tcfg = _smoke(get_config, arch)
    if weights == "frozen":
        params, qstate = frozen, 0
    tparams, tq = _t(params), _t(qstate)
    b, s, steps = 2, 6, 2
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (b, s + steps))
    jcache = JT.init_cache(cfg, b, s + steps, dtype=jnp.float32)
    tcache = _t(jcache)
    for t0, t1 in [(0, s)] + [(s + i, s + i + 1) for i in range(steps)]:
        tok = toks[:, t0:t1].astype(np.int32)
        pos = np.broadcast_to(np.arange(t0, t1, dtype=np.int32),
                              tok.shape).copy()
        jl, jcache, jaux = JT.lm_apply(params, qstate, jnp.asarray(tok),
                                       JCTX, cfg, positions=jnp.asarray(pos),
                                       cache=jcache)
        tl, tcache, taux = TT.lm_apply(tparams, tq, torch.from_numpy(tok),
                                       FP32_CTX, tcfg,
                                       positions=torch.from_numpy(pos),
                                       cache=tcache)
        _close(tl, jl, STACK_TOL)
        _close(taux, jaux, AUX_TOL)
        assert sorted(tcache) == sorted(jcache)


def test_lm_apply_without_cache_matches_reference():
    cfg, _, _, frozen = _jax_world("glm4-9b")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 7))
    jl, _, _ = JT.lm_apply(frozen, 0, jnp.asarray(toks), JCTX, cfg)
    tl, none, _ = TT.lm_apply(_t(frozen), 0, torch.from_numpy(toks),
                              FP32_CTX, get_config("glm4-9b").smoke())
    assert none is None
    _close(tl, jl, STACK_TOL)


def test_lm_loss_matches_reference():
    cfg, params, qstate, _ = _jax_world("smollm-360m")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 7))
    labels = np.roll(toks, -1, axis=1).astype(np.int32)
    mask = (np.arange(7)[None] < np.asarray([[5], [7]])).astype(np.float32)
    batch = {"tokens": toks.astype(np.int32), "labels": labels, "mask": mask}
    want, _ = jlm.lm_forward_loss(params, qstate,
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()}, JCTX, cfg)
    got, metrics = tlm.lm_forward_loss(
        _t(params), _t(qstate), {k: torch.from_numpy(v) for k, v in
                                 batch.items()},
        FP32_CTX, get_config("smollm-360m").smoke())
    _close(got, want)
    assert set(metrics) == {"ce", "aux", "loss"}


# ---------------------------------------------------------------- freezing

def _costs(w, omega, probs, lam):
    """Per element and code, the ECL cost in float32 (the port's order),
    for a leaf with any leading dims (layers, experts)."""
    w, omega, probs = (torch.from_numpy(np.asarray(a)) for a in
                       (w, omega, probs))
    from repro_torch.core import ecl
    pen = ecl.penalty(w, probs, lam)                          # (*lead, 16)
    book = tbp.codebook(omega)                                # (*lead, 16)
    return (w[..., None] - book[..., None, None, :]) ** 2 \
        + pen[..., None, None, :]


def _trained_like(params, qstate, seed):
    """Non-uniform probabilities, so the entropy penalty decides codes too,
    and centroids off the power-of-two init, as training leaves them: the
    reference's batched codebook (an einsum) then rounds some subset sums
    differently from its decode."""
    rng = np.random.default_rng(seed)
    qstate = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.dirichlet(np.ones(16), a.shape[:-1])
                              .astype(np.float32))
        if a.ndim and a.shape[-1] == 16 and a.dtype == jnp.float32 else a,
        qstate)
    params = jax.tree_util.tree_map(
        lambda n: {**n, "omega": n["omega"] * jnp.asarray(
            rng.uniform(0.8, 1.2, n["omega"].shape).astype(np.float32))}
        if jqat.is_quant_leaf(n) else n, params,
        is_leaf=jqat.is_quant_leaf)
    return params, qstate


def _frozen_leaves(jtree, ttree, params, qstate, path=()):
    """(path, JAX frozen leaf, port frozen leaf, source leaf, its state)
    for every quantized leaf, in sorted key order."""
    if jqat.is_frozen_leaf(jtree):
        yield path, jtree, ttree, params, qstate
    elif isinstance(jtree, dict):
        for k in sorted(jtree):
            yield from _frozen_leaves(jtree[k], ttree[k], params[k],
                                      qstate[k], path + (k,))


def _freeze_both(arch, lam, seed):
    """Both packages' ``freeze_tree`` of the same perturbed JAX world;
    asserts every leaf's ω equal and its codes equal except cost ties
    within 4 ulp.  Returns (params, qstate, port frozen tree, leaf paths,
    differing codes, codes)."""
    _, params, qstate, _ = _jax_world(arch)
    params, qstate = _trained_like(params, qstate, seed)
    jfrozen = jqat.freeze_tree(params, qstate, lam)
    tfrozen = tqat.freeze_tree(_t(params), _t(qstate), lam)
    paths, ties, total = [], 0, 0
    for path, jl, tl, src, qs in _frozen_leaves(jfrozen, tfrozen, params,
                                                qstate):
        paths.append(path)
        assert tl["packed"].dtype == torch.uint8
        np.testing.assert_array_equal(tl["omega"].numpy(),
                                      np.asarray(jl["omega"]))
        jc = np.asarray(jbp.unpack_codes_rows(jl["packed"]))
        tc = tbp.unpack_codes_rows(tl["packed"]).numpy()
        total += jc.size
        diff = np.argwhere(jc != tc)
        if len(diff):
            cost = _costs(src["w"], src["omega"], qs["probs"], lam).numpy()
            for idx in map(tuple, diff):
                a, b = cost[idx + (jc[idx],)], cost[idx + (tc[idx],)]
                ulp = np.spacing(np.float32(max(abs(a), abs(b))))
                assert abs(a - b) <= 4 * ulp, (path, idx, a, b)
            ties += len(diff)
    return params, qstate, tfrozen, paths, ties, total


def test_freeze_tree_codes_match_reference():
    params, _, tfrozen, paths, ties, total = _freeze_both("smollm-360m",
                                                          0.3, 4)
    assert len(paths) == 7
    np.testing.assert_array_equal(tfrozen["embed"]["table"].numpy(),
                                  np.asarray(params["embed"]["table"]))
    print(f"freeze_tree: {ties} of {total} codes differ from the "
          "reference, each a cost tie within 4 ulp")


def test_freeze_tree_codes_and_stats_match_reference_on_expert_banks():
    """grok's (L, E) banks: each (layer, expert) a segment with its own ω
    and probabilities; ``stats`` over them as the reference's."""
    cfg = get_config("grok-1-314b").smoke()
    params, qstate, tfrozen, paths, ties, total = _freeze_both(
        "grok-1-314b", 0.3, 5)
    banks = [p for p in paths if "experts" in p]
    assert len(banks) == 3 and len(paths) == 7
    for bank in ("down", "gate", "up"):
        leaf = tfrozen["stacks"]["moe"]["moe"]["experts"][bank]
        assert leaf["omega"].shape == (cfg.n_layers, cfg.n_experts, 4)
        assert leaf["packed"].shape[:2] == (cfg.n_layers, cfg.n_experts)
    want = jqat.stats(params, qstate, 0.3)
    got = tqat.stats(_t(params), _t(qstate), 0.3)
    assert got["quant_params"] == int(want["quant_params"])
    for key in ("sparsity", "entropy_bits_per_weight"):
        _close(got[key], want[key], AUX_TOL)
    print(f"freeze_tree on expert banks: {ties} of {total} codes differ "
          "from the reference, each a cost tie within 4 ulp")


def test_moe_tree_round_trips_through_convert():
    """The JAX MoE trees (the fp32 router's w and bias_correction, the
    (L, E, d_in, d_out) banks as quant params, the shared expert, the
    probabilities and the frozen (L, E, d/2, ff) ``packed``) cross to the
    port and back with every array and dtype intact."""
    from repro_torch.convert import tree_to_numpy
    cfg, params, qstate, frozen = _jax_world(DS_NOMLA)
    for tree in (params, qstate, frozen):
        want = _np(tree)
        got = tree_to_numpy(_t(tree))
        flat_w, wdef = jax.tree_util.tree_flatten(want)
        flat_g, gdef = jax.tree_util.tree_flatten(got)
        assert wdef == gdef
        for a, b in zip(flat_w, flat_g):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    moe = _t(frozen)["stacks"]["moe"]["moe"]
    n_moe = cfg.n_layers - cfg.n_dense_layers
    assert moe["experts"]["gate"]["packed"].shape == (
        n_moe, cfg.n_experts, cfg.d_model // 2, cfg.d_ff)
    assert moe["router"]["bias_correction"].shape == (n_moe, cfg.n_experts)
    assert {"router", "experts", "shared"} <= set(moe)


# -------------------------------------------------------------- generation

@pytest.mark.parametrize("arch", ["smollm-360m", "h2o-danube-1.8b",
                                  "grok-1-314b", DS])
def test_generate_matches_reference_tokens(arch):
    """14 prompt + 4 new tokens: danube's decode slides past its window."""
    cfg, _, _, frozen = _jax_world(arch)
    prompt = np.random.default_rng(6).integers(0, cfg.vocab, (2, 14))
    want = jlm.generate(frozen, 0, jnp.asarray(prompt, jnp.int32), JCTX,
                        cfg, max_new=4)
    got = tlm.generate(_t(frozen), 0, torch.from_numpy(prompt), FP32_CTX,
                       _smoke(get_config, arch), max_new=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_with_cache_equals_re_prefill():
    """Prefill 9 tokens, decode 3 through the cache: each step's logits
    equal a prefill of the whole sequence so far without a cache.  The
    capacity factor is E / k, so an expert's capacity covers every token
    and no assignment drops: with drops, a token's second-layer keys and
    values depend on which other tokens share its prefill."""
    _, _, _, frozen = _jax_world("grok-1-314b")
    cfg = get_config("grok-1-314b").smoke()
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    tf = _t(frozen)
    toks = torch.from_numpy(
        np.random.default_rng(7).integers(0, cfg.vocab, (2, 12)))
    cache = TT.init_cache(cfg, 2, 12, dtype=torch.float32, device="cpu")
    pos = torch.arange(9, dtype=torch.int32).expand(2, 9)
    _, cache, _ = TT.lm_apply(tf, 0, toks[:, :9], FP32_CTX, cfg,
                              positions=pos, cache=cache)
    for t in range(9, 12):
        p_t = torch.full((2, 1), t, dtype=torch.int32)
        step, cache, _ = TT.lm_apply(tf, 0, toks[:, t:t + 1], FP32_CTX, cfg,
                                     positions=p_t, cache=cache)
        full, none, _ = TT.lm_apply(tf, 0, toks[:, :t + 1], FP32_CTX, cfg)
        assert none is None
        _close(step[:, 0], full[:, -1], STACK_TOL)


# ------------------------------------------------- deepseek-v3 with MLA

def test_mla_stack_has_the_reference_leaves():
    """deepseek-v3 smoke with MLA: the port builds the reference's tree
    (every key and shape of ``lm_init``), and its cache is the latent."""
    cfg, params, _, _ = _jax_world(DS)
    tcfg = _smoke(get_config, DS)
    mine = TT.lm_init(tcfg, seed=0, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(_np(params))[0]
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: np.zeros(t.shape), mine))[0]
    assert [(str(k), v.shape) for k, v in got] == \
        [(str(k), v.shape) for k, v in want]
    tc = TT.init_cache(tcfg, 2, 5, dtype=torch.float32, device="cpu")
    jc = JT.init_cache(cfg, 2, 5, dtype=jnp.float32)
    assert sorted(tc) == sorted(jc) == ["dense", "moe"]
    for kind in tc:
        assert sorted(tc[kind]["attn"]) == ["ckv", "krope", "len", "pos"]
        for key in tc[kind]["attn"]:
            assert tuple(tc[kind]["attn"][key].shape) == \
                jc[kind]["attn"][key].shape


def test_freeze_tree_codes_and_stats_match_reference_with_mla():
    """Every MLA leaf (q_down, q_up, kv_down, kv_up, o) of both stacks,
    the dense FFN, the (L, E) banks and the shared expert frozen in one
    grouped call, as the reference freezes them; ``stats`` alike."""
    params, qstate, tfrozen, paths, ties, total = _freeze_both(DS, 0.3, 6)
    mla = {p for p in paths if p[1:2] in (("dense",), ("moe",))
           and p[2] == "attn"}
    assert len(mla) == 10 and len(paths) == 19
    kv_up = tfrozen["stacks"]["moe"]["attn"]["kv_up"]["kernel"]
    m = get_config(DS).smoke().mla
    assert kv_up["packed"].shape == (1, m.kv_lora_rank // 2,
                                     4 * (m.qk_nope_dim + m.v_head_dim))
    want = jqat.stats(params, qstate, 0.3)
    got = tqat.stats(_t(params), _t(qstate), 0.3)
    assert got["quant_params"] == int(want["quant_params"])
    for key in ("sparsity", "entropy_bits_per_weight"):
        _close(got[key], want[key], AUX_TOL)
    print(f"freeze_tree with MLA: {ties} of {total} codes differ from the "
          "reference, each a cost tie within 4 ulp")


def test_mla_decode_with_cache_equals_re_prefill():
    """deepseek-v3 smoke: prefill 9 tokens into the latent cache, decode 3
    (absorbed form): each step's logits equal a prefill of the whole
    sequence so far without a cache (naive form), at capacity factor
    E / k so that no assignment drops."""
    _, _, _, frozen = _jax_world(DS)
    cfg = get_config(DS).smoke()
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    tf = _t(frozen)
    toks = torch.from_numpy(
        np.random.default_rng(8).integers(0, cfg.vocab, (2, 12)))
    cache = TT.init_cache(cfg, 2, 12, dtype=torch.float32, device="cpu")
    pos = torch.arange(9, dtype=torch.int32).expand(2, 9)
    _, cache, _ = TT.lm_apply(tf, 0, toks[:, :9], FP32_CTX, cfg,
                              positions=pos, cache=cache)
    for t in range(9, 12):
        p_t = torch.full((2, 1), t, dtype=torch.int32)
        step, cache, _ = TT.lm_apply(tf, 0, toks[:, t:t + 1], FP32_CTX, cfg,
                                     positions=p_t, cache=cache)
        full, none, _ = TT.lm_apply(tf, 0, toks[:, :t + 1], FP32_CTX, cfg)
        assert none is None
        _close(step[:, 0], full[:, -1], STACK_TOL)
    assert int(cache["moe"]["attn"]["len"][0]) == 12


def test_mla_tree_round_trips_through_convert():
    """The JAX trees with MLA (params, probabilities, the frozen tree)
    cross to the port and back with every array and dtype intact, and
    ``take_experts`` cuts a frozen deepseek tree's banks only."""
    from repro_torch.convert import take_experts, tree_to_numpy
    cfg, params, qstate, frozen = _jax_world(DS)
    for tree in (params, qstate, frozen):
        want = _np(tree)
        got = tree_to_numpy(_t(tree))
        flat_w, wdef = jax.tree_util.tree_flatten(want)
        flat_g, gdef = jax.tree_util.tree_flatten(got)
        assert wdef == gdef
        for a, b in zip(flat_w, flat_g):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    share = take_experts(_t(frozen), 2, 2)
    moe = share["stacks"]["moe"]
    whole = _t(frozen)["stacks"]["moe"]
    assert torch.equal(moe["moe"]["experts"]["up"]["packed"],
                       whole["moe"]["experts"]["up"]["packed"][:, 2:4])
    assert torch.equal(moe["attn"]["kv_up"]["kernel"]["packed"],
                       whole["attn"]["kv_up"]["kernel"]["packed"])
    assert moe["moe"]["router"]["w"].shape[-1] == cfg.n_experts


def test_frozen_shares_add_up_to_the_reference_layer():
    """The serving path's share (the ``model-configs`` guide's test): the
    frozen MoE layer of deepseek-v3 smoke (sigmoid gate, top-2 of 4,
    routed scaling 2.5, a shared expert) as shares (0, 2) and (2, 2), the
    shared expert counted once, adds up to JAX's uncut frozen layer
    (``atol=rtol=1e-5``)."""
    from repro.nn import moe as jmoe
    from repro_torch.convert import take_experts
    from repro_torch.nn import moe as tmoe
    cfg, _, _, frozen = _jax_world(DS)
    p = jax.tree_util.tree_map(lambda a: a[0],
                               frozen["stacks"]["moe"]["moe"])
    kw = dict(top_k=cfg.top_k, gate=cfg.moe_gate,
              capacity_factor=cfg.capacity_factor,
              routed_scaling=cfg.routed_scaling)
    x = _rand(14, (2, 9, cfg.d_model))
    want, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, 0, x, JCTX, **kw))(
        p, jnp.asarray(x))
    tp, xt = _t(p), torch.from_numpy(x)
    total = None
    for first in (0, 2):
        y, aux = tmoe.moe_ffn(take_experts(tp, first, 2, axis=0), 0, xt,
                              FP32_CTX, experts_held=(first, 2), **kw)
        total = y if total is None else total + y
        _close(aux, jaux, AUX_TOL)
    total = total - tlayers.swiglu(tp["shared"], 0, xt, FP32_CTX)
    _close(total, want)
