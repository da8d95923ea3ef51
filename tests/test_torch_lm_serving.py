"""The port's LMProgram vs the JAX package's (``tests/test_lm_serving.py``).

A frozen smoke transformer, frozen by the JAX package and carried across
as numpy (``repro_torch.convert.lm_tree_from_numpy``), is served as a
:class:`~repro_torch.serving.lm.LMProgram` through the port's
``ServingFrontend`` (register -> prefill -> decode steps -> futures).
Gates: the engine's tokens bitwise equal to the program's own
``generate``, and equal to the JAX package's ``LMProgram.generate`` and
``models.lm.generate`` on the same frozen tree; the ``rows_per_request``
wire contract and the batcher's scatter guard; the integrity guard over
the program's per-block FFN packs and the copies its kernels read.
Everything runs on ``device="cpu"``, where the kernels' plain versions
serve.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import get_config as jget_config
from repro.core import qat as jqat
from repro.models import lm as jlm
from repro.nn import transformer as JT
from repro.nn.module import QuantCtx as JQuantCtx
from repro_torch import serving
from repro_torch.configs import get_config
from repro_torch.convert import lm_tree_from_numpy
from repro_torch.core import qat
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.nn import transformer as TT
from repro_torch.nn.module import FP32_CTX

B, S, NEW = 3, 6, 5
JCTX = JQuantCtx(quant=False, compute_dtype=jnp.float32)


def _t(tree):
    return lm_tree_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                              device="cpu")


def _jax_frozen(cfg, seed=0):
    params = JT.lm_init(jax.random.PRNGKey(seed), cfg)
    return jqat.freeze_tree(params, jqat.build_qstate(params), cfg.lam)


@pytest.fixture(scope="module")
def world():
    jcfg = jget_config("smollm-360m").smoke()
    frozen = _jax_frozen(jcfg)
    cfg = get_config("smollm-360m").smoke()
    prog = serving.LMProgram(_t(frozen), cfg, max_prompt=S, max_new=NEW,
                             max_bucket=8, device="cpu").warmup()
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    return jcfg, cfg, frozen, prog, prompt


def _engine_tokens(prog, prompt, new, first_sid=100):
    toks = []
    frontend = serving.ServingFrontend()
    with frontend:
        frontend.register("lm", prog, max_delay=1e-3)
        futs = [frontend.submit(
                    "lm", prog.encode_prefill(first_sid + i, p)[None])
                for i, p in enumerate(prompt)]
        toks.append([int(f.result(60.0).y[0, 0]) for f in futs])
        for _ in range(new - 1):
            futs = [frontend.submit(
                        "lm", prog.encode_decode(first_sid + i)[None])
                    for i in range(len(prompt))]
            toks.append([int(f.result(60.0).y[0, 0]) for f in futs])
    for i in range(len(prompt)):
        prog.release(first_sid + i)
    return np.asarray(toks, np.int64).T


# ------------------------------------------------- protocol surface

def test_servable_protocol_surface(world):
    _, cfg, _, prog, _ = world
    assert prog.d_in == 2 + S and prog.d_out == 1
    assert prog.rows_per_request == 1
    assert list(prog.bucket_sizes) == [1, 2, 4, 8]
    assert prog.bucket_for(1) == 1 and prog.bucket_for(9) is None
    d = prog.describe(n_seqs=3)
    assert d["program"] == "lm" and d["device"] == "cpu"
    assert set(d["ffn_schedules"]) == {"decode(m=3)", f"prefill(m<={S})"}
    for phase, b in (("decode(m=3)", 4), (f"prefill(m<={S})", 8)):
        assert d["ffn_schedules"][phase] == {
            name: d["ffn_bucket_schedules"][name][b]
            for name in ("gate", "up", "down")}
    assert set(d["ffn_bucket_schedules"]) == {"gate", "up", "down"}
    assert len(prog.layers) == 3 * cfg.n_layers
    assert all(l["packed"].is_contiguous() for l in prog.layers)
    assert prog.live_sequences == 0          # warmup released its sequence
    with pytest.raises(KeyError):
        prog.decode_step(99_999)


def test_rejects_non_dense_family():
    with pytest.raises(ValueError, match="dense-family"):
        serving.LMProgram({}, get_config("mamba2-1.3b").smoke(),
                          max_prompt=4, max_new=4, device="cpu")


def test_default_device_is_the_card(world):
    """Without ``device`` the program runs on CUDA: here there is none (it
    raises), on the card the CPU tree is refused."""
    _, cfg, _, prog, _ = world
    with pytest.raises((RuntimeError, ValueError)):
        serving.LMProgram(prog.frozen, cfg, max_prompt=S, max_new=NEW,
                          max_bucket=8)


def test_ffn_plans_hold_the_frozen_codes(world):
    _, cfg, _, prog, _ = world
    mlp = prog.frozen["stacks"]["dense"]["mlp"]
    for l in range(cfg.n_layers):
        for j, name in enumerate(("gate", "up", "down")):
            layer = prog.layers[3 * l + j]
            np.testing.assert_array_equal(
                layer["packed"].numpy(), mlp[name]["kernel"]["packed"][l])
            np.testing.assert_array_equal(
                layer["omega"].numpy(), mlp[name]["kernel"]["omega"][l])
            assert layer["crc"] and layer["format"]


# ------------------------------------------------- end-to-end engine

def test_frontend_end_to_end_bit_identical(world):
    jcfg, cfg, frozen, prog, prompt = world
    direct = prog.generate(prompt, NEW)
    engine = _engine_tokens(prog, prompt, NEW)
    np.testing.assert_array_equal(engine, direct)
    assert prog.live_sequences == 0
    # the JAX package's program and its models.lm loop on the same tree
    jprog = jserving.LMProgram(frozen, jcfg, max_prompt=S, max_new=NEW,
                               max_bucket=8, interpret=True)
    np.testing.assert_array_equal(engine, jprog.generate(prompt, NEW))
    ref = jlm.generate(frozen, 0, jnp.asarray(prompt, jnp.int32), JCTX, jcfg,
                       max_new=NEW)
    np.testing.assert_array_equal(engine, np.asarray(ref, np.int64))
    # and the port's own models.lm loop
    got = tlm.generate(prog.frozen, 0, torch.from_numpy(prompt), FP32_CTX,
                       cfg, max_new=NEW)
    np.testing.assert_array_equal(engine, got.numpy())


def test_generate_logits_agree_with_lm_apply(world):
    """Teacher-forced over the program's tokens, its logits at every step
    agree with ``lm_apply`` on the frozen tree within 1e-4 of the largest."""
    _, cfg, _, prog, prompt = world
    toks, logits = prog.generate(prompt, NEW, return_logits=True)
    seq = np.concatenate([prompt, toks], axis=1)
    for t in range(NEW):
        want, _, _ = TT.lm_apply(prog.frozen, 0,
                                 torch.from_numpy(seq[:, :S + t]),
                                 FP32_CTX, cfg)
        want = want[:, -1, :cfg.vocab]
        scale = float(want.abs().max())
        assert float((logits[:, t] - want).abs().max()) <= 1e-4 * scale


def test_wire_rows_padding_and_invalid(world):
    """Padding rows answer 0.0, unknown or invalid rows -1.0; neither
    fails the bucket."""
    _, _, _, prog, prompt = world
    rows = np.stack([
        prog.encode_prefill(500, prompt[0]),
        np.zeros(prog.d_in, np.float32),            # padding (seq_id 0)
        prog.encode_decode(777),                    # unknown sequence
        prog.encode_prefill(500, prompt[1]),        # already live
    ])
    out = prog.run(rows).numpy()[:, 0]
    assert out[0] >= 0 and out[1] == 0.0 and out[2] == -1.0 and \
        out[3] == -1.0
    sid, first = prog.prefill(prompt[0])
    assert first == int(out[0])
    prog.release(500)
    prog.release(sid)
    assert prog.live_sequences == 0


def test_decode_past_the_cache_raises(world):
    _, _, _, prog, prompt = world
    sid, _ = prog.prefill(prompt[0])
    try:
        for _ in range(NEW):
            prog.decode_step(sid)
        with pytest.raises(RuntimeError, match="exhausted"):
            prog.decode_step(sid)
    finally:
        prog.release(sid)


# --------------------------------------- wire contract + scatter guard

def test_rows_per_request_contract(world):
    _, _, _, prog, prompt = world
    batcher = serving.MicroBatcher(prog)
    two_rows = np.stack([prog.encode_prefill(900, prompt[0]),
                         prog.encode_decode(900)])
    with pytest.raises(ValueError, match="rows_per_request"):
        batcher.submit(two_rows)
    assert batcher.stats["requests"] == 0


class _ShortOutputStub:
    """ServableProgram that violates the row-count contract on output."""
    d_in = 4
    d_out = 2
    bucket_sizes = (4,)
    rows_per_request = None

    def bucket_for(self, rows):
        return 4 if rows <= 4 else None

    def entry(self, bucket):
        def f(xb):
            return torch.zeros((bucket // 2, self.d_out))
        return f

    def run(self, x):
        return self.entry(4)(x)

    def describe(self):
        return {"kind": "stub"}


def test_scatter_guard_refuses_short_outputs():
    batcher = serving.MicroBatcher(_ShortOutputStub(), max_delay=0.0)
    for _ in range(3):
        batcher.submit(np.zeros((1, 4), np.float32))
    with pytest.raises(RuntimeError, match="refusing to scatter"):
        batcher.flush()


# ------------------------------------------------- integrity guarding

def test_guarded_lm_program_detects_block_corruption(world):
    _, _, _, prog, _ = world
    g = serving.GuardedPlan(prog, model_id="lm")
    g.verify()                                  # clean pass
    layer = prog.layers[0]
    layer["packed"][0, 0] ^= 0x08
    try:
        with pytest.raises(serving.IntegrityError):
            g.verify()
    finally:
        layer["packed"][0, 0] ^= 0x08
    g.verify()                                  # restored -> clean again


def test_guard_checks_the_copies_the_program_reads(world):
    """``verify()`` with no launch checks every copy memoized for the
    program's packs; a flip in one is caught and passes once restored."""
    _, _, _, prog, _ = world
    copies = prog.staged_operands()
    assert copies and all(any(s is c for c in copies) for pack in
                          prog._packs for s in
                          kops.staged_operands(pack["layers"]))
    g = serving.GuardedPlan(prog, model_id="lm")
    g.verify()
    codes = next(s.codes for s in copies if s.codes is not None)
    codes.view(-1)[0] ^= 0x10
    try:
        with pytest.raises(serving.IntegrityError, match="copy"):
            g.verify()
    finally:
        codes.view(-1)[0] ^= 0x10
    g.verify()


def test_program_pins_its_operands_until_forget(world):
    """A program's operands outlive more packs than the operand memos keep
    (they are pinned), and ``forget()`` releases them."""
    from repro_torch.models.mlp import freeze_dense_layer
    jcfg, cfg, frozen, _, _ = world
    prog = serving.LMProgram(_t(frozen), cfg, max_prompt=S, max_new=NEW,
                             max_bucket=8, device="cpu").warmup()
    before = prog.staged_operands()
    assert before
    rng = np.random.default_rng(3)
    others = []
    for i in range(2 * kops._TABLE_MEMO.max_entries):
        codes = torch.from_numpy(rng.integers(0, 16, (8, 8), dtype=np.uint8))
        pack = {"layers": [freeze_dense_layer(
            codes, torch.tensor([0.5, -0.25, 0.125, -1.0]))],
            "name": f"other{i}"}
        serving.build_plan(pack, max_bucket=8, device="cpu").warmup()
        others.append(pack)
    try:
        after = prog.staged_operands()
        assert len(after) == len(before)
        assert all(a is b for a, b in zip(after, before))
        assert not kops.staged_operands(others[0]["layers"])   # evicted
    finally:
        prog.forget()
        for pack in others:
            kops.forget_pack_operands(pack["layers"])
    assert not prog.staged_operands()


def test_guarded_program_serves_through_the_frontend(world):
    """Every launch verified: the guard wraps the stateful program, and the
    tokens stay those of ``generate``."""
    _, _, _, prog, prompt = world
    direct = prog.generate(prompt[:2], 3)
    toks = []
    frontend = serving.ServingFrontend()
    with frontend:
        frontend.register("lm", prog, max_delay=1e-3, integrity=True)
        toks.append([int(frontend.submit(
            "lm", prog.encode_prefill(300 + i, p)[None]).result(60.0).y[0, 0])
            for i, p in enumerate(prompt[:2])])
        for _ in range(2):
            futs = [frontend.submit("lm", prog.encode_decode(300 + i)[None])
                    for i in range(2)]
            toks.append([int(f.result(60.0).y[0, 0]) for f in futs])
        assert frontend.stats["integrity"]["detected"] == 0
    for i in range(2):
        prog.release(300 + i)
    np.testing.assert_array_equal(np.asarray(toks, np.int64).T, direct)


# ------------------------------------------------- gelu variant, launcher

def test_gelu_variant_matches_reference():
    """act="gelu": one 2-layer chain plan a block, biases in the
    epilogue, against the JAX package's models.lm.generate."""
    jcfg = dataclasses.replace(jget_config("smollm-360m").smoke(), act="gelu")
    cfg = dataclasses.replace(get_config("smollm-360m").smoke(), act="gelu")
    params = JT.lm_init(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(2)
    mlp = params["stacks"]["dense"]["mlp"]
    for name in ("fc1", "fc2"):        # non-zero biases: the epilogue adds them
        mlp[name]["bias"] = jnp.asarray(
            rng.normal(size=mlp[name]["bias"].shape) * 0.05, jnp.float32)
    frozen = jqat.freeze_tree(params, jqat.build_qstate(params), jcfg.lam)
    prog = serving.LMProgram(_t(frozen), cfg, max_prompt=S, max_new=4,
                             max_bucket=8, device="cpu")
    assert set(prog._plans[0]) == {"chain"} and \
        len(prog._plans[0]["chain"].layers) == 2
    prompt = rng.integers(0, cfg.vocab, (2, S))
    ref = jlm.generate(frozen, 0, jnp.asarray(prompt, jnp.int32), JCTX, jcfg,
                       max_new=4)
    np.testing.assert_array_equal(prog.generate(prompt, 4),
                                  np.asarray(ref, np.int64))


def test_launcher_engine_returns_the_direct_tokens(capsys):
    gen = tserve.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                       "--engine", "--batch", "2", "--prompt-len", "5",
                       "--max-new", "4"])
    out = capsys.readouterr().out
    assert "decode bit-identical to the direct generate loop" in out
    assert "ms/token" in out and "program schedules" in out
    cfg = get_config("smollm-360m").smoke()
    params = TT.lm_init(cfg, seed=0, device="cpu")
    frozen = qat.freeze_tree(params, qat.build_qstate(params), cfg.lam)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (2, 5))
    want = tlm.generate(frozen, 0, torch.from_numpy(prompt), FP32_CTX, cfg,
                        max_new=4)
    np.testing.assert_array_equal(gen, want.numpy())
