"""The port's integrity layer vs the JAX package's.

Checksums must be equal to the JAX values (same algorithm, same bytes),
so packs verify across the two packages; the port's frozen layers carry
the same ``format``, ``size_bytes``, ``dense_bytes`` and ``crc`` as the
JAX package's for the same params (carried across by
``repro_torch.convert``); and ``GuardedPlan`` detects a flipped byte on
the next launch, in the pack or in a sealed copy the launch reads,
screens non-finite outputs and runs the canary.  Inputs
are seeded numpy; everything runs on ``device="cpu"``.  Tolerance: none
(digests and stamps are exact).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_mlps import MLPConfig
from repro.core import formats as jf
from repro.models import mlp as jmlp
from repro.runtime import integrity as ji
from repro.serving import pack_cache as jpc
from repro_torch.convert import pack_from_numpy, params_from_numpy
from repro_torch.core import formats as tf
from repro_torch.kernels import ops as kops
from repro_torch.kernels import staged
from repro_torch.models import mlp as tmlp
from repro_torch.runtime import integrity as ti
from repro_torch.serving import pack_cache as tpc
from repro_torch.serving.plans import ExecutionPlan
from test_torch_mlp_serving import TINY, _jax_params, _np, _rand_pack

DIMS = (16, 12, 4)
ODD = (33, 20, 9)
NO_BN = MLPConfig("tiny-nobn", (24, 9), d_in=31, batch_norm=False)


def _jax_layers(tpack):
    """The port pack (CPU tensors) as the JAX package's pack."""
    layers = []
    for l in tpack["layers"]:
        out = dict(l)
        for key in ("packed", "omega", "alpha1", "bias", "alpha2"):
            out[key] = jnp.asarray(l[key].numpy())
        layers.append(out)
    return {**tpack, "layers": layers}


def test_crc_algo_equal():
    assert ti.CRC_ALGO == ji.CRC_ALGO


@pytest.mark.parametrize("dims", [DIMS, ODD], ids=["even", "odd_k"])
def test_layer_and_hot_crcs_equal_the_jax_values(dims):
    tpack = _rand_pack(dims, seed=5)
    jpack = _jax_layers(tpack)
    for tl, jl in zip(tpack["layers"], jpack["layers"]):
        assert ti.hot_layer_crc(tl) == ji.hot_layer_crc(jl)
        k, n = tl["shape"]
        codes_t = ti.unpack_codes_np(tl["packed"], k, n)
        codes_j = ji.unpack_codes_np(np.asarray(jl["packed"]), k, n)
        np.testing.assert_array_equal(codes_t, codes_j)
        assert ti.layer_content_crc(codes_t, tl["omega"], tl["alpha1"],
                                    tl["bias"], tl["alpha2"]) == \
            ji.layer_content_crc(codes_j, jl["omega"], jl["alpha1"],
                                 jl["bias"], jl["alpha2"])
    assert ti.hot_layer_crcs(tpack["layers"]) == \
        [ji.hot_layer_crc(jl) for jl in jpack["layers"]]
    # the header separates dtype and shape, as in the reference
    a = np.arange(6, dtype=np.float32)
    for arr in (a, a.reshape(2, 3), a.astype(np.float64)):
        assert ti.crc_update(0, arr, "x") == ji.crc_update(0, arr, "x")
    assert ti.crc_update(0, a, "x") != ti.crc_update(0, a.reshape(2, 3), "x")


@pytest.mark.parametrize("fmt", ["dense4", "bitmask", "csr", "huffman"])
def test_payload_crc_equal(fmt):
    codes = np.random.default_rng(3).integers(0, 16, (19, 23)).astype(
        np.uint8)
    codes[codes < 9] = 0
    assert ti.payload_crc(tf.encode(codes, fmt)) == \
        ji.payload_crc(jf.encode(codes, fmt))


@pytest.mark.parametrize("cfg,lam", [(TINY, None), (TINY, 4.0),
                                     (NO_BN, None)],
                         ids=["bn", "bn-sparse", "no-bn"])
def test_frozen_layers_carry_the_jax_stamps(cfg, lam):
    """The fault this slice repairs: a port pack lacked format,
    size_bytes, dense_bytes and crc.  The same params frozen in both
    packages now give equal stamps on every layer."""
    lam = cfg.lam if lam is None else lam
    params, qs, bn = _jax_params(cfg)
    jpack = jmlp.freeze_mlp(params, qs, bn, lam=lam)
    tp, tq, tb = params_from_numpy(_np(params), _np(qs), _np(bn),
                                   device="cpu")
    tpack = tmlp.freeze_mlp(tp, tq, tb, lam=lam)
    for jl, tl in zip(jpack["layers"], tpack["layers"]):
        for key in ("format", "size_bytes", "dense_bytes", "crc"):
            assert tl[key] == jl[key], key
        assert tl["crc"] == ti.hot_layer_crc(tl)
    assert tmlp.pack_compression_summary(tpack) == \
        jmlp.pack_compression_summary(jpack)
    # a port pack passes the JAX package's own checks, and the reverse
    jpc.compress_pack(_jax_layers(tpack))
    tpc.compress_pack(pack_from_numpy(_np(jpack), device="cpu"))


def test_compress_refuses_a_stamp_that_disagrees_in_both_packages():
    tpack = _rand_pack(DIMS, seed=2)
    ti.stamp_pack_crcs(tpack)
    tpack["layers"][1]["crc"] ^= 1
    jpack = _jax_layers(tpack)
    with pytest.raises(ti.IntegrityError) as te:
        tpc.compress_pack(tpack)
    with pytest.raises(ji.IntegrityError) as je:
        jpc.compress_pack(jpack)
    assert te.value.kind == je.value.kind == "content"
    assert te.value.layer == je.value.layer == 1


def _guarded(seed=0, **policy):
    pack = ti.stamp_pack_crcs(_rand_pack(DIMS, seed=seed))
    plan = ExecutionPlan(pack, device="cpu")
    return plan, ti.GuardedPlan(plan, policy=ti.IntegrityPolicy(**policy),
                                model_id="m")


def test_guarded_plan_detects_a_flipped_packed_byte_on_next_launch():
    plan, guard = _guarded()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, DIMS[0])).astype(np.float32))
    y = guard.entry(2)(x)
    torch.testing.assert_close(y, plan.entry(2)(x), rtol=0, atol=0)
    assert guard.stats["verifies"] == 1
    host = plan.layers[0]["packed"].numpy().copy()
    host.reshape(-1)[3] ^= 4
    plan.layers[0]["packed"] = torch.from_numpy(host)
    with pytest.raises(ti.IntegrityError) as e:
        guard.entry(2)(x)
    assert e.value.kind == "hot" and e.value.layer == 0
    assert e.value.model_id == "m"
    assert guard.stats["detected"] == 1


def test_guarded_entry_verifies_the_layers_it_launched_from():
    """A bucket entry is tagged with its plan's layers: the guard checks
    those, not whatever the wrapped program resolves to later."""
    plan, guard = _guarded()
    entry = guard.entry(1)
    assert entry.layers is plan.layers
    other, _ = _guarded(seed=9)
    guard._plan = other          # a recovery swapped the program meanwhile
    plan.layers[1]["bias"] = plan.layers[1]["bias"] + 1.0
    with pytest.raises(ti.IntegrityError):
        entry(torch.zeros((1, DIMS[0])))


def test_guarded_plan_screens_nonfinite_outputs():
    plan, guard = _guarded(verify_launch=False)
    plan.layers[0]["omega"] = torch.full((4,), float("nan"))
    with pytest.raises(ti.IntegrityError) as e:
        guard.run(np.ones((1, DIMS[0]), np.float32))
    assert e.value.kind == "output"
    assert guard.stats["screened"] == 1


def test_canary_arms_then_catches_drift():
    plan, guard = _guarded(canary=True, verify_launch=False)
    guard.check_canary()            # arms
    guard.check_canary()            # same bits
    assert guard.stats["canary_runs"] == 1
    plan.layers[1]["alpha1"] = plan.layers[1]["alpha1"] * 1.5
    kops.forget_pack_operands(plan.layers)   # as the fault injector does
    with pytest.raises(ti.IntegrityError) as e:
        guard.check_canary()
    assert e.value.kind == "canary"
    d = guard.describe()
    assert d["guarded"] and d["integrity_stats"]["canary_failures"] == 1


def test_unwrap_chain_walks_proxies():
    plan, guard = _guarded()
    chain = ti.unwrap_chain(guard)
    assert chain[0] is guard and chain[1] is plan and len(chain) == 2


def _x(rows=2, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(rows, DIMS[0])).astype(np.float32))


def _sealed(layers, what):
    (st,) = [s for s in kops.staged_operands(layers) if s.what == what]
    return st


def test_launch_notes_the_sealed_copies_it_reads():
    """On the CPU the ws plain version reads the stacked operands and the
    int8 batch_tiled plain version the folded epilogue; the fp32 chain
    reads only the pack.  Each copy is noted once per collector."""
    layers = ti.stamp_pack_crcs(_rand_pack(DIMS, seed=1))["layers"]
    x = _x()
    with staged.reads() as got:
        kops.fantastic4_mlp_fused(x, layers, schedule="ws")
        kops.fantastic4_mlp_fused(x, layers, schedule="ws")
    assert [s.what for s in got] == ["stacked operands"]
    with staged.reads() as got:
        kops.fantastic4_mlp_fused(x, layers, schedule="batch_tiled",
                                  act_dtype="int8", act_scales=(0.5,))
    assert [s.what for s in got] == ["folded int8 epilogue"]
    with staged.reads() as got:
        kops.fantastic4_mlp_chain(x, layers)
    assert got == []
    st = _sealed(layers, "stacked operands")
    assert st.codes is st.tensors[0]
    assert kops.pack_operand_bytes(layers) == sum(
        -(-t.untyped_storage().nbytes() // 512) * 512
        for s in kops.staged_operands(layers) for t in s.tensors)


def test_guarded_plan_detects_an_in_place_flip_in_a_copy_the_launch_reads():
    """The ws bucket reads the stacked codes, a copy of the pack built
    once: a bit flipped there in place, with nothing forgotten and the
    pack itself clean, fails the next launch."""
    plan, guard = _guarded()
    assert plan.buckets[2].path == "fused_ws"
    x = _x()
    y = guard.entry(2)(x)
    assert guard.stats["verifies"] == 1
    st = _sealed(plan.layers, "stacked operands")
    st.codes.reshape(-1)[7] ^= 16
    assert ti.hot_layer_crcs(plan.layers) == guard.expected_crcs()
    with pytest.raises(ti.IntegrityError) as e:
        guard.entry(2)(x)
    assert e.value.kind == "hot" and "stacked operands" in str(e.value)
    assert guard.stats["detected"] == 1
    st.codes.reshape(-1)[7] ^= 16
    torch.testing.assert_close(guard.entry(2)(x), y, rtol=0, atol=0)


def test_scrub_verify_checks_every_sealed_copy_of_the_pack():
    """``verify()`` with no launch behind it (the scrubber, the recovery
    rung) checks every copy memoized for the pack, read or not."""
    plan, guard = _guarded(seed=3)
    x = _x()
    plan.entry(2)(x)                     # builds the copy, unguarded
    kops.fantastic4_mlp_fused(x, plan.layers, schedule="batch_tiled",
                              act_dtype="int8", act_scales=(0.5,))
    guard.verify()
    fold = _sealed(plan.layers, "folded int8 epilogue")
    fold.tensors[0].reshape(-1).view(torch.uint8)[1] ^= 1
    with pytest.raises(ti.IntegrityError) as e:
        guard.verify()
    assert "folded int8 epilogue" in str(e.value)


@pytest.mark.parametrize("kind", ["stacked operands", "layer table"])
def test_a_copy_is_built_only_from_an_intact_copy(kind):
    """The stacked operands and the layer tables are built from the folded
    int8 epilogue (the ws tables from the stacked operands): a parent
    changed since its seal refuses the build, so no seal covers bytes
    that do not go back to the pack."""
    layers = ti.stamp_pack_crcs(_rand_pack(DIMS, seed=4))["layers"]
    scales = (0.25,)
    (alpha1s, _), fold, _ = kops._int8_fold_entry(layers, scales)
    staged.require_intact(fold)
    alpha1s[1].view(torch.uint8)[2] ^= 8
    with pytest.raises(ti.IntegrityError) as e:
        if kind == "stacked operands":
            kops._ws_entry(layers, "int8", scales)
        else:
            kops._layer_table(layers, "int8", scales, "tiled")
    assert e.value.kind == "hot" and "folded int8 epilogue" in str(e.value)
