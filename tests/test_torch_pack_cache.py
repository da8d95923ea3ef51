"""The port's cold tier, hot tier and pack artifacts vs the JAX package's.

* compress → decode serves bit for bit what the original pack serves;
* ``cold_pack_to_payload`` equals the JAX package's key by key;
* a ``pack.npz`` exported by either package loads, verifies and serves in
  the other (served logits at the fp32 gate ``atol=1e-3, rtol=1e-4``
  against the other package's oracle plan);
* tampered artifacts and a foreign ``crc_algo`` are refused with the same
  ``IntegrityError`` kind in both directions;
* ``PackCache`` takes the same LRU and ``hot_bytes`` decisions as the JAX
  package's under one request script, and eviction releases the plan and
  operand memos.

Inputs are seeded numpy packs; everything runs on ``device="cpu"``.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jman
from repro.runtime.integrity import IntegrityError as JIntegrityError
from repro.serving import pack_cache as jpc
from repro.serving import plans as jplans
from repro_torch.checkpoint import manager as tman
from repro_torch.kernels import ops as kops
from repro_torch.runtime import integrity as ti
from repro_torch.runtime.integrity import IntegrityError as TIntegrityError
from repro_torch.serving import pack_cache as tpc
from repro_torch.serving import plans as tplans
from test_torch_integrity import _jax_layers
from test_torch_mlp_serving import _rand_pack

DIMS = (16, 12, 4)
ODD = (33, 20, 9)
FP32 = dict(atol=1e-3, rtol=1e-4)


def _sparse_pack(dims, seed):
    """A pack whose layers pick different formats at rest."""
    pack = _rand_pack(dims, seed=seed)
    rng = np.random.default_rng(seed)
    for i, l in enumerate(pack["layers"]):
        host = l["packed"].numpy().copy()
        host[rng.random(host.shape) < (0.2, 0.95, 0.6)[i % 3]] = 0
        l["packed"] = torch.from_numpy(host)
    return ti.stamp_pack_crcs(pack)


def _x(rows, d, seed=0):
    return np.random.default_rng(seed).normal(size=(rows, d)).astype(
        np.float32)


@pytest.mark.parametrize("dims", [DIMS, ODD], ids=["even", "odd_k"])
@pytest.mark.parametrize("act_dtype", ["float32", "int8"])
def test_compress_decode_serves_bitwise_the_same(dims, act_dtype):
    pack = _sparse_pack(dims, seed=4)
    cold = tpc.compress_pack(pack)
    formats = {l.codes.format for l in cold.layers}
    assert len(formats) > 1, formats
    back = tpc.decode_pack(cold, "cpu")
    x = _x(37, dims[0])
    a = tplans.ExecutionPlan(pack, act_dtype=act_dtype, device="cpu")
    b = tplans.ExecutionPlan(back, act_dtype=act_dtype,
                             calib={"act_scales": a.act_scales},
                             device="cpu")
    for rows in (1, 8, 37):
        torch.testing.assert_close(b.run(x[:rows]), a.run(x[:rows]),
                                   rtol=0, atol=0)
    for lo, lb in zip(pack["layers"], back["layers"]):
        assert lb["crc"] == lo["crc"] == ti.hot_layer_crc(lb)
        torch.testing.assert_close(lb["packed"], lo["packed"], rtol=0,
                                   atol=0)


def test_cold_payload_equals_the_jax_payload_key_by_key():
    pack = _sparse_pack(ODD, seed=6)
    tpay = tpc.cold_pack_to_payload(tpc.compress_pack(pack), prefix="m/")
    jpay = jpc.cold_pack_to_payload(jpc.compress_pack(_jax_layers(pack)),
                                    prefix="m/")
    assert sorted(tpay) == sorted(jpay)
    for key in jpay:
        t, j = np.asarray(tpay[key]), np.asarray(jpay[key])
        assert t.dtype == j.dtype and t.shape == j.shape, key
        assert t.tobytes() == j.tobytes(), key
    # and back: each package reads the other's payload
    assert tpc.cold_pack_from_payload(jpay, prefix="m/").shapes == \
        jpc.cold_pack_from_payload(tpay, prefix="m/").shapes


def test_jax_export_loads_verifies_and_serves_in_the_port(tmp_path):
    pack = _sparse_pack(DIMS, seed=8)
    jpack = _jax_layers(pack)
    jman.export_pack(str(tmp_path / "p"), jpack)
    cold = tman.load_pack(str(tmp_path / "p"), verify=True)
    cache = tpc.PackCache(device="cpu")
    proxy = cache.add("m", cold)
    x = _x(5, DIMS[0], seed=1)
    want = np.asarray(jplans.build_plan(jpack, mode="oracle").run(
        jnp.asarray(x)))
    np.testing.assert_allclose(proxy.run(x).numpy(), want, **FP32)
    assert [l["crc"] for l in proxy.layers] == \
        [l["crc"] for l in pack["layers"]]


def test_port_export_loads_verifies_and_serves_in_the_jax_package(tmp_path):
    pack = _sparse_pack(ODD, seed=9)
    report = tman.export_pack(str(tmp_path / "p"), pack, meta={"arch": "t"})
    assert report["arch"] == "t" and report["compression_ratio"] > 1
    cold = jman.load_pack(str(tmp_path / "p"), verify=True)
    jplan = jplans.build_plan(jpc.decode_pack(cold), mode="oracle")
    x = _x(6, ODD[0], seed=2)
    want = tplans.ExecutionPlan(pack, mode="oracle", device="cpu").run(x)
    np.testing.assert_allclose(np.asarray(jplan.run(jnp.asarray(x))),
                               want.numpy(), **FP32)
    with open(tmp_path / "p" / "report.json") as f:
        assert '"compressed_bytes"' in f.read()


def _flip_stored_bit(path):
    npz = os.path.join(path, "pack.npz")
    data = dict(np.load(npz, allow_pickle=False))
    key = max((k for k in data if "//codes//" in k),
              key=lambda k: data[k].nbytes)
    data[key] = data[key].copy()
    data[key].view(np.uint8).reshape(-1)[0] ^= 1
    np.savez(npz.removesuffix(".npz"), **data)


def _truncate(path):
    npz = os.path.join(path, "pack.npz")
    blob = open(npz, "rb").read()
    with open(npz, "wb") as f:
        f.write(blob[: len(blob) // 2])


def _foreign_algo(path):
    npz = os.path.join(path, "pack.npz")
    data = dict(np.load(npz, allow_pickle=False))
    data["crc_algo"] = np.array("crc32c-foreign")
    np.savez(npz.removesuffix(".npz"), **data)


def _drop_field(path):
    npz = os.path.join(path, "pack.npz")
    data = dict(np.load(npz, allow_pickle=False))
    del data["layer0//omega"]
    np.savez(npz.removesuffix(".npz"), **data)


@pytest.mark.parametrize("tamper", [_flip_stored_bit, _truncate,
                                    _foreign_algo, _drop_field],
                         ids=["flipped_bit", "truncated", "crc_algo",
                              "missing_field"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tampered_artifacts_refused_alike(tmp_path, tamper, writer):
    pack = _sparse_pack(DIMS, seed=10)
    path = str(tmp_path / "p")
    if writer == "jax":
        jman.export_pack(path, _jax_layers(pack))
    else:
        tman.export_pack(path, pack)
    tamper(path)
    with pytest.raises(TIntegrityError) as te:
        tman.load_pack(path)
    with pytest.raises(JIntegrityError) as je:
        jman.load_pack(path)
    assert te.value.kind == je.value.kind == "artifact"
    assert "pack.npz" in str(te.value)
    if tamper is _flip_stored_bit:      # the opt-out stays available
        tman.load_pack(path, verify=False)


def test_cold_flip_caught_by_scrub_and_by_decode():
    cold = tpc.compress_pack(_sparse_pack(DIMS, seed=11))
    tpc.verify_cold_pack(cold)
    ct = cold.layers[1].codes
    key, _ = ct.canonical_items()[0]
    ct.payload[key].view(np.uint8).reshape(-1)[0] ^= 1
    with pytest.raises(TIntegrityError) as e:
        tpc.verify_cold_pack(cold)
    assert e.value.kind == "cold" and e.value.layer == 1
    with pytest.raises(TIntegrityError) as e:
        tpc.decode_pack(cold, "cpu")
    assert e.value.kind == "cold"


SCRIPT = ["a", "b", "a", "c", "d", "b", "a", "a", "e", "c", "d", "e", "b"]


@pytest.mark.parametrize("max_hot,hot_plans", [(2, None), (3, None),
                                               (None, 2.5), (2, 1.5)])
def test_lru_and_byte_budget_decisions_equal_the_jax_cache(max_hot,
                                                           hot_plans):
    packs = {m: _rand_pack(DIMS, seed=i) for i, m in enumerate("abcde")}
    one = tpc.plan_resident_bytes(tplans.ExecutionPlan(
        packs["a"], mode="oracle", device="cpu"))
    hot_bytes = None if hot_plans is None else int(one * hot_plans)
    tcache = tpc.PackCache(max_hot, hot_bytes, device="cpu",
                           plan_kwargs={"mode": "oracle"})
    jcache = jpc.PackCache(max_hot, hot_bytes,
                           plan_kwargs={"mode": "oracle"})
    for m, p in packs.items():
        tcache.add(m, p)
        jcache.add(m, _jax_layers(p))
    x = _x(1, DIMS[0])
    for m in SCRIPT:
        tcache.plan(m).run(x)
        jcache.plan(m).run(jnp.asarray(x))
        assert tcache.hot_ids() == jcache.hot_ids(), m
        for key in ("resolves", "hits", "evictions", "resident_bytes",
                    "resident_high_water"):
            assert tcache.stats[key] == jcache.stats[key], (m, key)
    dt, dj = tcache.describe(), jcache.describe()
    for key in ("hot", "cold_bytes", "fp32_bytes", "resident_bytes"):
        assert dt[key] == dj[key], key


def test_eviction_releases_plan_and_operand_memos():
    cache = tpc.PackCache(max_hot=1, device="cpu")
    proxy = cache.add("m", _rand_pack(DIMS, seed=1))
    proxy.run(_x(3, DIMS[0]))                 # fused plain path: ws stacks
    plan = cache.plan("m")
    layers = plan.layers

    def held():
        return sum(any(o is layers or o is plan.pack for o in objs)
                   for memo in (kops._WS_OPERAND_MEMO, tplans._PLAN_MEMO)
                   for objs, _ in memo._entries.values())
    assert held() >= 2              # the pinned plan and the ws stacks
    assert tplans.get_plan(plan.pack) is plan     # adopted, not a duplicate
    cache.add("n", _rand_pack(DIMS, seed=2)).run(_x(1, DIMS[0]))
    assert not cache.has_hot("m") and held() == 0


def test_evict_reload_is_bitwise_on_the_int8_grid():
    cache = tpc.PackCache(max_hot=1, device="cpu",
                          plan_kwargs={"act_dtype": "int8"})
    proxy = cache.add("m", _rand_pack(ODD, seed=3))
    x = _x(3, ODD[0], seed=7)
    y1 = proxy.run(x)
    scales = list(proxy.act_scales)
    assert cache.evict("m") and not cache.has_hot("m")
    torch.testing.assert_close(proxy.run(x), y1, rtol=0, atol=0)
    assert list(proxy.act_scales) == scales
    assert proxy.device == torch.device("cpu")
    assert proxy.describe()["resident"]


def test_update_and_remove():
    cache = tpc.PackCache(device="cpu")
    proxy = cache.add("m", _rand_pack(DIMS, seed=1))
    x = _x(2, DIMS[0])
    y1 = proxy.run(x)
    cache.update("m", _rand_pack(DIMS, seed=2))
    assert not torch.equal(proxy.run(x), y1)
    with pytest.raises(ValueError):
        cache.add("m", _rand_pack(DIMS, seed=3))
    cache.remove("m")
    with pytest.raises(KeyError):
        cache.plan("m")
    with pytest.raises(ValueError):
        tpc.PackCache(max_hot=0, device="cpu")
