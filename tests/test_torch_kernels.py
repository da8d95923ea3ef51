"""The port's kernel modules vs the JAX package's Pallas kernels.

On the CPU each port wrapper takes its kernel's plain PyTorch version (the
CUDA kernels run only on the card, see ``chip_smoke.py``); the JAX side
runs the real Pallas bodies with ``interpret=True``, as the JAX tests do.
Same numpy inputs on both sides.

Gates (the repo's serving gates, ``tests/test_serving_parity.py:82,134``):
fp32 ``atol=1e-3, rtol=1e-4``; int8 relative max-abs error ``< 5e-3``
(the reference's own int8 paths are not bitwise equal to each other, see
ROADMAP queue 3).  Inside the port, the int8 outputs of the chain and of
every fused schedule are bitwise equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplanes as jbp
from repro.kernels import ops as jops
from repro.kernels.fantastic4_matmul import fantastic4_matmul_pallas
from repro.serving.plans import calibrate_act_scales as j_calibrate
from repro_torch.convert import pack_from_numpy
from repro_torch.kernels import build
from repro_torch.kernels import fantastic4_fused_mlp as ffm
from repro_torch.kernels import fantastic4_matmul as fm
from repro_torch.kernels import ops as tops

STACKS = {"odd": (33, 40, 24, 10), "even": (64, 48, 32, 12)}
SCHEDULES = ("batch_tiled", "db", "ws", "stream")


def _np_pack(dims, seed=0):
    """numpy frozen pack at BN-realistic magnitudes (activations O(1))."""
    rng = np.random.default_rng(seed)
    layers = []
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        codes = rng.integers(0, 16, size=(k + (k % 2), n)).astype(np.uint8)
        if k % 2:
            codes[-1] = 0
        layers.append({
            "packed": np.asarray(jbp.pack_codes_rows(jnp.asarray(codes))),
            "omega": (rng.normal(size=4) / np.sqrt(k)).astype(np.float32),
            "alpha1": (rng.normal(size=n) * 0.5).astype(np.float32),
            "bias": (rng.normal(size=n) * 0.1).astype(np.float32),
            "alpha2": np.float32(rng.uniform(0.5, 1.5)),
            "shape": (k, n),
            "activation": "relu" if i < len(dims) - 2 else None,
        })
    return {"layers": layers, "act_bits": None}


def _jax_pack(pack):
    return {"layers": [{k: (jnp.asarray(v) if isinstance(
        v, (np.ndarray, np.generic)) else v) for k, v in l.items()}
        for l in pack["layers"]], "act_bits": None}


def _check_fp32(got, want, tag=""):
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4, err_msg=tag)


def _check_int8(got, want, tag=""):
    rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert rel < 5e-3, (tag, rel)


@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
@pytest.mark.parametrize("m,k,n", [(1, 32, 24), (7, 64, 130), (40, 96, 12)])
def test_matmul_plain_vs_pallas(m, k, n, activation):
    rng = np.random.default_rng(m + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    packed = np.asarray(jbp.pack_codes_rows(jnp.asarray(
        rng.integers(0, 16, size=(k, n)).astype(np.uint8))))
    om = (rng.normal(size=4) / np.sqrt(k)).astype(np.float32)
    a1 = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    a2 = np.float32(0.8)
    want = np.asarray(fantastic4_matmul_pallas(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(om),
        jnp.asarray(a1), jnp.asarray(b), jnp.asarray(a2),
        activation=activation, interpret=True))
    t = torch.from_numpy
    got = fm.fantastic4_matmul(t(x), t(packed), t(om), t(a1), t(b),
                               torch.tensor(a2), activation=activation)
    _check_fp32(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), fm.fantastic4_matmul_plain(
            t(x), t(packed), t(om), t(a1), t(b), torch.tensor(a2),
            activation=activation).numpy())


@pytest.mark.parametrize("stack,batch", [("odd", 1), ("even", 16)])
def test_chain_plain_vs_pallas(stack, batch):
    dims = STACKS[stack]
    pack = _np_pack(dims, seed=batch)
    jp, tp = _jax_pack(pack), pack_from_numpy(pack, device="cpu")
    x = np.random.default_rng(batch).normal(size=(batch, dims[0])).astype(
        np.float32)
    scales = j_calibrate(jp, jnp.asarray(x))["act_scales"]
    _check_fp32(tops.fantastic4_mlp_chain(torch.from_numpy(x),
                                          tp["layers"]).numpy(),
                np.asarray(jops.fantastic4_mlp_chain(
                    jnp.asarray(x), jp["layers"], interpret=True)))
    _check_int8(tops.fantastic4_mlp_chain_int8(
        torch.from_numpy(x), tp["layers"], scales).numpy(),
        np.asarray(jops.fantastic4_mlp_chain_int8(
            jnp.asarray(x), jp["layers"], scales, interpret=True)))


@pytest.mark.parametrize("stack", sorted(STACKS))
@pytest.mark.parametrize("batch", [1, 12])
@pytest.mark.parametrize("act_dtype", ["float32", "int8"])
def test_fused_schedules_vs_pallas(stack, batch, act_dtype):
    dims = STACKS[stack]
    pack = _np_pack(dims, seed=3 + batch)
    jp, tp = _jax_pack(pack), pack_from_numpy(pack, device="cpu")
    x = np.random.default_rng(batch).normal(size=(batch, dims[0])).astype(
        np.float32)
    scales = j_calibrate(jp, jnp.asarray(x))["act_scales"] \
        if act_dtype == "int8" else None
    outs = {}
    for sched in SCHEDULES:
        bm = {"stream": 8, "db": 16}.get(sched)
        want = np.asarray(jops.fantastic4_mlp_fused(
            jnp.asarray(x), jp["layers"], interpret=True, schedule=sched,
            block_m=bm, act_dtype=act_dtype, act_scales=scales))
        got = tops.fantastic4_mlp_fused(
            torch.from_numpy(x), tp["layers"], schedule=sched, block_m=bm,
            act_dtype=act_dtype, act_scales=scales).numpy()
        assert got.shape == (batch, dims[-1])
        (_check_fp32 if act_dtype == "float32" else _check_int8)(
            got, want, f"{sched} {stack} b={batch}")
        outs[sched] = got
    if act_dtype == "int8":
        chain = tops.fantastic4_mlp_chain_int8(torch.from_numpy(x),
                                               tp["layers"], scales).numpy()
        for sched, got in outs.items():
            np.testing.assert_array_equal(got, chain, err_msg=sched)


def test_ws_operands_plain_vs_pallas():
    """The stacked ws/stream operands the port builds serve the same
    function as the reference's kernels on the reference's operands."""
    from repro.kernels import fantastic4_fused_mlp as jffm
    dims = STACKS["odd"]
    pack = _np_pack(dims, seed=9)
    jp, tp = _jax_pack(pack), pack_from_numpy(pack, device="cpu")
    shapes = tuple(l["shape"] for l in pack["layers"])
    acts = tuple(l["activation"] for l in pack["layers"])
    x = np.random.default_rng(9).normal(size=(6, dims[0])).astype(np.float32)
    jst = jffm.build_ws_operands(
        *[tuple(l[k] for l in jp["layers"]) for k in
          ("packed", "omega", "alpha1", "bias", "alpha2")],
        shapes=shapes, activations=acts)
    want = np.asarray(jffm.fantastic4_fused_mlp_stream_pallas(
        jnp.asarray(x), *jst, shapes=shapes, activations=acts, block_m=8,
        interpret=True))
    tst = ffm.build_ws_operands(
        *[tuple(l[k] for l in tp["layers"]) for k in
          ("packed", "omega", "alpha1", "bias", "alpha2")],
        shapes=shapes, activations=acts)
    assert tst[0].shape == (len(shapes), 20, 40)     # D = widest even dim
    for plain in (ffm.fantastic4_fused_mlp_ws_plain,
                  ffm.fantastic4_fused_mlp_stream_plain):
        _check_fp32(plain(torch.from_numpy(x), *tst, shapes=shapes).numpy(),
                    want)


GSC = (512, 512, 512, 256, 256, 128, 128, 12)


def _shapes(dims):
    return tuple(zip(dims[:-1], dims[1:]))


@pytest.mark.parametrize("dims,tile", [
    (GSC, 32), ((512, 512, 256, 128, 12), 32), ((784, 300, 100, 10), 32),
    ((33, 40, 24, 10), 256), ((8192, 64, 10), None)])
def test_fits_express_shared_memory(dims, tile):
    """The batch-tiled fit is the kernel's two rows x D activation buffers
    plus the staging tiles, against the 232,448 bytes of a Hopper block;
    ws/stream hold activations in global memory and always fit."""
    shapes = _shapes(dims)
    assert ffm.max_fused_block_m(shapes) == tile
    d = ffm.stack_width(shapes)
    assert ffm.fused_mlp_smem_bytes(shapes, 32) == \
        ffm.CORE_SMEM_BYTES + 2 * 4 * 32 * d
    assert ffm.ws_mlp_fits(shapes, rows=8)
    assert ffm.stream_mlp_fits(shapes, rows=256, block_m=8)
    for fits in (ffm.ws_mlp_fits(shapes, rows=8, smem_budget_bytes=1),
                 ffm.stream_mlp_fits(shapes, rows=8, smem_budget_bytes=1),
                 ffm.fused_mlp_fits(shapes, block_m=8, smem_budget_bytes=1)):
        assert not fits


@pytest.mark.parametrize("sched", SCHEDULES)
def test_budget_one_falls_back_to_chain(sched):
    pack = pack_from_numpy(_np_pack(STACKS["odd"], seed=4), device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(9, 33)).astype(np.float32))
    got = tops.fantastic4_mlp_fused(x, pack["layers"], schedule=sched,
                                    smem_budget_bytes=1)
    np.testing.assert_array_equal(
        got.numpy(), tops.fantastic4_mlp_chain(x, pack["layers"]).numpy())


def test_layer_table_layout():
    """The descriptor bytes the CUDA kernels read (f4::LayerDesc)."""
    pack = pack_from_numpy(_np_pack(STACKS["odd"], seed=5), device="cpu")
    layers = pack["layers"]
    table = ffm.tiled_layer_table(
        *[tuple(l[k] for l in layers) for k in
          ("packed", "omega", "alpha1", "bias", "alpha2")],
        shapes=tuple(l["shape"] for l in layers),
        activations=tuple(l["activation"] for l in layers),
        act_dtype="int8")
    rows = table.tensor.numpy().view(ffm.DESC_DTYPE)
    assert ffm.DESC_DTYPE.itemsize == 80 and len(rows) == 3
    np.testing.assert_array_equal(rows["K"], [34, 40, 24])
    np.testing.assert_array_equal(rows["N"], [40, 24, 10])
    np.testing.assert_array_equal(rows["quant"], [1, 1, 0])
    np.testing.assert_array_equal(rows["act"], [1, 1, 0])
    np.testing.assert_array_equal(rows["wdec_off"], [0, 34 * 40,
                                                     34 * 40 + 40 * 24])
    assert rows["packed"][1] == layers[1]["packed"].data_ptr()
    np.testing.assert_array_equal(rows["omega"][2],
                                  layers[2]["omega"].numpy())


def test_unsupported_device_raises():
    x = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError):
        fm.fantastic4_matmul(x, torch.empty((2, 3), dtype=torch.uint8,
                                            device="meta"),
                             torch.empty(4, device="meta"))


def test_build_names_library_by_source_hash(tmp_path, monkeypatch):
    monkeypatch.setenv(build.ENV_BUILD_DIR, str(tmp_path))
    path = build.library_path()
    assert path.parent == tmp_path
    assert build.source_hash() in path.name
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
