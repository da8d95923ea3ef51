"""The port's CUDA kernels on the card (skipped without one).

These tests import neither JAX nor the JAX package, so they run on the
GPU machine, which has no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Gates as in ``chip_smoke.py``: fp32 ``atol=1e-3, rtol=1e-4`` and int8
relative ``< 5e-3`` against the plain versions; the int8 outputs of the
chain and every fused schedule bitwise equal; a launch the card refuses
(cluster, programmatic dependent or cooperative) raises; a request served from a
coalesced bucket bitwise equal to the same rows served alone.  The ECL
kernel's codes and ŵ bitwise equal to its plain version on the card, for
one tensor a launch and for groups (MLP-GSC's seven tensors in one
launch, unaligned lead slices and views, more segments than one launch
takes); the card's ``fake_quant`` ω gradient within ``rtol=1e-5`` of the
CPU's; grouped training losses bitwise equal to the per-leaf path's.
"""
import array
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.convert import pack_from_numpy
from repro_torch.core import bitplanes, ecl, qat
from repro_torch.kernels import ecl_quant as eq
from repro_torch.kernels import fantastic4_fused_mlp as ffm
from repro_torch.kernels import fantastic4_matmul as fm
from repro_torch.kernels import ops
from repro_torch.serving.batcher import MicroBatcher
from repro_torch.serving.plans import ExecutionPlan

SCHEDULES = ("batch_tiled", "db", "ws", "stream")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 "
                    "chip_smoke.py, or this file with --noconftest)")
    return torch.device("cuda", 0)


def _pack(dims, seed, device):
    rng = np.random.default_rng(seed)
    layers = []
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        codes = rng.integers(0, 16, size=(k + k % 2, n)).astype(np.uint8)
        if k % 2:
            codes[-1] = 0
        layers.append({
            "packed": bitplanes.pack_codes_rows(torch.from_numpy(codes)).numpy(),
            "omega": (rng.normal(size=4) / np.sqrt(k)).astype(np.float32),
            "alpha1": (rng.normal(size=n) * 0.5).astype(np.float32),
            "bias": (rng.normal(size=n) * 0.1).astype(np.float32),
            "alpha2": np.float32(rng.uniform(0.5, 1.5)), "shape": (k, n),
            "activation": "relu" if i < len(dims) - 2 else None})
    return pack_from_numpy({"layers": layers, "act_bits": None}, device)


def _close(got, want, int8):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if int8:
        assert np.abs(got - want).max() / max(np.abs(want).max(), 1e-6) < 5e-3
    else:
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)


STACKS = {"odd": (33, 40, 24, 10),
          "gsc": (512, 512, 512, 256, 256, 128, 128, 12)}


@pytest.mark.parametrize("act_dtype", ["float32", "int8"])
@pytest.mark.parametrize("batch", [1, 3, 9, 17, 20, 33, 70, 255])
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_kernels_match_plain(cuda_device, stack, act_dtype, batch):
    dims = STACKS[stack]
    pack = _pack(dims, 6, cuda_device)
    x = torch.from_numpy(np.random.default_rng(batch).normal(
        size=(batch, dims[0])).astype(np.float32)).to(cuda_device)
    int8 = act_dtype == "int8"
    scales = [0.05] * (len(dims) - 2) if int8 else None
    layers = pack["layers"]
    chain = ops.fantastic4_mlp_chain_int8(x, layers, scales) if int8 \
        else ops.fantastic4_mlp_chain(x, layers)
    plain = (ops.fantastic4_mlp_chain_int8(x, layers, scales,
                                           use_kernel=False) if int8
             else ops.fantastic4_mlp_chain(x, layers, use_kernel=False))
    _close(chain, plain, int8)
    fm.LAUNCHES = 0
    ffm.reset_launches()
    for sched in SCHEDULES:
        got = ops.fantastic4_mlp_fused(x, layers, schedule=sched,
                                       act_dtype=act_dtype, act_scales=scales,
                                       block_m=16 if sched == "db" else None)
        _close(got, plain, int8)
        if int8:
            assert torch.equal(got, chain), sched
    torch.cuda.synchronize(cuda_device)
    assert ffm.LAUNCHES["ws"] == ffm.LAUNCHES["stream"] == 1
    assert ffm.LAUNCHES["batch_tiled"] + ffm.LAUNCHES["db"] == 2


def test_refused_cluster_launch_raises(cuda_device):
    """A cluster launch the card cannot hold returns its CUDA error (no
    fallback), and the wrapper's check raises on it."""
    from repro_torch.kernels import build

    pack = _pack(STACKS["odd"], 6, cuda_device)
    layers = pack["layers"]
    table = ops._layer_table(layers, "float32", None, "tiled")
    x = torch.zeros((4, 33), device=cuda_device)
    y = torch.empty((4, 10), device=cuda_device)
    lib = build.load()
    stream = build.stream_handle(cuda_device)
    for cluster, ldx in ((8, 8000), (32, 44)):   # too much smem; too many CTAs
        err = lib.f4_fused_tiled(x.data_ptr(), 4, 33, table.tensor.data_ptr(),
                                 table.n_layers, table.codes.data_ptr(),
                                 cluster, 8, ldx, max(table.slice_bytes), 0,
                                 y.data_ptr(), stream)
        assert err != 0
        with pytest.raises(RuntimeError, match="CUDA error"):
            build.check(err, "refused")


def test_refused_pdl_and_cooperative_launches_raise(cuda_device):
    """The chain's PDL launch and stream's cooperative launch return the
    card's refusal (here: a row tile past a block's shared memory) and the
    wrapper's check raises on it; there is no other kernel to fall to."""
    from repro_torch.kernels import build

    pack = _pack(STACKS["odd"], 6, cuda_device)
    layers = pack["layers"]
    lib = build.load()
    stream = build.stream_handle(cuda_device)
    l0 = layers[0]
    ops_, _ = fm.chain_operands(l0["packed"], l0["omega"], cuda_device)
    x = torch.zeros((32, 34), device=cuda_device)
    y = torch.empty((32, 40), device=cuda_device)
    err = lib.f4_matmul(x.data_ptr(), ops_.codes.data_ptr(),
                        ops_.omega.data_ptr(), l0["alpha1"].data_ptr(),
                        l0["bias"].data_ptr(), None, 1.0, 0, 1, 32, 34, 40,
                        ops_.n_slices, ops_.slice_w, ops_.slice_bytes, 32,
                        8004, 34, ops_.slice_bytes, 1, y.data_ptr(), stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.check(err, "refused")
    table = ops._layer_table(layers, "float32", None, "stream")
    act = torch.empty(2 * 32 * 40, device=cuda_device)
    ctas = ctypes.c_int(0)
    err = lib.f4_fused_stream(x.data_ptr(), 32, 33, table.tensor.data_ptr(),
                              table.n_layers, table.codes.data_ptr(), 32,
                              8004, 40, max(table.slice_bytes), 8,
                              act.data_ptr(), act.data_ptr(), y.data_ptr(),
                              ctypes.byref(ctas), stream)
    assert err != 0 and ctas.value == 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.check(err, "refused")
    # the card still serves after the refusals
    got = ops.fantastic4_mlp_chain(x[:3, :33], layers)
    torch.cuda.synchronize(cuda_device)
    assert torch.isfinite(got).all()


def test_launch_shapes_on_the_card(cuda_device):
    """At one row the chain spreads a 512-wide layer over 32 CTAs and the
    stream grid over 32; the chain's launches after the first use PDL and
    give the same bits as the first."""
    pack = _pack(STACKS["gsc"], 9, cuda_device)
    layers = pack["layers"]
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(1, 512)).astype(np.float32)).to(cuda_device)
    fm.LAST_LAUNCHES = []
    try:
        first = ops.fantastic4_mlp_chain(x, layers)
        again = ops.fantastic4_mlp_chain(x, layers)
        launches = fm.LAST_LAUNCHES
    finally:
        fm.LAST_LAUNCHES = None
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(first, again)
    assert len(launches) == 14
    assert [l["pdl"] for l in launches] == [False] * 7 + [True] * 7
    assert [l["ctas"] for l in launches[:3]] == [32, 32, 16]
    ops.fantastic4_mlp_fused(x, layers, schedule="stream")
    torch.cuda.synchronize(cuda_device)
    assert ffm.LAST_LAUNCH["stream"]["ctas"] == 32
    assert ffm.LAST_LAUNCH["stream"]["smem_bytes"] == \
        ffm.stream_mlp_smem_bytes(tuple(l["shape"] for l in layers), 1, 8)


@pytest.mark.parametrize("act_dtype", ["float32", "int8"])
@pytest.mark.parametrize("batch", [1, 8, 32])
def test_wide_k_chain_and_fused_fallback(cuda_device, batch, act_dtype):
    """An 8192-wide input: its x tile and code slice do not fit a block's
    shared memory at 8 rows and more, so the chain stages K in chunks;
    stream takes fewer rows a tile; batch_tiled and db (and ws past one
    row) fall back to the chain.  Every path within its gate of the plain version, and int8
    bitwise equal across them."""
    dims = (8192, 64, 10)
    pack = _pack(dims, 10, cuda_device)
    layers = pack["layers"]
    x = torch.from_numpy(np.random.default_rng(batch).normal(
        size=(batch, dims[0])).astype(np.float32)).to(cuda_device)
    int8 = act_dtype == "int8"
    scales = [0.05] if int8 else None
    fm.LAST_LAUNCHES = []
    try:
        chain = ops.fantastic4_mlp_chain_int8(x, layers, scales) if int8 \
            else ops.fantastic4_mlp_chain(x, layers)
        launches = fm.LAST_LAUNCHES
    finally:
        fm.LAST_LAUNCHES = None
    plain = (ops.fantastic4_mlp_chain_int8(x, layers, scales,
                                           use_kernel=False) if int8
             else ops.fantastic4_mlp_chain(x, layers, use_kernel=False))
    _close(chain, plain, int8)
    _, want_kc, _ = fm.chain_tiling(batch, 8192, 16, 8192 // 2 * 16)
    assert launches[0]["k_chunk"] == want_kc
    assert (want_kc < 8192) == (batch >= 8)
    ffm.reset_launches()
    for sched in SCHEDULES:
        got = ops.fantastic4_mlp_fused(x, layers, schedule=sched,
                                       act_dtype=act_dtype, act_scales=scales)
        _close(got, plain, int8)
        if int8:
            assert torch.equal(got, chain), sched
    torch.cuda.synchronize(cuda_device)
    assert ffm.LAUNCHES["stream"] == 1
    assert ffm.LAUNCHES["batch_tiled"] + ffm.LAUNCHES["db"] == 0
    assert ffm.LAUNCHES["ws"] == int(ffm.ws_mlp_fits(
        tuple(l["shape"] for l in layers), rows=batch))
    assert ffm.LAST_LAUNCH["stream"]["rows_per_tile"] == min(batch, 3)


def test_plan_and_batcher_on_the_card(cuda_device):
    pack = _pack((64, 48, 33, 10), 7, cuda_device)
    plan = ExecutionPlan(pack, device=cuda_device)
    rng = np.random.default_rng(7)
    reqs = [rng.normal(size=(int(rng.integers(1, 6)), 64)).astype(np.float32)
            for _ in range(30)]
    ys = MicroBatcher(plan).serve(reqs)
    for r, y in zip(reqs, ys):
        alone = plan.run(torch.from_numpy(r).to(cuda_device)).cpu().numpy()
        np.testing.assert_array_equal(y, alone)


def test_cuda_tensor_on_cpu_pack_raises(cuda_device):
    pack = _pack((8, 6, 4), 8, "cpu")
    with pytest.raises(ValueError):
        ExecutionPlan(pack, device=cuda_device)


ECL_SHAPES = [(512, 512), (512, 256), (256, 256), (256, 128), (128, 128),
              (128, 12), (37, 129), (1, 5)]


def _ecl_inputs(shape, lam, seed, device):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape) * np.sqrt(2.0 / shape[0])).astype(np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    omega = bitplanes.init_omega_from_weights(t(w))
    probs = t(rng.dirichlet(np.ones(16)))
    return t(w), omega, probs, ecl.penalty(t(w), probs, lam)


@pytest.mark.parametrize("lam", [0.0, 0.02, 0.3])
@pytest.mark.parametrize("shape", ECL_SHAPES)
def test_ecl_quant_kernel_bitwise(cuda_device, shape, lam):
    w, omega, _, pen = _ecl_inputs(shape, lam, shape[0] * 7 + shape[1],
                                   cuda_device)
    before = eq.LAUNCHES
    codes, w_hat = eq.ecl_quant_cuda(w, omega, pen)
    want_c, want_w = eq.ecl_quant_plain(w, omega, pen)
    torch.cuda.synchronize(cuda_device)
    assert eq.LAUNCHES == before + 1
    assert torch.equal(codes, want_c)
    assert torch.equal(w_hat, want_w)


@pytest.mark.parametrize("shape", [(512, 256), (37, 129)])
def test_fake_quant_grads_card_vs_cpu(cuda_device, shape):
    w, omega, probs, _ = _ecl_inputs(shape, 0.3, 3, cuda_device)
    ct = torch.from_numpy(np.random.default_rng(4).normal(
        size=shape).astype(np.float32))
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        tw = w.detach().to(dev).clone().requires_grad_()
        tom = omega.detach().to(dev).clone().requires_grad_()
        out = qat.fake_quant(tw, tom, probs.to(dev), 0.3)
        out.backward(ct.to(dev))
        grads[dev.type] = (out.detach().cpu(), tw.grad.cpu(), tom.grad.cpu())
    (out_c, gw_c, gom_c), (out_p, gw_p, gom_p) = grads["cuda"], grads["cpu"]
    torch.testing.assert_close(gw_c, gw_p, rtol=0, atol=0)
    torch.testing.assert_close(gom_c, gom_p, rtol=1e-5, atol=0)


GSC_LAYERS = [(512, 512), (512, 512), (512, 256), (256, 256), (256, 128),
              (128, 128), (128, 12)]


def _batched_inputs(shape, lam, seed, device):
    """w (*lead, R, C) with a batched init ω (*lead, 4) and penalty."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.normal(size=shape) * np.sqrt(2.0 / shape[-2]))
                         .astype(np.float32)).to(device)
    probs = torch.from_numpy(rng.dirichlet(np.ones(16), size=shape[:-2])
                             .astype(np.float32)).to(device)
    return w, bitplanes.init_omega_from_weights(w), ecl.penalty(w, probs, lam)


def _assert_group_bitwise(ws, omegas, pens, outs):
    for w, om, pen, (codes, w_hat) in zip(ws, omegas, pens, outs):
        assert codes.shape == w.shape and w_hat.shape == w.shape
        segs = ([(w, om, pen, codes, w_hat)] if om.ndim == 1 else
                zip(w, om, pen, codes, w_hat))
        for sw, so, sp, sc, sv in segs:
            want_c, want_w = eq.ecl_quant_plain(sw, so, sp)
            assert torch.equal(sc, want_c)
            assert torch.equal(sv, want_w)


@pytest.mark.parametrize("lam", [0.0, 0.02, 0.3])
def test_ecl_group_gsc_in_one_launch(cuda_device, lam):
    """MLP-GSC's seven tensors in one launch, bitwise equal to the plain
    version tensor by tensor."""
    group = [_ecl_inputs(s, lam, 300 + i, cuda_device)
             for i, s in enumerate(GSC_LAYERS)]
    ws, oms, pens = ([g[0] for g in group], [g[1] for g in group],
                     [g[3] for g in group])
    before = eq.LAUNCHES
    outs = eq.ecl_quant_many(ws, oms, pens)
    torch.cuda.synchronize(cuda_device)
    assert eq.LAUNCHES == before + 1
    _assert_group_bitwise(ws, oms, pens, outs)


def test_ecl_group_unaligned_segments(cuda_device):
    """Lead slices of a (3, 37, 129) tensor start 4,773 elements apart (not
    16-byte aligned), a (37, 129) view at an odd offset is copied to its
    outputs' alignment, and 1-5 element tensors are shorter than a vector:
    one launch, bitwise equal to the plain version.  The C entry refuses
    outputs aligned otherwise than w."""
    wb, ob, pb = _batched_inputs((3, 37, 129), 0.3, 21, cuda_device)
    base = _ecl_inputs((37, 129), 0.3, 22, cuda_device)
    flat = torch.cat([torch.zeros(1, device=cuda_device),
                      base[0].reshape(-1)])
    w_odd = flat[1:].view(37, 129)
    assert w_odd.data_ptr() % 16 == 4
    small = [_ecl_inputs(s, 0.3, 23 + i, cuda_device)
             for i, s in enumerate([(1, 1), (1, 2), (1, 3), (1, 4), (1, 5),
                                    (2, 3)])]
    ws = [wb, w_odd] + [s[0] for s in small]
    oms = [ob, base[1]] + [s[1] for s in small]
    pens = [pb, base[3]] + [s[3] for s in small]
    before = eq.LAUNCHES
    outs = eq.ecl_quant_many(ws, oms, pens)
    torch.cuda.synchronize(cuda_device)
    assert eq.LAUNCHES == before + 1
    _assert_group_bitwise(ws, oms, pens, outs)
    # the batched entry of core/ecl.py is one launch as well
    before = eq.LAUNCHES
    codes, w_hat = ecl.quantize(wb, ob, pb)
    assert eq.LAUNCHES == before + 1
    assert torch.equal(codes, outs[0][0]) and torch.equal(w_hat, outs[0][1])
    from repro_torch.kernels import build
    c, v = torch.empty(64, dtype=torch.uint8, device=cuda_device), \
        torch.empty(68, device=cuda_device)
    row = array.array("q", [base[0].data_ptr(), base[1].data_ptr(),
                            base[3].data_ptr(), c.data_ptr(),
                            v.data_ptr() + 4, 64])
    assert build.load().f4_ecl_quant_many(
        row.buffer_info()[0], 1, build.stream_handle(cuda_device)) != 0


def test_ecl_group_splits_past_the_cap(cuda_device):
    """MAX_SEGMENTS + 8 tensors take two launches; a batched tensor with
    MAX_SEGMENTS + 1 leading indices takes two more; all bitwise."""
    cap = eq.MAX_SEGMENTS
    group = [_ecl_inputs((i % 7 + 1, 17 + i), 0.3, 400 + i, cuda_device)
             for i in range(cap + 8)]
    ws, oms, pens = ([g[0] for g in group], [g[1] for g in group],
                     [g[3] for g in group])
    before = eq.LAUNCHES
    outs = eq.ecl_quant_many(ws, oms, pens)
    assert eq.LAUNCHES == before + 2
    wb, ob, pb = _batched_inputs((cap + 1, 6, 5), 0.3, 31, cuda_device)
    outs_b = eq.ecl_quant_many([wb], [ob], [pb])
    torch.cuda.synchronize(cuda_device)
    assert eq.LAUNCHES == before + 4
    _assert_group_bitwise(ws, oms, pens, outs)
    _assert_group_bitwise([wb], [ob], [pb], outs_b)


def test_grouped_train_steps_equal_per_leaf(cuda_device, monkeypatch):
    """Three MLP-GSC EC4T steps: 2 launches a step (plus one per eval
    batch and one for stats), and every loss bitwise equal to the
    per-leaf path (one launch per tensor)."""
    from repro_torch.configs.paper_mlps import MLPS
    from repro_torch.launch import train as T

    cfg = MLPS["mlp-gsc"]
    steps = 3
    kw = dict(lam=0.3, steps=steps, lr=5e-3, seed=0, lam_ramp=60)
    before = eq.LAUNCHES
    grouped = T.train_mlp(cfg, device=cuda_device, **kw)[3]["losses"]
    assert eq.LAUNCHES - before == 2 * steps + T.EVAL_BATCHES + 1
    one_call = ecl.quantize_many
    monkeypatch.setattr(ecl, "quantize_many", lambda ws, oms, pens: [
        one_call([w], [o], [p])[0] for w, o, p in zip(ws, oms, pens)])
    before = eq.LAUNCHES
    per_leaf = T.train_mlp(cfg, device=cuda_device, **kw)[3]["losses"]
    layers = len(cfg.features)
    assert eq.LAUNCHES - before == layers * (2 * steps + T.EVAL_BATCHES + 1)
    assert grouped == per_leaf
