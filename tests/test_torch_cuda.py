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
takes, a tensor-parallel rank's MoE bank blocks: its experts with their
slice of ω and the penalties, or each expert's FFN columns); the card's
``fake_quant`` ω gradient within ``rtol=1e-5`` of the CPU's; grouped training losses bitwise equal to the per-leaf path's.
Several CUDA streams on the one card: launch counters exact under four
threads; operands memoized on one stream ready for a launch on another;
memory a queued launch reads not reused after its pack is dropped;
stream-schedule launches ordered across streams; the two-stream frontend
bitwise equal to requests served alone.  The integrity guard catches a
bit flipped in place in the copies the kernels read (the slice-major
codes of the chain and of every layer table, ω in a table's
descriptors).  The LM path: ``freeze_tree`` of a stacked leaf bitwise
against the plain version, an ``LMProgram`` on the card giving the CPU
program's tokens through ws and stream, and SmolLM-360M's FFN shapes
(960→2560, 2560→960) within the fp32 gate.  LM training: two smoke
train steps on the card within ``rtol=1e-4`` of the CPU's, one ECL
launch a grouped pass, a card checkpoint restored bitwise; the input feed
places pinned batches on the card.  MoE: grok's smoke stack frozen on the
card bitwise equal to the CPU freeze, and a frozen layer's routing and
dispatch exactly, its output within 1e-5, equal to the CPU's; a share of
grok's smoke config trained on the card within ``rtol=1e-4`` of the CPU,
its backward twice bitwise.  MLA: deepseek-v3's smoke config trained
on the card within ``rtol=1e-4`` of the CPU, and bitwise alike under
remat none, full and dots.  The ssm and hybrid families: the SSD scan on
the card within 1e-5 of the CPU's (2 groups, a ragged chunk, a carried
state), and mamba2's and hymba's smoke configs trained on the card
within ``rtol=1e-4`` of the CPU, bitwise alike under remat none and full.
The vlm and audio families: whisper's sinusoid frequencies (the
reference's exp) bitwise the CPU's and its table within 1e-6, and
qwen2-vl's and whisper's smoke configs trained on the card within
``rtol=1e-4`` of the CPU.  The Huffman codec on the card gives the host's
bytes and codes.  Scale-out: two gloo ranks sharing the card serve
MLP-GSC column-sharded and row-split, bitwise the chain kernel.  Plans
bind from the prior here (the ``cuda_device`` fixture sets
``autotune.tuning`` to the prior, as the CPU tests do, with the autotune
cache in a temporary directory), except in the one test of the
autotuner's sweep on the card:
every bucket bound from the sweep, a warm build with no measure, the
outputs within the gates, and a count of a train step on meta equal to
the card's.
"""
import array
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.convert import pack_from_numpy
from repro_torch.core import bitplanes, ecl, qat
from repro_torch.kernels import autotune
from repro_torch.kernels import ecl_quant as eq
from repro_torch.kernels import fantastic4_fused_mlp as ffm
from repro_torch.kernels import fantastic4_matmul as fm
from repro_torch.kernels import ops
from repro_torch.serving.batcher import MicroBatcher
from repro_torch.serving.plans import ExecutionPlan

SCHEDULES = ("batch_tiled", "db", "ws", "stream")
# the package's own choice: the sweep on a CUDA device
TUNING = autotune.tuning


@pytest.fixture
def cuda_device(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 "
                    "chip_smoke.py, or this file with --noconftest)")
    monkeypatch.setattr(autotune, "tuning", lambda device: "prior")
    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "autotune.json"))
    autotune.clear_memory_cache()
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


def test_plan_sweeps_on_the_card(cuda_device, monkeypatch):
    """The autotuner's sweep on the card: every fused bucket and the plan's
    block_m from the sweep, the crossover kept in the cache file, a warm
    build over the same file with no measure and the same bindings, the
    outputs within the gates (int8 bitwise the chain)."""
    from repro_torch.serving import plans

    monkeypatch.setattr(autotune, "tuning", TUNING)
    pack = _pack((64, 48, 33, 10), 9, cuda_device)
    calls = []
    measure = plans.ExecutionPlan._schedule_measure

    def counted(plan, rows):
        m = measure(plan, rows)
        return lambda s, bm: calls.append((rows, s, bm)) or m(s, bm)
    monkeypatch.setattr(plans.ExecutionPlan, "_schedule_measure", counted)
    x = torch.randn((5, 64), device=cuda_device)
    for act in ("float32", "int8"):
        plan = ExecutionPlan(pack, act_dtype=act, device=cuda_device)
        assert plan.block_source == "sweep"
        assert all(p.source == "sweep" for p in plan.buckets.values())
        assert len(calls) == sum(len(autotune.candidate_schedule_blocks(
            b, plan._eligible_schedules(b))) for b in plan.bucket_sizes)
        assert autotune.get_ws_crossover(
            64, 10, backend=plan._backend_key, act_dtype=act,
            stack=plan._stack_extra) == plan.ws_crossover_rows
        autotune.clear_memory_cache()
        calls.clear()
        warm = ExecutionPlan(pack, act_dtype=act, device=cuda_device)
        assert calls == [] and warm.ws_prior_source == "measured"
        assert {b: (p.path, p.block_m) for b, p in warm.buckets.items()} \
            == {b: (p.path, p.block_m) for b, p in plan.buckets.items()}
        chain = ExecutionPlan(pack, act_dtype=act, mode="per_layer",
                              device=cuda_device,
                              calib={"act_scales": plan.act_scales})
        got, want = plan.run(x), chain.run(x)
        if act == "int8":
            assert torch.equal(got, want)
        else:
            _close(got, ops.fantastic4_mlp_chain(x, pack["layers"],
                                                 use_kernel=False), False)


def test_train_step_count_on_meta_equals_the_cards(cuda_device):
    """launch.op_analysis of one smoke SmolLM train step (its grouped ECL
    passes on the kernel): FLOPs, bytes and operations on meta tensors
    equal those on the card's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import op_analysis
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.nn import transformer as T

    cfg = get_config("smollm-360m").smoke()
    b = S.build_train_step(cfg, ShapeMesh((1, 1)), remat="none",
                           zero1=False, dtype=torch.float32)
    batch = {k: torch.zeros((2, 16), dtype=torch.int32)
             for k in ("tokens", "labels")}
    meta = op_analysis.analyze(b.fn, b.args[0], {
        k: v.to("meta") for k, v in batch.items()})
    state = b.init_state(T.lm_init(cfg, seed=0, device=cuda_device))
    real = op_analysis.analyze(b.fn, state, {
        k: v.to(cuda_device) for k, v in batch.items()})
    assert real["kernels"] == meta["kernels"] == {"ecl_quant": 2}
    for key in ("flops", "bytes", "ops", "peak_bytes"):
        assert meta[key] == real[key], key


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


@pytest.mark.parametrize("rank", [0, 3])
def test_ecl_group_moe_rank_blocks(cuda_device, rank):
    """A tensor-parallel rank's MoE bank blocks in one grouped launch: an
    expert-parallel block (its 2 experts of an (L, 8, d, ff) stack, with
    their slice of ω and of the penalties) and an expert-TP block (each
    expert's ff / 4 columns, a strided view, with the whole ω and the
    whole segments' penalties) give codes and ŵ bitwise the slice of the
    whole stack's."""
    shape, tp = (2, 8, 32, 48), 4
    w, om, pen = _batched_inputs(shape, 0.3, 41, cuda_device)
    whole_c, whole_w = eq.ecl_quant_many([w], [om], [pen])[0]
    e = slice(rank * 2, rank * 2 + 2)
    f = slice(rank * 12, rank * 12 + 12)
    col = w[..., f]
    assert not col.is_contiguous()
    before = eq.LAUNCHES
    (ep_c, ep_w), (tp_c, tp_w) = eq.ecl_quant_many(
        [w[:, e], col], [om[:, e], om], [pen[:, e], pen])
    torch.cuda.synchronize(cuda_device)
    assert eq.LAUNCHES == before + 1
    assert torch.equal(ep_c, whole_c[:, e]) and torch.equal(ep_w,
                                                            whole_w[:, e])
    assert torch.equal(tp_c, whole_c[..., f]) and torch.equal(
        tp_w, whole_w[..., f])


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


# ------------------------------------------- several streams, one card

GSC = (512, 512, 512, 256, 256, 128, 128, 12)
SPIN = 200_000_000          # ~0.1 s of a spinning kernel


def test_launch_counters_exact_under_threads(cuda_device):
    """Four threads, each on a CUDA stream of its own, launch the chain
    and the stream schedule: no launch is lost from the counters."""
    import threading
    pack = _pack((64, 48, 10), 61, cuda_device)
    layers = pack["layers"]
    x = torch.randn((5, 64), device=cuda_device)
    want = ops.fantastic4_mlp_chain(x, layers, use_kernel=False)
    ops.fantastic4_mlp_fused(x, layers, schedule="stream", block_m=8)
    torch.cuda.synchronize(cuda_device)
    chain0, stream0 = fm.LAUNCHES, ffm.LAUNCHES["stream"]
    errors = []

    def work():
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
                for _ in range(25):
                    y = ops.fantastic4_mlp_chain(x, layers)
                    z = ops.fantastic4_mlp_fused(x, layers, schedule="stream",
                                                 block_m=8)
                torch.testing.assert_close(y, want, atol=1e-3, rtol=1e-4)
                torch.testing.assert_close(z, want, atol=1e-3, rtol=1e-4)
        except Exception as exc:                   # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert fm.LAUNCHES - chain0 == 4 * 25 * len(layers)
    assert ffm.LAUNCHES["stream"] - stream0 == 4 * 25


def test_memo_built_on_one_stream_is_ready_for_another(cuda_device):
    """A pack's first launch builds its operands (slice-major code copies,
    layer tables, ws stacks) on a stream held by a spinning kernel; a
    launch on a second stream right after reads them only once built."""
    pack = _pack(GSC, 62, cuda_device)
    layers = pack["layers"]
    x = torch.randn((8, 512), device=cuda_device)
    want = ops.fantastic4_mlp_chain(x, layers, use_kernel=False)
    s1, s2 = torch.cuda.Stream(cuda_device), torch.cuda.Stream(cuda_device)
    for schedule in ("chain", "batch_tiled", "ws", "stream"):
        ops.forget_pack_operands(layers)
        with torch.cuda.stream(s1):
            torch.cuda._sleep(SPIN)
            if schedule == "chain":
                ops.fantastic4_mlp_chain(x, layers)
            else:
                ops.fantastic4_mlp_fused(x, layers, schedule=schedule)
        with torch.cuda.stream(s2):
            y = ops.fantastic4_mlp_chain(x, layers) if schedule == "chain" \
                else ops.fantastic4_mlp_fused(x, layers, schedule=schedule)
        torch.cuda.synchronize(cuda_device)
        torch.testing.assert_close(y, want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("schedule", ["chain", "batch_tiled", "stream"])
def test_dropped_operands_not_reused_while_a_launch_reads_them(cuda_device,
                                                               schedule):
    """The eviction trap: a launch queued on a worker stream behind a
    spinning kernel, then every reference to the pack and its memoized
    operands dropped and the memory filled again on the default stream.
    The launch still reads its own bytes (the wrappers record the stream
    on what they read)."""
    import gc
    pack = _pack(GSC, 63, cuda_device)
    x = torch.randn((8, 512), device=cuda_device)

    def run(layers, xx):
        return ops.fantastic4_mlp_chain(xx, layers) if schedule == "chain" \
            else ops.fantastic4_mlp_fused(xx, layers, schedule=schedule)

    want = run(pack["layers"], x).cpu()          # builds the memos here
    s1 = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(s1):
        torch.cuda._sleep(SPIN)
        x1 = x.clone()
        y = run(pack["layers"], x1)
    ops.forget_pack_operands(pack["layers"])
    del pack
    gc.collect()
    junk = [torch.full((n,), float("nan"), device=cuda_device)
            for n in (1 << 16, 1 << 14, 4096, 2048, 512, 128, 16, 4) * 8]
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(y.cpu(), want)
    del junk


def test_stream_launches_ordered_across_streams(cuda_device):
    """Stream-schedule launches from two CUDA streams run one after the
    other (the cross-stream order) and give the single-stream output."""
    pack = _pack(GSC, 64, cuda_device)
    layers = pack["layers"]
    x = torch.randn((256, 512), device=cuda_device)
    want = ops.fantastic4_mlp_fused(x, layers, schedule="stream", block_m=8)
    s1, s2 = torch.cuda.Stream(cuda_device), torch.cuda.Stream(cuda_device)
    ys = []
    for _ in range(10):
        for st in (s1, s2):
            with torch.cuda.stream(st):
                ys.append(ops.fantastic4_mlp_fused(x, layers,
                                                   schedule="stream",
                                                   block_m=8))
    torch.cuda.synchronize(cuda_device)
    assert all(torch.equal(y, want) for y in ys)
    index = cuda_device.index or 0
    assert ffm._COOP_LAST[index][0] == s2
    ffm._COOP_LAST.clear()


def test_frontend_two_streams_on_the_card(cuda_device):
    """ServingFrontend(streams=2) with verify_launch over two cache-backed
    packs: every result bitwise equal to the request served alone."""
    from repro_torch.serving import PackCache, ServingFrontend

    packs = {"a": _pack(GSC, 65, cuda_device),
             "b": _pack((64, 48, 10), 66, cuda_device)}
    alone = {m: ExecutionPlan(p, device=cuda_device) for m, p in packs.items()}
    fe = ServingFrontend(cache=PackCache(device=cuda_device), streams=2)
    for m, p in packs.items():
        fe.register_pack(m, p, integrity=True, max_delay=1e-3)
    rng = np.random.default_rng(67)
    reqs = [(m, rng.normal(size=(int(rng.integers(1, 33)),
                                 packs[m]["layers"][0]["shape"][0]))
             .astype(np.float32)) for m in "abab" * 30]
    with fe:
        served = [(m, x, fe.submit(m, x)) for m, x in reqs]
        served = [(m, x, f.result(60.0)) for m, x, f in served]
    for m, x, s in served:
        y = alone[m].run(torch.from_numpy(x).to(cuda_device)).cpu().numpy()
        assert np.array_equal(s.y, y)
    assert sum(ss["launches"] for ss in fe.stats["streams"]) == \
        fe.stats["launches"]
    assert not fe.stats["launch_failures"]


def test_hot_crcs_read_the_live_device_tensors(cuda_device):
    """The stack's CRCs from one device-to-host copy equal the CRCs of
    the same pack on the CPU, and a bit flipped in device memory (in
    place, behind the layer dict's back) changes them."""
    from repro_torch.runtime import integrity

    pack = _pack(GSC, 68, cuda_device)
    host = [{k: (v.cpu() if isinstance(v, torch.Tensor) else v)
             for k, v in l.items()} for l in pack["layers"]]
    want = [integrity.hot_layer_crc(l) for l in host]
    assert integrity.hot_layer_crcs(pack["layers"]) == want
    pack["layers"][3]["packed"].view(-1)[5] ^= 16
    got = integrity.hot_layer_crcs(pack["layers"])
    assert got[3] != want[3] and got[:3] == want[:3]


class _Schedule:
    """A program that serves every bucket through one schedule."""

    def __init__(self, layers, schedule):
        self.layers, self.schedule = layers, schedule

    def entry(self, bucket):
        def fn(x):
            if self.schedule == "chain":
                return ops.fantastic4_mlp_chain(x, self.layers)
            return ops.fantastic4_mlp_fused(
                x, self.layers, schedule=self.schedule,
                block_m=8 if self.schedule == "stream" else None)
        fn.layers = self.layers
        return fn


def _guarded_schedule(cuda_device, schedule, seed):
    from repro_torch.runtime import integrity

    pack = integrity.stamp_pack_crcs(_pack(GSC, seed, cuda_device))
    return pack["layers"], integrity.GuardedPlan(
        _Schedule(pack["layers"], schedule), model_id="m")


@pytest.mark.parametrize("schedule,what", [
    ("chain", "chain code slices"), ("batch_tiled", "tiled layer table"),
    ("ws", "stacked layer table"), ("stream", "stream layer table")])
def test_guard_catches_a_flip_in_the_codes_the_kernel_reads(
        cuda_device, schedule, what):
    """The kernels read slice-major code copies, not the pack's packed
    codes: a bit flipped in place in the copy a schedule reads, with
    nothing forgotten and the pack clean, fails the next launch."""
    from repro_torch.runtime import integrity

    layers, guard = _guarded_schedule(cuda_device, schedule, 69)
    x = torch.randn((8, 512), device=cuda_device)
    want = guard.entry(8)(x)
    sealed = [s for s in ops.staged_operands(layers) if s.what == what]
    assert sealed
    sealed[0].codes.view(-1)[100] ^= 1
    assert integrity.hot_layer_crcs(layers) == guard.expected_crcs()
    with pytest.raises(integrity.IntegrityError) as e:
        guard.entry(8)(x)
    assert e.value.kind == "hot" and what in str(e.value)
    sealed[0].codes.view(-1)[100] ^= 1
    assert torch.equal(guard.entry(8)(x), want)


def test_guard_catches_a_flipped_omega_in_a_layer_table_descriptor(
        cuda_device):
    """A layer table holds ω by value in its descriptors: a flip there
    changes what the kernel computes and fails the next launch."""
    from repro_torch.runtime import integrity

    layers, guard = _guarded_schedule(cuda_device, "batch_tiled", 70)
    x = torch.randn((8, 512), device=cuda_device)
    want = guard.entry(8)(x)
    (table,) = [s for s in ops.staged_operands(layers)
                if s.what == "tiled layer table"]
    desc = table.tensors[0]
    desc[2 * ffm.DESC_BYTES + 32] ^= 4          # layer 2, omega[0]
    with pytest.raises(integrity.IntegrityError):
        guard.entry(8)(x)
    desc[2 * ffm.DESC_BYTES + 32] ^= 4
    assert torch.equal(guard.entry(8)(x), want)


# ------------------------------------------------- the LM path (slice 7)

def test_freeze_tree_stacked_leaf_bitwise_on_the_card(cuda_device):
    """A (3, 96, 256) leaf with ω (3, 4) freezes in one grouped launch,
    each segment's codes bitwise equal to the plain version on the same
    card tensors."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.normal(size=(3, 96, 256)) * 0.05)
                         .astype(np.float32)).to(cuda_device)
    probs = torch.from_numpy(rng.dirichlet(np.ones(16), size=3)
                             .astype(np.float32)).to(cuda_device)
    params = {"k": qat.make_quant_param(w)}
    qstate = {"k": {"probs": probs}}
    before = eq.LAUNCHES
    frozen = qat.freeze_tree(params, qstate, 0.3)
    assert eq.LAUNCHES == before + 1
    pen = ecl.penalty(w, probs, 0.3)
    got = bitplanes.unpack_codes_rows(frozen["k"]["packed"])
    for l in range(3):
        want, _ = eq.ecl_quant_plain(w[l], params["k"]["omega"][l], pen[l])
        assert torch.equal(got[l], want)


def test_moe_layer_on_the_card_matches_the_cpu(cuda_device):
    """grok's smoke MoE stack frozen on the card (one grouped launch for
    its (L, E) banks) equals the CPU freeze bitwise; a frozen layer's
    routing ids, dispatch and output (drops included) on the card equal
    the CPU's, ids and slots exactly, the output within 1e-5; a batched
    bank decodes bitwise on both."""
    from repro_torch.configs import get_config
    from repro_torch.nn import moe
    from repro_torch.nn import transformer as T
    from repro_torch.nn.module import FP32_CTX
    from repro_torch.tree import map_

    cfg = get_config("grok-1-314b").smoke()
    params = T.lm_init(cfg, seed=0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 24, cfg.d_model)).astype(np.float32))
    out = {}
    for name, dev in (("card", cuda_device), ("cpu", torch.device("cpu"))):
        p = _to(params, dev)
        before = eq.LAUNCHES
        frozen = qat.freeze_tree(p, qat.build_qstate(p), cfg.lam)
        assert eq.LAUNCHES == before + (name == "card")
        layer = map_(lambda a: a[0], frozen["stacks"]["moe"]["moe"])
        xt = x.to(dev).reshape(-1, cfg.d_model)
        ids, _, _ = moe.route(xt @ layer["router"]["w"],
                              layer["router"]["bias_correction"], top_k=2,
                              gate="softmax")
        slot, keep = moe._dispatch_indices(ids.reshape(-1), 4, 8)
        y, aux = moe.moe_apply(layer, 0, x.to(dev), FP32_CTX, top_k=2,
                               capacity_factor=0.5)
        banks = frozen["stacks"]["moe"]["moe"]["experts"]
        out[name] = [t.cpu() for t in (ids, slot, keep, y, aux)] + [
            t.cpu() for bank in ("gate", "up", "down") for t in (
                banks[bank]["packed"], bitplanes.decode(
                    bitplanes.unpack_codes_rows(banks[bank]["packed"]),
                    banks[bank]["omega"]))]
    card, cpu = out["card"], out["cpu"]
    for a, b in zip(card[:3] + card[5:], cpu[:3] + cpu[5:]):
        assert torch.equal(a, b)
    assert not cpu[2].all()               # capacity 8 drops some
    torch.testing.assert_close(card[3], cpu[3], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(card[4], cpu[4], atol=1e-6, rtol=1e-6)


def _to(tree, device):
    from repro_torch.tree import map_
    return map_(lambda t: t.to(device) if isinstance(t, torch.Tensor)
                else t, tree)


def test_lm_program_on_the_card_matches_the_cpu_program(cuda_device):
    """A smoke LM with a 4096-wide FFN, so that its down matrix takes ws
    at a decode of 3 sequences and stream at an 8-token prefill: the
    card's tokens equal the CPU program's (same frozen codes)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.nn import transformer as T
    from repro_torch.serving.lm import LMProgram

    cfg = dataclasses.replace(get_config("smollm-360m").smoke(), d_ff=4096)
    params = T.lm_init(cfg, seed=0, device="cpu")
    frozen = qat.freeze_tree(params, qat.build_qstate(params), cfg.lam)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (3, 8))
    kw = dict(max_prompt=8, max_new=4, max_bucket=8)
    want = LMProgram(frozen, cfg, device="cpu", **kw).generate(prompt, 4)
    prog = LMProgram(_to(frozen, cuda_device), cfg, device=cuda_device,
                     **kw).warmup()
    ffm.reset_launches()
    got = prog.generate(prompt, 4)
    np.testing.assert_array_equal(got, want)
    assert ffm.LAUNCHES["ws"] > 0 and ffm.LAUNCHES["stream"] > 0


@pytest.mark.parametrize("rows", [1, 64])
def test_smollm_ffn_shapes_on_the_card(cuda_device, rows):
    """SmolLM-360M's FFN shapes through the plan's schedule at 1 and 64
    rows, within the fp32 gate of the plain oracle."""
    for dims in ((960, 2560), (2560, 960)):
        pack = _pack(dims, 80 + dims[0], cuda_device)
        plan = ExecutionPlan(pack, device=cuda_device, max_bucket=64)
        x = torch.randn((rows, dims[0]), device=cuda_device)
        want = ops.fantastic4_mlp_chain(x, pack["layers"], use_kernel=False)
        _close(plan.run(x), want, False)


def test_lm_train_steps_on_the_card_match_the_cpu(cuda_device):
    """The LM train step at the smoke config in fp32: two card steps
    within rtol=1e-4 of two CPU steps from one init, each making exactly
    2 ecl_quant launches (the grouped fake-quant forward and the
    probability update, 14 segments each), and a checkpoint of the card
    state restoring onto the card bitwise."""
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data import pipeline
    from repro_torch.launch import train as T
    from repro_torch.nn import transformer as TT
    from repro_torch.optim import ec4t
    from repro_torch.tree import leaves

    cfg = T.lm_config("smollm-360m", smoke=True)
    params = TT.lm_init(cfg, seed=0, device="cpu")
    batch_fn = T.lm_batch_fn(cfg, batch=4, seq=32)
    step_fn = T.lm_step_fn(cfg, steps=10, lr=1e-3, lam=0.3, lam_ramp=1,
                           dtype=torch.float32)
    losses = {}
    for dev in (cuda_device, torch.device("cpu")):
        state = ec4t.init_train_state(_to(params, dev))
        out = []
        for i in range(2):
            before = eq.LAUNCHES
            state, m = step_fn(state, pipeline.place(batch_fn(i), device=dev))
            out.append(float(m["loss"]))
            if dev.type == "cuda":
                assert eq.LAUNCHES - before == 2
        losses[dev.type] = out
        if dev.type == "cuda":
            with tempfile.TemporaryDirectory() as tmp:
                mgr = CheckpointManager(tmp)
                mgr.save(2, state)
                restored, _ = mgr.restore(ec4t.init_train_state(
                    TT.lm_init(cfg, seed=1, device=dev)))
            assert all(a.device == b.device and torch.equal(a, b)
                       for a, b in zip(leaves(restored), leaves(state)))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def test_feed_places_batches_on_the_card(cuda_device):
    """ShardedFeed pins each batch in its worker and copies it to the card
    without blocking; the values are the step's."""
    from repro_torch.data import pipeline, synthetic

    cfg = synthetic.LMDataCfg(vocab=64, seq_len=8, global_batch=2)
    feed = pipeline.ShardedFeed(lambda s: synthetic.lm_batch(cfg, s),
                                start_step=3, device=cuda_device)
    try:
        got = next(feed)
    finally:
        feed.close()
    assert got["tokens"].device.type == "cuda"
    np.testing.assert_array_equal(got["tokens"].cpu().numpy(),
                                  synthetic.lm_batch(cfg, 3)["tokens"])


def test_moe_share_train_steps_on_the_card(cuda_device):
    """A share of grok's smoke config (experts 0-1 of 4) in fp32: two
    card train steps within rtol=1e-4 of two CPU steps from one init,
    one ecl_quant launch a grouped pass (20 segments), the backward run
    twice on the card bitwise, the routing bias untouched."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as T
    from repro_torch.nn import transformer as TT
    from repro_torch.optim import ec4t

    cfg = dataclasses.replace(T.lm_config("grok-1-314b", smoke=True),
                              experts_held=(0, 2))
    params = TT.lm_init(cfg, seed=0, device="cpu")
    batch_fn = T.lm_batch_fn(cfg, batch=4, seq=32)
    step_fn = T.lm_step_fn(cfg, steps=10, lr=1e-3, lam=0.3, lam_ramp=1,
                           dtype=torch.float32)
    losses = {}
    for dev in (cuda_device, torch.device("cpu")):
        state = ec4t.init_train_state(_to(params, dev))
        out = []
        for i in range(2):
            before = eq.LAUNCHES
            state, m = step_fn(state, pipeline.place(batch_fn(i), device=dev))
            out.append(float(m["loss"]))
            if dev.type == "cuda":
                assert eq.LAUNCHES - before == 2
        losses[dev.type] = out
        router = state["params"]["stacks"]["moe"]["moe"]["router"]
        assert not router["bias_correction"].any()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)

    p = _to(params, cuda_device)
    qs = qat.build_qstate(p)
    batch = pipeline.place(batch_fn(3), device=cuda_device)
    loss_fn = steps_mod._loss_fn(cfg)

    def grads():
        leaves = [t.detach().requires_grad_() for t in tree.leaves(p)]
        loss, _ = loss_fn(tree.unflatten(p, leaves), qs, batch, 0.3)
        return torch.autograd.grad(loss, leaves, allow_unused=True)
    for a, b in zip(grads(), grads()):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


def test_mla_train_steps_on_the_card_under_every_remat(cuda_device):
    """deepseek-v3's smoke config with MLA in fp32 at 3 KV chunks: two
    card train steps within rtol=1e-4 of two CPU steps from one init,
    each making 2 ecl_quant launches (the dense and the MoE stack in one
    grouped pass, then the update), and the same two steps under remat
    full and dots on the card bitwise equal to none's."""
    from repro_torch import tree
    from repro_torch.data import pipeline
    from repro_torch.launch import train as T
    from repro_torch.nn import transformer as TT
    from repro_torch.optim import ec4t

    cfg = T.lm_config("deepseek-v3-671b", smoke=True)
    params = TT.lm_init(cfg, seed=0, device="cpu")
    batch_fn = T.lm_batch_fn(cfg, batch=2, seq=40)
    runs = {}
    for dev, remat in ((cuda_device, "none"), (torch.device("cpu"), "none"),
                       (cuda_device, "full"), (cuda_device, "dots")):
        step_fn = T.lm_step_fn(cfg, steps=10, lr=1e-3, lam=0.3, lam_ramp=1,
                               remat=remat, dtype=torch.float32)
        state = ec4t.init_train_state(_to(params, dev))
        out = []
        for i in range(2):
            before = eq.LAUNCHES
            state, m = step_fn(state, pipeline.place(batch_fn(i), device=dev))
            out.append(float(m["loss"]))
            if dev.type == "cuda":
                assert eq.LAUNCHES - before == 2
        runs[dev.type, remat] = (out, tree.leaves(state))
    np.testing.assert_allclose(runs["cuda", "none"][0], runs["cpu", "none"][0],
                               rtol=1e-4)
    for remat in ("full", "dots"):
        assert runs["cuda", remat][0] == runs["cuda", "none"][0]
        assert all(torch.equal(a, b) for a, b in zip(
            runs["cuda", remat][1], runs["cuda", "none"][1]))


def test_ssd_chunked_on_the_card_matches_the_cpu(cuda_device):
    from repro_torch.nn import ssm
    g = torch.Generator().manual_seed(0)
    x, B, C = (torch.randn(shape, generator=g) for shape in
               ((3, 21, 4, 3), (3, 21, 2, 5), (3, 21, 2, 5)))
    a = -torch.rand((3, 21, 4), generator=g) * 3
    s0 = torch.randn((3, 4, 3, 5), generator=g)
    want = ssm.ssd_chunked(x, a, B, C, 8, init_state=s0)
    got = ssm.ssd_chunked(*(t.to(cuda_device) for t in (x, a, B, C)), 8,
                          init_state=s0.to(cuda_device))
    for w, t in zip(want, got):
        assert t.device.type == "cuda"
        np.testing.assert_allclose(t.cpu().numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_ssm_train_steps_on_the_card_under_remat(cuda_device, arch):
    """An ssm or hybrid smoke config in fp32 (seq 20: a ragged SSD chunk):
    two card train steps within rtol=1e-4 of two CPU steps from one init,
    each making 2 ecl_quant launches, and the same two steps under remat
    full on the card bitwise equal to none's."""
    from repro_torch import tree
    from repro_torch.data import pipeline
    from repro_torch.launch import train as T
    from repro_torch.nn import transformer as TT
    from repro_torch.optim import ec4t

    cfg = T.lm_config(arch, smoke=True)
    params = TT.lm_init(cfg, seed=0, device="cpu")
    batch_fn = T.lm_batch_fn(cfg, batch=2, seq=20)
    runs = {}
    for dev, remat in ((cuda_device, "none"), (torch.device("cpu"), "none"),
                       (cuda_device, "full")):
        step_fn = T.lm_step_fn(cfg, steps=10, lr=1e-3, lam=0.3, lam_ramp=1,
                               remat=remat, dtype=torch.float32)
        state = ec4t.init_train_state(_to(params, dev))
        out = []
        for i in range(2):
            before = eq.LAUNCHES
            state, m = step_fn(state, pipeline.place(batch_fn(i), device=dev))
            out.append(float(m["loss"]))
            if dev.type == "cuda":
                assert eq.LAUNCHES - before == 2
        runs[dev.type, remat] = (out, tree.leaves(state))
    np.testing.assert_allclose(runs["cuda", "none"][0], runs["cpu", "none"][0],
                               rtol=1e-4)
    assert runs["cuda", "full"][0] == runs["cuda", "none"][0]
    assert all(torch.equal(a, b) for a, b in zip(runs["cuda", "full"][1],
                                                 runs["cuda", "none"][1]))


def test_positions_on_the_card_match_the_cpu(cuda_device):
    """``_exp_f32`` (XLA's exp, emulated) bitwise the CPU's on 200,000
    arguments, so whisper's 1,500 x 512 sinusoids take the CPU's (and
    the reference's) frequencies: the table within 1e-6 of the CPU's."""
    from repro_torch.nn import layers
    x = torch.empty(200_000).uniform_(-87.0, 88.0,
                                      generator=torch.Generator()
                                      .manual_seed(0))
    assert torch.equal(layers._exp_f32(x.to(cuda_device)).cpu(),
                       layers._exp_f32(x))
    got = layers.sinusoidal_positions(1500, 512, device=cuda_device)
    np.testing.assert_allclose(got.cpu().numpy(),
                               layers.sinusoidal_positions(1500, 512).numpy(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-base"])
def test_vlm_and_audio_train_steps_on_the_card(cuda_device, arch):
    """qwen2-vl's (patch embeddings) and whisper's (frames and tokens)
    smoke configs in fp32: two card train steps within rtol=1e-4 of two
    CPU steps from one init, each making 2 ecl_quant launches."""
    from repro_torch.data import pipeline
    from repro_torch.launch import train as T
    from repro_torch.optim import ec4t

    cfg = T.lm_config(arch, smoke=True)
    params = T.lm_init(cfg, seed=0, device="cpu")
    batch_fn = T.lm_batch_fn(cfg, batch=2, seq=12)
    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        step_fn = T.lm_step_fn(cfg, steps=10, lr=1e-3, lam=0.3, lam_ramp=1,
                               dtype=torch.float32)
        state = ec4t.init_train_state(_to(params, dev))
        out = []
        for i in range(2):
            before = eq.LAUNCHES
            state, m = step_fn(state, pipeline.place(batch_fn(i), device=dev))
            out.append(float(m["loss"]))
            if dev.type == "cuda":
                assert eq.LAUNCHES - before == 2
        runs[dev.type] = out
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-4)


def test_huffman_on_the_card_equals_the_host_codec(cuda_device):
    """The export's Huffman codec on the card: the host's bytes and its
    codes, for a near-uniform and a skewed code tensor."""
    from repro_torch.core import formats

    rng = np.random.default_rng(0)
    p = np.array([0.3, 0.15, 0.15, 0.1] + [0.3 / 12] * 12)
    for codes in (rng.integers(0, 16, (300, 1000)).astype(np.uint8),
                  rng.choice(16, size=(512, 777), p=p).astype(np.uint8)):
        want = formats.encode_huffman(codes)
        got = formats.encode_huffman(torch.from_numpy(codes).to(
            cuda_device))
        for key in want.payload:
            np.testing.assert_array_equal(got.payload[key],
                                          want.payload[key])
        on = formats.decode_huffman(want, cuda_device)
        assert on.device.type == "cuda"
        np.testing.assert_array_equal(on.cpu().numpy(), codes)


@pytest.mark.parametrize("act_dtype", ["float32", "int8"])
def test_sharded_gsc_over_two_gloo_ranks_is_the_chain_bitwise(cuda_device,
                                                              act_dtype):
    """Two gloo ranks sharing the card serve MLP-GSC column-sharded (mesh
    (1, 2)) and row-split (mesh (2, 1)): every rank's logits bitwise equal
    to the unsharded chain kernel, one matmul_kernel launch a layer."""
    from repro_torch.convert import tree_to_numpy
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import ranks
    from repro_torch.serving.plans import calibrate_act_scales

    pack = _pack(STACKS["gsc"], 15, cuda_device)
    layers = tree_to_numpy(pack["layers"])
    rng = np.random.default_rng(15)
    xs = [rng.normal(size=(r, 512)).astype(np.float32) for r in (1, 3, 64)]
    scales = calibrate_act_scales(pack, xs[-1])["act_scales"] \
        if act_dtype == "int8" else None
    out = tmesh.run_ranks(ranks.sharded_mlp, 2, backend="gloo",
                          device="cuda", args=(layers, xs, [(1, 2), (2, 1)]),
                          kwargs={"act_dtype": act_dtype,
                                  "act_scales": scales}, timeout=300)
    for per_rank in out:
        for res in per_rank:
            assert res["describe"]["collectives"] == \
                "staged through host buffers"
            for call in res["calls"]:
                assert call["bitwise"] and call["launches"] == 7
                _close(torch.from_numpy(call["y"]),
                       torch.from_numpy(call["plain"]), act_dtype == "int8")
