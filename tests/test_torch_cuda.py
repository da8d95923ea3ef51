"""The port's CUDA kernels on the card (skipped without one).

These tests import neither JAX nor the JAX package, so they run on the
GPU machine, which has no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Gates as in ``chip_smoke.py``: fp32 ``atol=1e-3, rtol=1e-4`` and int8
relative ``< 5e-3`` against the plain versions; the int8 outputs of the
chain and every fused schedule bitwise equal; a request served from a
coalesced bucket bitwise equal to the same rows served alone.  The ECL
kernel's codes and ŵ bitwise equal to its plain version on the card, and
the card's ``fake_quant`` ω gradient within ``rtol=1e-5`` of the CPU's.
"""
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
