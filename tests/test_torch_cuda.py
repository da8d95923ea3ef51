"""The port's CUDA kernels on the card (skipped without one).

These tests import neither JAX nor the JAX package, so they run on the
GPU machine, which has no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Gates as in ``chip_smoke.py``: fp32 ``atol=1e-3, rtol=1e-4`` and int8
relative ``< 5e-3`` against the plain versions; the int8 outputs of the
chain and every fused schedule bitwise equal; a request served from a
coalesced bucket bitwise equal to the same rows served alone.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import pack_from_numpy
from repro_torch.core import bitplanes
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


@pytest.mark.parametrize("act_dtype", ["float32", "int8"])
@pytest.mark.parametrize("batch", [1, 20, 70])
def test_kernels_match_plain(cuda_device, act_dtype, batch):
    pack = _pack((33, 40, 24, 10), 6, cuda_device)
    x = torch.from_numpy(np.random.default_rng(batch).normal(
        size=(batch, 33)).astype(np.float32)).to(cuda_device)
    int8 = act_dtype == "int8"
    scales = [0.05, 0.05] if int8 else None
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
