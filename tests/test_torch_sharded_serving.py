"""The column-sharded serving stack (``repro_torch.serving.sharded``) over
a gloo world of 4 CPU ranks, against the port's own per-layer chain and
the JAX package's single-device chain.

One world is spawned for the module (``launch.mesh.RankPool``); its
meshes (1, 4), (2, 2) and (4, 1) are process groups of it.  The paper's
three MLPs at their published widths (random numpy packs from a seed,
BN-realistic magnitudes) in fp32 and int8, at 1, 3 and 8 rows: 3 rows do
not divide a data axis of 2 or 4, so they are replicated there.  Gates:
every rank's logits bitwise equal to the port's unsharded chain (the
plain versions; their products are tiled as the kernels tile them, so a
column block or a row block of a layer has the whole layer's bits), and
to the JAX package's ``fantastic4_mlp_chain`` (interpret mode, as its own
tests run it) within the fp32 gate ``atol=1e-3, rtol=1e-4``, its
``fantastic4_mlp_chain_int8`` within a relative ``5e-3``
(``tests/test_serving_parity.py:82`` and ``:134``).  The sharded plan's
buckets serve ragged batches over the world, and the launcher's
``--shard`` ranks (run in the same world) print ``--no-fused``'s logits.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_mlps import MLPS
from repro.core import bitplanes as jbp
from repro.kernels import ops as jops
from repro.serving.plans import calibrate_act_scales as j_calibrate
from repro_torch.convert import pack_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import ranks
from repro_torch.launch import serve as tserve

MESHES = [(1, 4), (2, 2), (4, 1)]
ROWS = (1, 3, 8)


@pytest.fixture(scope="module")
def world():
    with tmesh.RankPool(4, device="cpu", timeout=300) as pool:
        yield pool


def _np_pack(dims, seed):
    rng = np.random.default_rng(seed)
    layers = []
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        codes = rng.integers(0, 16, size=(k, n)).astype(np.uint8)
        layers.append({
            "packed": np.asarray(jbp.pack_codes_rows(jnp.asarray(codes))),
            "omega": (rng.normal(size=4) / np.sqrt(k)).astype(np.float32),
            "alpha1": (rng.normal(size=n) * 0.5).astype(np.float32),
            "bias": (rng.normal(size=n) * 0.1).astype(np.float32),
            "alpha2": np.float32(rng.uniform(0.5, 1.5)),
            "shape": (k, n),
            "activation": "relu" if i < len(dims) - 2 else None})
    return layers


@pytest.mark.parametrize("act_dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", sorted(MLPS))
def test_sharded_stack_bitwise_to_the_chain_and_near_the_reference(
        world, name, act_dtype):
    dims = (MLPS[name].d_in,) + tuple(MLPS[name].features)
    layers = _np_pack(dims, seed=len(name))
    jl = [{k: (jnp.asarray(v) if isinstance(v, (np.ndarray, np.generic))
               else v) for k, v in l.items()} for l in layers]
    rng = np.random.default_rng(11)
    xs = [rng.normal(size=(r, dims[0])).astype(np.float32) for r in ROWS]
    scales = None
    if act_dtype == "int8":
        scales = [float(s) for s in j_calibrate(
            {"layers": jl}, jnp.asarray(xs[-1]))["act_scales"]]
    out = world.run(ranks.sharded_mlp, layers, xs, MESHES,
                    act_dtype=act_dtype, act_scales=scales)

    tl = pack_from_numpy({"layers": layers}, device="cpu")["layers"]
    for x, r in zip(xs, ROWS):
        xt = torch.from_numpy(x)
        if act_dtype == "int8":
            chain = tops.fantastic4_mlp_chain_int8(xt, tl, scales).numpy()
            ref = np.asarray(jops.fantastic4_mlp_chain_int8(
                jnp.asarray(x), jl, scales, interpret=True))
            rel = np.abs(chain - ref).max() / np.abs(ref).max()
            assert rel < 5e-3, (name, r, rel)
        else:
            chain = tops.fantastic4_mlp_chain(xt, tl).numpy()
            ref = np.asarray(jops.fantastic4_mlp_chain(
                jnp.asarray(x), jl, interpret=True))
            np.testing.assert_allclose(chain, ref, atol=1e-3, rtol=1e-4)
        for rank, per_rank in enumerate(out):
            for m, res in zip(MESHES, per_rank):
                call = res["calls"][ROWS.index(r)]
                tag = f"{name} {act_dtype} rows {r} mesh {m} rank {rank}"
                np.testing.assert_array_equal(call["y"], chain, err_msg=tag)
                assert call["bitwise"], tag
                assert call["launches"] == 0, tag    # plain: no kernel
    for per_rank in out:
        for m, res in zip(MESHES, per_rank):
            d = res["describe"]
            assert d["mesh"] == {"data": m[0], "model": m[1]}
            split = [i for i, (_, n) in enumerate(zip(dims[:-1], dims[1:]))
                     if n % m[1] == 0]
            assert d["col_sharded_layers"] == split
            assert d["replicated_layers"] == sorted(
                set(range(len(layers))) - set(split))


@pytest.mark.parametrize("act_dtype", ["float32", "int8"])
def test_sharded_plan_serves_ragged_requests_across_ranks(world, act_dtype):
    """``ExecutionPlan(mode="sharded")`` over a (2, 2) mesh: each batch
    padded to its bucket (1 row stays whole; 3, 5 and 8 rows pad to 4, 8
    and 8, split over 'data'), every rank returns every row, bitwise the
    chain."""
    dims = (MLPS["mlp-hr"].d_in,) + tuple(MLPS["mlp-hr"].features)
    layers = _np_pack(dims, seed=5)
    xs = [np.random.default_rng(r).normal(size=(r, dims[0])).astype(
        np.float32) for r in (1, 3, 5, 8)]
    scales = None
    if act_dtype == "int8":
        jl = [{k: (jnp.asarray(v) if isinstance(v, (np.ndarray, np.generic))
                   else v) for k, v in l.items()} for l in layers]
        scales = [float(s) for s in j_calibrate(
            {"layers": jl}, jnp.asarray(xs[-1]))["act_scales"]]
    out = world.run(ranks.sharded_plan, layers, xs, (2, 2),
                    act_dtype=act_dtype, act_scales=scales)
    tl = pack_from_numpy({"layers": layers}, device="cpu")["layers"]
    for rank, res in enumerate(out):
        assert res["describe"]["resolved_mode"] == "sharded"
        assert res["describe"]["sharding"]["mesh"] == {"data": 2, "model": 2}
        for x, call in zip(xs, res["calls"]):
            xt = torch.from_numpy(x)
            want = (tops.fantastic4_mlp_chain_int8(xt, tl, scales)
                    if act_dtype == "int8"
                    else tops.fantastic4_mlp_chain(xt, tl)).numpy()
            tag = f"{act_dtype} rows {x.shape[0]} rank {rank}"
            assert call["path"] == "sharded", tag
            assert call["bucket"] == {1: 1, 3: 4, 5: 8, 8: 8}[x.shape[0]], tag
            assert call["bitwise"], tag
            np.testing.assert_array_equal(call["y"], want, err_msg=tag)


@pytest.mark.parametrize("argv,message", [
    (["--shard", "--arch", "grok-1-314b"],
     r"--shard applies to the paper-MLP serving path \(--arch one of "
     r"\['lenet-300-100', 'mlp-gsc', 'mlp-hr'\]\)"),
    (["--shard", "--engine", "--async"], "--shard serves through the plan"),
    (["--world", "2"], "--world/--backend apply to --shard"),
    (["--shard", "--world", "0"], "--world must be >= 1"),
])
def test_launcher_shard_messages(argv, message):
    with pytest.raises(SystemExit, match=message):
        tserve.main(argv + ["--device", "cpu"])


def test_launcher_shard_prints_the_no_fused_logits(world, monkeypatch,
                                                   capfd):
    """``--shard --world 4``: the launcher's ranks run in the module's world
    (its ``run_ranks`` handed to the pool), rank 0's lines printed here."""
    spawned = []

    def run_in_world(fn, n, *, backend, device, args):
        spawned.append((fn, n, backend, str(device)))
        print(world.run(ranks.launcher_shard, *args)[0], end="")

    monkeypatch.setattr(tmesh, "run_ranks", run_in_world)
    base = ["--arch", "lenet-300-100", "--batch", "5", "--iters", "1",
            "--device", "cpu"]
    tserve.main(base + ["--no-fused"])
    chained = capfd.readouterr().out
    tserve.main(base + ["--shard", "--world", "4"])
    sharded = capfd.readouterr().out
    assert spawned == [(tserve._shard_rank, 4, None, "cpu")]
    assert "shard: ('data','model') mesh {'data': 2, 'model': 2} over 4 " \
        "device(s)" in sharded
    assert "column-split layers [0, 1, 2], replicated none" in sharded
    logits = [re.search(r"logits\[0\]: (.*)", o).group(1)
              for o in (chained, sharded)]
    assert logits[0] == logits[1]
    assert sharded.count("logits[0]") == 1          # rank 0 prints
