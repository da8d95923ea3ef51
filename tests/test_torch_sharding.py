"""The port's partition rules, mesh shapes and one-rank sharded plan
(``repro_torch.runtime.sharding``, ``launch.mesh``, ``serving.sharded``)
against the JAX package, in one process on the CPU.

``Rules`` reads names and shapes only, so the reference's rules run here
on abstract trees (``jax.eval_shape``) at every arch's published widths
and at the production 16 x 16 mesh, which no host here builds; the port's
specs must equal them leaf by leaf (a spec is a plain tuple in the port,
a ``PartitionSpec`` there).  ``fit_mesh`` is held to the reference's
function with the device count patched.  A one-rank sharded plan is
bitwise equal to the unsharded chain (plain versions).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_configs
from repro.configs.paper_mlps import MLPS
from repro.core import qat as jqat
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.nn import transformer as JT
from repro.runtime import sharding as jsh
from repro_torch.convert import pack_from_numpy
from repro_torch.kernels import ref as tref
from repro_torch.configs import get_config
from repro_torch.kernels import ops as tops
from repro_torch.launch import mesh as tmesh
from repro_torch.models import whisper as TW
from repro_torch.nn import transformer as TT
from repro_torch.runtime import sharding as tsh
from repro_torch.serving import plans as tplans
from repro_torch.serving.sharded import ShardedStack

MESHES = [(1, 1), (2, 2), (1, 4), (4, 1), (16, 16)]
ARCHS = list_configs()


def _rules(pkg, shape, cfg):
    return pkg.Rules(("data", "model"), dict(zip(("data", "model"), shape)),
                     cfg)


@functools.lru_cache(maxsize=None)
def _abstract(arch, frozen):
    """The reference's abstract params (fp32 masters) or frozen serving
    tree of ``arch`` at its published widths."""
    cfg = jget_config(arch)
    a = jspecs.abstract_params(cfg)
    if frozen:
        a = jax.eval_shape(functools.partial(jqat.freeze_tree, lam=cfg.lam),
                           a, jax.eval_shape(jqat.build_qstate, a))
    return jax.tree_util.tree_flatten_with_path(a)[0]


def _at(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", k))]
    return tree


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_match_reference_leaf_by_leaf(arch, mesh):
    cfg, tcfg = jget_config(arch), get_config(arch)
    jr, tr = _rules(jsh, mesh, cfg), _rules(tsh, mesh, tcfg)
    sharded = 0
    for frozen in (False, True):
        leaves = _abstract(arch, frozen)
        for path, leaf in leaves:
            name = jsh.path_name(path)
            want = tuple(jr.spec_for(name, leaf.shape))
            assert tsh.path_name(
                [getattr(k, "key", getattr(k, "idx", k)) for k in path]
            ) == name
            got = tr.spec_for(name, leaf.shape)
            assert got == want, (name, leaf.shape, got, want)
            assert tr.zero1_spec(got, leaf.shape) == tuple(
                jr.zero1_spec(jr.spec_for(name, leaf.shape), leaf.shape))
            sharded += any(s is not None for s in got)
    if mesh[1] > 1:
        assert sharded, "no leaf sharded over a model axis > 1"


@pytest.mark.parametrize("arch", ["smollm-360m", "grok-1-314b",
                                  "deepseek-v3-671b", "hymba-1.5b",
                                  "whisper-base"])
def test_param_and_cache_specs_on_the_ports_own_trees(arch):
    """``param_specs`` over the port's own smoke tree, ``opt_specs``,
    ``cache_specs`` and ``batch_specs`` equal the reference's on its tree
    of the same config."""
    tcfg = get_config(arch).smoke()
    cfg = jget_config(arch).smoke()
    if cfg.family == "audio":
        tree = TW.whisper_init(tcfg, seed=0, device="cpu")
    else:
        tree = TT.lm_init(tcfg, seed=0, device="cpu")
    a = jspecs.abstract_params(cfg)
    for mesh in MESHES[1:4]:
        jr, tr = _rules(jsh, mesh, cfg), _rules(tsh, mesh, tcfg)
        mine, theirs = tr.param_specs(tree), jr.param_specs(a)
        opt_mine, opt_theirs = tr.opt_specs(tree), jr.opt_specs(a)
        for path, spec in jax.tree_util.tree_flatten_with_path(
                theirs, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec))[0]:
            assert _at(mine, path) == tuple(spec), path
            assert _at(opt_mine, path) == tuple(_at(opt_theirs, path)), path
        if cfg.family != "audio":
            ac = jax.eval_shape(functools.partial(JT.init_cache, cfg, 4, 16))
            tc = TT.init_cache(tcfg, 4, 16, dtype=torch.float32, device="cpu")
            cm, ct = tr.cache_specs(tc), jr.cache_specs(ac)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                    ct, is_leaf=lambda s: isinstance(
                        s, jax.sharding.PartitionSpec))[0]:
                assert _at(cm, path) == tuple(spec), path
        batch = {"tokens": np.zeros((4, 8), np.int32),
                 "one": np.zeros((1, 8), np.int32)}
        assert tr.batch_specs(batch) == {
            k: tuple(v) for k, v in jr.batch_specs(batch).items()}


def _mlp_layers(name):
    dims = (MLPS[name].d_in,) + tuple(MLPS[name].features)
    rng = np.random.default_rng(len(dims))
    return [{"packed": np.zeros(((k + 1) // 2, n), np.uint8),
             "omega": rng.normal(size=4).astype(np.float32)}
            for k, n in zip(dims[:-1], dims[1:])]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", sorted(MLPS))
def test_serving_pack_specs_match_reference(name, mesh):
    layers = _mlp_layers(name)
    want = jsh.serving_pack_specs(layers, _rules(jsh, mesh, None))
    got = tsh.serving_pack_specs(layers, _rules(tsh, mesh, None))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == {k: tuple(v) for k, v in w.items()}
    if name == "lenet-300-100" and mesh[1] == 4:     # 10 logits replicate
        assert [s["packed"][1] for s in got] == ["model", "model", None]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 64, 256])
@pytest.mark.parametrize("model", [None, 1, 2, 3, 4])
def test_fit_mesh_table_matches_reference(monkeypatch, n, model):
    monkeypatch.setattr(jmesh.jax, "device_count", lambda: n)
    monkeypatch.setattr(jmesh.jax, "make_mesh", lambda shape, axes: shape)
    try:
        want = jmesh.fit_mesh(model=model)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            tmesh.fit_mesh_shape(n, model)
        return
    assert tmesh.fit_mesh_shape(n, model) == tuple(want)
    table = {1: (1, 1), 2: (2, 1), 4: (2, 2), 8: (4, 2), 16: (4, 4),
             64: (8, 8), 256: (16, 16), 6: (3, 2)}
    if model is None and n in table:
        assert tuple(want) == table[n]


def test_fit_mesh_errors_and_one_rank_mesh():
    with pytest.raises(ValueError, match="n_devices must be >= 1"):
        tmesh.fit_mesh_shape(0)
    with pytest.raises(ValueError, match="model axis 3 does not divide 4"):
        tmesh.fit_mesh_shape(4, model=3)
    mesh = tmesh.fit_mesh(device="cpu")
    assert tmesh.describe(mesh)["axes"] == {"data": 1, "model": 1}
    assert tmesh.describe(mesh)["n_devices"] == 1
    assert tmesh.describe(tmesh.make_production_mesh(multi_pod=True)) == {
        "axes": {"pod": 2, "data": 16, "model": 16}, "n_devices": 512}
    with pytest.raises(ValueError, match="mesh .* has 4 ranks, the world 1"):
        tmesh.Mesh((2, 2))


def test_more_ranks_than_cards_need_gloo_named(monkeypatch):
    assert tmesh.resolve_backend(4, "cpu") == "gloo"
    with pytest.raises(ValueError, match="use gloo"):
        tmesh.resolve_backend(4, "cpu", "nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmesh.resolve_backend(1, "cuda") == "nccl"
    with pytest.raises(ValueError, match="pass backend='gloo' to let ranks "
                       "share a card"):
        tmesh.resolve_backend(4, "cuda")
    with pytest.raises(ValueError, match="backend='nccl' with 4 ranks"):
        tmesh.resolve_backend(4, "cuda", "nccl")
    assert tmesh.resolve_backend(4, "cuda", "gloo") == "gloo"


@pytest.mark.parametrize("act_dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", sorted(MLPS))
def test_one_rank_sharded_plan_is_the_chain_bitwise(name, act_dtype):
    dims = (MLPS[name].d_in,) + tuple(MLPS[name].features)
    rng = np.random.default_rng(7)
    layers = []
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        codes = rng.integers(0, 16, size=(k, n)).astype(np.uint8)
        layers.append({
            "packed": (codes[0::2] | (codes[1::2] << 4)).astype(np.uint8),
            "omega": (rng.normal(size=4) / np.sqrt(k)).astype(np.float32),
            "alpha1": (rng.normal(size=n) * 0.5).astype(np.float32),
            "bias": (rng.normal(size=n) * 0.1).astype(np.float32),
            "alpha2": np.float32(1.0), "shape": (k, n),
            "activation": "relu" if i < len(dims) - 2 else None})
    pack = pack_from_numpy({"layers": layers}, device="cpu")
    x = torch.from_numpy(rng.normal(size=(5, dims[0])).astype(np.float32))
    calib = tplans.calibrate_act_scales(pack, x) \
        if act_dtype == "int8" else None
    plan = tplans.ExecutionPlan(pack, mode="sharded", act_dtype=act_dtype,
                                calib=calib, device="cpu",
                                mesh=tmesh.single_device_mesh("cpu"))
    if act_dtype == "int8":
        want = tops.fantastic4_mlp_chain_int8(x, pack["layers"],
                                              calib["act_scales"])
    else:
        want = tops.fantastic4_mlp_chain(x, pack["layers"])
    got = plan.run(x)
    assert torch.equal(got, want)
    desc = plan.describe()
    assert desc["resolved_mode"] == "sharded"
    assert desc["sharding"]["mesh"] == {"data": 1, "model": 1}
    assert plan.path_for(300) == "sharded"
    assert plan.mode_label(5).startswith("column-sharded multi-device stack")
    stack = ShardedStack(pack, tmesh.single_device_mesh("cpu"),
                         act_dtype=act_dtype,
                         act_scales=calib and calib["act_scales"])
    assert torch.equal(stack(x[:3]), want[:3])


def test_sharded_plan_without_a_mesh_raises():
    layers = [{"packed": torch.zeros((4, 6), dtype=torch.uint8),
               "omega": torch.ones(4), "alpha1": torch.ones(6),
               "bias": torch.zeros(6), "alpha2": torch.tensor(1.0),
               "shape": (8, 6), "activation": None}]
    with pytest.raises(ValueError, match="mode='sharded' requires mesh= "
                       r"\(build one with launch.mesh.fit_mesh\)"):
        tplans.ExecutionPlan({"layers": layers}, mode="sharded",
                             device="cpu")
    with pytest.raises(ValueError, match="act_dtype='int8' requires "
                       "act_scales"):
        ShardedStack({"layers": layers}, tmesh.single_device_mesh("cpu"),
                     act_dtype="int8")


@pytest.mark.parametrize("m,k,n", [(1, 784, 300), (3, 300, 100),
                                   (64, 128, 12), (100, 960, 2560),
                                   (256, 512, 512)])
def test_tiled_product_blocks_have_the_wholes_bits(m, k, n):
    """What the sharded stack's bitwise gate rests on: a row block or a
    column block of ``tiled_matmul`` has the whole product's bits, and the
    whole is within fp32 rounding of one matmul."""
    rng = np.random.default_rng(m + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
    whole = tref.tiled_matmul(x, w)
    np.testing.assert_allclose(whole.numpy(), (x @ w).numpy(), rtol=1e-4,
                               atol=1e-3)
    for dp in (1, 2, 4):
        for tp in (1, 2, 4):
            if m % dp or n % tp:
                continue
            r, c = m // dp, n // tp
            for i in range(dp):
                for j in range(tp):
                    part = tref.tiled_matmul(x[i * r:(i + 1) * r],
                                             w[:, j * c:(j + 1) * c])
                    assert torch.equal(
                        part, whole[i * r:(i + 1) * r, j * c:(j + 1) * c]), \
                        (dp, tp, i, j)


def test_nothing_falls_back_to_the_cpu(monkeypatch):
    """The mesh defaults to the card and raises without one; the sharded
    stack and plan refuse a pack or a batch that is not on the mesh's
    device (the meta device stands in for a card here) instead of moving
    it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tmesh, "_RANK_DEVICE", None)
    for make in (lambda: tmesh.Mesh((1, 1)),
                 lambda: tmesh.Mesh((1, 1), device="cuda"),
                 tmesh.default_device, tmesh.fit_mesh,
                 tmesh.single_device_mesh,
                 lambda: tmesh.make_mesh((1, 1), device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    layers = [{"packed": torch.zeros((4, 6), dtype=torch.uint8),
               "omega": torch.ones(4), "alpha1": torch.ones(6),
               "bias": torch.zeros(6), "alpha2": torch.tensor(1.0),
               "shape": (8, 6), "activation": None}]
    off = tmesh.Mesh((1, 1), device="meta")
    with pytest.raises(ValueError, match="layer 0's packed lives on cpu, "
                       "the mesh on meta"):
        ShardedStack({"layers": layers}, off)
    with pytest.raises(ValueError, match="lives on cpu, the mesh on meta"):
        tplans.ExecutionPlan({"layers": layers}, mode="sharded",
                             device="cpu", mesh=off)
    stack = ShardedStack({"layers": layers}, tmesh.single_device_mesh("cpu"))
    with pytest.raises(ValueError, match="x lives on meta, the mesh on cpu"):
        stack(torch.zeros((2, 8), device="meta"))
    assert stack(torch.ones((2, 8))).shape == (2, 6)


def test_a_failing_rank_fails_the_call():
    """A rank's exception reaches the parent with its traceback, and the
    pool stops every rank."""
    import operator
    with pytest.raises(tmesh.RankError, match="ZeroDivisionError"):
        tmesh.run_ranks(operator.truediv, 2, device="cpu", args=(1, 0),
                        timeout=60)
    pool = tmesh.RankPool(2, device="cpu", timeout=60)
    try:
        assert pool.run(operator.add, 2, 3) == [5, 5]
        assert [w["rank"] for w in pool.run(tmesh.describe_world)] == [0, 1]
    finally:
        pool.close()
    assert not any(p.is_alive() for p in pool._procs)
    with pytest.raises(tmesh.RankError, match="closed"):
        pool.run(operator.add, 1, 1)
