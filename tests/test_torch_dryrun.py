"""The port's dry-run tooling against hand counts and the JAX package:
``launch/op_analysis.py`` (the counterpart of ``hlo_analysis.py``), the
shape-only mesh, ``launch/steps.py``'s bundles, ``launch/dryrun.py``,
``launch/roofline.py`` and ``launch/report.py``, on the CPU at smoke
widths.  Counts are exact (integers of FLOPs and bytes); tokens exact.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_configs
from repro.launch import hlo_analysis as jhlo
from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro.launch import specs as jspecs
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core import qat
from repro_torch.launch import dryrun, op_analysis, ranks
from repro_torch.launch import report as treport
from repro_torch.launch import roofline as troofline
from repro_torch.launch import specs as tspecs
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import ShapeMesh
from repro_torch.models import lm as lm_model
from repro_torch.nn import transformer as T
from repro_torch.nn.module import QuantCtx

FAMILY_ARCHS = ("smollm-360m", "deepseek-v3-671b", "grok-1-314b",
                "mamba2-1.3b", "hymba-1.5b", "whisper-base", "qwen2-vl-2b")
CUT = dict(seq=64, batch=8)       # tests/test_distributed_equivalence.py:89-91


@pytest.fixture
def cut_shapes(monkeypatch):
    """The reference test's cut cells: seq 64, batch 8."""
    shapes = {k: dict(v, **CUT) if k != "long_500k" else dict(v)
              for k, v in tspecs.SHAPES.items()}
    monkeypatch.setattr(tspecs, "SHAPES", shapes)
    return shapes


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------ op_analysis

def test_one_matmul_is_two_m_k_n():
    m, k, n = 5, 7, 3
    r = op_analysis.analyze(lambda a, b: a @ b, _meta(m, k), _meta(k, n))
    assert r["flops"] == 2 * m * k * n
    assert r["bytes"] == 4 * (m * k + k * n + m * n)
    assert r["argument_bytes"] == 4 * (m * k + k * n)
    assert r["output_bytes"] == r["peak_bytes"] == 4 * m * n


def test_a_loop_of_ten_is_ten_times_exactly():
    m = k = n = 128

    def loop(x, w):
        for i in range(10):
            x = x @ w[i]
        return x
    r = op_analysis.analyze(loop, _meta(m, k), _meta(10, k, n))
    assert r["flops"] == 10 * 2 * m * k * n
    # the reference's trip-count walker lands between 10x and 11x
    x = jax.ShapeDtypeStruct((m, k), jnp.float32)
    w = jax.ShapeDtypeStruct((10, k, n), jnp.float32)
    c = jax.jit(lambda x, w: jax.lax.scan(
        lambda c, wi: (c @ wi, None), x, w)[0]).lower(x, w).compile()
    ref = jhlo.analyze(c.as_text())["flops"]
    assert 10 * 2 * m * k * n <= ref <= 11 * 2 * m * k * n


def test_elementwise_reductions_and_views():
    def f(a, b):
        y = torch.relu(a + b)            # 2 ops of 12 elements
        return y.t().reshape(-1).sum()   # views move nothing; sum reads 12
    r = op_analysis.analyze(f, _meta(3, 4), _meta(3, 4))
    assert r["flops"] == 12 + 12 + 12
    # add: 2 x 48 in, 48 out; relu 48 + 48; the copy of the transposed
    # view 48 + 48; sum 48 + 4
    assert r["bytes"] == (96 + 48) + 96 + 96 + 52


def test_meta_equals_real_tensors_for_a_train_step(cut_shapes):
    """One step of the smoke SmolLM without quantization (every op an ATen
    op on both devices): counts on meta equal those on CPU tensors."""
    cfg = dataclasses.replace(get_config("smollm-360m").smoke(),
                              quantize=False)
    mesh = ShapeMesh((1, 1), device="cpu")
    b = S.build_train_step(cfg, mesh, remat="none", zero1=False,
                           dtype=torch.float32)
    meta = op_analysis.analyze(b.fn, *b.args)
    state = b.init_state(T.lm_init(cfg, seed=0, device="cpu"))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, v.shape)
                                 ).to(torch.int32)
             for k, v in b.args[1].items()}
    real = op_analysis.analyze(b.fn, state, batch)
    assert meta["ops"] == real["ops"]
    assert meta["flops"] == real["flops"] > 0
    assert meta["bytes"] == real["bytes"] > 0
    assert meta["peak_bytes"] == real["peak_bytes"]
    assert torch.isfinite(real["out"][1]["loss"])


def test_ecl_quant_on_meta_counts_launches_and_copies():
    """On meta, ``ecl_quant_many`` reports the launches the card would make
    (one per MAX_SEGMENTS segments with elements) and copies a view the
    kernel cannot read (at an offset off its 16-byte alignment), as its
    launch on the card does."""
    from repro_torch.kernels import ecl_quant as eq
    n = eq.MAX_SEGMENTS + 1
    r = op_analysis.analyze(eq.ecl_quant_many, [_meta(n, 4, 3), _meta(0, 3)],
                            [_meta(n, 4), _meta(4)], [_meta(n, 16),
                                                      _meta(16)])
    assert r["kernels"] == {"ecl_quant": 2}
    base = _meta(5, 3)
    counts = [op_analysis.analyze(eq.ecl_quant_many, [w], [_meta(4)],
                                  [_meta(16)])
              for w in (base[4:], base[1:2])]      # offsets 48 B and 12 B
    aligned, odd = counts
    assert aligned["kernels"] == odd["kernels"] == {"ecl_quant": 1}
    assert odd["ops"] == aligned["ops"] + 1
    assert odd["bytes"] == aligned["bytes"] + 2 * 4 * 3


# --------------------------------------------------------- the shape mesh

def test_shape_mesh_exchanges_shapes_and_bytes():
    mesh = ShapeMesh((4, 2))
    assert (mesh.rank, mesh.coords) == (0, {"data": 0, "model": 0})
    t = _meta(6, 3)
    assert tuple(mesh.all_gather(t, "data", dim=1).shape) == (6, 12)
    assert tuple(mesh.all_to_all(_meta(8, 3), "data").shape) == (8, 3)
    assert tuple(mesh.all_reduce(t, ("data", "model")).shape) == (6, 3)
    assert tuple(mesh.all_reduce(t, "data", op="max").shape) == (6, 3)
    assert tuple(mesh.ppermute(t, "model", [(0, 1), (1, 0)]).shape) == \
        (6, 3)
    c = mesh.collectives
    assert c["all-gather"] == c["collective-permute"] == 72
    assert c["all-to-all"] == 96 and c["all-reduce"] == 144
    assert c["count"] == 5
    # an axis of one exchanges nothing
    mesh.reset()
    mesh1 = ShapeMesh((1, 4))
    mesh1.all_reduce(t, "data")
    assert mesh1.collectives["count"] == 0


def test_shape_mesh_backward_counts_the_adjoints():
    mesh = ShapeMesh((4, 1))
    x = _meta(6, 3).requires_grad_()

    def f(x):
        y = mesh.all_reduce(mesh.all_gather(x, "data"), "data").sum()
        y.backward()
        return y
    r = op_analysis.analyze(f, x)
    # forward: a gather of x (72 B) and a sum of the (24, 3) result (288
    # B); backward: the sum's adjoint and the gather's, an all-reduce of
    # the (24, 3) gradient each
    assert r["collectives"]["all-gather"] == 72
    assert r["collectives"]["all-reduce"] == 3 * 288
    assert tuple(x.grad.shape) == (6, 3)


def test_data_parallel_all_reduce_is_the_gradient_buffer():
    """On a (4, 1) shape-only mesh a step all-reduces every fp32 gradient
    once (``ranks.reduced_bytes``) plus the loss's sum and count and the
    sum's adjoint (three fp32 scalars)."""
    cfg = get_config("smollm-360m").smoke()
    mesh = ShapeMesh((4, 1))
    b = S.build_train_step(cfg, mesh, remat="none", zero1=False,
                           dtype=torch.float32)
    batch = {"tokens": _meta(2, 16, dtype=torch.int32),
             "labels": _meta(2, 16, dtype=torch.int32)}
    r = op_analysis.analyze(b.fn, b.args[0], batch)
    params = tspecs.abstract_params(cfg)
    grads = ranks.reduced_bytes(params, mesh)
    assert grads == 4 * sum(t.numel() for t in
                            tree.leaves(params)
                            if t.is_floating_point())
    assert max(n for k, _, n in mesh.calls if k == "all-reduce") == grads
    assert r["collectives"]["all-reduce"] == grads + 12


# ---------------------------------------------------------- step bundles

def test_bundles_tokens_equal_generate(monkeypatch):
    cfg = get_config("smollm-360m").smoke()
    b_, p_, n_ = 2, 6, 5
    shapes = dict(tspecs.SHAPES)
    shapes["prefill_32k"] = dict(shapes["prefill_32k"], seq=p_ + n_,
                                 batch=b_)
    shapes["decode_32k"] = dict(shapes["decode_32k"], seq=p_ + n_,
                                batch=b_)
    monkeypatch.setattr(tspecs, "SHAPES", shapes)
    mesh = ShapeMesh((1, 1), device="cpu")
    pre = S.build_prefill_step(cfg, mesh)
    dec = S.build_decode_step(cfg, mesh)
    assert pre.name == "prefill" and dec.donate == (1,)
    params = T.lm_init(cfg, seed=0, device="cpu")
    frozen = qat.freeze_tree(params, qat.build_qstate(params), cfg.lam)
    # the abstract serving tree is the frozen tree's shapes
    ab = dict(S.specs_mod.abstract(frozen))
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, ab)) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda t: 0, pre.args[0]))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b_, p_))).to(torch.int32)
    nxt, cache = pre.fn(frozen, {"tokens": prompt})
    out = [nxt]
    for t in range(n_ - 1):
        nxt, cache = dec.fn(frozen, {
            "tokens": nxt, "cache": cache,
            "positions": torch.full((b_, 1), p_ + t, dtype=torch.int32)})
        out.append(nxt)
    want = lm_model.generate(frozen, 0, prompt,
                             QuantCtx(compute_dtype=torch.bfloat16), cfg,
                             max_new=n_)
    assert torch.equal(torch.cat(out, dim=1), want)


def test_train_bundle_layout_and_share(cut_shapes):
    cfg = get_config("grok-1-314b").smoke()
    mesh = ShapeMesh((2, 2))
    b = S.build_train_step(cfg, mesh)
    # the reference's layout: the banks cut on their experts over 'model'
    assert b.describe()["layout"] == "tensor parallel"
    assert b.describe()["experts"] == "ep"
    state, batch = b.args
    assert tuple(batch["tokens"].shape) == (4, 64)      # 8 rows over 2
    gate = state["params"]["stacks"]["moe"]["moe"]["experts"]["gate"]
    assert gate["w"].shape[1] == cfg.n_experts // 2
    specs = b.in_specs[0]["params"]["stacks"]["moe"]["moe"]
    assert specs["experts"]["gate"]["w"][1] == "model"
    assert specs["router"]["w"] == (None, None, None)
    assert b.in_specs[1]["tokens"] == ("data", None)
    assert set(S.BUILDERS) == {"train", "prefill", "decode"}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_bundle_builds_its_layout_on_first_read(kind, monkeypatch):
    """A bundle built to run ``fn`` on real tensors builds no abstract
    tree; the first read of its layout builds it once."""
    cfg = get_config("smollm-360m").smoke()
    built = []
    real = tspecs.input_specs
    monkeypatch.setattr(tspecs, "input_specs",
                        lambda *a, **k: built.append(a) or real(*a, **k))
    shape = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}[kind]
    b = S.build_step(cfg, ShapeMesh((1, 1)), shape)
    assert b.name == kind and built == []
    args, specs = b.args, b.in_specs
    assert len(built) == 1 and b.args is args and b.in_specs is specs
    assert b.out_specs is not None


# ------------------------------------------------------------ the dry run

@pytest.fixture
def smoke_configs(monkeypatch):
    orig = tconfigs.get_config
    monkeypatch.setattr(tconfigs, "get_config",
                        lambda name: orig(name).smoke())


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_run_cell_every_family_at_the_cut_shapes(tmp_path, cut_shapes,
                                                 smoke_configs, arch):
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = dryrun.run_cell(arch, shape, False, out_dir=str(tmp_path))
        assert rec["status"] == "OK", rec.get("traceback")
        assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
        assert rec["n_devices"] == 256 and rec["mesh"] == "pod16x16"
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes", "generated_code_bytes"}
        on_disk = json.loads((tmp_path / f"{rec['cell']}.json").read_text())
        assert on_disk["status"] == "OK"
        if shape == "train_4k":
            assert rec["collectives"]["all-reduce"] > 0
            assert rec["kernels"].get("ecl_quant", 0) >= 1
    # long_500k is not cut: a full-attention arch skips it, and the SSM
    # (a constant-size state) runs it; a hybrid's global layers would
    # attend over all 524,288 slots
    cfg = get_config(arch)
    if not cfg.sub_quadratic or cfg.family == "ssm":
        long = dryrun.run_cell(arch, "long_500k", False,
                               out_dir=str(tmp_path))
        assert long["status"] == ("OK" if cfg.sub_quadratic else "SKIP")


def test_run_cell_records_a_failure(tmp_path, cut_shapes, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no such layout")
    monkeypatch.setattr(S, "build_step", boom)
    rec = dryrun.run_cell("smollm-360m", "train_4k", False,
                          out_dir=str(tmp_path))
    assert rec["status"] == "FAIL" and "no such layout" in rec["error"]
    assert "Traceback" in rec["traceback"]
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "smollm-360m",
                                     "--shape", "train_4k", "--out",
                                     str(tmp_path)])
    with pytest.raises(SystemExit) as e:
        dryrun.main()
    assert e.value.code == 1


@pytest.mark.parametrize("arch", list_configs())
def test_model_flops_and_active_params_match_reference(arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    assert troofline.active_params(tcfg) == jroofline.active_params(jcfg)
    for info in jspecs.SHAPES.values():
        assert troofline.model_flops(tcfg, info) == \
            jroofline.model_flops(jcfg, info)


def test_h100_peaks_and_no_tpu_figure():
    assert troofline.CARDS == {"NVIDIA H100 80GB HBM3": {
        "flops": 989e12, "hbm": 3.35e12, "link": 450e9}}
    assert (troofline.PEAK_FLOPS, troofline.HBM_BW, troofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    assert troofline.PEAK_FLOPS != jroofline.PEAK_FLOPS
    assert troofline.HBM_BW != jroofline.HBM_BW


def _records(tmp_path):
    """Port records of every family's cells, and each as the reference
    writes it (``lower_s`` / ``compile_s`` in place of ``trace_s``)."""
    port = treport.load(str(tmp_path))
    ref = []
    for r in port:
        r = dict(r)
        if "trace_s" in r:
            r["lower_s"], r["compile_s"] = r.pop("trace_s"), 0.0
        ref.append(r)
    return port, ref


def test_tables_match_reference(tmp_path, cut_shapes, smoke_configs,
                                monkeypatch):
    for arch in ("smollm-360m", "mamba2-1.3b", "whisper-base"):
        for shape in tspecs.SHAPES:
            dryrun.run_cell(arch, shape, False, out_dir=str(tmp_path))
    dryrun.run_cell("smollm-360m", "decode_32k", True, out_dir=str(tmp_path))
    port, ref = _records(tmp_path)
    assert {r["status"] for r in port} == {"OK", "SKIP"}
    for mesh in ("pod16x16", "pod2x16x16"):
        text = treport.dryrun_table(port, mesh)
        assert text == jreport.dryrun_table(ref, mesh)
        assert treport.dryrun_table(ref, mesh) == text
    monkeypatch.setattr(troofline, "PEAK_FLOPS", jroofline.PEAK_FLOPS)
    monkeypatch.setattr(troofline, "HBM_BW", jroofline.HBM_BW)
    monkeypatch.setattr(troofline, "LINK_BW", jroofline.ICI_BW)
    monkeypatch.setattr(jspecs, "SHAPES", cut_shapes)
    text = treport.roofline_table(port)
    assert text == jreport.roofline_table(ref)
    assert text.count("\n") == 1 + sum(
        r["status"] == "OK" and r["mesh"] == "pod16x16" for r in port)
