"""The port's MoE layer (``repro_torch.nn.moe``) vs the JAX package's
``nn/moe.py``, on the CPU at small sizes.

The same numpy inputs, and JAX's parameter trees carried across with
``convert.lm_tree_from_numpy``, go through both packages.  Tolerances:
routing ids, dispatch slots and capacities exactly equal; routing weights
and the aux loss within 1e-6; the layer's output in fp32 within
``atol=rtol=1e-5`` (the expert products sum in another order in the two
frameworks).  The port's mirrors of ``tests/test_moe.py`` hold it to its
own per-token dense reference as the JAX tests do (``atol=1e-4``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.nn import moe as jmoe
from repro.nn.module import FP32_CTX as JFP32
from repro_torch.convert import lm_tree_from_numpy
from repro_torch.nn import moe
from repro_torch.nn.layers import swiglu
from repro_torch.nn.module import FP32_CTX, materialize

ROUTE_TOL = dict(atol=1e-6, rtol=1e-6)
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(tree):
    return lm_tree_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                              device="cpu")


def _logits(case, n=24, e=8):
    rng = np.random.default_rng(3)
    if case == "ties":        # few distinct integers: many exact ties
        return rng.integers(-2, 3, (n, e)).astype(np.float32)
    return rng.normal(size=(n, e)).astype(np.float32)


# --------------------------------------------------------------- routing

@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("gate,k,scaling,biased", [
    ("softmax", 2, 1.0, False), ("sigmoid", 3, 2.5, False),
    ("sigmoid", 2, 1.0, True)])
def test_route_matches_reference(gate, k, scaling, biased, case):
    logits = _logits(case)
    bias = (np.random.default_rng(4).normal(size=(8,)) * 0.1).astype(
        np.float32) if biased else np.zeros((8,), np.float32)
    if biased and case == "ties":     # ties in score + bias as well
        bias = np.round(bias * 10).astype(np.float32)
    jids, jw, jaux = jmoe.route(jnp.asarray(logits), jnp.asarray(bias),
                                top_k=k, gate=gate, routed_scaling=scaling)
    ids, w, aux = moe.route(torch.from_numpy(logits), torch.from_numpy(bias),
                            top_k=k, gate=gate, routed_scaling=scaling)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **ROUTE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **ROUTE_TOL)


def test_capacity_matches_reference():
    for n_assign in (1, 8, 30, 62, 64, 128, 248, 1000):
        for e in (1, 2, 4, 8, 256):
            for factor in (0.33, 0.5, 1.0, 1.25, 8.0):
                assert moe._capacity(n_assign, e, factor) == \
                    jmoe._capacity(n_assign, e, factor), (n_assign, e, factor)
    assert moe._capacity(4 * 2, 8, 1.25) == 8        # a 4-sequence decode
    assert moe._capacity(64 * 2, 8, 1.25) == 24      # a 64-token prefill


@pytest.mark.parametrize("capacity", [4, 8, 32])
def test_dispatch_indices_match_reference(capacity):
    ids = np.random.default_rng(5).integers(0, 4, (40,)).astype(np.int32)
    ids[:12] = 0                 # expert 0 overflows all but the largest
    jslot, jkeep = jmoe._dispatch_indices(jnp.asarray(ids), 4, capacity)
    slot, keep = moe._dispatch_indices(torch.from_numpy(ids).long(), 4,
                                       capacity)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    assert bool(keep.all()) == (capacity == 32)


# ------------------------------------------------------------- the layer

MOE_CASES = {
    # name: (gate, top_k, routed_scaling, n_shared, capacity_factor); the
    # softmax case's capacity (8 slots an expert for 30 assignments over
    # 4) drops some
    "softmax_top2_shared": ("softmax", 2, 1.0, 1, 0.5),
    "sigmoid_top3_scaled": ("sigmoid", 3, 2.5, 0, 1.25),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_reference(case):
    gate, k, scaling, n_shared, factor = MOE_CASES[case]
    p = jmoe.moe_init(jax.random.PRNGKey(7), 16, 32, 4, quantize=False,
                      n_shared=n_shared)
    p["router"]["bias_correction"] = jnp.asarray(
        np.random.default_rng(8).normal(size=(4,)).astype(np.float32) * 0.05)
    x = np.random.default_rng(9).normal(size=(3, 5, 16)).astype(np.float32)
    kw = dict(top_k=k, gate=gate, capacity_factor=factor,
              routed_scaling=scaling)
    want, jaux = jmoe.moe_apply(p, 0, jnp.asarray(x), JFP32, **kw)
    got, aux = moe.moe_ffn(_t(p), 0, torch.from_numpy(x), FP32_CTX, **kw)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **ROUTE_TOL)
    if case == "softmax_top2_shared":
        ids, _, _ = moe.route(torch.from_numpy(x).reshape(-1, 16)
                              @ _t(p)["router"]["w"], None, top_k=2,
                              gate="softmax")
        _, keep = moe._dispatch_indices(ids.reshape(-1), 4, 8)
        assert not keep.all()


def test_moe_ffn_refuses_a_mesh():
    p = moe.moe_init(torch.Generator().manual_seed(0), 8, 16, 2, False)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        moe.moe_ffn(p, 0, torch.zeros((2, 8)), FP32_CTX, mesh=object(),
                    top_k=1)


# ------------------------------------- the port's mirrors of test_moe.py

def _dense_ref(p, x, k, gate="softmax", scaling=1.0):
    """Per token, each chosen expert's SwiGLU decoded on its own."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    ids, w, _ = moe.route(xt @ p["router"]["w"], p["router"]["bias_correction"],
                          top_k=k, gate=gate, routed_scaling=scaling)
    banks = {n: materialize(p["experts"][n], 0, FP32_CTX)
             for n in ("gate", "up", "down")}
    out = torch.zeros_like(xt)
    for i in range(xt.shape[0]):
        for j in range(k):
            e = int(ids[i, j])
            h = F.silu(xt[i] @ banks["gate"][e]) * (xt[i] @ banks["up"][e])
            out[i] += w[i, j] * (h @ banks["down"][e])
    if "shared" in p:
        out = out + swiglu(p["shared"], 0, xt, FP32_CTX)
    return out.reshape(x.shape)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_moe_matches_dense_reference():
    p = moe.moe_init(_gen(0), 16, 32, 4, quantize=False, n_shared=1)
    x = torch.randn((3, 5, 16), generator=_gen(1))
    y, _ = moe.moe_apply(p, 0, x, FP32_CTX, top_k=2, capacity_factor=8.0)
    np.testing.assert_allclose(y.numpy(), _dense_ref(p, x, 2).numpy(),
                               atol=1e-4)


def test_sigmoid_gate_matches_dense_reference():
    p = moe.moe_init(_gen(2), 16, 32, 8, quantize=False)
    x = torch.randn((2, 4, 16), generator=_gen(3))
    y, _ = moe.moe_apply(p, 0, x, FP32_CTX, top_k=3, gate="sigmoid",
                         routed_scaling=2.5, capacity_factor=8.0)
    np.testing.assert_allclose(
        y.numpy(), _dense_ref(p, x, 3, "sigmoid", 2.5).numpy(), atol=1e-4)


def test_capacity_drops_earliest_win():
    """With capacity 8 (the floor), surplus assignments to one expert are
    dropped; earlier tokens keep their slots (position-drop policy)."""
    d, e = 4, 2
    p = moe.moe_init(_gen(4), d, 8, e, quantize=False)
    p["router"]["w"] = torch.zeros((d, e))
    p["router"]["w"][:, 0] = 100.0        # every token to expert 0
    x = torch.ones((1, 24, d))
    y, _ = moe.moe_apply(p, 0, x, FP32_CTX, top_k=1, capacity_factor=0.33)
    out_norm = torch.linalg.norm(y[0], dim=-1)
    assert float(out_norm[0]) > 0            # first token routed
    assert float(out_norm[7]) > 0            # the eighth keeps the last slot
    assert float(out_norm[8]) == 0 and float(out_norm[-1]) == 0   # dropped


# ------------------------------------------------------------ launchers

def test_serve_launcher_serves_grok_on_the_cpu(capsys):
    from repro_torch.launch import serve
    gen = serve.main(["--arch", "grok-1-314b", "--smoke", "--layers", "1",
                      "--device", "cpu", "--batch", "2", "--prompt-len", "5",
                      "--max-new", "3"])
    out = capsys.readouterr().out
    assert "depth cut to 1 layers" in out and "4 experts top-2" in out
    assert gen.shape == (2, 3) and "grok-1-314b" in serve.lm_archs()
    assert "deepseek-v3-671b" in serve.lm_archs()


def test_serve_launcher_serves_deepseek_with_mla_on_the_cpu(capsys):
    """deepseek-v3 smoke (MLA, a dense layer then MoE with the sigmoid
    gate and a shared expert) through the launcher, and a share of it
    handed to ``serve_lm_config`` by a caller: both serve greedy ids of
    the vocabulary."""
    import dataclasses
    from repro_torch.launch import serve
    argv = ["--arch", "deepseek-v3-671b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "5", "--max-new", "3"]
    gen = serve.main(argv)
    out = capsys.readouterr().out
    assert "MLA (kv_lora 16)" in out and "4 experts top-2" in out
    assert gen.shape == (2, 3) and ((gen >= 0) & (gen < 256)).all()
    args = serve.parse_args(argv)
    share = dataclasses.replace(serve.lm_config(args), experts_held=(0, 2))
    gen = serve.serve_lm_config(share, args)
    assert "(experts 0-1 held)" in capsys.readouterr().out
    assert gen.shape == (2, 3)


def test_launchers_refuse_what_is_not_ported():
    from repro_torch.launch import serve, train
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        serve.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--engine: LMProgram serves "
                       "dense-family archs only"):
        serve.main(["--arch", "grok-1-314b", "--smoke", "--engine",
                    "--device", "cpu", "--batch", "1", "--max-new", "2"])
    with pytest.raises(SystemExit, match="--layers applies to LM archs"):
        serve.main(["--arch", "mlp-hr", "--layers", "1", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match=r"MLA.*queue 1 item 8\.2"):
        train.main(["--arch", "deepseek-v3-671b", "--smoke", "--device",
                    "cpu"])


def test_serve_layers_only_cuts_the_depth():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="--layers 3: grok-1-314b-smoke "
                       "has 2 layers; the flag only cuts"):
        serve.main(["--arch", "grok-1-314b", "--smoke", "--layers", "3",
                    "--device", "cpu"])
