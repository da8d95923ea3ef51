"""GPipe over a 'pipe' axis (``repro_torch.runtime.pipeline_parallel``)
on a gloo world of 4 CPU ranks, against the JAX package.

The reference test's stack (``tests/test_pipeline_parallel.py``: L
layers of ``x = tanh(x @ w)``, d 16, batch 16) runs through
``pipeline_apply`` over ``Mesh((4,), ("pipe",))`` at 4, 8 and 16
micro-batches.  Every rank's output is held to the JAX package's
sequential stack within ``atol=1e-5`` (the reference test's gate), and
the gradients of ``Σ out·w`` (each rank's backward seeded 1 / world)
to ``jax.grad`` of the sequential stack within 1e-5: each rank's stage
block of the weights, and the input's gradient summed over the ranks.
``stage_split`` and ``bubble_fraction`` against the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import pipeline_parallel as jpp
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import ranks
from repro_torch.runtime import pipeline_parallel as pp

L, D, B = 8, 16, 16


@pytest.fixture(scope="module")
def world():
    with tmesh.RankPool(4, device="cpu", timeout=300) as pool:
        yield pool


@pytest.mark.parametrize("s,m", [(4, 4), (1, 8), (4, 8), (2, 3), (8, 1)])
def test_bubble_fraction_matches_reference(s, m):
    assert pp.bubble_fraction(s, m) == jpp.bubble_fraction(s, m)
    assert pp.bubble_fraction(4, 4) == 3 / 7


def test_stage_split_matches_reference():
    w = np.arange(L * 3 * 2, dtype=np.float32).reshape(L, 3, 2)
    tree = {"w": w, "b": np.arange(L, dtype=np.float32)}
    want = jpp.stage_split(jax.tree_util.tree_map(jnp.asarray, tree), 4)
    got = pp.stage_split({k: torch.from_numpy(v) for k, v in tree.items()},
                         4)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="do not split"):
        pp.stage_split({"w": torch.zeros(6, 2)}, 4)


def _jax_stack(ws, x):
    def body(h, w):
        return jnp.tanh(h @ w), None
    return jax.lax.scan(body, x, ws)[0]


def test_pipeline_matches_the_sequential_stack(world):
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(L, D, D)) * D ** -0.5).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    r = rng.normal(size=(B, D)).astype(np.float32)
    want = np.asarray(_jax_stack(jnp.asarray(ws), jnp.asarray(x)))
    gw, gx = jax.grad(lambda w, h: jnp.sum(_jax_stack(w, h) * r),
                      argnums=(0, 1))(jnp.asarray(ws), jnp.asarray(x))
    micro = (4, 8, 16)
    res = world.run(ranks.pp_apply, ws, x, r, n_micro=micro)
    for i, m in enumerate(micro):
        for rank, rr in enumerate(res):
            got = rr[i]
            assert got["ticks"] == m + 3
            assert got["bubble"] == jpp.bubble_fraction(4, m)
            np.testing.assert_allclose(got["y"], want, atol=1e-5, rtol=0,
                                       err_msg=f"n_micro {m} rank {rank}")
            np.testing.assert_allclose(
                got["stage_grad"], np.asarray(gw)[rank * 2:rank * 2 + 2],
                atol=1e-5, rtol=0, err_msg=f"n_micro {m} stage {rank}")
            np.testing.assert_allclose(got["x_grad"], np.asarray(gx),
                                       atol=1e-5, rtol=0)


def test_pipeline_refuses_a_batch_that_does_not_split():
    mesh = tmesh.Mesh((1,), ("pipe",), device="cpu")
    ws = torch.zeros(2, 1, 4, 4)
    with pytest.raises(ValueError, match="micro-batches"):
        pp.pipeline_apply(ranks._tanh_stack, ws, torch.zeros(5, 4),
                          mesh=mesh, n_micro=2)
    with pytest.raises(ValueError, match="stages"):
        pp.pipeline_apply(ranks._tanh_stack, ws, torch.zeros(4, 4),
                          mesh=mesh, n_micro=2)


def test_one_stage_is_the_stack():
    mesh = tmesh.Mesh((1,), ("pipe",), device="cpu")
    g = torch.Generator().manual_seed(1)
    ws = torch.randn(L, D, D, generator=g) * D ** -0.5
    x = torch.randn(B, D, generator=g)
    out = pp.pipeline_apply(ranks._tanh_stack, pp.stage_split(ws, 1), x,
                            mesh=mesh, n_micro=4)
    want = torch.cat([ranks._tanh_stack(ws, c) for c in x.chunk(4)])
    assert torch.equal(out, want)
