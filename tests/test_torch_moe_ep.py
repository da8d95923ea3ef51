"""The MoE layer's exchanges over a mesh (``repro_torch.nn.moe``
``moe_apply_ep``, ``moe_apply_tp``, ``moe_ffn``) on a gloo world of 4 CPU
ranks, against the JAX package's single-device ``moe_apply``.

One world is spawned for the module (``launch.mesh.RankPool``); the
meshes (1, 4) and (2, 2) are process groups of it.  The same numpy inputs
and the JAX package's ``moe_init`` trees go to both packages.  At capacity
factor E / k no assignment drops, so the exchange computes the
single-device layer: its output within ``atol=rtol=1e-5`` of the
reference's ``moe_apply`` (the expert products sum in other batches), its
aux within 1e-6 of the mean of the reference's ``route`` aux over the
ranks' token blocks (the ``pmean`` of the reference's ``local_moe``).
``moe_ffn``'s choice is held to the reference's dispatcher, and
``generate(mesh=)`` gives ``generate()``'s tokens on grok's smoke config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as jmoe
from repro.nn.module import FP32_CTX as JFP32
from repro_torch.configs import get_config
from repro_torch.convert import tree_to_numpy
from repro_torch.core import qat
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import ranks
from repro_torch.models import lm as LM
from repro_torch.nn import moe
from repro_torch.nn import transformer as T
from repro_torch.nn.module import FP32_CTX

TOL = dict(atol=1e-5, rtol=1e-5)
AUX_TOL = dict(atol=1e-6, rtol=1e-6)
D, FF = 16, 32


@pytest.fixture(scope="module")
def world():
    with tmesh.RankPool(4, device="cpu", timeout=300) as pool:
        yield pool


def _layer(e, gate, shared, seed=0):
    p = jmoe.moe_init(jax.random.PRNGKey(seed), D, FF, e, False,
                      n_shared=1 if shared else 0, shared_ff=FF // 2)
    return jax.tree_util.tree_map(np.asarray, p)


def _aux_of_blocks(p, x, blocks, k, gate, scaling):
    """The mean of the reference's ``route`` aux over token blocks."""
    n = -(-x.shape[0] // blocks) * blocks
    xp = np.concatenate([x, np.zeros((n - x.shape[0], D), np.float32)])
    auxs = [float(jmoe.route(jnp.asarray(b) @ p["router"]["w"],
                             jnp.asarray(p["router"]["bias_correction"]),
                             top_k=k, gate=gate, routed_scaling=scaling)[2])
            for b in np.split(xp, blocks)]
    return np.mean(auxs)


EP_CASES = [("softmax", 2, 1.0, False, 24), ("sigmoid", 2, 2.5, True, 24),
            ("softmax", 2, 1.0, False, 22)]


@pytest.mark.parametrize("share", [False, True], ids=["whole", "shares"])
@pytest.mark.parametrize("gate,k,scaling,shared,n", EP_CASES)
def test_ep_matches_single_device_moe_apply(world, gate, k, scaling, shared,
                                            n, share):
    e = 8
    p = _layer(e, gate, shared)
    x = np.random.default_rng(n).normal(size=(n, D)).astype(np.float32)
    want, _ = jmoe.moe_apply(p, 0, jnp.asarray(x), JFP32, top_k=k, gate=gate,
                             capacity_factor=e / k, routed_scaling=scaling)
    meshes = [(1, 4), (2, 2)] if n % 4 == 0 else [(1, 4)]
    for mesh in meshes:
        out = world.run(ranks.moe_layer, p, x, mesh, path="ep", top_k=k,
                        gate=gate, capacity_factor=e / k,
                        routed_scaling=scaling, share=share)
        aux = _aux_of_blocks(p, x, 4, k, gate, scaling)
        for rank, r in enumerate(out):
            np.testing.assert_allclose(r["y"], np.asarray(want), **TOL,
                                       err_msg=f"{mesh} rank {rank}")
            np.testing.assert_allclose(r["aux"], aux, **AUX_TOL)
            assert r["path"] == "ep"


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
@pytest.mark.parametrize("gate,k", [("softmax", 1), ("sigmoid", 2)])
def test_tp_matches_single_device_moe_apply(world, gate, k, mesh):
    e = 2
    p = _layer(e, gate, shared=gate == "sigmoid", seed=1)
    x = np.random.default_rng(5).normal(size=(20, D)).astype(np.float32)
    want, _ = jmoe.moe_apply(p, 0, jnp.asarray(x), JFP32, top_k=k, gate=gate,
                             capacity_factor=e / k)
    # on (1, 4) the dispatcher picks TP (2 experts, 32 % 4 == 0); on
    # (2, 2) it would pick EP (2 % 2 == 0), so TP is called by name
    out = world.run(ranks.moe_layer, p, x, mesh,
                    path="ffn" if mesh[1] == 4 else "tp", top_k=k,
                    gate=gate, capacity_factor=e / k)
    aux = _aux_of_blocks(p, x, mesh[0], k, gate, 1.0)
    for rank, r in enumerate(out):
        assert r["path"] == ("tp" if mesh[1] == 4 else "ep")
        np.testing.assert_allclose(r["y"], np.asarray(want), **TOL,
                                   err_msg=f"{mesh} rank {rank}")
        np.testing.assert_allclose(r["aux"], aux, **AUX_TOL)


class _Mesh:
    """What the reference's dispatcher reads of a mesh."""

    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))
        self.devices = np.zeros(shape)


@pytest.mark.parametrize("use_ep", [True, False])
@pytest.mark.parametrize("mesh", [None, (1, 1), (1, 4), (2, 2), (4, 1),
                                  (1, 16)])
@pytest.mark.parametrize("e,ff", [(8, 32), (2, 32), (2, 6), (16, 6)])
def test_moe_ffn_choice_matches_reference(monkeypatch, e, ff, mesh, use_ep):
    for name in ("moe_apply_ep", "moe_apply_tp", "moe_apply"):
        monkeypatch.setattr(jmoe, name,
                            lambda *a, _n=name, **kw: _n)
    p = {"router": {"w": np.zeros((D, e), np.float32)},
         "experts": {"gate": {"packed": np.zeros((e, D // 2, ff), np.uint8)}}}
    want = jmoe.moe_ffn(p, 0, None, JFP32, mesh=None if mesh is None
                        else _Mesh(mesh), top_k=1, use_ep=use_ep)
    got = moe.moe_path(p, None if mesh is None
                       else tmesh.MeshSpec(mesh, tmesh.AXES), use_ep)
    assert {"ep": "moe_apply_ep", "tp": "moe_apply_tp",
            "local": "moe_apply"}[got] == want


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
@pytest.mark.parametrize("experts", [4, 2], ids=["e4", "e2"])
def test_generate_over_a_mesh_gives_generates_tokens(world, experts, mesh):
    base = get_config("grok-1-314b").smoke()
    cfg = dataclasses.replace(base, n_experts=experts,
                              capacity_factor=experts / base.top_k)
    params = T.lm_init(cfg, seed=3, device="cpu")
    frozen = qat.freeze_tree(params, qat.build_qstate(params), cfg.lam)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, (4, 6))
    want = LM.generate(frozen, 0, torch.from_numpy(prompt), FP32_CTX, cfg,
                       max_new=5).numpy()
    out = world.run(ranks.lm_generate, cfg, tree_to_numpy(frozen), prompt, 5,
                    mesh)
    for rank, r in enumerate(out):
        np.testing.assert_array_equal(r["tokens"], want,
                                      err_msg=f"{mesh} rank {rank}")
