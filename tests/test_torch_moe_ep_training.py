"""Expert-parallel and expert-TP training (``repro_torch.nn.moe``
``moe_apply_ep`` / ``moe_apply_tp`` / ``moe_ffn`` under grad) on a gloo
world of 4 CPU ranks, against the JAX package's single-device layer.

grok-1-314b's smoke widths (d 64, d_ff 128, top-2): 4 experts for expert
parallelism on meshes (1, 4) and (2, 2), whole banks and each rank's
share of them (``experts_held``); 2 experts for expert TP, which the
dispatcher picks on (1, 4) and which is called by name on (2, 2).  Also
deepseek's gate (sigmoid, routed scaling 2.5, a shared expert).  At
capacity factor E / k nothing drops.  The objective is ``Σ y·r + 0.01 ·
aux`` over the whole batch on every rank (each rank's backward seeded
with 1 / world, every gradient summed over the ranks that hold it).  Its
value and its gradients (router, banks, shared expert, tokens) are held
within 1e-5 to ``jax.grad`` of the same objective on one device, built on
the JAX package's ``moe_apply`` and ``route`` (the aux: the mean of
``route``'s over the token blocks the ranks route, as the reference's
``local_moe`` pmeans it), and to the port's own single-device layer under
autograd.  A checkpointed layer (its exchanges run again in the
backward) gives the same gradients bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.nn import moe as jmoe
from repro.nn.module import FP32_CTX as JFP32
from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import ranks

TOL = dict(atol=1e-5, rtol=1e-5)
COEF = 0.01
N = 24


@pytest.fixture(scope="module")
def world():
    with tmesh.RankPool(4, device="cpu", timeout=300) as pool:
        yield pool


def _layer(e, shared, seed):
    cfg = get_config("grok-1-314b").smoke()
    p = jmoe.moe_init(jax.random.PRNGKey(seed), cfg.d_model, cfg.d_ff, e,
                      False, n_shared=1 if shared else 0,
                      shared_ff=cfg.d_ff // 2)
    return cfg, jax.tree_util.tree_map(np.asarray, p)


def _jax_grads(p, x, r, blocks, k, gate, scaling):
    """The objective and its gradients (params, tokens) on one device."""
    e = p["router"]["w"].shape[1]

    def obj(p, x):
        y, _ = jmoe.moe_apply(p, 0, x, JFP32, top_k=k, gate=gate,
                              capacity_factor=e / k, routed_scaling=scaling)
        pad = (-x.shape[0]) % blocks
        xp = jnp.concatenate([x, jnp.zeros((pad, x.shape[1]))])
        aux = sum(jmoe.route(b @ p["router"]["w"],
                             p["router"]["bias_correction"], top_k=k,
                             gate=gate, routed_scaling=scaling)[2]
                  for b in jnp.split(xp, blocks)) / blocks
        return jnp.sum(y * r) + COEF * aux
    val, (gp, gx) = jax.value_and_grad(obj, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    return float(val), np.asarray(gx), jax.tree_util.tree_map(np.asarray,
                                                              gp)


def _port_grads(p, x, r, blocks, k, gate, scaling):
    """The same objective through the port's single-device layer."""
    e = p["router"]["w"].shape[1]
    return ranks.moe_single_grads(p, x, r, blocks=blocks, top_k=k,
                                  gate=gate, capacity_factor=e / k,
                                  routed_scaling=scaling, coef=COEF,
                                  device="cpu")


def _check(res, want, label):
    val, gx, gp = want
    flat = dict(ranks.named_leaves(gp))
    for rank, rr in enumerate(res):
        tag = f"{label} rank {rank}"
        np.testing.assert_allclose(rr["obj"], val, **TOL, err_msg=tag)
        np.testing.assert_allclose(rr["grads"]["x"], gx, **TOL, err_msg=tag)
        got = dict(ranks.named_leaves(rr["grads"]["p"]))
        assert sorted(got) == sorted(flat)
        for name, g in got.items():
            ref = flat[name]
            if rr["experts_held"] is not None and name.startswith(
                    "/experts/"):
                first, count = rr["experts_held"]
                ref = ref[first:first + count]
            np.testing.assert_allclose(g, ref, **TOL,
                                       err_msg=f"{tag} {name}")
        assert rr["remat_bitwise"], tag


EP_CASES = [("softmax", 1.0, False), ("sigmoid", 2.5, True)]


@pytest.mark.parametrize("share", [False, True], ids=["whole", "shares"])
@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
@pytest.mark.parametrize("gate,scaling,shared", EP_CASES)
def test_ep_gradients_match_single_device(world, gate, scaling, shared,
                                          mesh, share):
    e = 4
    cfg, p = _layer(e, shared, seed=7)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(N, cfg.d_model)).astype(np.float32)
    r = rng.normal(size=(N, cfg.d_model)).astype(np.float32)
    k = cfg.top_k
    res = world.run(ranks.ep_train, p, x, r, mesh, path="ep", top_k=k,
                    gate=gate, capacity_factor=e / k,
                    routed_scaling=scaling, coef=COEF, share=share)
    args = (p, x, r, 4, k, gate, scaling)
    _check(res, _jax_grads(*args), f"EP {mesh} vs jax.grad")
    _check(res, _port_grads(*args), f"EP {mesh} vs the port's layer")
    assert all(rr["path"] == "ep" for rr in res)


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_tp_gradients_match_single_device(world, mesh):
    cfg, p = _layer(2, False, seed=8)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(20, cfg.d_model)).astype(np.float32)
    r = rng.normal(size=(20, cfg.d_model)).astype(np.float32)
    k = cfg.top_k
    # on (1, 4) the dispatcher picks TP (2 experts, 128 % 4 == 0); on
    # (2, 2) it would pick EP, so TP is called by name
    res = world.run(ranks.ep_train, p, x, r, mesh,
                    path="ffn" if mesh == (1, 4) else "tp", top_k=k,
                    capacity_factor=2 / k, coef=COEF)
    args = (p, x, r, mesh[0], k, "softmax", 1.0)
    _check(res, _jax_grads(*args), f"TP {mesh} vs jax.grad")
    _check(res, _port_grads(*args), f"TP {mesh} vs the port's layer")
    assert all(rr["path"] == ("tp" if mesh == (1, 4) else "ep")
               for rr in res)
