"""The adjoints of the mesh's exchanges (``repro_torch.launch.mesh``) on a
gloo world of 4 CPU ranks.

Each rank r holds its own fp64 input x_r, applies one exchange and takes
the gradient of ``Σ_r Σ out_r · w_r`` (each rank seeds 1, so autograd
over the mesh computes the gradient of the sum over the ranks).  The
same composite is written out on one device (the exchange's meaning as
concatenations, sums and permutations of the x_r) and differentiated by
autograd there: outputs and gradients agree within 1e-12.  On meshes
(4, 1) and (2, 2), over 'data', 'model' and both.  A one-rank mesh stays
an identity; ``all_reduce(op="max")`` refuses a tensor under grad.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as tmesh
from repro_torch.launch import ranks

TOL = dict(atol=1e-12, rtol=1e-12)
SHAPE = (4, 3)
AXES = [("data",), ("model",), ("data", "model")]


@pytest.fixture(scope="module")
def world():
    with tmesh.RankPool(4, device="cpu", timeout=300) as pool:
        yield pool


def _inputs(seed, shape=SHAPE, out_shape=None):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=shape) for _ in range(4)]
    rs = [rng.normal(size=out_shape or shape) for _ in range(4)]
    return xs, rs


def _members(mesh, r, axes):
    """The world ranks of rank r's slice along ``axes``, in mesh order."""
    shape = dict(zip(("data", "model"), mesh))
    coord = dict(zip(("data", "model"), divmod(r, mesh[1])))
    out = []
    for dd in (range(shape["data"]) if "data" in axes else [coord["data"]]):
        for mm in (range(shape["model"]) if "model" in axes
                   else [coord["model"]]):
            out.append(dd * mesh[1] + mm)
    return out


def _single(xs, rs, fn):
    """``fn(x list) -> out list`` on one device: outputs and the gradient
    of ``Σ_r Σ out_r·w_r`` for each x_r."""
    x = [torch.from_numpy(a).requires_grad_() for a in xs]
    out = fn(x)
    total = sum(torch.sum(o * torch.from_numpy(w)) for o, w in zip(out, rs))
    grads = torch.autograd.grad(total, x, allow_unused=True)
    return ([o.detach().numpy() for o in out],
            [np.zeros_like(a) if g is None else g.numpy()
             for g, a in zip(grads, xs)])


def _check(got, want_out, want_grad):
    for r, res in enumerate(got):
        assert res["requires_grad"]
        np.testing.assert_allclose(res["out"], want_out[r], **TOL,
                                   err_msg=f"rank {r} output")
        np.testing.assert_allclose(res["grad"], want_grad[r], **TOL,
                                   err_msg=f"rank {r} gradient")


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("axes", AXES, ids="+".join)
@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)])
def test_all_gather_backward_is_a_reduce_scatter(world, mesh, axes, dim):
    n = len(_members(mesh, 0, axes))
    out_shape = tuple(s * n if i == dim else s for i, s in enumerate(SHAPE))
    xs, rs = _inputs(1, out_shape=out_shape)
    want = _single(xs, rs, lambda x: [
        torch.cat([x[m] for m in _members(mesh, r, axes)], dim=dim)
        for r in range(4)])
    _check(world.run(ranks.collective_grads, xs, rs, mesh, "all_gather",
                     axes=axes, dim=dim), *want)


@pytest.mark.parametrize("axes", AXES, ids="+".join)
@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)])
def test_all_to_all_backward_is_the_reverse_exchange(world, mesh, axes):
    xs, rs = _inputs(2, shape=(8, 3))

    def fn(x):
        out = []
        for r in range(4):
            members = _members(mesh, r, axes)
            n, me = len(members), members.index(r)
            out.append(torch.cat([x[m].chunk(n)[me] for m in members]))
        return out
    _check(world.run(ranks.collective_grads, xs, rs, mesh, "all_to_all",
                     axes=axes), *_single(xs, rs, fn))


@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("axes", AXES, ids="+".join)
@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)])
def test_all_reduce_backward_is_an_all_reduce(world, mesh, axes, op):
    xs, rs = _inputs(3)

    def fn(x):
        out = []
        for r in range(4):
            members = _members(mesh, r, axes)
            s = sum(x[m] for m in members)
            out.append(s / len(members) if op == "mean" else s)
        return out
    _check(world.run(ranks.collective_grads, xs, rs, mesh, "all_reduce",
                     axes=axes, op=op), *_single(xs, rs, fn))


PERMS = {"rotate": [(0, 1), (1, 2), (2, 3), (3, 0)],
         "shift": [(0, 1), (1, 2), (2, 3)],          # member 0 gets zeros
         "swap": [(0, 1), (1, 0), (2, 2)]}           # 2 keeps, 3 gets zeros


@pytest.mark.parametrize("perm", list(PERMS))
def test_ppermute_backward_is_the_inverse_permutation(world, perm):
    xs, rs = _inputs(4)
    pairs = PERMS[perm]

    def fn(x):
        out = [torch.zeros_like(x[0]) for _ in range(4)]
        for s, d in pairs:
            out[d] = x[s] * 1.0
        return out
    # a 4-wide axis: the data axis of (4, 1)
    _check(world.run(ranks.collective_grads, xs, rs, (4, 1), "ppermute",
                     axis="data", perm=pairs), *_single(xs, rs, fn))


def test_ppermute_over_a_slice_of_the_mesh(world):
    xs, rs = _inputs(5)

    def fn(x):            # model slices {0, 1}, {2, 3}: a swap in each
        return [x[1] * 1.0, x[0] * 1.0, x[3] * 1.0, x[2] * 1.0]
    _check(world.run(ranks.collective_grads, xs, rs, (2, 2), "ppermute",
                     axis="model", perm=[(0, 1), (1, 0)]),
           *_single(xs, rs, fn))


def test_a_one_rank_mesh_is_an_identity():
    mesh = tmesh.Mesh((1, 1), device="cpu")
    x = torch.randn(4, 3, dtype=torch.float64, requires_grad=True)
    w = torch.randn(4, 3, dtype=torch.float64)
    for out in (mesh.all_gather(x, "model", dim=1),
                mesh.all_to_all(x, ("data", "model")),
                mesh.all_reduce(x, "data"),
                mesh.all_reduce(x, ("data", "model"), op="mean"),
                mesh.ppermute(x, "model", [(0, 0)])):
        assert torch.equal(out, x)
        g, = torch.autograd.grad(torch.sum(out * w), x)
        assert torch.equal(g, w)
    with torch.no_grad():
        assert torch.equal(mesh.all_reduce(x, "data", op="max"), x)


def test_max_has_no_gradient_and_perms_are_checked():
    mesh = tmesh.Mesh((1, 1), device="cpu")
    x = torch.randn(3, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient"):
        mesh.all_reduce(x, "data", op="max")
    with pytest.raises(ValueError, match="sum, mean or max"):
        mesh.all_reduce(x, "data", op="min")
    with pytest.raises(ValueError, match="partial permutation"):
        mesh.ppermute(x, "model", [(0, 1)])
    with pytest.raises(ValueError, match="mesh has no axes"):
        mesh.ppermute(x, "pipe", [(0, 0)])
