"""The port's grouped ECL quantization vs the JAX package, on the CPU.

One call of ``kernels.ecl_quant.ecl_quant_many`` takes every MLP-GSC
layer shape, the odd shapes (37, 129) and (1, 5) and a batched
(3, 37, 129) tensor with ω (3, 4), as the trainer's grouped launch does.
On the CPU each segment takes the plain version, which must equal the
JAX package's ``ops.ecl_quant`` (the Pallas body run with
``interpret=True``) bit for bit, segment by segment.  The trainer's
grouped callers (``mlp_apply``, ``qat.update_qstate``, ``qat.stats``,
``freeze_mlp``, ``fake_quant_many``) must equal the per-tensor path bit
for bit: the same function of each element, only fewer calls.
Tolerances: none, every comparison here is exact.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs.paper_mlps import MLPConfig
from repro_torch.core import bitplanes, ecl, qat
from repro_torch.kernels import ecl_quant as eq
from repro_torch.kernels import ops
from repro_torch.models import mlp
from repro_torch.nn.module import QuantCtx

GSC_SHAPES = [(512, 512), (512, 256), (256, 256), (256, 128), (128, 128),
              (128, 12)]
ODD_SHAPES = [(37, 129), (1, 5)]
BATCHED = (3, 37, 129)
TINY = MLPConfig("tiny", (32, 16, 10), d_in=24)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(shape, lam, seed):
    """He-scaled w, its init ω, seeded Dirichlet probs and the penalty; ω
    and probs batched over w's leading dims."""
    rng = np.random.default_rng(seed)
    lead = shape[:-2]
    w = _t((rng.normal(size=shape) * np.sqrt(2.0 / shape[-2]))
           .astype(np.float32))
    omega = bitplanes.init_omega_from_weights(w)
    if not lead:
        omega = omega.reshape(4)
    probs = _t(rng.dirichlet(np.ones(16), size=lead or None)
               .astype(np.float32))
    return w, omega, ecl.penalty(w, probs, lam)


def _group(lam):
    shapes = GSC_SHAPES + ODD_SHAPES + [BATCHED]
    return [_case(s, lam, 40 + i) for i, s in enumerate(shapes)]


def _pallas(w, omega, pen):
    c, v = jops.ecl_quant(jnp.asarray(w.numpy()), jnp.asarray(omega.numpy()),
                          jnp.asarray(pen.numpy()), use_kernel=True,
                          interpret=True)
    return np.asarray(c), np.asarray(v)


@pytest.mark.parametrize("lam", [0.0, 0.3])
def test_ecl_quant_many_matches_pallas_per_segment(lam):
    """Codes and ŵ of every segment exact against the Pallas body."""
    group = _group(lam)
    outs = eq.ecl_quant_many(*zip(*group))
    assert len(outs) == len(group)
    for (w, omega, pen), (codes, w_hat) in zip(group, outs):
        assert codes.shape == w.shape and codes.dtype == torch.uint8
        assert w_hat.shape == w.shape and w_hat.dtype == torch.float32
        segs = ([(w, omega, pen, codes, w_hat)] if omega.ndim == 1 else
                zip(w, omega, pen, codes, w_hat))
        for ws, om, pn, c, v in segs:
            want_c, want_w = _pallas(ws, om, pn)
            np.testing.assert_array_equal(c.numpy(), want_c)
            np.testing.assert_array_equal(v.numpy(), want_w)


def test_ops_ecl_quant_many_reshapes_per_segment():
    """1-D and N-D w with an unbatched ω reshape as ``ops.ecl_quant``; a
    (2, 3, R, C) w with ω (2, 3, 4) runs each leading index; all exact
    against the Pallas body."""
    rng = np.random.default_rng(8)
    flat = _case((1, 7), 0.3, 1)
    w3 = _t(rng.normal(size=(3, 4, 5)).astype(np.float32) * 0.1)
    nd = (w3, bitplanes.init_omega_from_weights(w3.reshape(3, 20)),
          ecl.penalty(w3, _t(rng.dirichlet(np.ones(16)).astype(np.float32)),
                      0.3))
    w4 = _t(rng.normal(size=(2, 3, 6, 5)).astype(np.float32) * 0.1)
    om4 = bitplanes.init_omega_from_weights(w4)
    pen4 = ecl.penalty(w4, _t(rng.dirichlet(np.ones(16), size=(2, 3))
                               .astype(np.float32)), 0.3)
    ws = [flat[0].reshape(7), nd[0], w4]
    outs = ops.ecl_quant_many(ws, [flat[1], nd[1], om4],
                              [flat[2], nd[2], pen4])
    for w, om, pn, (c, v) in zip(ws[:2], (flat[1], nd[1]), (flat[2], nd[2]),
                                 outs[:2]):
        want_c, want_w = _pallas(w, om, pn)
        assert tuple(c.shape) == tuple(w.shape)
        np.testing.assert_array_equal(c.numpy(), want_c)
        np.testing.assert_array_equal(v.numpy(), want_w)
    c4, v4 = outs[2]
    assert tuple(c4.shape) == (2, 3, 6, 5)
    for i in range(2):
        for j in range(3):
            want_c, want_w = _pallas(w4[i, j], om4[i, j], pen4[i, j])
            np.testing.assert_array_equal(c4[i, j].numpy(), want_c)
            np.testing.assert_array_equal(v4[i, j].numpy(), want_w)


def test_ecl_quant_many_rejects_bad_groups():
    w, omega, pen = _case((4, 4), 0.3, 3)
    wb, ob, pb = _case((2, 4, 4), 0.3, 4)
    assert eq.ecl_quant_many([], [], []) == []
    with pytest.raises(ValueError):
        eq.ecl_quant_many([w, w], [omega], [pen])
    with pytest.raises(ValueError):                 # batched ω, wrong lead
        eq.ecl_quant_many([wb], [ob[:1]], [pb[:1]])
    with pytest.raises(ValueError):                 # 3-D w, unbatched ω
        eq.ecl_quant_many([wb], [omega], [pen])
    with pytest.raises(ValueError):                 # CPU and meta together
        eq.ecl_quant_many([w, torch.empty((4, 4), device="meta")],
                          [omega, omega], [pen, pen])
    with pytest.raises(ValueError):                 # the kernel needs CUDA
        eq.ecl_quant_cuda(w, omega, pen)


class _RecordingLib:
    """Stands in for the kernel library: records each launch's segment
    rows (w, omega, penalty, codes, w_hat, n) as the C entry reads them."""

    def __init__(self):
        self.launches = []

    def f4_ecl_quant_many(self, table, count, stream):
        rows = (ctypes.c_longlong * (6 * count)).from_address(table)
        self.launches.append([tuple(rows[6 * r:6 * r + 6])
                              for r in range(count)])
        return 0


def _odd_view(shape, seed):
    w, omega, pen = _case(shape, 0.3, seed)
    flat = torch.cat([torch.zeros(1), w.reshape(-1)])
    return flat[1:].view(shape), omega, pen


@pytest.mark.parametrize("group", ["gsc", "odd", "past_cap"])
def test_segment_table_meets_the_kernel_alignment(monkeypatch, group):
    """The host side of the grouped launch, with a recording library: one
    row a segment (a batched tensor's lead slices at their offsets), at
    most MAX_SEGMENTS rows a launch, and every row aligned as the C entry
    demands (w 4-byte, ŵ at w's offset within 16 bytes, codes at w's
    element offset within 4), a view at an odd offset copied first."""
    lib = _RecordingLib()
    monkeypatch.setattr(eq.build, "load", lambda: lib)
    monkeypatch.setattr(eq.build, "stream_handle", lambda dev: 0)
    if group == "gsc":
        cases = [_case(s, 0.3, 60 + i) for i, s in enumerate(GSC_SHAPES)]
    elif group == "odd":
        small = _case((1, 5), 0.3, 72)
        cases = [_case(BATCHED, 0.3, 70), _odd_view((37, 129), 71), small,
                 (torch.zeros(0, 4), *small[1:])]
        assert cases[1][0].data_ptr() % 16 == 4
    else:
        cases = [_case((i % 7 + 1, 17 + i), 0.3, 80 + i)
                 for i in range(eq.MAX_SEGMENTS + 8)]
    ws, omegas, pens = (list(c) for c in zip(*cases))
    before = eq.LAUNCHES
    outs = eq._launch_group(ws, omegas, pens)
    want = []
    for w, omega, (codes, w_hat) in zip(ws, omegas, outs):
        assert codes.shape == w.shape and w_hat.shape == w.shape
        segs = int(np.prod(w.shape[:-2])) if omega.ndim > 1 else 1
        n = w.shape[-2] * w.shape[-1]
        want += [(codes.data_ptr() + n * i, w_hat.data_ptr() + 4 * n * i, n)
                 for i in range(segs) if n]
    assert eq.LAUNCHES - before == len(lib.launches)
    assert [len(rows) for rows in lib.launches] == [
        min(eq.MAX_SEGMENTS, len(want) - k)
        for k in range(0, len(want), eq.MAX_SEGMENTS)]
    rows = [r for rows in lib.launches for r in rows]
    assert [(r[3], r[4], r[5]) for r in rows] == want
    for wp, _, _, cp, hp, _ in rows:
        assert wp % 4 == 0 and (hp - wp) % 16 == 0
        assert (wp // 4 - cp) % 4 == 0


def _one_by_one(grouped):
    """``grouped`` one tensor a call: the per-leaf path."""
    def f(ws, omegas, pens):
        return [grouped([w], [o], [p])[0] for w, o, p in zip(ws, omegas, pens)]
    return f


def _count_groups(monkeypatch):
    sizes = []
    grouped = ops.ecl_quant_many

    def counted(ws, omegas, pens):
        sizes.append(len(ws))
        return grouped(ws, omegas, pens)
    monkeypatch.setattr(ops, "ecl_quant_many", counted)
    return sizes


def _tiny(seed=0):
    params, bn = mlp.mlp_init(TINY, seed=seed, device="cpu")
    qs = qat.build_qstate(params)
    rng = np.random.default_rng(seed)
    for q in qs["layers"]:
        q["kernel"]["probs"] = _t(rng.dirichlet(np.ones(16))
                                  .astype(np.float32))
    return params, qs, bn


def _grads_of(params, qs, bn, x, train):
    leaves = [p for layer in params["layers"] for p in
              (layer["kernel"]["w"], layer["kernel"]["omega"])]
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    logits, new_bn = mlp.mlp_apply(params, qs, bn, x,
                                   QuantCtx(quant=True, lam=0.3),
                                   train=train)
    logits.square().sum().backward()
    return logits.detach(), new_bn, [p.grad.clone() for p in leaves]


@pytest.mark.parametrize("train", [True, False])
def test_grouped_mlp_apply_equals_per_leaf(monkeypatch, train):
    """Logits, BatchNorm state and every w / ω gradient bitwise equal; the
    grouped forward makes one call over all three layers."""
    params, qs, bn = _tiny()
    x = _t(np.random.default_rng(1).normal(size=(16, 24)).astype(np.float32))
    sizes = _count_groups(monkeypatch)
    got = _grads_of(params, qs, bn, x, train)
    assert sizes == [3]
    monkeypatch.setattr(ecl, "quantize_many", _one_by_one(ecl.quantize_many))
    want = _grads_of(params, qs, bn, x, train)
    assert sizes == [3, 1, 1, 1]
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[2], want[2]):
        assert torch.equal(g, w)
    for g, w in zip(got[1]["layers"], want[1]["layers"]):
        assert g.keys() == w.keys()
        for k in g:
            assert torch.equal(g[k], w[k])


def _batched_tree(seed=5):
    """A tree with a batched-ω leaf (3, 8, 6) beside two plain ones."""
    rng = np.random.default_rng(seed)
    params = {"b": qat.make_quant_param(
                  _t(rng.normal(size=(3, 8, 6)).astype(np.float32) * 0.2)),
              "a": [qat.make_quant_param(
                  _t(rng.normal(size=(5, 7)).astype(np.float32) * 0.2)),
                  {"bias": torch.zeros(7),
                   "k": qat.make_quant_param(
                       _t(rng.normal(size=(7, 2)).astype(np.float32)))}]}
    qs = qat.build_qstate(params)
    qs["b"]["probs"] = _t(rng.dirichlet(np.ones(16), size=3)
                          .astype(np.float32))
    qs["a"][0]["probs"] = _t(rng.dirichlet(np.ones(16)).astype(np.float32))
    return params, qs


def test_grouped_update_qstate_and_stats_equal_per_leaf(monkeypatch):
    """Every probs leaf and both statistics bitwise equal, the tree's
    structure unchanged; each grouped call is one call over all leaves."""
    params, qs = _batched_tree()
    sizes = _count_groups(monkeypatch)
    got_q = qat.update_qstate(params, qs, 0.3)
    got_st = qat.stats(params, got_q, 0.3)
    assert sizes == [3, 3]
    monkeypatch.setattr(ecl, "quantize_many", _one_by_one(ecl.quantize_many))
    want_q = qat.update_qstate(params, qs, 0.3)
    want_st = qat.stats(params, want_q, 0.3)
    assert list(got_q) == list(want_q) == ["b", "a"]
    assert torch.equal(got_q["b"]["probs"], want_q["b"]["probs"])
    assert torch.equal(got_q["a"][0]["probs"], want_q["a"][0]["probs"])
    assert torch.equal(got_q["a"][1]["k"]["probs"],
                       want_q["a"][1]["k"]["probs"])
    assert torch.equal(got_q["a"][1]["bias"], qs["a"][1]["bias"])
    n_quant = 3 * 48 + 35 + 14
    assert got_st["quant_params"] == want_st["quant_params"] == n_quant
    for k in ("sparsity", "entropy_bits_per_weight"):
        assert torch.equal(got_st[k], want_st[k])


def test_grouped_freeze_equals_per_leaf(monkeypatch):
    """freeze_mlp assigns every layer in one call; packed codes and the
    folded constants bitwise equal to the per-leaf path."""
    params, qs, bn = _tiny(seed=2)
    sizes = _count_groups(monkeypatch)
    got = mlp.freeze_mlp(params, qs, bn, lam=0.3)
    assert sizes == [3]
    monkeypatch.setattr(ecl, "quantize_many", _one_by_one(ecl.quantize_many))
    want = mlp.freeze_mlp(params, qs, bn, lam=0.3)
    for g, w in zip(got["layers"], want["layers"]):
        for k in ("packed", "omega", "alpha1", "bias", "alpha2"):
            assert torch.equal(g[k], w[k]), k
        assert g["shape"] == w["shape"]


@pytest.mark.parametrize("lam", [0.02, 0.3])
def test_fake_quant_many_equals_fake_quant_per_leaf(lam):
    """Forward and the w and ω gradients of every leaf (one of them
    batched) bitwise equal to ``fake_quant`` leaf by leaf."""
    group = [_case((24, 32), lam, 7), _case((37, 129), lam, 8),
             _case((3, 8, 6), lam, 9)]
    rng = np.random.default_rng(3)
    probs = [_t(rng.dirichlet(np.ones(16), size=w.shape[:-2] or None)
                .astype(np.float32)) for w, _, _ in group]
    cts = [_t(rng.normal(size=w.shape).astype(np.float32))
           for w, _, _ in group]

    def leaves():
        return [(w.clone().requires_grad_(), o.clone().requires_grad_())
                for w, o, _ in group]
    grouped = leaves()
    outs = qat.fake_quant_many([w for w, _ in grouped],
                               [o for _, o in grouped], probs, lam)
    torch.autograd.backward(outs, cts)
    for (w, o), (gw, go), p, ct, out in zip(leaves(), grouped, probs, cts,
                                            outs):
        want = qat.fake_quant(w, o, p, lam)
        want.backward(ct)
        assert torch.equal(out.detach(), want.detach())
        assert torch.equal(gw.grad, w.grad)
        assert torch.equal(go.grad, o.grad)
