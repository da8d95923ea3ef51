"""The port's pack format, ECL assignment and plain oracles vs the JAX
package, on the same numpy inputs.

Tolerances: bit-plane pack/unpack/decode/codebook are exact (the same adds
in the same order); ECL codes are exact; the ``kernels/ref.py`` oracles,
tanh-gelu included, agree to ``atol=1e-5`` (fp32 matmuls sum in another
order in the two frameworks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplanes as jbp
from repro.core import ecl as jecl
from repro.kernels import ref as jref
from repro_torch.core import bitplanes as tbp
from repro_torch.core import ecl as tecl
from repro_torch.core import qat as tqat
from repro_torch.kernels import ref as tref

RNG = np.random.default_rng(0)


def _codes(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 16, size=shape,
                                                dtype=np.uint8)


def _omega(seed=0, lead=()):
    return np.random.default_rng(seed).normal(size=(*lead, 4)).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(8, 5), (2, 6, 3), (64, 48)])
def test_pack_unpack_exact(shape):
    codes = _codes(shape)
    jp = np.asarray(jbp.pack_codes_rows(jnp.asarray(codes)))
    tp = tbp.pack_codes_rows(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(tp, jp)
    back = tbp.unpack_codes_rows(torch.from_numpy(tp)).numpy()
    np.testing.assert_array_equal(back, codes)
    np.testing.assert_array_equal(
        back, np.asarray(jbp.unpack_codes_rows(jnp.asarray(jp))))


def test_pack_rejects_odd_k():
    with pytest.raises(ValueError):
        tbp.pack_codes_rows(torch.zeros((3, 4), dtype=torch.uint8))


@pytest.mark.parametrize("lead", [(), (3,)])
def test_codebook_and_decode_exact(lead):
    om = _omega(1, lead)
    got = tbp.codebook(torch.from_numpy(om)).numpy()
    # exact against the reference's decode of the 16 codes; the
    # reference's own batched codebook (an einsum) can sum in another
    # order and miss its decode by one ulp (ROADMAP queue 3), so it gets
    # a one-ulp gate
    idx = jnp.arange(16, dtype=jnp.uint8)
    per_lead = [np.asarray(jbp.decode(idx, jnp.asarray(o)))
                for o in om.reshape(-1, 4)]
    np.testing.assert_array_equal(got.reshape(-1, 16), np.stack(per_lead))
    np.testing.assert_allclose(got, np.asarray(jbp.codebook(jnp.asarray(om))),
                               rtol=0, atol=2 ** -22)
    codes = _codes((*lead, 16, 9), seed=2)
    np.testing.assert_array_equal(
        tbp.decode(torch.from_numpy(codes), torch.from_numpy(om)).numpy(),
        np.asarray(jbp.decode(jnp.asarray(codes), jnp.asarray(om))))
    # every decoded weight is its code's codebook entry, bitwise
    book = tbp.codebook(torch.from_numpy(om)).numpy()
    dec = tbp.decode(torch.from_numpy(codes), torch.from_numpy(om)).numpy()
    if lead:
        for i in range(lead[0]):
            np.testing.assert_array_equal(dec[i], book[i][codes[i]])
    else:
        np.testing.assert_array_equal(dec, book[codes])


def _decode_bit_planes(codes, omega, dtype):
    """The term-by-term sum over int64 bit-planes that ``decode`` computed
    before it gathered from the codebook."""
    out = torch.zeros(codes.shape, dtype=dtype)
    c = codes.to(torch.int64)
    for i in range(tbp.NUM_BASIS):
        w_i = omega[..., i].to(dtype)
        if omega.ndim > 1:
            w_i = w_i[..., None, None]
        out = out + w_i * ((c >> i) & 1).to(dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead", [(), (3,), (2, 4)])
def test_decode_bitwise_equals_the_bit_plane_sum(lead, dtype):
    om = torch.from_numpy(_omega(7, lead) * 0.05)
    codes = torch.from_numpy(_codes((*lead, 34, 20), seed=8))
    got, want = tbp.decode(codes, om, dtype), _decode_bit_planes(codes, om,
                                                                dtype)
    assert got.dtype == dtype and got.shape == codes.shape
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))


def test_init_omega_exact():
    w = RNG.normal(size=(2, 12, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        tbp.init_omega_from_weights(torch.from_numpy(w)).numpy(),
        np.asarray(jbp.init_omega_from_weights(jnp.asarray(w))))


@pytest.mark.parametrize("lam", [0.0, 0.02, 0.5])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_ecl_assign_exact(lam, lead):
    rng = np.random.default_rng(3)
    w = rng.normal(size=(*lead, 24, 10)).astype(np.float32) * 0.1
    om = np.asarray(jbp.init_omega_from_weights(jnp.asarray(w)))
    probs = rng.dirichlet(np.ones(16), size=lead or None).astype(np.float32)
    want = np.asarray(jecl.assign(jnp.asarray(w), jnp.asarray(om),
                                  jnp.asarray(probs), lam))
    got = tecl.assign(torch.from_numpy(w), torch.from_numpy(om),
                      torch.from_numpy(probs), lam).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        tecl.histogram(torch.from_numpy(got), len(lead)).numpy(),
        np.asarray(jecl.histogram(jnp.asarray(want), len(lead))), rtol=1e-6)
    np.testing.assert_allclose(
        tecl.entropy_bits(torch.from_numpy(probs)).numpy(),
        np.asarray(jecl.entropy_bits(jnp.asarray(probs))), rtol=1e-6)


def test_ecl_assign_ties_take_lowest_code():
    # omega all zero: every code decodes to 0, all costs tie -> code 0
    w = torch.ones((4, 4))
    codes = tecl.assign(w, torch.zeros(4), torch.full((16,), 1 / 16), 0.0)
    assert int(codes.max()) == 0


def test_build_qstate_mirrors_tree():
    w = torch.zeros((6, 4))
    params = {"layers": [{"kernel": tqat.make_quant_param(w),
                          "bias": torch.zeros(4)}]}
    qs = tqat.build_qstate(params)
    assert qs["layers"][0]["kernel"]["probs"].shape == (16,)
    assert qs["layers"][0]["bias"].dtype == torch.uint8


@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_ref_matmul_matches_jax(activation):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 32)).astype(np.float32)
    packed = np.asarray(jbp.pack_codes_rows(jnp.asarray(_codes((32, 20), 5))))
    om = _omega(6) / 4
    a1 = rng.normal(size=20).astype(np.float32)
    b = rng.normal(size=20).astype(np.float32)
    a2 = np.float32(0.75)
    want = np.asarray(jref.fantastic4_matmul_ref(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(om),
        bias=jnp.asarray(b), alpha1=jnp.asarray(a1), alpha2=jnp.asarray(a2),
        activation=activation))
    t = torch.from_numpy
    got = tref.fantastic4_matmul_ref(
        t(x), t(packed), t(om), bias=t(b), alpha1=t(a1),
        alpha2=torch.tensor(a2), activation=activation).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    acm = tref.acm_bitplane_ref(
        t(x), t(packed), t(om), bias=t(b), alpha1=t(a1),
        alpha2=torch.tensor(a2), activation=activation).numpy()
    np.testing.assert_allclose(acm, want, atol=1e-5)


def test_activations_match_jax():
    y = np.linspace(-6, 6, 97).astype(np.float32)
    for act in (None, "relu", "gelu"):
        np.testing.assert_allclose(
            tref.apply_activation(torch.from_numpy(y), act).numpy(),
            np.asarray(jref.apply_activation(jnp.asarray(y), act)),
            atol=1e-5)
        code = tref.activation_code(act)
        np.testing.assert_allclose(
            tref.apply_activation_coded(torch.from_numpy(y),
                                        torch.tensor(float(code))).numpy(),
            np.asarray(jref.apply_activation_coded(jnp.asarray(y),
                                                   jnp.float32(code))),
            atol=1e-5)
    with pytest.raises(ValueError):
        tref.activation_code("swish")


def test_ecl_quant_ref_matches_jax():
    rng = np.random.default_rng(7)
    w = rng.normal(size=(9, 11)).astype(np.float32) * 0.3
    om = _omega(8) / 5
    pen = (0.01 * -np.log2(rng.dirichlet(np.ones(16)))).astype(np.float32)
    jc, jw = jref.ecl_quant_ref(jnp.asarray(w), jnp.asarray(om),
                                jnp.asarray(pen))
    tc, tw = tref.ecl_quant_ref(torch.from_numpy(w), torch.from_numpy(om),
                                torch.from_numpy(pen))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)


def test_quantize_int8_rounds_half_to_even():
    y = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0])
    np.testing.assert_array_equal(tref.quantize_int8(y, 1.0).numpy(),
                                  [0, 2, 2, 0, -2, 127, -127])


@pytest.mark.parametrize("shape", [(6,), (3, 8), (2, 5, 4)])
def test_bitplanes_and_flat_packing_exact(shape):
    """``codes_to_bitplanes`` / ``bitplanes_to_codes`` and the flat
    ``pack_codes`` / ``unpack_codes`` bitwise against the reference."""
    codes = _codes(shape, seed=9)
    planes = tbp.codes_to_bitplanes(torch.from_numpy(codes))
    want = np.asarray(jbp.codes_to_bitplanes(jnp.asarray(codes)))
    assert planes.dtype == torch.bool and planes.shape == (4, *shape)
    np.testing.assert_array_equal(planes.numpy(), want)
    back = tbp.bitplanes_to_codes(planes)
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jbp.bitplanes_to_codes(jnp.asarray(want))))
    packed = tbp.pack_codes(torch.from_numpy(codes))
    jpacked = np.asarray(jbp.pack_codes(jnp.asarray(codes)))
    np.testing.assert_array_equal(packed.numpy(), jpacked)
    np.testing.assert_array_equal(tbp.unpack_codes(packed).numpy(), codes)
    np.testing.assert_array_equal(
        tbp.unpack_codes(packed).numpy(),
        np.asarray(jbp.unpack_codes(jnp.asarray(jpacked))))
    with pytest.raises(ValueError):
        tbp.pack_codes(torch.zeros((*shape[:-1], 3), dtype=torch.uint8))
