"""The port's lossless code formats vs the JAX package's, array by array.

Cold packs and ``pack.npz`` files cross between the two packages, so every
payload array (dense4, bitmask, CSR, Huffman) must be byte-equal, the size
functions and ``select_format*`` must pick the same, and decoding must be
exact.  Inputs: seeded numpy code tensors, including all-zero, one-symbol,
empty and odd-shaped ones.  Tolerance: none (exact).
"""
import numpy as np
import pytest

from repro.core import formats as jf
from repro_torch.core import formats as tf

SHAPES = ((16, 12), (33, 17), (1, 5), (7, 1), (3, 300), (64, 40))
FORMATS = ("dense4", "bitmask", "csr", "huffman")


def _codes(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, 16, size=shape).astype(np.uint8)
    if kind == "sparse":
        c = rng.integers(1, 16, size=shape).astype(np.uint8)
        c[rng.random(shape) < 0.9] = 0
        return c
    if kind == "skewed":
        p = np.array([0.6, 0.2, 0.1, 0.05] + [0.05 / 12] * 12)
        return rng.choice(16, size=shape, p=p).astype(np.uint8)
    if kind == "zeros":
        return np.zeros(shape, np.uint8)
    if kind == "one_symbol":
        return np.full(shape, 7, np.uint8)
    raise ValueError(kind)


KINDS = ("uniform", "sparse", "skewed", "zeros", "one_symbol")


def _cases():
    for kind in KINDS:
        for i, shape in enumerate(SHAPES):
            yield pytest.param(kind, shape, id=f"{kind}-{shape[0]}x{shape[1]}")


@pytest.mark.parametrize("kind,shape", list(_cases()))
@pytest.mark.parametrize("fmt", FORMATS)
def test_payload_equal_and_decode_exact(fmt, kind, shape):
    codes = _codes(kind, shape, seed=shape[0] * 31 + shape[1])
    ct_t = tf.encode(codes, fmt)
    ct_j = jf.encode(codes, fmt)
    assert ct_t.format == ct_j.format and tuple(ct_t.shape) == \
        tuple(ct_j.shape)
    assert sorted(ct_t.payload) == sorted(ct_j.payload)
    for (kt, at), (kj, aj) in zip(ct_t.canonical_items(),
                                  ct_j.canonical_items()):
        assert kt == kj
        assert at.dtype == aj.dtype and at.shape == aj.shape, kt
        assert at.tobytes() == aj.tobytes(), kt
    assert ct_t.size_bytes == ct_j.size_bytes
    np.testing.assert_array_equal(tf.decode(ct_t), codes)
    # the JAX package decodes the port's payload (and the reverse)
    np.testing.assert_array_equal(jf.decode(ct_t), codes)
    np.testing.assert_array_equal(tf.decode(ct_j), codes)


@pytest.mark.parametrize("kind,shape", list(_cases()))
def test_selection_and_sizes_equal(kind, shape):
    codes = _codes(kind, shape, seed=7)
    assert tf.select_format(codes) == jf.select_format(codes)
    assert tf.select_format_ext(codes) == jf.select_format_ext(codes)
    nnz = int(np.count_nonzero(codes))
    for fmt in tf.FORMATS:
        assert tf.analytic_size_bits(codes.shape, nnz, fmt) == \
            jf.analytic_size_bits(codes.shape, nnz, fmt)
        # the closed form matches the encoded payload
        assert tf.analytic_size_bits(codes.shape, nnz, fmt) == \
            tf.encode(codes, fmt).size_bits
    assert tf.analytic_size_bits_huffman(codes) == \
        jf.analytic_size_bits_huffman(codes)
    assert tf.compression_ratio(codes) == jf.compression_ratio(codes)
    best = tf.encode_best(codes)
    np.testing.assert_array_equal(tf.decode(best), codes)


@pytest.mark.parametrize("fmt", FORMATS)
def test_empty_tensor_roundtrips_like_the_reference(fmt):
    codes = np.zeros((0, 8), np.uint8)
    ct_t, ct_j = tf.encode(codes, fmt), jf.encode(codes, fmt)
    assert [(k, a.tobytes()) for k, a in ct_t.canonical_items()] == \
        [(k, a.tobytes()) for k, a in ct_j.canonical_items()]
    assert tf.decode(ct_t).shape == (0, 8)


def test_huffman_lengths_and_canonical_codes_equal():
    for kind in KINDS:
        codes = _codes(kind, (40, 40), seed=3)
        counts = np.bincount(codes.reshape(-1), minlength=16)
        lt, lj = tf._huffman_lengths(counts), jf._huffman_lengths(counts)
        np.testing.assert_array_equal(lt, lj)
        np.testing.assert_array_equal(tf._canonical_codes(lt),
                                      jf._canonical_codes(lj))


@pytest.mark.parametrize("kind", KINDS)
def test_huffman_of_a_tensor_equals_the_reference(kind):
    """``encode_huffman`` of a tensor (the export passes the codes where
    they lie) gives the reference's payload byte for byte; ``decode``
    with a device named gives the codes as a tensor there."""
    import torch
    codes = _codes(kind, (37, 129), seed=3)
    want = jf.encode_huffman(codes)
    got = tf.encode(torch.from_numpy(codes), "huffman")
    assert got.shape == want.shape
    for key in want.payload:
        np.testing.assert_array_equal(got.payload[key], want.payload[key])
    on = tf.decode(want, "cpu")
    assert isinstance(on, torch.Tensor) and on.dtype == torch.uint8
    np.testing.assert_array_equal(on.numpy(), codes)
    np.testing.assert_array_equal(tf.decode(want), codes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_huffman_chain_by_doubling_equals_the_walk(seed, monkeypatch):
    """The card's chain of code starts (pointer doubling) equals the
    host's walk on one next-start map, here both on the CPU: a map of
    steps 1..15 with, for seed 2, positions where no code starts
    (mapped to ``nbits + 1``), as a broken stream gives.  The doubling
    squares its map in place, 777 entries at a time here (so each
    squaring crosses chunks); it gets a copy."""
    import torch
    monkeypatch.setattr(tf, "_SQUARE_CHUNK", 777)
    rng = np.random.default_rng(seed)
    nbits = 5000 + 777 * seed
    nxt = np.arange(nbits + 2, dtype=np.int32)
    nxt[:nbits] += rng.integers(1, 16, nbits).astype(np.int32)
    if seed == 2:
        nxt[:nbits][rng.random(nbits) < 0.01] = nbits + 1
    nxt[:nbits][nxt[:nbits] > nbits] = nbits + 1
    nxt_t = torch.from_numpy(nxt)
    for n in (1, 31, 32, 33, nbits // 8, nbits):
        np.testing.assert_array_equal(
            tf._starts_doubling(nxt_t.clone(), n).numpy(),
            tf._starts_walk(nxt_t, n).numpy())


def test_huffman_decode_raises_on_a_broken_stream():
    """A truncated payload, or a bit count that is short or long, fails
    with the bit where the stream breaks; the reference fails too."""
    codes = _codes("skewed", (40, 25), seed=4)
    ct = tf.encode_huffman(codes)
    nbits = int(ct.payload["nbits"][0])
    broken = {"truncated": {**ct.payload, "bits": ct.payload["bits"][:-9]},
              "short": {**ct.payload, "nbits": np.asarray([nbits - 3],
                                                          np.int64)},
              "long": {**ct.payload, "nbits": np.asarray([nbits + 5],
                                                         np.int64)}}
    for name, payload in broken.items():
        bad = tf.CompressedTensor("huffman", ct.shape, payload)
        with pytest.raises(ValueError, match="huffman payload"):
            tf.decode_huffman(bad)
        with pytest.raises(Exception):
            jf.decode_huffman(jf.CompressedTensor("huffman", ct.shape,
                                                  payload))
