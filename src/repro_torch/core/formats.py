"""Lossless compressed formats for 4-bit code tensors (paper §III-B.2).

A copy of the JAX package's ``core/formats.py`` (numpy only), so the port
imports nothing of it: cold packs and ``pack.npz`` files cross between
the two packages, and their payload arrays are equal byte for byte.

Three formats, selected per layer by minimum encoded size (contribution 4):

* ``dense4``  — trivial 4 bits/element, two codes per byte.
* ``bitmask`` — the paper's "simple Huffman" code: a 1-bit/element occupancy
  bitmask followed by the non-zero 4-bit codes in row-major order. Wins at
  moderate sparsity (25–90 %).
* ``csr``     — non-zero codes plus 8-bit column pointers within 256-wide
  row chunks (matching the paper's 256-wide adder tree / 8-bit CSR pointer
  chunks) and a per-chunk-row count. Wins at high sparsity (>90 %).

plus a canonical Huffman code over the 16 cluster ids (``select_format_ext``).
These are host-side codecs: checkpoint payloads, the serving cold tier and
host→device transfer accounting.  On the card execution always uses the
row-pair packed dense4 form the kernels read; ``csr``/``bitmask``/``huffman``
are decoded on load.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

CHUNK = 256  # paper's adder-tree width; CSR column pointers are 8-bit within a chunk

FORMATS = ("dense4", "bitmask", "csr")


@dataclass
class CompressedTensor:
    format: str
    shape: tuple
    payload: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def size_bits(self) -> int:
        return int(sum(a.size * a.dtype.itemsize * 8 for a in self.payload.values()))

    @property
    def size_bytes(self) -> int:
        return (self.size_bits + 7) // 8

    def canonical_items(self):
        """Payload arrays in sorted key order — the canonical walk every
        payload-level checksum (``runtime.integrity.payload_crc``) and
        byte-level fault injector uses, so digests are stable across
        dict insertion orders."""
        return [(key, np.asarray(self.payload[key]))
                for key in sorted(self.payload)]


def _pack_nibbles(flat: np.ndarray) -> np.ndarray:
    flat = flat.astype(np.uint8)
    if flat.size % 2:
        flat = np.concatenate([flat, np.zeros(1, np.uint8)])
    return (flat[0::2] & 0xF) | (flat[1::2] << 4)


def _unpack_nibbles(packed: np.ndarray, n: int) -> np.ndarray:
    out = np.empty(packed.size * 2, np.uint8)
    out[0::2] = packed & 0xF
    out[1::2] = (packed >> 4) & 0xF
    return out[:n]


# ---------------------------------------------------------------- dense4

def encode_dense4(codes: np.ndarray) -> CompressedTensor:
    return CompressedTensor("dense4", codes.shape,
                            {"nibbles": _pack_nibbles(codes.reshape(-1))})


def decode_dense4(ct: CompressedTensor) -> np.ndarray:
    n = int(np.prod(ct.shape))
    return _unpack_nibbles(ct.payload["nibbles"], n).reshape(ct.shape)


# ---------------------------------------------------------------- bitmask

def encode_bitmask(codes: np.ndarray) -> CompressedTensor:
    flat = codes.reshape(-1).astype(np.uint8)
    mask = flat != 0
    return CompressedTensor("bitmask", codes.shape, {
        "mask": np.packbits(mask),
        "values": _pack_nibbles(flat[mask]),
        "nnz": np.asarray([int(mask.sum())], np.int64),
    })


def decode_bitmask(ct: CompressedTensor) -> np.ndarray:
    n = int(np.prod(ct.shape))
    mask = np.unpackbits(ct.payload["mask"])[:n].astype(bool)
    nnz = int(ct.payload["nnz"][0])
    vals = _unpack_nibbles(ct.payload["values"], nnz)
    out = np.zeros(n, np.uint8)
    out[mask] = vals
    return out.reshape(ct.shape)


# ---------------------------------------------------------------- csr

def encode_csr(codes: np.ndarray) -> CompressedTensor:
    """CSR over 256-wide chunks: per chunk-row nnz count (uint16), 8-bit
    column pointers, 4-bit values."""
    if codes.size == 0:        # empty/zero-row tensor: no chunks at all
        return CompressedTensor("csr", codes.shape, {
            "counts": np.zeros(0, np.uint16),
            "colptr": np.zeros(0, np.uint8),
            "values": np.zeros(0, np.uint8),
            "nnz": np.asarray([0], np.int64),
        })
    mat = codes.reshape(codes.shape[0], -1) if codes.ndim > 1 else codes.reshape(1, -1)
    rows, cols = mat.shape
    pad = (-cols) % CHUNK
    if pad:
        mat = np.concatenate([mat, np.zeros((rows, pad), np.uint8)], axis=1)
    chunked = mat.reshape(rows * (mat.shape[1] // CHUNK), CHUNK)
    nz_r, nz_c = np.nonzero(chunked)
    counts = np.bincount(nz_r, minlength=chunked.shape[0]).astype(np.uint16)
    return CompressedTensor("csr", codes.shape, {
        "counts": counts,
        "colptr": nz_c.astype(np.uint8),
        "values": _pack_nibbles(chunked[nz_r, nz_c]),
        "nnz": np.asarray([nz_r.size], np.int64),
    })


def decode_csr(ct: CompressedTensor) -> np.ndarray:
    shape = ct.shape
    if int(np.prod(shape)) == 0:
        return np.zeros(shape, np.uint8)
    rows = shape[0] if len(shape) > 1 else 1
    cols = int(np.prod(shape)) // rows
    padded_cols = cols + ((-cols) % CHUNK)
    chunked = np.zeros((rows * (padded_cols // CHUNK), CHUNK), np.uint8)
    counts = ct.payload["counts"].astype(np.int64)
    nnz = int(ct.payload["nnz"][0])
    vals = _unpack_nibbles(ct.payload["values"], nnz)
    row_idx = np.repeat(np.arange(chunked.shape[0]), counts)
    chunked[row_idx, ct.payload["colptr"]] = vals
    mat = chunked.reshape(rows, padded_cols)[:, :cols]
    return mat.reshape(shape)


_ENC = {"dense4": encode_dense4, "bitmask": encode_bitmask, "csr": encode_csr}
_DEC = {"dense4": decode_dense4, "bitmask": decode_bitmask, "csr": decode_csr}


def encode(codes: np.ndarray, fmt: str) -> CompressedTensor:
    return _ENC[fmt](np.asarray(codes, np.uint8))


def decode(ct: CompressedTensor) -> np.ndarray:
    return _DEC[ct.format](ct)


def analytic_size_bits(shape: tuple, nnz: int, fmt: str) -> int:
    """Closed-form encoded size (bits) — used for fast format selection and
    the Table-II style benchmark (matches the codecs above exactly)."""
    n = int(np.prod(shape))
    rows = shape[0] if len(shape) > 1 else 1
    cols = n // rows if rows else 0     # zero-row shard: nothing to chunk
    chunk_rows = rows * ((cols + CHUNK - 1) // CHUNK)
    if fmt == "dense4":
        return 2 * ((n + 1) // 2) * 4
    if fmt == "bitmask":
        return 8 * ((n + 7) // 8) + 2 * ((nnz + 1) // 2) * 4 + 64
    if fmt == "csr":
        return 16 * chunk_rows + 8 * nnz + 2 * ((nnz + 1) // 2) * 4 + 64
    raise ValueError(fmt)


def select_format(codes: np.ndarray) -> str:
    """Pick the most compact of the three formats (paper contribution 4)."""
    codes = np.asarray(codes, np.uint8)
    nnz = int(np.count_nonzero(codes))
    sizes = {f: analytic_size_bits(codes.shape, nnz, f) for f in FORMATS}
    return min(sizes, key=sizes.get)


def encode_best(codes: np.ndarray) -> CompressedTensor:
    return encode(codes, select_format(codes))


def compression_ratio(codes: np.ndarray, fmt: str | None = None,
                      orig_bits_per_weight: int = 32) -> float:
    """Full-precision size / compressed size (paper Table II 'CR')."""
    codes = np.asarray(codes, np.uint8)
    fmt = fmt or select_format(codes)
    nnz = int(np.count_nonzero(codes))
    comp = analytic_size_bits(codes.shape, nnz, fmt)
    return codes.size * orig_bits_per_weight / comp


# ------------------------------------------------------------- huffman
# Beyond-paper extension in the paper's own lineage ([5] Deep Compression,
# [6] DeepCABAC): a canonical Huffman code over the 16 cluster ids.  Where
# CSR/bitmask only exploit *zeros*, Huffman exploits the full low-entropy
# histogram that EC4T training produces — encoded size approaches
# H bits/weight, beating every other format once H < ~3.5 bits.  Decode is
# table-driven (canonical codes), the natural software analogue of the
# paper's "efficient loading of repeated values".

def _huffman_lengths(counts: np.ndarray) -> np.ndarray:
    """Code lengths for 16 symbols (package-merge-free simple Huffman)."""
    import heapq
    heap = [(int(c), i, (i,)) for i, c in enumerate(counts) if c > 0]
    if len(heap) == 1:
        lengths = np.zeros(16, np.uint8)
        lengths[heap[0][1]] = 1
        return lengths
    heapq.heapify(heap)
    lengths = np.zeros(16, np.uint8)
    tie = 16
    while len(heap) > 1:
        c1, _, s1 = heapq.heappop(heap)
        c2, _, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            lengths[s] += 1
        heapq.heappush(heap, (c1 + c2, tie, s1 + s2))
        tie += 1
    return lengths


def _canonical_codes(lengths: np.ndarray):
    """(code, length) per symbol, canonical ordering.

    Pure-python ints throughout: ``int << np.uint8`` promotes to uint8
    under NumPy 2 and silently wraps at 255 (bug found by hypothesis)."""
    order = sorted((int(l), s) for s, l in enumerate(lengths) if l > 0)
    codes = np.zeros(16, np.uint32)
    if not order:        # empty tensor: no symbols, no codewords
        return codes
    code = 0
    prev_len = order[0][0]
    for l, s in order:
        code <<= (l - prev_len)
        codes[s] = code
        code += 1
        prev_len = l
    return codes


#: symbols encoded at a time (bounds the (symbols, longest code) table)
_ENCODE_CHUNK = 1 << 22


def encode_huffman(codes: np.ndarray) -> CompressedTensor:
    """Canonical Huffman, MSB first: each symbol's codeword bits come from
    a (16, longest code) bit table, the valid ones kept in order, then
    packed; the JAX package's bytes."""
    flat = codes.reshape(-1).astype(np.uint8)
    counts = np.bincount(flat, minlength=16)
    lengths = _huffman_lengths(counts)
    cw = _canonical_codes(lengths)
    width = int(lengths.max()) if flat.size else 0
    col = np.arange(width)
    table = ((cw[:, None].astype(np.int64)
              >> np.maximum(lengths[:, None].astype(np.int64) - 1 - col, 0))
             & 1).astype(np.uint8)
    valid = col < lengths[:, None]
    parts = [table[chunk][valid[chunk]]
             for chunk in (flat[i:i + _ENCODE_CHUNK]
                           for i in range(0, flat.size, _ENCODE_CHUNK))]
    bits = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return CompressedTensor("huffman", codes.shape, {
        "bits": np.packbits(bits),
        "lengths": lengths,
        "nbits": np.asarray([bits.size], np.int64),
    })


#: code starts a jump of the decoder's chain skips (2**5)
_JUMP_LOG2 = 5


def decode_huffman(ct: CompressedTensor) -> np.ndarray:
    """Table-driven canonical decode, in numpy.  Every bit position's next
    ``L`` bits (``L`` the longest code) index one table of (symbol,
    length), so each position knows where the next code would start if a
    code started there.  The code starts are the chain from bit 0: a
    table of 64-start jumps (six squarings of that map) lets a Python
    loop walk one start in 64, and 64 gathers fill in the rest.  The JAX
    package's decoder matches bit by bit in Python and gives the same
    symbols far slower (a cold-tier decode is on the serving frontend's
    recovery path; an export's load decodes every weight of a model)."""
    lengths = np.asarray(ct.payload["lengths"]).astype(np.int64)
    n = int(np.prod(ct.shape))
    nbits = int(ct.payload["nbits"][0])
    if n == 0:
        return np.zeros(ct.shape, np.uint8)
    cw = _canonical_codes(lengths)
    width = int(lengths.max())
    if width == 0:
        raise ValueError("huffman payload has no code lengths")
    bits = np.unpackbits(ct.payload["bits"])[:nbits]
    if bits.size != nbits:
        raise ValueError(f"huffman payload holds {bits.size} of {nbits} bits")
    padded = np.concatenate([bits, np.zeros(width, np.uint8)])
    window = np.zeros(nbits, np.uint16)
    for j in range(width):
        np.left_shift(window, 1, out=window)
        np.bitwise_or(window, padded[j:j + nbits], out=window)
    sym_t = np.zeros(1 << width, np.uint8)
    len_t = np.zeros(1 << width, np.int32)       # 0: no code starts so
    for sym in range(16):
        l = int(lengths[sym])
        if l:
            lo = int(cw[sym]) << (width - l)
            sym_t[lo:lo + (1 << (width - l))] = sym
            len_t[lo:lo + (1 << (width - l))] = l
    # next start after a start at each bit; nbits (the end) and nbits + 1
    # (no code starts there, or it runs past the end) map to themselves
    idx = np.int64 if nbits + 2 > np.iinfo(np.int32).max else np.int32
    step = len_t[window]
    nxt = np.empty(nbits + 2, idx)
    nxt[:nbits] = np.arange(nbits, dtype=idx) + step
    nxt[:nbits][(step == 0) | (nxt[:nbits] > nbits)] = nbits + 1
    nxt[nbits:] = (nbits, nbits + 1)
    jump = nxt
    for _ in range(_JUMP_LOG2):
        jump = jump[jump]
    span = 1 << _JUMP_LOG2
    m = -(-n // span)
    coarse = np.empty(m, idx)
    p = 0
    for i in range(m):
        coarse[i] = p
        p = jump[p]
    starts = np.empty((m, span), idx)
    cur = coarse
    for t in range(span):
        starts[:, t] = cur
        cur = nxt[cur]
    starts = starts.reshape(-1)[:n]
    bad = np.flatnonzero(starts >= nbits)
    if bad.size:
        j = int(bad[0])
        raise ValueError(f"huffman payload ends or breaks at bit "
                         f"{int(starts[j - 1]) if j else 0} after {j} of "
                         f"{n} symbols")
    end = int(nxt[starts[-1]])
    if end != nbits:
        raise ValueError(f"huffman payload: {n} symbols end at bit "
                         f"{end if end <= nbits else 'past the end'} of "
                         f"{nbits}")
    return sym_t[window[starts]].reshape(ct.shape)


_ENC["huffman"] = encode_huffman
_DEC["huffman"] = decode_huffman
FORMATS_EXT = FORMATS + ("huffman",)


def analytic_size_bits_huffman(codes: np.ndarray) -> int:
    counts = np.bincount(codes.reshape(-1).astype(np.uint8), minlength=16)
    lengths = _huffman_lengths(counts) if counts.sum() else np.zeros(16)
    data_bits = int((counts * lengths).sum())
    return 8 * ((data_bits + 7) // 8) + 16 * 8 + 64   # + table + header


def select_format_ext(codes: np.ndarray) -> str:
    """Format selection over the extended set (incl. huffman)."""
    codes = np.asarray(codes, np.uint8)
    nnz = int(np.count_nonzero(codes))
    sizes = {f: analytic_size_bits(codes.shape, nnz, f) for f in FORMATS}
    sizes["huffman"] = analytic_size_bits_huffman(codes)
    return min(sizes, key=sizes.get)
