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
are decoded on load.  The Huffman codec is PyTorch and runs where its
codes lie, or on a device named at decode: a MoE bank holds hundreds of
millions of codes, which the card encodes and decodes in a fraction of
the host's time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

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


def encode(codes, fmt: str) -> CompressedTensor:
    """``codes`` (a numpy array or a tensor) in format ``fmt``: Huffman
    where the codes lie, the other formats on the host."""
    if fmt == "huffman":
        return encode_huffman(codes)
    if isinstance(codes, torch.Tensor):
        codes = codes.cpu().numpy()
    return _ENC[fmt](np.asarray(codes, np.uint8))


def decode(ct: CompressedTensor, device=None):
    """The codes of ``ct``: numpy, or a tensor on ``device`` when one is
    named (a Huffman stream is decoded there, the other formats on the
    host and moved)."""
    if ct.format == "huffman":
        return decode_huffman(ct, device)
    codes = _DEC[ct.format](ct)
    return codes if device is None else torch.from_numpy(codes).to(device)


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


def _huffman_tables(lengths: np.ndarray) -> tuple:
    """(codeword bits (16, L) uint8, valid (16, L) bool) over the longest
    code L, MSB first: what :func:`encode_huffman` writes per symbol."""
    cw = _canonical_codes(lengths)
    width = int(lengths.max())
    col = np.arange(width)
    table = ((cw[:, None].astype(np.int64)
              >> np.maximum(lengths[:, None].astype(np.int64) - 1 - col, 0))
             & 1).astype(np.uint8)
    return table, col < lengths[:, None]


#: codes :func:`encode_huffman` selects bits for at a time (bounds the
#: (codes, longest code) table)
_ENCODE_CHUNK = 1 << 24


def encode_huffman(codes) -> CompressedTensor:
    """Canonical Huffman, MSB first, the JAX package's bytes.  ``codes`` is
    a numpy array or a tensor and is encoded where it lies (a MoE bank's
    codes on the card): the 16 counts and the code lengths on the host,
    then each code's bits from a (16, longest code) bit table, the valid
    ones kept in order and packed, ``_ENCODE_CHUNK`` codes at a time."""
    flat = torch.as_tensor(codes).reshape(-1)
    dev = flat.device
    counts = torch.bincount(flat, minlength=16).cpu()
    lengths = _huffman_lengths(counts.numpy())
    table, valid = _huffman_tables(lengths)
    table_t = torch.from_numpy(table).to(dev)
    valid_t = torch.from_numpy(valid).to(dev)
    parts = []
    for i in range(0, flat.numel(), _ENCODE_CHUNK):
        chunk = flat[i:i + _ENCODE_CHUNK].to(torch.int32)
        parts.append(torch.index_select(table_t, 0, chunk)[
            torch.index_select(valid_t, 0, chunk)])
    bits = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.uint8,
                                                      device=dev)
    nbits = bits.numel()
    pad = (-nbits) % 8
    if pad:
        bits = torch.cat([bits, bits.new_zeros(pad)])
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=dev)
    packed = (bits.view(-1, 8) * weights).sum(-1, dtype=torch.uint8)
    return CompressedTensor("huffman", tuple(codes.shape), {
        "bits": packed.cpu().numpy(),
        "lengths": lengths,
        "nbits": np.asarray([nbits], np.int64),
    })


#: code starts a jump of the host chain skips (2**5)
_JUMP_LOG2 = 5


def _starts_walk(nxt: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` code starts, the chain from bit 0 through the
    next-start map ``nxt``, on the host: a table of 32-start jumps (five
    squarings of the map) lets a Python loop walk one start in 32, and 32
    gathers fill in the rest."""
    step = nxt.numpy()
    jump = step
    for _ in range(_JUMP_LOG2):
        jump = jump[jump]
    span = 1 << _JUMP_LOG2
    m = -(-n // span)
    coarse = np.empty(m, step.dtype)
    p = 0
    for i in range(m):
        coarse[i] = p
        p = jump[p]
    starts = np.empty((m, span), step.dtype)
    cur = coarse
    for t in range(span):
        starts[:, t] = cur
        cur = step[cur]
    return torch.from_numpy(starts.reshape(-1)[:n])


def _starts_doubling(nxt: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`_starts_walk` on a device, by doubling: with J the map, the
    first 2**(b+1) starts are the first 2**b followed by J**(2**b) of
    them, and J squares itself each round (log2 n gathers over the bits,
    no walk on the host)."""
    starts = nxt.new_zeros(1)
    jump = nxt
    while starts.numel() < n:
        starts = torch.cat([starts, torch.index_select(jump, 0, starts)])
        if starts.numel() < n:
            jump = torch.index_select(jump, 0, jump)
    return starts[:n]


def decode_huffman(ct: CompressedTensor, device=None):
    """Table-driven canonical decode with PyTorch, on ``device`` (default:
    the host).  Every bit position's next ``L`` bits (``L`` the longest
    code) index one table of (symbol, length), so each position knows
    where the next code would start if a code started there.  The code
    starts are the chain from bit 0, walked on the host
    (:func:`_starts_walk`) or by doubling on a card
    (:func:`_starts_doubling`).  Returns numpy when no device is named,
    else a tensor on it.  The JAX package's decoder matches bit by bit in
    Python and gives the same symbols far slower (a cold-tier decode is
    on the serving frontend's recovery path; an export's load decodes
    every weight of a model)."""
    dev = torch.device("cpu" if device is None else device)
    lengths = np.asarray(ct.payload["lengths"]).astype(np.int64)
    n = int(np.prod(ct.shape))
    nbits = int(ct.payload["nbits"][0])
    if n == 0:
        out = torch.zeros(ct.shape, dtype=torch.uint8, device=dev)
        return out.numpy() if device is None else out
    cw = _canonical_codes(lengths)
    width = int(lengths.max())
    if width == 0:
        raise ValueError("huffman payload has no code lengths")
    packed = torch.from_numpy(np.asarray(ct.payload["bits"], np.uint8)).to(dev)
    if packed.numel() * 8 < nbits:
        raise ValueError(f"huffman payload holds {packed.numel() * 8} of "
                         f"{nbits} bits")
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
    bits = ((packed[:, None] >> shifts) & 1).reshape(-1)[:nbits]
    padded = torch.cat([bits, bits.new_zeros(width)])
    del bits
    window = torch.zeros(nbits, dtype=torch.int32, device=dev)
    for j in range(width):
        window.mul_(2).add_(padded[j:j + nbits])
    del padded
    sym_t = np.zeros(1 << width, np.uint8)
    len_t = np.zeros(1 << width, np.int32)       # 0: no code starts so
    for sym in range(16):
        l = int(lengths[sym])
        if l:
            lo = int(cw[sym]) << (width - l)
            sym_t[lo:lo + (1 << (width - l))] = sym
            len_t[lo:lo + (1 << (width - l))] = l
    idx = torch.int64 if nbits + 2 > np.iinfo(np.int32).max else torch.int32
    sym_at = torch.index_select(torch.from_numpy(sym_t).to(dev), 0, window)
    step = torch.index_select(torch.from_numpy(len_t).to(dev), 0,
                              window).to(idx)
    del window
    # next start after a start at each bit; nbits (the end) and nbits + 1
    # (no code starts there, or it runs past the end) map to themselves
    nxt = torch.arange(nbits + 2, dtype=idx, device=dev)
    head = nxt[:nbits]
    head += step
    head.masked_fill_((step == 0) | (head > nbits), nbits + 1)
    del step, head
    starts = (_starts_walk if dev.type == "cpu" else _starts_doubling)(nxt, n)
    bad = torch.nonzero(starts >= nbits)
    if bad.numel():
        j = int(bad[0, 0])
        raise ValueError(f"huffman payload ends or breaks at bit "
                         f"{int(starts[j - 1]) if j else 0} after {j} of "
                         f"{n} symbols")
    end = int(nxt[starts[-1]])
    if end != nbits:
        raise ValueError(f"huffman payload: {n} symbols end at bit "
                         f"{end if end <= nbits else 'past the end'} of "
                         f"{nbits}")
    out = torch.index_select(sym_at, 0, starts).reshape(ct.shape)
    return out.numpy() if device is None else out


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
