"""Kernel 1: the per-layer packed-int4 ACM matmul with fused §V epilogue.

Replaces the JAX package's ``kernels/fantastic4_matmul.py``
``fantastic4_matmul_pallas`` (body ``_kernel``).  Computes

    y = epilogue(x @ W),  W = Σ_i ω_i · bit_i(code)  from (K/2, N) row-pair
    packed codes (low nibble = row 2r),
    epilogue: y·α₁ + b, act ∈ {none, relu, tanh-gelu}, then ×α₂ — or, with
    ``quant_scale``, clip(rint(y / s), ±127) through int8 (the int8 chain).

On the H100 (``csrc/fantastic4.cu`` ``matmul_kernel``) one CTA computes a
(row tile of <= 32 rows) x (column slice of <= ``SLICE_COLS`` = 16 columns)
block of the output with K looped inside the block (the TPU kernel carried
its sum across an "arbitrary" K grid instead), so a 512-wide layer covers
32 SMs even at one row.  Each CTA copies its K x 16 slice of the codes into
shared memory with one bulk async copy, from a slice-major copy built once
per (packed, ω) (:func:`chain_operands`), and decodes the weights in
registers; the K loop has no barrier and no L2 load.  What bounds it: the
dependent FFMA chain over K at a few rows, FFMA issue at 32-row tiles, and
across the seven layers of a served chain each launch's gap and first
loads.  Launches use programmatic dependent launch: a CTA reads only pack
constants (the code slice, ω) before ``griddepcontrol.wait``, so its
prologue overlaps the previous layer; x, α₁, b and α₂ are read after the
wait.  fp32 FFMA on CUDA cores keeps the result inside the fp32 gate.  A
K whose x tile and code slice do not fit a block's shared memory is
staged in chunks (:func:`chain_tiling`), so any K runs.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`fantastic4_matmul_plain`.  ``LAUNCHES`` counts kernel launches;
a list put in ``LAST_LAUNCHES`` collects the shape of each launch (CTAs,
shared memory, K chunk, PDL on or off) until it is set back to None.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..memo import MISS, IdentityMemo
from . import build, ref, staged
from .slices import code_slices, round_up, slice_count, slice_width

MAX_TILE_ROWS = 32      # rows per CTA (the kernel's row tile)
SMEM_BUDGET_BYTES = 232448   # shared memory a Hopper block may use
K_CHUNK = 64            # a partial K chunk is a multiple of this
LAUNCHES = 0
LAST_LAUNCHES: Optional[list] = None
# slice-major code copies, one per (packed, omega): a served chain's seven
# layers times a few packs
_OPERANDS = IdentityMemo(max_entries=256)


class ChainOperands(NamedTuple):
    codes: torch.Tensor      # slice-major copy, n_slices x slice_bytes
    n_slices: int
    slice_w: int
    slice_bytes: int
    omega: torch.Tensor      # (4,) fp32 on the device
    staged: staged.Staged    # codes and omega, sealed when built


def chain_operands(packed: torch.Tensor, omega: torch.Tensor,
                   device: torch.device) -> tuple:
    """(ChainOperands, built before?) for one layer: its code copy cut into
    slices of at most ``SLICE_COLS`` columns, and ω on ``device``; built
    once per (packed, omega) pair (frozen packs are never mutated in
    place)."""
    key = (device.type, device.index)
    hit = _OPERANDS.get((packed, omega), key)
    if hit is not MISS:
        return hit, True
    pk = packed.to(device, torch.uint8)
    k, n = 2 * pk.shape[0], pk.shape[1]
    s = slice_count(n)
    codes = code_slices(pk, k, n, n, s)
    codes = codes.reshape(-1)
    om = omega.to(device, torch.float32).reshape(4).contiguous()
    build.publish(device)
    ops = ChainOperands(codes, s, slice_width(n, s),
                        codes.numel() // s, om,
                        staged.Staged("chain code slices", (codes, om),
                                      codes=codes))
    _OPERANDS.put((packed, omega), key, ops)
    return ops, False


def forget_operands(packed: torch.Tensor) -> int:
    """Drop the code copies built from ``packed``; returns how many."""
    return _OPERANDS.drop(packed)


def staged_operands(packed: torch.Tensor) -> list:
    """The sealed code copies built from ``packed`` and memoized now."""
    return [ops.staged for ops in _OPERANDS.values(packed)]


def tile_stride(k: int) -> int:
    """Row stride (floats) of the shared x tile: K rounded up to a multiple
    of 4 (16-byte rows) whose quarter is odd (rows on different banks)."""
    ld = round_up(k, 4)
    return ld + 4 if (ld // 4) % 2 == 0 else ld


def chain_smem_bytes(rows: int, kc: int, chunk_bytes: int) -> int:
    """Shared memory of one CTA, as ``csrc/fantastic4.cu`` lays it out:
    the codebook (static), then dynamically an mbarrier, the x tile of
    ``kc`` columns and one chunk of the code slice
    (``chain_dyn_smem_bytes``)."""
    return 16 + 64 + 4 * rows * tile_stride(kc) + chunk_bytes


def chain_tiling(m: int, k: int, slice_w: int, slice_bytes: int) -> tuple:
    """(rows, kc, chunk_bytes) of one chain launch: rows per CTA (the batch
    up to ``MAX_TILE_ROWS``); the K chunk a CTA stages at a time -- all of
    K when the x tile and the whole code slice fit a block's shared memory,
    else the largest multiple of ``K_CHUNK`` that does -- and the bytes of
    one chunk of the code slice."""
    rows = max(1, min(m, MAX_TILE_ROWS))
    if chain_smem_bytes(rows, k, slice_bytes) <= SMEM_BUDGET_BYTES:
        return rows, k, slice_bytes
    # a multiple of K_CHUNK has tile_stride(kc) = kc + 4 and kc / 2 *
    # slice_w code bytes: 80 + 16·rows + kc·(4·rows + slice_w / 2) bytes
    kc = (2 * (SMEM_BUDGET_BYTES - 80 - 16 * rows)
          // (8 * rows + slice_w) // K_CHUNK * K_CHUNK)
    return rows, kc, kc // 2 * slice_w


def _check(x: torch.Tensor, packed: torch.Tensor) -> None:
    if x.ndim != 2 or packed.ndim != 2:
        raise ValueError(f"x (M, K) and packed (K/2, N) expected, got "
                         f"{tuple(x.shape)} and {tuple(packed.shape)}")
    if x.shape[1] != 2 * packed.shape[0]:
        raise ValueError(f"K mismatch: x {tuple(x.shape)} vs packed "
                         f"{tuple(packed.shape)}")


def fantastic4_matmul_plain(x, packed, omega, alpha1, bias, alpha2, *,
                            activation: Optional[str] = None,
                            quant_scale: Optional[float] = None
                            ) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 out)."""
    _check(x, packed)
    y = ref.fantastic4_matmul_ref(
        x, packed, omega, bias=bias, alpha1=alpha1,
        alpha2=None if quant_scale is not None else alpha2,
        activation=activation, out_dtype=torch.float32)
    if quant_scale is not None:
        y = ref.quantize_int8(y, quant_scale)
    return y


def fantastic4_matmul_cuda(x, packed, omega, alpha1, bias, alpha2, *,
                           activation: Optional[str] = None,
                           quant_scale: Optional[float] = None
                           ) -> torch.Tensor:
    """Launch kernel 1 on x's device; fp32 (M, N) out."""
    global LAUNCHES
    _check(x, packed)
    dev = x.device
    m, k = x.shape
    n = packed.shape[1]
    ops, built_before = chain_operands(packed, omega, dev)
    staged.note(ops.staged)
    xf = x.to(torch.float32).contiguous()
    if xf.data_ptr() % 16:
        xf = xf.clone()    # rows are read as float4
    a1 = (torch.ones(n, device=dev) if alpha1 is None
          else alpha1.to(dev, torch.float32).reshape(n).contiguous())
    b = (torch.zeros(n, device=dev) if bias is None
         else bias.to(dev, torch.float32).reshape(n).contiguous())
    scale_dev, scale = None, 1.0
    if quant_scale is not None:
        scale = float(quant_scale)
    elif isinstance(alpha2, torch.Tensor):
        scale_dev = alpha2.to(dev, torch.float32).reshape(1).contiguous()
    elif alpha2 is not None:
        scale = float(alpha2)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    rows, kc, chunk = chain_tiling(m, k, ops.slice_w, ops.slice_bytes)
    # programmatic dependent launch, except for a copy built in this call:
    # the kernels that wrote it ran just before this launch, whose prologue
    # would read it before they are known to have finished
    pdl = built_before
    lib = build.load()
    err = lib.f4_matmul(
        xf.data_ptr(), ops.codes.data_ptr(), ops.omega.data_ptr(),
        a1.data_ptr(), b.data_ptr(),
        None if scale_dev is None else scale_dev.data_ptr(), scale,
        int(quant_scale is not None), ref.activation_code(activation),
        m, k, n, ops.n_slices, ops.slice_w, ops.slice_bytes, rows,
        tile_stride(kc), kc, chunk, int(pdl), y.data_ptr(),
        build.stream_handle(dev))
    build.check(err, "fantastic4_matmul kernel")
    build.keep_for_stream((ops.codes, ops.omega, a1, b, scale_dev, xf), dev)
    with build.COUNT_LOCK:
        LAUNCHES += 1
    if LAST_LAUNCHES is not None:
        LAST_LAUNCHES.append({
            "k": k, "n": n, "rows": m,
            "ctas": ops.n_slices * -(-m // rows), "rows_per_cta": rows,
            "cols_per_cta": ops.slice_w, "k_chunk": kc,
            "smem_bytes": chain_smem_bytes(rows, kc, chunk), "pdl": pdl})
    return y


def fantastic4_matmul(x, packed, omega, alpha1=None, bias=None, alpha2=None,
                      *, activation: Optional[str] = None,
                      quant_scale: Optional[float] = None) -> torch.Tensor:
    """x (M, K) · packed (K/2, N) -> (M, N) fp32: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return fantastic4_matmul_cuda(x, packed, omega, alpha1, bias, alpha2,
                                      activation=activation,
                                      quant_scale=quant_scale)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return fantastic4_matmul_plain(x, packed, omega, alpha1, bias, alpha2,
                                   activation=activation,
                                   quant_scale=quant_scale)
