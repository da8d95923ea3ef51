"""Kernel 5: fused ECL assignment + dequantization (the EC4T hot loop).

Replaces the JAX package's ``kernels/ecl_quant.py`` ``ecl_quant_pallas``
(body ``_kernel``).  For every element of w (R, C)

    code = argmin_c (w − v_c)² + pen_c,   ŵ = v_code,

over the 16 subset sums v_c of ω; ``penalty`` (16,) is the entropy term
λ·mean(w²)·(−log2 P) already computed.  Ties keep the lowest code.

:func:`ecl_quant_many` quantizes a list of tensors in one launch.  Each
tensor is (R, C) with ω (4,) and a penalty (16,), or (*lead, R, C) with a
batched ω (*lead, 4) and penalty (*lead, 16); each leading index is a
segment of its own that writes straight into its slice of the outputs.
On the H100 (``csrc/ecl_quant.cu`` ``ecl_quant_group_kernel``) the
segment table travels by value in the kernel's parameters, up to
:data:`MAX_SEGMENTS` segments a launch (more take more launches), and each
thread quantizes 8 elements with 16-byte loads and stores against the
codebook and penalty held in registers.  What bounds it: bytes, 9 per
element (read w, write the code and ŵ), with issue close behind.  The
cost is rounded step by step (no FMA contraction), so codes and ŵ are
bitwise equal to :func:`ecl_quant_plain`.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`ecl_quant_plain`.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import array
from typing import Sequence

import torch

from . import build, ref

LAUNCHES = 0
#: segments one launch takes (``kMaxSegments`` in csrc/ecl_quant.cu)
MAX_SEGMENTS = 32
_INT32_MAX = 2**31 - 1
# the work of one element and one segment (:func:`_note_work`)
ELEM_FLOPS = 16 * 4
ELEM_BYTES = 9
SEGMENT_BYTES = 4 * (4 + 16)


def _check(w: torch.Tensor, omega: torch.Tensor,
           penalty: torch.Tensor) -> None:
    if w.ndim != 2:
        raise ValueError(f"w (R, C) expected, got {tuple(w.shape)}")
    if omega.numel() != 4 or penalty.numel() != 16:
        raise ValueError(f"omega (4,) and penalty (16,) expected, got "
                         f"{tuple(omega.shape)} and {tuple(penalty.shape)}")


def _check_group(w: torch.Tensor, omega: torch.Tensor,
                 penalty: torch.Tensor) -> tuple:
    """The leading dims of one tensor of a group: () for w (R, C) with ω
    (4,) and penalty (16,), else w's dims before its last two, which a
    batched ω and penalty share."""
    if omega.ndim <= 1:
        _check(w, omega, penalty)
        return ()
    lead = tuple(w.shape[:-2])
    if (w.ndim < 3 or tuple(omega.shape) != (*lead, 4)
            or tuple(penalty.shape) != (*lead, 16)):
        raise ValueError(f"w (*lead, R, C) with omega (*lead, 4) and penalty "
                         f"(*lead, 16) expected, got {tuple(w.shape)}, "
                         f"{tuple(omega.shape)} and {tuple(penalty.shape)}")
    return lead


def ecl_quant_plain(w: torch.Tensor, omega: torch.Tensor,
                    penalty: torch.Tensor) -> tuple:
    """The kernel's function in plain PyTorch: (codes uint8, ŵ fp32)."""
    _check(w, omega, penalty)
    return ref.ecl_quant_ref(w, omega.reshape(4), penalty.reshape(16))


def _plain_group(w: torch.Tensor, omega: torch.Tensor,
                 penalty: torch.Tensor) -> tuple:
    if not _check_group(w, omega, penalty):
        return ecl_quant_plain(w, omega, penalty)
    w3 = w.reshape(-1, *w.shape[-2:])
    om, pn = omega.reshape(-1, 4), penalty.reshape(-1, 16)
    codes = torch.empty(w3.shape, dtype=torch.uint8, device=w.device)
    w_hat = torch.empty(w3.shape, dtype=torch.float32, device=w.device)
    for i in range(w3.shape[0]):
        codes[i], w_hat[i] = ecl_quant_plain(w3[i], om[i], pn[i])
    return codes.reshape(w.shape), w_hat.reshape(w.shape)


def _f32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype is torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


def _launch_group(ws, omegas, pens) -> list:
    """Every tensor's segments through the kernel, MAX_SEGMENTS a launch.
    The segment rows go to the C entry as one int64 array; no tensor op
    runs per segment, only the two output allocations per tensor."""
    global LAUNCHES
    dev = ws[0].device
    outs, rows, keep = [], [], []
    for w, omega, pen in zip(ws, omegas, pens):
        lead = _check_group(w, omega, pen)
        if not w.device == omega.device == pen.device == dev:
            raise ValueError(f"w, omega and penalty on {w.device}, "
                             f"{omega.device} and {pen.device}; the group's "
                             f"first w on {dev}")
        wf, om, pn = _aligned(_f32(w)), _f32(omega), _f32(pen)
        codes = torch.empty_like(wf, dtype=torch.uint8)
        w_hat = torch.empty_like(wf)
        outs.append((codes, w_hat))
        # hold the operands until the launch is queued: a temporary freed
        # earlier could back a later tensor of this group
        keep.append((wf, om, pn))
        n = wf.shape[-2] * wf.shape[-1]
        if n > _INT32_MAX:
            raise ValueError(f"w has {n} elements a segment; the kernel "
                             "indexes with 32-bit ints")
        if n == 0:
            continue
        wp, op, pp = wf.data_ptr(), om.data_ptr(), pn.data_ptr()
        cp, hp = codes.data_ptr(), w_hat.data_ptr()
        for i in range(torch.Size(lead).numel()):
            rows.append((wp + 4 * n * i, op + 16 * i, pp + 64 * i,
                         cp + n * i, hp + 4 * n * i, n))
    if rows:
        lib = build.load()
        stream = build.stream_handle(dev)
        for s in range(0, len(rows), MAX_SEGMENTS):
            chunk = rows[s:s + MAX_SEGMENTS]
            table = array.array("q", [v for row in chunk for v in row])
            build.check(lib.f4_ecl_quant_many(table.buffer_info()[0],
                                              len(chunk), stream),
                        "ecl_quant kernel")
            with build.COUNT_LOCK:
                LAUNCHES += 1
    return outs


def _aligned(wf: torch.Tensor) -> torch.Tensor:
    """``wf``, or a copy of it when it is a view at an offset the kernel
    cannot read (it reads w at its fresh outputs' 16-byte alignment)."""
    if wf.device.type == "meta":
        # a fresh allocation on the card is aligned: what decides is the
        # view's offset, which a meta tensor keeps
        off = wf.storage_offset() * wf.element_size()
    else:
        off = wf.data_ptr()
    return wf.clone() if off % 16 else wf


def _note_work(ws, omegas) -> None:
    """The group's launches and the kernel's work over it, by its
    contract: one launch per MAX_SEGMENTS segments with elements; per
    element 16 candidates of a subtract, a multiply, an add and a compare
    (``ELEM_FLOPS``), w read and the code and ŵ written (``ELEM_BYTES``);
    per segment its ω and penalty read (``SEGMENT_BYTES``)."""
    n = sum(w.numel() for w in ws)
    segs = sum(o.numel() // 4 for w, o in zip(ws, omegas) if w.numel())
    build.note_work("ecl_quant", -(-segs // MAX_SEGMENTS), ELEM_FLOPS * n,
                    ELEM_BYTES * n + SEGMENT_BYTES * segs)


def _meta_group(ws, omegas, pens) -> list:
    """The kernel path on the meta device: the same casts, copies and
    output allocations as :func:`_launch_group`, no values, and the
    launches' work reported, so a count on meta equals one on the card."""
    outs = []
    for w, omega, pen in zip(ws, omegas, pens):
        _check_group(w, omega, pen)
        wf = _aligned(_f32(w))
        _f32(omega), _f32(pen)
        outs.append((torch.empty_like(wf, dtype=torch.uint8),
                     torch.empty_like(wf)))
    _note_work(ws, omegas)
    return outs


def ecl_quant_many(ws: Sequence[torch.Tensor],
                   omegas: Sequence[torch.Tensor],
                   pens: Sequence[torch.Tensor]) -> list:
    """[(codes uint8, ŵ fp32) of each w's shape]: one kernel launch (per
    MAX_SEGMENTS segments) for CUDA tensors, the plain version per segment
    for CPU tensors.  w (R, C) takes ω (4,) and a penalty (16,); w (*lead,
    R, C) a batched ω (*lead, 4) and penalty (*lead, 16)."""
    if not (len(ws) == len(omegas) == len(pens)):
        raise ValueError(f"{len(ws)} tensors, {len(omegas)} omegas and "
                         f"{len(pens)} penalties")
    if not ws:
        return []
    kinds = {w.device.type for w in ws}
    if kinds == {"cuda"}:
        outs = _launch_group(ws, omegas, pens)
        if build.WORK_LISTENERS:
            _note_work(ws, omegas)
        return outs
    if kinds == {"meta"}:
        return _meta_group(ws, omegas, pens)
    if kinds == {"cpu"}:
        return [_plain_group(w, o, p) for w, o, p in zip(ws, omegas, pens)]
    raise ValueError(f"unsupported devices {sorted(kinds)}")


def ecl_quant_cuda(w: torch.Tensor, omega: torch.Tensor,
                   penalty: torch.Tensor) -> tuple:
    """Launch kernel 5 on w's device for one (R, C) tensor: a one-segment
    group; (codes uint8, ŵ fp32) of w's shape."""
    _check(w, omega, penalty)
    if w.device.type != "cuda":
        raise ValueError(f"the kernel needs a CUDA tensor, got {w.device}")
    return _launch_group([w], [omega.reshape(4)], [penalty.reshape(16)])[0]


def ecl_quant(w: torch.Tensor, omega: torch.Tensor,
              penalty: torch.Tensor) -> tuple:
    """w (R, C) -> (codes uint8, ŵ fp32): the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if w.device.type == "cuda":
        return ecl_quant_cuda(w, omega, penalty)
    if w.device.type != "cpu":
        raise ValueError(f"unsupported device {w.device}")
    return ecl_quant_plain(w, omega, penalty)
