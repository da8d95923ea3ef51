"""Kernel 5: fused ECL assignment + dequantization (the EC4T hot loop).

Replaces the JAX package's ``kernels/ecl_quant.py`` ``ecl_quant_pallas``
(body ``_kernel``).  For every element of w (R, C)

    code = argmin_c (w − v_c)² + pen_c,   ŵ = v_code,

over the 16 subset sums v_c of ω; ``penalty`` (16,) is the entropy term
λ·mean(w²)·(−log2 P) already computed.  Ties keep the lowest code.

On the H100 (``csrc/ecl_quant.cu`` ``ecl_quant_kernel``) one thread takes
one element in a grid-stride loop over the contiguous tensor, with the
codebook and penalty staged in shared memory.  What bounds it: bytes, 9
per element (read w, write the code and ŵ); at the MLP layer sizes a
launch takes a few microseconds, so launch latency dominates.  The cost
is rounded step by step (no FMA contraction), so codes and ŵ are bitwise
equal to :func:`ecl_quant_plain`.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`ecl_quant_plain`.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import build, ref

LAUNCHES = 0


def _check(w: torch.Tensor, omega: torch.Tensor,
           penalty: torch.Tensor) -> None:
    if w.ndim != 2:
        raise ValueError(f"w (R, C) expected, got {tuple(w.shape)}")
    if omega.numel() != 4 or penalty.numel() != 16:
        raise ValueError(f"omega (4,) and penalty (16,) expected, got "
                         f"{tuple(omega.shape)} and {tuple(penalty.shape)}")


def ecl_quant_plain(w: torch.Tensor, omega: torch.Tensor,
                    penalty: torch.Tensor) -> tuple:
    """The kernel's function in plain PyTorch: (codes uint8, ŵ fp32)."""
    _check(w, omega, penalty)
    return ref.ecl_quant_ref(w, omega.reshape(4), penalty.reshape(16))


def ecl_quant_cuda(w: torch.Tensor, omega: torch.Tensor,
                   penalty: torch.Tensor) -> tuple:
    """Launch kernel 5 on w's device; (codes uint8, ŵ fp32) of w's shape."""
    global LAUNCHES
    _check(w, omega, penalty)
    dev = w.device
    for name, t in (("omega", omega), ("penalty", penalty)):
        if t.device != dev:
            raise ValueError(f"{name} lives on {t.device}, w on {dev}")
    if w.numel() > 2**31 - 1:
        raise ValueError(f"w has {w.numel()} elements; the kernel indexes "
                         "with 32-bit ints")
    wf = w.to(torch.float32).contiguous()
    om = omega.to(torch.float32).reshape(4).contiguous()
    pen = penalty.to(torch.float32).reshape(16).contiguous()
    codes = torch.empty(wf.shape, dtype=torch.uint8, device=dev)
    w_hat = torch.empty(wf.shape, dtype=torch.float32, device=dev)
    lib = build.load()
    err = lib.f4_ecl_quant(wf.data_ptr(), om.data_ptr(), pen.data_ptr(),
                           wf.numel(), codes.data_ptr(), w_hat.data_ptr(),
                           build.stream_handle(dev))
    build.check(err, "ecl_quant kernel")
    LAUNCHES += 1
    return codes, w_hat


def ecl_quant(w: torch.Tensor, omega: torch.Tensor,
              penalty: torch.Tensor) -> tuple:
    """w (R, C) -> (codes uint8, ŵ fp32): the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if w.device.type == "cuda":
        return ecl_quant_cuda(w, omega, penalty)
    if w.device.type != "cpu":
        raise ValueError(f"unsupported device {w.device}")
    return ecl_quant_plain(w, omega, penalty)
