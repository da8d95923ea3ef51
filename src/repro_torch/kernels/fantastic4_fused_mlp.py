"""Kernels 2-4: a whole FantastIC4 MLP stack in one launch.

Each CUDA kernel here (``csrc/fantastic4.cu``) replaces one Pallas
megakernel of the JAX package's ``kernels/fantastic4_fused_mlp.py``:

* **batch_tiled / db** (``tiled_kernel``) replaces
  ``fantastic4_fused_mlp_pallas`` (bodies ``_kernel``, ``_decode_tile``).
  One CTA per row tile walks every layer; the activation never leaves
  shared memory between layers (two ping-pong buffers of rows × D fp32).
  ``double_buffer`` ("db") splits each tile's two row groups over two CTAs,
  which traverse the stack concurrently on two SMs: what the TPU's skewed
  two-group schedule emulated inside one core.  Bound: FFMA issue at large
  batch, the packed bytes at small batch; every CTA re-decodes each layer's
  codes from L2, which is the price of keeping activations on chip.
* **ws** (``ws_kernel``) replaces ``fantastic4_fused_mlp_ws_pallas``
  (``_ws_kernel``).  The latency schedule for ≤ 8 rows: each layer's output
  columns are split across CTAs, so every code byte is read once per
  inference; the small activation ping-pongs between two global buffers
  (L2-resident) with a grid sync between layers (cooperative launch) —
  the TPU carried it across sequential grid steps instead.  Bound: the
  packed bytes and the L − 1 grid syncs.
* **stream** (``stream_kernel``) replaces
  ``fantastic4_fused_mlp_stream_pallas`` (``_stream_kernel``).  Every layer
  is decoded once per batch into an fp32 scratch in global memory by all
  CTAs, one grid sync, then each CTA walks its ``block_m``-row tiles
  through the stack reading decoded weights from L2.  The TPU version
  rewrote its whole-batch activation in place and relied on step (l, 0)
  decoding before tiles i > 0; here a tile's rows belong to one CTA and
  ping-pong between two global buffers.  Bound: L2 traffic of the decoded
  fp32 weights at large batch.

All three share ``layer_pass`` with kernel 1 (``csrc/fantastic4_common.cuh``),
so the port's int8 outputs are bitwise equal across schedules and the chain.

Fits.  The TPU budget (12 MiB VMEM, 128-wide padding) does not carry over.
These fits state the CUDA kernels' own shared memory against the 232,448
bytes a Hopper block may use: every kernel needs the core's staging tiles
(``CORE_SMEM_BYTES``); only batch_tiled/db add the two activation buffers,
``2 · rows · D · 4`` bytes (int8 activations are held as exact fp32 values,
so int8 needs no more).  ws and stream keep activations in global memory,
so their need does not grow with width or batch.  ``smem_budget_bytes=1``
fits nothing and forces the per-layer chain.  Dims are padded to even
(``DIM_ALIGN = 2``): the odd-K pack carries one zero code row, and padded
epilogue columns carry α₁ = b = 0, so they stay 0 through relu and int8.

Every wrapper launches its kernel for a CUDA tensor (or raises) and takes
the plain PyTorch version beside it for a CPU tensor.  ``LAUNCHES`` counts
kernel launches per schedule.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import build, ref
from .fantastic4_matmul import fantastic4_matmul_plain

SMEM_BUDGET_BYTES = 232448
# layer_pass staging: xs (32 x 32) + decoded W tile (32 x 64) + codebook, fp32
CORE_SMEM_BYTES = 4 * (32 * 32 + 32 * 64 + 16)
DIM_ALIGN = 2

LAUNCHES = {"batch_tiled": 0, "db": 0, "ws": 0, "stream": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_up(v: int, mult: int) -> int:
    return -(-max(v, 1) // mult) * mult


def padded_shapes(shapes: Sequence[Tuple[int, int]]
                  ) -> Tuple[Tuple[int, int], ...]:
    return tuple((_round_up(k, DIM_ALIGN), _round_up(n, DIM_ALIGN))
                 for k, n in shapes)


def stack_width(shapes: Sequence[Tuple[int, int]]) -> int:
    """Uniform width D of the stacked operands: the widest padded dim."""
    ps = padded_shapes(shapes)
    return max([ps[0][0]] + [n for _, n in ps])



def tile_rows(block_m: int, rows: Optional[int] = None,
              double_buffer: bool = False) -> Tuple[int, int]:
    """(rows per CTA, row groups) of the batch-tiled kernel: the tile is
    ``block_m`` rows (fewer for a smaller batch, in multiples of 8); db
    splits a tile of ≥ 16 rows into two row groups, one CTA each."""
    bm = block_m if rows is None else min(block_m, _round_up(rows, 8))
    halves = 2 if double_buffer and bm % 16 == 0 else 1
    return bm // halves, halves


def fused_mlp_smem_bytes(shapes, block_m: int = 32,
                         act_dtype: str = "float32",
                         double_buffer: bool = False) -> int:
    rows, _ = tile_rows(block_m, double_buffer=double_buffer)
    return CORE_SMEM_BYTES + 2 * 4 * rows * stack_width(shapes)


def fused_mlp_fits(shapes, *, block_m: int = 32,
                   smem_budget_bytes: int = SMEM_BUDGET_BYTES,
                   act_dtype: str = "float32",
                   double_buffer: bool = False) -> bool:
    if not shapes:
        return False
    return fused_mlp_smem_bytes(shapes, block_m, act_dtype,
                                double_buffer) <= smem_budget_bytes


def max_fused_block_m(shapes, *, smem_budget_bytes: int = SMEM_BUDGET_BYTES,
                      act_dtype: str = "float32",
                      cap: int = 256) -> Optional[int]:
    """Largest power-of-two row tile (8..cap) the batch-tiled kernel can
    hold in shared memory, or None when not even 8 rows fit."""
    best, bm = None, 8
    while bm <= cap:
        if fused_mlp_fits(shapes, block_m=bm,
                          smem_budget_bytes=smem_budget_bytes,
                          act_dtype=act_dtype):
            best = bm
        bm *= 2
    return best


def ws_mlp_smem_bytes(shapes, rows: int = 8,
                      act_dtype: str = "float32") -> int:
    return CORE_SMEM_BYTES


def ws_mlp_fits(shapes, *, rows: int = 8,
                smem_budget_bytes: int = SMEM_BUDGET_BYTES,
                act_dtype: str = "float32") -> bool:
    if not shapes:
        return False
    return ws_mlp_smem_bytes(shapes, rows, act_dtype) <= smem_budget_bytes


def stream_mlp_smem_bytes(shapes, rows: int, block_m: int = 8,
                          act_dtype: str = "float32") -> int:
    return CORE_SMEM_BYTES


def stream_mlp_fits(shapes, *, rows: int, block_m: int = 8,
                    smem_budget_bytes: int = SMEM_BUDGET_BYTES,
                    act_dtype: str = "float32") -> bool:
    if not shapes:
        return False
    return stream_mlp_smem_bytes(shapes, rows, block_m,
                                 act_dtype) <= smem_budget_bytes


# ------------------------------------------------------------ layer table

# mirrors f4::LayerDesc in csrc/fantastic4_common.cuh (80 bytes)
DESC_DTYPE = np.dtype({
    "names": ["packed", "alpha1", "bias", "wdec_off", "omega", "scale", "K",
              "N", "ldp", "act", "quant"],
    "formats": ["<u8", "<u8", "<u8", "<i8", ("<f4", (4,)), "<f4", "<i4",
                "<i4", "<i4", "<i4", "<i4"],
    "offsets": [0, 8, 16, 24, 32, 48, 52, 56, 60, 64, 68],
    "itemsize": 80})


class LayerTable:
    """The per-layer descriptors the fused kernels read, in device memory,
    plus strong references to every tensor they point into.  Build once per
    frozen pack (``ops`` memoizes it): building reads ω and the scales on
    the host."""

    def __init__(self, layers: Sequence[dict], device: torch.device):
        rows = np.zeros(len(layers), DESC_DTYPE)
        self.refs = []
        off = 0
        for i, l in enumerate(layers):
            for key in ("packed", "alpha1", "bias"):
                t = l[key]
                if t.device != device or not t.is_contiguous():
                    raise ValueError(f"layer {i} {key}: contiguous tensor "
                                     f"on {device} expected")
                self.refs.append(t)
                rows[key][i] = t.data_ptr()
            rows["wdec_off"][i] = off
            rows["omega"][i] = l["omega"]
            for key in ("scale", "K", "N", "ldp", "act", "quant"):
                rows[key][i] = l[key]
            off += l["K"] * l["N"]
        self.n_layers = len(layers)
        self.decoded_floats = off
        self.tensor = torch.from_numpy(rows.view(np.uint8).copy()).to(device)


def _host_floats(t) -> list:
    return [float(v) for v in torch.as_tensor(t).reshape(-1).tolist()]


def tiled_layer_table(packed, omega, alpha1, bias, scale, *, shapes,
                      activations, act_dtype: str) -> LayerTable:
    dev = packed[0].device
    n = len(shapes)
    layers = []
    for l, (k, nn) in enumerate(shapes):
        layers.append({
            "packed": packed[l].contiguous(),
            "alpha1": alpha1[l].to(torch.float32).reshape(-1).contiguous(),
            "bias": bias[l].to(torch.float32).reshape(-1).contiguous(),
            "omega": _host_floats(omega[l]),
            "scale": _host_floats(scale[l])[0],
            "K": 2 * packed[l].shape[0], "N": nn, "ldp": packed[l].shape[1],
            "act": ref.activation_code(activations[l]),
            "quant": int(act_dtype == "int8" and l < n - 1)})
    return LayerTable(layers, dev)


def stacked_layer_table(packed_stack, omega_stack, alpha1_stack, bias_stack,
                        meta_stack, *, shapes) -> LayerTable:
    dev = packed_stack.device
    d = packed_stack.shape[-1]
    meta = meta_stack.reshape(len(shapes), 4).tolist()
    om = omega_stack.reshape(len(shapes), 4).tolist()
    layers = []
    for l, (kp, np_) in enumerate(padded_shapes(shapes)):
        layers.append({
            "packed": packed_stack[l], "alpha1": alpha1_stack[l, 0],
            "bias": bias_stack[l, 0], "omega": om[l], "scale": meta[l][0],
            "K": kp, "N": shapes[l][1], "ldp": d,
            "act": int(round(meta[l][1])), "quant": int(meta[l][2] > 0)})
    return LayerTable(layers, dev)


def _check_x(x: torch.Tensor, shapes) -> None:
    if x.ndim != 2 or x.shape[1] != shapes[0][0]:
        raise ValueError(f"x must be (M, {shapes[0][0]}), got {tuple(x.shape)}")
    for l in range(1, len(shapes)):
        if shapes[l][0] != shapes[l - 1][1]:
            raise ValueError(f"layer dims do not chain: {shapes}")


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


# ------------------------------------------------------ batch-tiled / db

def fantastic4_fused_mlp_plain(x, packed, omega, alpha1, bias, scale, *,
                               shapes, activations, act_dtype="float32"
                               ) -> torch.Tensor:
    """The batch-tiled/db kernels' function in plain PyTorch: the layer
    loop with the fused epilogue (int8: re-quantize between layers)."""
    _check_x(x, shapes)
    n = len(shapes)
    y = x.to(torch.float32)
    for l, (k, _) in enumerate(shapes):
        if k % 2:
            y = torch.nn.functional.pad(y, (0, 1))
        quant = act_dtype == "int8" and l < n - 1
        y = fantastic4_matmul_plain(
            y, packed[l], omega[l], alpha1[l], bias[l],
            None if act_dtype == "int8" else scale[l],
            activation=activations[l], quant_scale=scale[l] if quant else None)
    return y


def fantastic4_fused_mlp(x, packed, omega, alpha1, bias, scale, *, shapes,
                         activations, act_dtype: str = "float32",
                         block_m: int = 32, double_buffer: bool = False,
                         table: Optional[LayerTable] = None) -> torch.Tensor:
    """x (M, K₀) through every layer in one launch -> (M, N_L) fp32.

    ``scale[l]`` is α₂ (fp32) or the int8 scale s_l (the last entry is a
    1.0 sentinel, logits stay float); in int8 mode the caller has folded
    s_{l−1} into ``alpha1[l]``.  ``table`` is the prebuilt layer table."""
    if act_dtype not in ("float32", "int8"):
        raise ValueError(f"act_dtype {act_dtype!r}")
    if _device_of(x) == "cpu":
        return fantastic4_fused_mlp_plain(x, packed, omega, alpha1, bias,
                                          scale, shapes=shapes,
                                          activations=activations,
                                          act_dtype=act_dtype)
    _check_x(x, shapes)
    if table is None:
        table = tiled_layer_table(packed, omega, alpha1, bias, scale,
                                  shapes=shapes, activations=activations,
                                  act_dtype=act_dtype)
    m, k0 = x.shape
    rows, halves = tile_rows(block_m, m, double_buffer)
    d = stack_width(shapes)
    if CORE_SMEM_BYTES + 8 * rows * d > SMEM_BUDGET_BYTES:
        raise ValueError(f"block_m={block_m} needs more shared memory than "
                         f"a block has (D={d})")
    xf = x.to(torch.float32).contiguous()
    y = torch.empty((m, shapes[-1][1]), dtype=torch.float32, device=x.device)
    err = build.load().f4_fused_tiled(
        xf.data_ptr(), m, k0, table.tensor.data_ptr(), table.n_layers, d,
        rows, y.data_ptr(), build.stream_handle(x.device))
    build.check(err, "fantastic4_fused_mlp kernel")
    LAUNCHES["db" if halves == 2 else "batch_tiled"] += 1
    return y


# ------------------------------------------------------ stacked operands

def _pad2(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(a, (0, cols - a.shape[1],
                                       0, rows - a.shape[0]))


def build_ws_operands(packed, omega, alpha1, bias, scale, *, shapes,
                      activations, act_dtype: str = "float32") -> tuple:
    """Stack per-layer operands into uniform-width arrays: ``(packed (L,
    D/2, D) u8, omega (L, 1, 4), alpha1 (L, 1, D), bias (L, 1, D), meta
    (L, 1, 4))`` with ``meta[l] = [scale_l, activation code, quant flag,
    0]``.  Once per frozen pack: the serving ops memoize it."""
    n = len(shapes)
    d = stack_width(shapes)
    dev = packed[0].device
    pk, om, a1, bi, me = [], [], [], [], []
    for l in range(n):
        pk.append(_pad2(packed[l], d // 2, d))
        om.append(omega[l].to(torch.float32).reshape(1, 4))
        a1.append(_pad2(alpha1[l].to(torch.float32).reshape(1, -1), 1, d))
        bi.append(_pad2(bias[l].to(torch.float32).reshape(1, -1), 1, d))
        quant = 1.0 if (act_dtype == "int8" and l < n - 1) else 0.0
        me.append(torch.tensor(
            [[_host_floats(scale[l])[0],
              float(ref.activation_code(activations[l])), quant, 0.0]],
            dtype=torch.float32, device=dev))
    return (torch.stack(pk).contiguous(), torch.stack(om).contiguous(),
            torch.stack(a1).contiguous(), torch.stack(bi).contiguous(),
            torch.stack(me).contiguous())


def _stacked_plain(x, packed_stack, omega_stack, alpha1_stack, bias_stack,
                   meta_stack, *, shapes, act_dtype) -> torch.Tensor:
    """Each layer on its true (even-padded) dims of the stacked operands,
    so the matmuls have the chain's shapes and the CPU plain schedules stay
    bitwise equal to each other on the int8 grid."""
    _check_x(x, shapes)
    d = packed_stack.shape[-1]
    act = _pad2(x.to(torch.float32), x.shape[0], d)
    for l, (kp, _) in enumerate(padded_shapes(shapes)):
        n = shapes[l][1]
        w = ref.decode_weights(packed_stack[l, :kp // 2, :n],
                               omega_stack[l, 0])
        y = act[:, :kp] @ w
        y = y * alpha1_stack[l, 0, :n] + bias_stack[l, 0, :n]
        y = ref.apply_activation_coded(y, meta_stack[l, 0, 1])
        s = meta_stack[l, 0, 0]
        if act_dtype == "int8":
            y = torch.where(meta_stack[l, 0, 2] > 0, ref.quantize_int8(y, s), y)
        else:
            y = y * s
        act = _pad2(y, y.shape[0], d)
    return act[:, :shapes[-1][1]]


def fantastic4_fused_mlp_ws_plain(x, packed_stack, omega_stack, alpha1_stack,
                                  bias_stack, meta_stack, *, shapes,
                                  act_dtype="float32") -> torch.Tensor:
    """The ws kernel's function in plain PyTorch (stacked operands)."""
    return _stacked_plain(x, packed_stack, omega_stack, alpha1_stack,
                          bias_stack, meta_stack, shapes=shapes,
                          act_dtype=act_dtype)


def fantastic4_fused_mlp_stream_plain(x, packed_stack, omega_stack,
                                      alpha1_stack, bias_stack, meta_stack, *,
                                      shapes, act_dtype="float32"
                                      ) -> torch.Tensor:
    """The stream kernel's function in plain PyTorch: rows are independent,
    so tiling the batch changes nothing."""
    return _stacked_plain(x, packed_stack, omega_stack, alpha1_stack,
                          bias_stack, meta_stack, shapes=shapes,
                          act_dtype=act_dtype)


def _stacked_launch(kind: str, x, stacked, shapes, act_dtype, block_m,
                    table: Optional[LayerTable]) -> torch.Tensor:
    _check_x(x, shapes)
    if table is None:
        table = stacked_layer_table(*stacked, shapes=shapes)
    m, k0 = x.shape
    d = stacked[0].shape[-1]
    dev = x.device
    xf = x.to(torch.float32).contiguous()
    y = torch.empty((m, shapes[-1][1]), dtype=torch.float32, device=dev)
    act = torch.empty(2 * m * d, dtype=torch.float32, device=dev)
    lib = build.load()
    if kind == "ws":
        err = lib.f4_fused_ws(xf.data_ptr(), m, k0, table.tensor.data_ptr(),
                              table.n_layers, d, act.data_ptr(), y.data_ptr(),
                              build.stream_handle(dev))
    else:
        wdec = torch.empty(table.decoded_floats, dtype=torch.float32,
                           device=dev)
        err = lib.f4_fused_stream(xf.data_ptr(), m, k0,
                                  table.tensor.data_ptr(), table.n_layers, d,
                                  block_m, act.data_ptr(), wdec.data_ptr(),
                                  y.data_ptr(), build.stream_handle(dev))
    build.check(err, f"fantastic4_fused_mlp_{kind} kernel")
    LAUNCHES[kind] += 1
    return y


def fantastic4_fused_mlp_ws(x, packed_stack, omega_stack, alpha1_stack,
                            bias_stack, meta_stack, *, shapes,
                            act_dtype: str = "float32",
                            table: Optional[LayerTable] = None
                            ) -> torch.Tensor:
    """Weight-stationary whole-stack serving from stacked operands."""
    stacked = (packed_stack, omega_stack, alpha1_stack, bias_stack,
               meta_stack)
    if _device_of(x) == "cpu":
        return fantastic4_fused_mlp_ws_plain(x, *stacked, shapes=shapes,
                                             act_dtype=act_dtype)
    return _stacked_launch("ws", x, stacked, shapes, act_dtype, 0, table)


def fantastic4_fused_mlp_stream(x, packed_stack, omega_stack, alpha1_stack,
                                bias_stack, meta_stack, *, shapes,
                                act_dtype: str = "float32", block_m: int = 8,
                                table: Optional[LayerTable] = None
                                ) -> torch.Tensor:
    """Decode-amortized streaming whole-stack serving, ``block_m``-row
    tiles, from stacked operands."""
    stacked = (packed_stack, omega_stack, alpha1_stack, bias_stack,
               meta_stack)
    if _device_of(x) == "cpu":
        return fantastic4_fused_mlp_stream_plain(x, *stacked, shapes=shapes,
                                                 act_dtype=act_dtype)
    if block_m < 1:
        raise ValueError(f"block_m must be >= 1, got {block_m}")
    return _stacked_launch("stream", x, stacked, shapes, act_dtype, block_m,
                           table)
