"""Kernels 2-4: a whole FantastIC4 MLP stack in one launch.

Each CUDA kernel here (``csrc/fantastic4.cu``) replaces one Pallas
megakernel of the JAX package's ``kernels/fantastic4_fused_mlp.py``:

* **batch_tiled / db** (``tiled_kernel``) replaces
  ``fantastic4_fused_mlp_pallas`` (bodies ``_kernel``, ``_decode_tile``).
  One thread-block cluster of ``CLUSTER`` CTAs per row tile of at most
  ``MAX_TILE_ROWS`` rows walks every layer; each CTA owns a column slice of
  every layer, and activations stay in the cluster's distributed shared
  memory (``csrc/fantastic4_cluster.cuh``).  Before each layer a CTA copies
  that layer's code slice into shared memory; ``double_buffer`` ("db")
  keeps two slice buffers and requests the next layer's slice before this
  layer's FMAs, the overlap the TPU's skewed two-group schedule bought.
  Below 16 rows db is the batch_tiled kernel.  Bound: FMA issue and the
  input's shared-memory loads on the cluster's SMs at 16-32 rows, the
  dependent FMA chain and the layer hand-offs at a few rows.
* **ws** (``ws_kernel``) replaces ``fantastic4_fused_mlp_ws_pallas``
  (``_ws_kernel``).  The latency schedule: one cluster per ``WS_TILE_ROWS``
  rows, each CTA holding its slice of the whole stack's codes (cut from
  the layers' true extents) in shared memory from launch, so every code
  byte is read from L2 once per cluster per inference.  Bound: the FMA
  chain and the L − 1 hand-offs of a layer's output between the CTAs.
* **stream** (``stream_kernel``) replaces
  ``fantastic4_fused_mlp_stream_pallas`` (``_stream_kernel``): layers
  outer, the whole batch per layer, as the TPU kernel, in one cooperative
  launch of at most the co-resident CTAs.  Per layer each CTA takes a
  (column slice of ≤ ``SLICE_COLS`` = 16 columns, group of ``block_m``-row
  tiles) work item, copies the slice's codes into shared memory once and
  serves each of its tiles from that copy: each code byte is read from L2
  once per CTA per layer, the GPU form of "decoded once per batch".
  Activations ping-pong between two global buffers that stay in L2, with
  one grid barrier per layer boundary.  Bound: the FFMA chain and the
  L − 1 barriers at a few rows, instruction issue at many (an 8-row tile
  gives each thread one output, so a decoded weight feeds one FFMA).

Every kernel computes each output as one accumulator from 0 over
ascending k with the same codebook and epilogue as kernel 1 (the shared
``slice_pass``), so the port's int8 outputs are bitwise equal across
schedules and the chain.

Code slices.  The kernels read codes from a slice-major device copy built
once per pack (``LayerTable.codes``, layout in ``kernels/slices.py``): for
the cluster kernels one slice per rank of the cluster, the packed columns
``[r·W_l, (r+1)·W_l)`` with ``W_l = ceil(n_l / CLUSTER)`` (``n_l`` the
even-padded width, the last layer's true width); for stream slices of at
most ``SLICE_COLS`` columns.  One bulk copy fetches a slice whatever the
pack's row stride.

Fits.  The TPU budget (12 MiB VMEM, 128-wide padding) does not carry over.
These fits state the CUDA kernels' own shared memory per CTA against the
232,448 bytes a Hopper block may use.  The cluster kernels need their
mbarriers, a copy of the layer table, one 16-entry codebook per layer,
two input buffers of rows × ``input_stride`` fp32 (int8 activations are
held as exact fp32 values), and the code slices: one layer's for
batch_tiled, two for db, the whole stack's for ws
(``cluster_smem_bytes``).  stream keeps activations in
global memory and needs one row tile of ``input_stride`` fp32 (``block_m``
rows, fewer where the budget holds fewer: a wide input), two buffers of
its largest code slice, the layer table and one codebook
(``stream_mlp_smem_bytes``): below the batch_tiled and ws needs for the
paper MLPs, so a budget can bind stream alone.
``smem_budget_bytes=1`` fits nothing and forces the per-layer chain.  Dims
are padded to even (``DIM_ALIGN = 2``): the odd-K pack carries one zero
code row, and padded epilogue columns carry α₁ = b = 0, so they stay 0
through relu and int8.

Every wrapper launches its kernel for a CUDA tensor (or raises) and takes
the plain PyTorch version beside it for a CPU tensor.  ``LAUNCHES`` counts
kernel launches per schedule; ``LAST_LAUNCH`` keeps each schedule's last
launch shape (CTAs, cluster size or cooperative, dynamic shared memory).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import build, ref
from .fantastic4_matmul import (MAX_TILE_ROWS, SMEM_BUDGET_BYTES,
                                 fantastic4_matmul_plain, tile_stride)
from .slices import (SLICE_COLS, code_slices, round_up, slice_bytes,
                     slice_count, slice_width)

DIM_ALIGN = 2
CLUSTER = 8            # CTAs per cluster: the portable cluster size
WS_TILE_ROWS = 8       # rows per ws cluster
DESC_BYTES = 80        # one f4::LayerDesc

LAUNCHES = {"batch_tiled": 0, "db": 0, "ws": 0, "stream": 0}
LAST_LAUNCH: dict = {}

# stream launches made from different CUDA streams run one after the
# other on the device (:func:`cooperative_order`)
_COOP_LOCK = threading.Lock()
_COOP_LAST: dict = {}       # device index -> (stream, event of last launch)


def reset_launches() -> None:
    with build.COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def padded_shapes(shapes: Sequence[Tuple[int, int]]
                  ) -> Tuple[Tuple[int, int], ...]:
    return tuple((round_up(k, DIM_ALIGN), round_up(n, DIM_ALIGN))
                 for k, n in shapes)


def stack_width(shapes: Sequence[Tuple[int, int]]) -> int:
    """Uniform width D of the stacked operands: the widest padded dim."""
    ps = padded_shapes(shapes)
    return max([ps[0][0]] + [n for _, n in ps])


# ------------------------------------------------------------ code slices

def output_width(n: int, last: bool) -> int:
    """Columns a layer writes: the even-padded width, the last layer's
    true width."""
    return n if last else round_up(n, DIM_ALIGN)


def stack_slice_bytes(shapes, cluster: int = CLUSTER) -> Tuple[int, ...]:
    """Bytes of one slice per layer: one rank's of a ``cluster``-CTA
    cluster, or with ``cluster=0`` a stream slice of ≤ ``SLICE_COLS``
    columns."""
    return _stack_layout(_shape_key(shapes), cluster)[1]


def layer_slices(n_end: int, cluster: int) -> int:
    """Slices a layer is cut into: one per rank of a ``cluster``-CTA
    cluster, or (``cluster=0``) stream slices of at most ``SLICE_COLS``
    columns."""
    return cluster if cluster else slice_count(n_end, SLICE_COLS)


def _shape_key(shapes) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(k), int(n)) for k, n in shapes)


@functools.lru_cache(maxsize=None)
def _stack_layout(shapes: Tuple[Tuple[int, int], ...], cluster: int
                  ) -> Tuple[int, Tuple[int, ...]]:
    """(input_stride, slice bytes per layer) of a stack, worked out once:
    the fits run on every served batch."""
    ps = padded_shapes(shapes)
    ld = tile_stride(max(kp for kp, _ in ps))
    n = len(shapes)
    ends = [output_width(shapes[l][1], l == n - 1) for l in range(n)]
    return ld, tuple(slice_bytes(kp, e, layer_slices(e, cluster))
                     for (kp, _), e in zip(ps, ends))


# ------------------------------------------------------------------- fits

def input_stride(shapes) -> int:
    """Row stride (floats) of the cluster kernels' input buffers and of
    the stream kernel's row tile: the widest layer input, a multiple of 4
    (float4 reads) whose quarter is odd (rows fall on different
    shared-memory banks)."""
    return _stack_layout(_shape_key(shapes), CLUSTER)[0]


def cluster_smem_bytes(n_layers: int, rows: int, ldx: int, code_region: int,
                       barriers: int) -> int:
    """Dynamic shared memory of one cluster CTA, as
    ``csrc/fantastic4_cluster.cuh::smem_bytes`` lays it out: ``barriers``
    for the code slices plus two for the input buffers."""
    return (round_up(8 * (barriers + 2), 16) + (DESC_BYTES + 64) * n_layers
            + 8 * rows * ldx + code_region)


def tile_rows(block_m: int, rows: Optional[int] = None,
              double_buffer: bool = False) -> Tuple[int, bool]:
    """(rows per cluster, db?) of the batch-tiled kernel: the tile is
    ``block_m`` rows capped at ``MAX_TILE_ROWS`` (fewer for a smaller
    batch, in multiples of 8); db needs a tile of ≥ 16 rows."""
    bm = min(block_m, MAX_TILE_ROWS)
    if rows is not None:
        bm = min(bm, round_up(rows, 8))
    return bm, double_buffer and bm >= 16


def fused_mlp_smem_bytes(shapes, block_m: int = 32,
                         act_dtype: str = "float32",
                         double_buffer: bool = False,
                         cluster: int = CLUSTER) -> int:
    rows, db = tile_rows(block_m, double_buffer=double_buffer)
    largest = max(stack_slice_bytes(shapes, cluster))
    return cluster_smem_bytes(len(shapes), rows, input_stride(shapes),
                              (2 if db else 1) * largest, 2 if db else 1)


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
    """Largest power-of-two row tile (8..min(cap, MAX_TILE_ROWS)) the
    batch-tiled kernel can hold in shared memory, or None when not even 8
    rows fit."""
    best, bm = None, 8
    while bm <= min(cap, MAX_TILE_ROWS):
        if fused_mlp_fits(shapes, block_m=bm,
                          smem_budget_bytes=smem_budget_bytes,
                          act_dtype=act_dtype):
            best = bm
        bm *= 2
    return best


def ws_mlp_smem_bytes(shapes, rows: int = 8, act_dtype: str = "float32",
                      cluster: int = CLUSTER) -> int:
    return cluster_smem_bytes(len(shapes), min(max(rows, 1), WS_TILE_ROWS),
                              input_stride(shapes),
                              sum(stack_slice_bytes(shapes, cluster)),
                              len(shapes))


def ws_mlp_fits(shapes, *, rows: int = 8,
                smem_budget_bytes: int = SMEM_BUDGET_BYTES,
                act_dtype: str = "float32") -> bool:
    if not shapes:
        return False
    return ws_mlp_smem_bytes(shapes, rows, act_dtype) <= smem_budget_bytes


def _stream_bytes(shapes, tile: int) -> int:
    """Shared memory of one stream CTA with ``tile``-row tiles, as
    ``csrc/fantastic4.cu`` lays it out: the current layer's codebook
    (static), then dynamically two mbarriers, a descriptor per layer, one
    row tile of ``input_stride`` fp32 and two buffers of the largest code
    slice (``stream_dyn_smem_bytes``)."""
    return (16 + 64 + DESC_BYTES * len(shapes)
            + 4 * tile * input_stride(shapes)
            + 2 * max(stack_slice_bytes(shapes, 0)))


def stream_tile_rows(shapes, rows: int, block_m: int = 8,
                     smem_budget_bytes: int = SMEM_BUDGET_BYTES) -> int:
    """Rows per stream tile: ``block_m`` capped at ``MAX_TILE_ROWS`` and at
    the batch, and cut to the most rows whose CTA fits
    ``smem_budget_bytes`` (a wide input: fewer rows a tile); 0 when not
    even one row fits."""
    want = max(1, min(block_m, MAX_TILE_ROWS, rows))
    room = smem_budget_bytes - _stream_bytes(shapes, 0)
    return max(0, min(want, room // (4 * input_stride(shapes))))


def stream_mlp_smem_bytes(shapes, rows: int, block_m: int = 8,
                          act_dtype: str = "float32") -> int:
    """Shared memory of one stream CTA at the tile
    :func:`stream_tile_rows` picks for a whole block (at least one row)."""
    return _stream_bytes(shapes, max(1, stream_tile_rows(shapes, rows,
                                                         block_m)))


def stream_mlp_fits(shapes, *, rows: int, block_m: int = 8,
                    smem_budget_bytes: int = SMEM_BUDGET_BYTES,
                    act_dtype: str = "float32") -> bool:
    if not shapes:
        return False
    return stream_tile_rows(shapes, rows, block_m, smem_budget_bytes) >= 1


# ------------------------------------------------------------ layer table

# mirrors f4::LayerDesc in csrc/fantastic4_common.cuh (DESC_BYTES)
DESC_DTYPE = np.dtype({
    "names": ["packed", "alpha1", "bias", "n_slices", "slice_w", "omega",
              "scale", "K", "N", "ldp", "act", "quant", "slice_off",
              "slice_bytes"],
    "formats": ["<u8", "<u8", "<u8", "<i4", "<i4", ("<f4", (4,)), "<f4",
                "<i4", "<i4", "<i4", "<i4", "<i4", "<i4", "<i4"],
    "offsets": [0, 8, 16, 24, 28, 32, 48, 52, 56, 60, 64, 68, 72, 76],
    "itemsize": DESC_BYTES})


class LayerTable:
    """The per-layer descriptors the fused kernels read, in device memory,
    the slice-major copy of the codes they read (``codes``: every layer's
    slices, layer after layer -- ``cluster`` per layer for the cluster
    kernels, slices of ≤ ``SLICE_COLS`` columns for stream with
    ``cluster=0``), and strong references to every tensor they point into.
    Build once per frozen pack (``ops`` memoizes it): building reads ω and
    the scales on the host."""

    def __init__(self, layers: Sequence[dict], device: torch.device,
                 cluster: int = CLUSTER):
        rows = np.zeros(len(layers), DESC_DTYPE)
        self.refs = []
        slices = []
        code_off = 0
        for i, l in enumerate(layers):
            for key in ("packed", "alpha1", "bias"):
                t = l[key]
                if t.device != device or not t.is_contiguous():
                    raise ValueError(f"layer {i} {key}: contiguous tensor "
                                     f"on {device} expected")
                self.refs.append(t)
                rows[key][i] = t.data_ptr()
            rows["omega"][i] = l["omega"]
            for key in ("scale", "K", "N", "ldp", "act", "quant"):
                rows[key][i] = l[key]
            n_end = output_width(l["N"], i == len(layers) - 1)
            n_sl = layer_slices(n_end, cluster)
            sl = code_slices(l["packed"], l["K"], l["N"], n_end, n_sl)
            rows["n_slices"][i] = n_sl
            rows["slice_w"][i] = slice_width(n_end, n_sl)
            rows["slice_off"][i] = code_off
            rows["slice_bytes"][i] = sl.shape[1]
            code_off += sl.numel()
            slices.append(sl.reshape(-1))
        self.n_layers = len(layers)
        self.cluster = cluster
        self.n_slices = tuple(int(v) for v in rows["n_slices"])
        self.slice_bytes = tuple(int(b) for b in rows["slice_bytes"])
        self.codes = torch.cat(slices).contiguous()
        self.tensor = torch.from_numpy(rows.view(np.uint8).copy()).to(device)
        # what a launch reads: the descriptors (ω and the scale by value),
        # the code copy, and each layer's α₁ and bias through its pointers
        self.reads = (self.tensor, self.codes,
                      *(l[k] for l in layers for k in ("alpha1", "bias")))


def _host_floats(t) -> list:
    return [float(v) for v in torch.as_tensor(t).reshape(-1).tolist()]


def tiled_layer_table(packed, omega, alpha1, bias, scale, *, shapes,
                      activations, act_dtype: str,
                      cluster: int = CLUSTER) -> LayerTable:
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
    return LayerTable(layers, dev, cluster)


def stacked_layer_table(packed_stack, omega_stack, alpha1_stack, bias_stack,
                        meta_stack, *, shapes,
                        cluster: int = CLUSTER) -> LayerTable:
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
    return LayerTable(layers, dev, cluster)


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
    s_{l−1} into ``alpha1[l]``.  ``table`` is the prebuilt layer table
    (it fixes the cluster size; ``CLUSTER`` when it is built here)."""
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
    rows, db = tile_rows(block_m, x.shape[0], double_buffer)
    return _cluster_launch("db" if db else "batch_tiled", x, table, shapes,
                           rows)


def _cluster_launch(kind: str, x: torch.Tensor, table: LayerTable, shapes,
                    rows: int) -> torch.Tensor:
    """One cluster of ``table.cluster`` CTAs per ``rows``-row tile; the
    kernel refuses (and this raises) a configuration the card cannot hold."""
    m, k0 = x.shape
    ldx = input_stride(shapes)
    sb = table.slice_bytes
    bars = {"ws": len(sb), "db": 2}.get(kind, 1)
    region = sum(sb) if kind == "ws" else bars * max(sb)
    smem = cluster_smem_bytes(len(sb), rows, ldx, region, bars)
    if smem > SMEM_BUDGET_BYTES:
        raise ValueError(f"{kind}: {rows}-row tile needs {smem} bytes of "
                         f"shared memory, a block has {SMEM_BUDGET_BYTES}")
    xf = x.to(torch.float32).contiguous()
    if xf.data_ptr() % 16:
        xf = xf.clone()    # rows are read as float4
    y = torch.empty((m, shapes[-1][1]), dtype=torch.float32, device=x.device)
    lib = build.load()
    args = (xf.data_ptr(), m, k0, table.tensor.data_ptr(), table.n_layers,
            table.codes.data_ptr(), table.cluster, rows, ldx)
    stream = build.stream_handle(x.device)
    if kind == "ws":
        err = lib.f4_fused_ws(*args, region, y.data_ptr(), stream)
    else:
        err = lib.f4_fused_tiled(*args, max(sb), int(kind == "db"),
                                 y.data_ptr(), stream)
    build.check(err, f"fantastic4 {kind} cluster kernel")
    build.keep_for_stream((table.tensor, table.codes, xf, *table.refs),
                          x.device)
    with build.COUNT_LOCK:
        LAUNCHES[kind] += 1
    LAST_LAUNCH[kind] = {"rows": m, "ctas": -(-m // rows) * table.cluster,
                         "cluster": table.cluster, "rows_per_cluster": rows,
                         "smem_bytes": smem}
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


@contextlib.contextmanager
def cooperative_order(device):
    """Serialize stream launches across CUDA streams, behind a lock.

    A stream launch is one cooperative grid of up to every co-resident
    CTA.  The card does not run two full-width grids side by side: a
    second one in flight on another stream waits for the first to leave
    the SMs (measured on the H100 by ``chip_smoke.py`` phase 3c).  So the
    order is made explicit: under the lock, a launch waits for the event
    of the previous launch when that one ran on another stream, and a
    launch on a stream other than the default records its own.  A launch
    on the default stream records nothing, so single-stream serving pays
    for no event."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _COOP_LOCK:
        cur = torch.cuda.current_stream(device)
        prev = _COOP_LAST.pop(index, None)
        if prev is not None and prev[0] != cur:
            cur.wait_event(prev[1])
        yield
        if cur != torch.cuda.default_stream(device):
            ev = torch.cuda.Event()
            ev.record(cur)
            _COOP_LAST[index] = (cur, ev)


def _stream_launch(x, shapes, block_m, table: LayerTable,
                   smem_budget_bytes: int) -> torch.Tensor:
    """One cooperative launch, in order with those of other CUDA streams
    (:func:`cooperative_order`)."""
    with cooperative_order(x.device):
        return _stream_kernel(x, shapes, block_m, table, smem_budget_bytes)


def _stream_kernel(x, shapes, block_m, table: LayerTable,
                   smem_budget_bytes: int) -> torch.Tensor:
    """One cooperative launch; the card sizes the grid (at most the
    co-resident CTAs) and refuses (this raises) what it cannot hold."""
    m, k0 = x.shape
    dev = x.device
    rows = stream_tile_rows(shapes, m, block_m, smem_budget_bytes)
    if rows < 1:
        raise ValueError(f"stream: a 1-row tile needs "
                         f"{_stream_bytes(shapes, 1)} bytes of shared "
                         f"memory, the budget is {smem_budget_bytes}")
    smem = _stream_bytes(shapes, rows)
    xf = x.to(torch.float32).contiguous()
    if xf.data_ptr() % 16:
        xf = xf.clone()    # rows are read as float4
    n = len(shapes)
    # activation rows 16-byte aligned: the tiles are staged as float4
    lda = round_up(max([2] + [nn for _, nn in shapes[:-1]]), 4)
    y = torch.empty((m, shapes[-1][1]), dtype=torch.float32, device=dev)
    # two activation buffers, then the grid barrier's counter (the kernel's
    # entry zeroes it)
    act = torch.empty(2 * m * lda + 4, dtype=torch.float32, device=dev)
    ctas = ctypes.c_int(0)
    # CTAs past the most work items a layer has would only idle
    want = max(table.n_slices) * -(-m // rows)
    lib = build.load()
    err = lib.f4_fused_stream(
        xf.data_ptr(), m, k0, table.tensor.data_ptr(), n,
        table.codes.data_ptr(), rows, input_stride(shapes), lda,
        max(table.slice_bytes), want, act.data_ptr(),
        act.data_ptr() + 4 * 2 * m * lda, y.data_ptr(),
        ctypes.byref(ctas), build.stream_handle(dev))
    build.check(err, "fantastic4_fused_mlp_stream kernel")
    build.keep_for_stream((table.tensor, table.codes, xf, *table.refs), dev)
    with build.COUNT_LOCK:
        LAUNCHES["stream"] += 1
    LAST_LAUNCH["stream"] = {"rows": m, "ctas": ctas.value,
                             "cooperative": True, "rows_per_tile": rows,
                             "smem_bytes": smem}
    return y


def fantastic4_fused_mlp_ws(x, packed_stack, omega_stack, alpha1_stack,
                            bias_stack, meta_stack, *, shapes,
                            act_dtype: str = "float32",
                            table: Optional[LayerTable] = None
                            ) -> torch.Tensor:
    """Weight-stationary whole-stack serving from stacked operands, one
    cluster per ``WS_TILE_ROWS`` rows (``table`` fixes the cluster size)."""
    stacked = (packed_stack, omega_stack, alpha1_stack, bias_stack,
               meta_stack)
    if _device_of(x) == "cpu":
        return fantastic4_fused_mlp_ws_plain(x, *stacked, shapes=shapes,
                                             act_dtype=act_dtype)
    _check_x(x, shapes)
    if table is None:
        table = stacked_layer_table(*stacked, shapes=shapes)
    return _cluster_launch("ws", x, table, shapes,
                           max(1, min(x.shape[0], WS_TILE_ROWS)))


def fantastic4_fused_mlp_stream(x, packed_stack, omega_stack, alpha1_stack,
                                bias_stack, meta_stack, *, shapes,
                                act_dtype: str = "float32", block_m: int = 8,
                                table: Optional[LayerTable] = None,
                                smem_budget_bytes: int = SMEM_BUDGET_BYTES
                                ) -> torch.Tensor:
    """Layers-outer streaming whole-stack serving, tiles of ``block_m``
    rows or as many as ``smem_budget_bytes`` holds, from stacked operands
    (``table``: built with ``cluster=0``, stream slices)."""
    stacked = (packed_stack, omega_stack, alpha1_stack, bias_stack,
               meta_stack)
    if _device_of(x) == "cpu":
        return fantastic4_fused_mlp_stream_plain(x, *stacked, shapes=shapes,
                                                 act_dtype=act_dtype)
    if block_m < 1:
        raise ValueError(f"block_m must be >= 1, got {block_m}")
    _check_x(x, shapes)
    if table is None:
        table = stacked_layer_table(*stacked, shapes=shapes, cluster=0)
    if table.cluster != 0:
        raise ValueError("stream needs a table of stream slices (cluster=0)")
    return _stream_launch(x, shapes, block_m, table, smem_budget_bytes)
