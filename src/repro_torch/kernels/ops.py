"""Serving ops over frozen packs: the per-layer chain and fused dispatch.

Mirrors the JAX package's ``kernels/ops.py``.  Each op runs where its input
tensor lies: a CUDA tensor goes through the hand-written kernels, a CPU
tensor through their plain PyTorch versions (the wrappers decide by device,
never by catching a failure).  ``use_kernel=False`` selects the plain
oracle on either device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..memo import MISS, IdentityMemo
from . import autotune, ref
from .fantastic4_fused_mlp import (SMEM_BUDGET_BYTES, build_ws_operands,
                                   fantastic4_fused_mlp,
                                   fantastic4_fused_mlp_stream,
                                   fantastic4_fused_mlp_ws, fused_mlp_fits,
                                   max_fused_block_m, stacked_layer_table,
                                   stream_mlp_fits, tiled_layer_table,
                                   ws_mlp_fits)
from .fantastic4_matmul import fantastic4_matmul as _matmul


def fantastic4_matmul(x: torch.Tensor, packed: torch.Tensor,
                      omega: torch.Tensor, bias=None, alpha1=None,
                      alpha2=None, activation: Optional[str] = None,
                      use_kernel: bool = True,
                      quant_scale: Optional[float] = None) -> torch.Tensor:
    """Quantized linear y = epilogue(x @ decode(packed, omega)).

    x (M, K); packed (K/2, N) uint8 row-pair packed; omega (4,); bias and
    alpha1 (N,) or None; alpha2 scalar or None.  ``quant_scale`` makes the
    epilogue emit the int8 grid clip(round(y / s), ±127) instead of ×α₂.
    """
    if not use_kernel:
        y = ref.fantastic4_matmul_ref(
            x, packed, omega, bias=bias, alpha1=alpha1,
            alpha2=None if quant_scale is not None else alpha2,
            activation=activation, out_dtype=torch.float32)
        if quant_scale is not None:
            y = ref.quantize_int8(y, quant_scale)
    else:
        y = _matmul(x, packed, omega, alpha1, bias, alpha2,
                    activation=activation, quant_scale=quant_scale)
    return y


def _pad_odd_k(x: torch.Tensor, layer: dict) -> torch.Tensor:
    # odd K: the pack carries one zero code row — mirror it on x
    if layer["shape"][0] % 2:
        return torch.nn.functional.pad(x, (0, 1))
    return x


def fantastic4_mlp_chain(x: torch.Tensor, layers: Sequence[dict], *,
                         use_kernel: bool = True) -> torch.Tensor:
    """Chained per-layer serving: the unfused path and every fused
    schedule's fallback past its fit."""
    for layer in layers:
        x = fantastic4_matmul(
            _pad_odd_k(x, layer), layer["packed"], layer["omega"],
            bias=layer["bias"], alpha1=layer["alpha1"],
            alpha2=layer["alpha2"], activation=layer.get("activation"),
            use_kernel=use_kernel)
    return x


def fantastic4_mlp_chain_int8(x: torch.Tensor, layers: Sequence[dict],
                              act_scales: Sequence[float], *,
                              use_kernel: bool = True) -> torch.Tensor:
    """Per-layer int8-activation chain (paper §VI-C): layer i emits
    clip(round(y / s_i), ±127) and layer i+1 folds s_i into its α₁ (the
    JAX package's ``ops.py:186-192`` expression).  The last layer returns
    float logits."""
    n = len(layers)
    xq = x.to(torch.float32)
    in_scale = 1.0
    for i, layer in enumerate(layers):
        xq = fantastic4_matmul(
            _pad_odd_k(xq, layer), layer["packed"], layer["omega"],
            bias=layer["bias"], alpha1=layer["alpha1"] * in_scale,
            alpha2=None, activation=layer.get("activation"),
            use_kernel=use_kernel,
            quant_scale=act_scales[i] if i < n - 1 else None)
        if i < n - 1:
            in_scale = act_scales[i]
    return xq


# Per-pack operand caches, keyed on the identity of the pack's layer list
# (frozen packs are never mutated in place, see repro_torch.memo).
_INT8_FOLD_MEMO = IdentityMemo()
_WS_OPERAND_MEMO = IdentityMemo()
_TABLE_MEMO = IdentityMemo()


def _int8_folded_operands(layers: Sequence[dict],
                          act_scales: Sequence[float]) -> tuple:
    hit = _INT8_FOLD_MEMO.get((layers, act_scales))
    if hit is not MISS:
        return hit
    # fold s_{l-1} into alpha1_l exactly as the chain does; the per-layer
    # scale carries s_l (final layer: sentinel 1.0, logits stay float)
    alpha1s = tuple(l["alpha1"] * (1.0 if i == 0 else act_scales[i - 1])
                    for i, l in enumerate(layers))
    scales = tuple(
        torch.tensor(act_scales[i] if i < len(layers) - 1 else 1.0,
                     dtype=torch.float32, device=l["alpha1"].device)
        for i, l in enumerate(layers))
    _INT8_FOLD_MEMO.put((layers, act_scales), (), (alpha1s, scales))
    return alpha1s, scales


def _epilogue_operands(layers, act_dtype, act_scales) -> tuple:
    if act_dtype == "int8":
        return _int8_folded_operands(layers, act_scales)
    return (tuple(l["alpha1"] for l in layers),
            tuple(l["alpha2"] for l in layers))


def _ws_stacked_operands(layers: Sequence[dict], act_dtype: str,
                         act_scales: Optional[Sequence[float]]) -> tuple:
    hit = _WS_OPERAND_MEMO.get((layers, act_scales), (act_dtype,))
    if hit is not MISS:
        return hit
    alpha1s, scales = _epilogue_operands(layers, act_dtype, act_scales)
    stacked = build_ws_operands(
        tuple(l["packed"] for l in layers), tuple(l["omega"] for l in layers),
        alpha1s, tuple(l["bias"] for l in layers), scales,
        shapes=tuple(tuple(l["shape"]) for l in layers),
        activations=tuple(l.get("activation") for l in layers),
        act_dtype=act_dtype)
    _WS_OPERAND_MEMO.put((layers, act_scales), (act_dtype,), stacked)
    return stacked


def _layer_table(layers, act_dtype, act_scales, kind: str):
    """The fused kernels' device layer table, built once per pack."""
    hit = _TABLE_MEMO.get((layers, act_scales), (act_dtype, kind))
    if hit is not MISS:
        return hit
    shapes = tuple(tuple(l["shape"]) for l in layers)
    if kind == "stacked":
        table = stacked_layer_table(
            *_ws_stacked_operands(layers, act_dtype, act_scales),
            shapes=shapes)
    else:
        alpha1s, scales = _epilogue_operands(layers, act_dtype, act_scales)
        table = tiled_layer_table(
            tuple(l["packed"] for l in layers),
            tuple(l["omega"] for l in layers), alpha1s,
            tuple(l["bias"] for l in layers), scales, shapes=shapes,
            activations=tuple(l.get("activation") for l in layers),
            act_dtype=act_dtype)
    _TABLE_MEMO.put((layers, act_scales), (act_dtype, kind), table)
    return table


def forget_pack_operands(layers: Sequence[dict]) -> int:
    """Drop every cached operand keyed on ``layers``; returns how many."""
    return (_INT8_FOLD_MEMO.drop(layers) + _WS_OPERAND_MEMO.drop(layers)
            + _TABLE_MEMO.drop(layers))


def fantastic4_mlp_fused(x: torch.Tensor, layers: Sequence[dict], *,
                         use_kernel: bool = True,
                         block_m: Optional[int] = None,
                         act_dtype: str = "float32",
                         act_scales: Optional[Sequence[float]] = None,
                         schedule: str = "batch_tiled",
                         smem_budget_bytes: int = SMEM_BUDGET_BYTES
                         ) -> torch.Tensor:
    """Whole-stack serving in one launch; ``schedule`` is one of
    ``batch_tiled`` (default), ``db``, ``ws`` or ``stream``.  Every
    schedule falls back to the per-layer chain past its shared-memory fit
    (``smem_budget_bytes=1`` always does)."""
    if schedule not in autotune.SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    if act_dtype == "int8" and (act_scales is None
                                or len(act_scales) < len(layers) - 1):
        raise ValueError("act_dtype='int8' needs act_scales with one entry "
                         "per layer boundary")
    shapes = tuple(tuple(l["shape"]) for l in layers)
    activations = tuple(l.get("activation") for l in layers)
    on_cuda = x.device.type == "cuda"
    scales_key = act_scales if act_dtype == "int8" else None

    def chain() -> torch.Tensor:
        if act_dtype == "int8":
            return fantastic4_mlp_chain_int8(x, layers, act_scales,
                                             use_kernel=use_kernel)
        return fantastic4_mlp_chain(x, layers, use_kernel=use_kernel)

    if not use_kernel:
        return chain()
    m = x.shape[0]
    if schedule in ("ws", "stream"):
        bm = block_m or 8
        fits = (ws_mlp_fits(shapes, rows=m, smem_budget_bytes=smem_budget_bytes,
                            act_dtype=act_dtype) if schedule == "ws" else
                stream_mlp_fits(shapes, rows=m, block_m=bm,
                                smem_budget_bytes=smem_budget_bytes,
                                act_dtype=act_dtype))
        if not fits:
            return chain()
        stacked = _ws_stacked_operands(layers, act_dtype, scales_key)
        table = _layer_table(layers, act_dtype, scales_key, "stacked") \
            if on_cuda else None
        if schedule == "ws":
            return fantastic4_fused_mlp_ws(x, *stacked, shapes=shapes,
                                           act_dtype=act_dtype, table=table)
        return fantastic4_fused_mlp_stream(x, *stacked, shapes=shapes,
                                           act_dtype=act_dtype, block_m=bm,
                                           table=table)

    db = schedule == "db"
    bm = block_m or max_fused_block_m(shapes,
                                      smem_budget_bytes=smem_budget_bytes,
                                      act_dtype=act_dtype)
    if bm is None or not fused_mlp_fits(shapes, block_m=bm,
                                        smem_budget_bytes=smem_budget_bytes,
                                        act_dtype=act_dtype,
                                        double_buffer=db):
        return chain()
    alpha1s, scales = _epilogue_operands(layers, act_dtype, scales_key)
    table = _layer_table(layers, act_dtype, scales_key, "tiled") \
        if on_cuda else None
    return fantastic4_fused_mlp(
        x, tuple(l["packed"] for l in layers),
        tuple(l["omega"] for l in layers), alpha1s,
        tuple(l["bias"] for l in layers), scales, shapes=shapes,
        activations=activations, act_dtype=act_dtype, block_m=bm,
        double_buffer=db, table=table)
