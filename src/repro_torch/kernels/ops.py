"""Kernel ops: the serving chain and fused dispatch over frozen packs, and
the fused ECL assign + dequantize of EC4T training.

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
from . import autotune, build, ref, staged
from .ecl_quant import ecl_quant as _ecl_quant
from .ecl_quant import ecl_quant_many as _ecl_quant_many
from .fantastic4_fused_mlp import (CLUSTER, SMEM_BUDGET_BYTES,
                                   build_ws_operands,
                                   fantastic4_fused_mlp,
                                   fantastic4_fused_mlp_stream,
                                   fantastic4_fused_mlp_ws, fused_mlp_fits,
                                   max_fused_block_m, stacked_layer_table,
                                   stream_mlp_fits, tiled_layer_table,
                                   ws_mlp_fits)
from .fantastic4_matmul import fantastic4_matmul as _matmul
from .fantastic4_matmul import forget_operands as _forget_chain_operands
from .fantastic4_matmul import staged_operands as _chain_staged


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
# (frozen packs are never mutated in place, see repro_torch.memo).  Each
# build is waited for (``build.publish``) before it is memoized: a stream
# worker other than the one that built it may read it next.  Each is
# sealed when it is built (``staged.Staged``), and a launch notes the
# sealed copies it reads, so the integrity guard checks what the kernels
# read and not only the pack they were built from.
_INT8_FOLD_MEMO = IdentityMemo()
_WS_OPERAND_MEMO = IdentityMemo()
_TABLE_MEMO = IdentityMemo()
# Layer lists whose owner keeps their operands for its own lifetime: their
# entries are pinned (exempt from the memos' eviction) until the owner
# releases them (unpin_pack_operands).
_PINNED = IdentityMemo()


def pin_pack_operands(layers: Sequence[dict]) -> None:
    """Pin every operand built from ``layers``, now or after a
    :func:`forget_pack_operands`, until :func:`unpin_pack_operands`: for
    an owner that holds more packs than the memos keep (an LM program's
    block packs)."""
    _PINNED.put((layers,), (), True, pin=True)


def unpin_pack_operands(layers: Sequence[dict]) -> None:
    """Release :func:`pin_pack_operands`' pin and drop the operands."""
    _PINNED.drop(layers)
    forget_pack_operands(layers)


def _pinned(layers: Sequence[dict]) -> bool:
    return _PINNED.get((layers,)) is not MISS


def _int8_fold_entry(layers: Sequence[dict],
                     act_scales: Sequence[float]) -> tuple:
    """((alpha1s, scales), their seal, built by this call?)"""
    hit = _INT8_FOLD_MEMO.get((layers, act_scales))
    if hit is not MISS:
        return hit + (False,)
    # fold s_{l-1} into alpha1_l exactly as the chain does; the per-layer
    # scale carries s_l (final layer: sentinel 1.0, logits stay float)
    alpha1s = tuple(l["alpha1"] * (1.0 if i == 0 else act_scales[i - 1])
                    for i, l in enumerate(layers))
    scales = tuple(
        torch.tensor(act_scales[i] if i < len(layers) - 1 else 1.0,
                     dtype=torch.float32, device=l["alpha1"].device)
        for i, l in enumerate(layers))
    build.publish(layers[0]["alpha1"].device)
    entry = ((alpha1s, scales),
             staged.Staged("folded int8 epilogue", alpha1s + scales))
    _INT8_FOLD_MEMO.put((layers, act_scales), (), entry,
                        pin=_pinned(layers))
    return entry + (True,)


def _epilogue_entry(layers, act_dtype, act_scales) -> tuple:
    """((alpha1s, scales), their sealed copy or None, built by this
    call?)."""
    if act_dtype == "int8":
        return _int8_fold_entry(layers, act_scales)
    return ((tuple(l["alpha1"] for l in layers),
             tuple(l["alpha2"] for l in layers)), None, False)


def _epilogue_operands(layers, act_dtype, act_scales) -> tuple:
    return _epilogue_entry(layers, act_dtype, act_scales)[0]


def _ws_entry(layers: Sequence[dict], act_dtype: str,
              act_scales: Optional[Sequence[float]]) -> tuple:
    """(stacked operands, their seal, built by this call?)"""
    hit = _WS_OPERAND_MEMO.get((layers, act_scales), (act_dtype,))
    if hit is not MISS:
        return hit + (False,)
    (alpha1s, scales), fold, fresh = _epilogue_entry(layers, act_dtype,
                                                     act_scales)
    if not fresh:
        staged.require_intact(fold)
    stacked = build_ws_operands(
        tuple(l["packed"] for l in layers), tuple(l["omega"] for l in layers),
        alpha1s, tuple(l["bias"] for l in layers), scales,
        shapes=tuple(tuple(l["shape"]) for l in layers),
        activations=tuple(l.get("activation") for l in layers),
        act_dtype=act_dtype)
    build.publish(stacked[0].device)
    entry = (stacked, staged.Staged("stacked operands", stacked,
                                    codes=stacked[0]))
    _WS_OPERAND_MEMO.put((layers, act_scales), (act_dtype,), entry,
                         pin=_pinned(layers))
    return entry + (True,)


def _ws_stacked_operands(layers: Sequence[dict], act_dtype: str,
                         act_scales: Optional[Sequence[float]]) -> tuple:
    return _ws_entry(layers, act_dtype, act_scales)[0]


def _layer_table(layers, act_dtype, act_scales, kind: str):
    """The fused kernels' device layer table, built once per pack: ``kind``
    "tiled" (batch_tiled/db), "stacked" (ws) or "stream".  Its
    ``staged`` is the sealed copy of what a launch reads."""
    hit = _TABLE_MEMO.get((layers, act_scales), (act_dtype, kind))
    if hit is not MISS:
        return hit
    shapes = tuple(tuple(l["shape"]) for l in layers)
    # a parent copy built by this call was sealed just now; an older one
    # is checked against its seal before anything is built from it
    if kind in ("stacked", "stream"):
        stacked, parent, fresh = _ws_entry(layers, act_dtype, act_scales)
        if not fresh:
            staged.require_intact(parent)
        table = stacked_layer_table(
            *stacked, shapes=shapes,
            cluster=0 if kind == "stream" else CLUSTER)
    else:
        (alpha1s, scales), parent, fresh = _epilogue_entry(
            layers, act_dtype, act_scales)
        if not fresh:
            staged.require_intact(parent)
        table = tiled_layer_table(
            tuple(l["packed"] for l in layers),
            tuple(l["omega"] for l in layers), alpha1s,
            tuple(l["bias"] for l in layers), scales, shapes=shapes,
            activations=tuple(l.get("activation") for l in layers),
            act_dtype=act_dtype)
    build.publish(table.codes.device)
    table.staged = staged.Staged(f"{kind} layer table", table.reads,
                                 codes=table.codes)
    _TABLE_MEMO.put((layers, act_scales), (act_dtype, kind), table,
                    pin=_pinned(layers))
    return table


def forget_pack_operands(layers: Sequence[dict]) -> int:
    """Drop every cached operand keyed on ``layers`` (and the chain's code
    copies of its layers); returns how many.  A pin stays: what is built
    next from ``layers`` is pinned again."""
    return (_INT8_FOLD_MEMO.drop(layers) + _WS_OPERAND_MEMO.drop(layers)
            + _TABLE_MEMO.drop(layers)
            + sum(_forget_chain_operands(l["packed"]) for l in layers))


def staged_operands(layers: Sequence[dict]) -> list:
    """Every sealed copy built from ``layers`` and memoized now: the layer
    tables, the stacked operands, the folded int8 epilogue and the chain's
    code copies of its layers."""
    out = [t.staged for t in _TABLE_MEMO.values(layers)]
    out += [e[1] for memo in (_WS_OPERAND_MEMO, _INT8_FOLD_MEMO)
            for e in memo.values(layers)]
    for l in layers:
        out += _chain_staged(l["packed"])
    return out


def pack_operand_bytes(layers: Sequence[dict]) -> int:
    """Device bytes the operand caches hold for ``layers`` beyond the
    layers' own tensors, each storage once and rounded up to the caching
    allocator's 512-byte blocks."""
    own = {l[k].untyped_storage().data_ptr() for l in layers
           for k in ("packed", "omega", "alpha1", "bias", "alpha2")
           if isinstance(l[k], torch.Tensor)}
    sizes = {}
    for s in staged_operands(layers):
        for t in s.tensors:
            st = t.untyped_storage()
            if st.data_ptr() not in own:
                sizes[st.data_ptr()] = st.nbytes()
    return sum(-(-n // 512) * 512 for n in sizes.values())


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
        # the table first: on a first launch it builds the stacked
        # operands it is built from, with no second look at their seal
        table = _layer_table(layers, act_dtype, scales_key,
                             "stacked" if schedule == "ws" else "stream") \
            if on_cuda else None
        stacked, sealed, _ = _ws_entry(layers, act_dtype, scales_key)
        staged.note(table.staged if on_cuda else sealed)
        if schedule == "ws":
            return fantastic4_fused_mlp_ws(x, *stacked, shapes=shapes,
                                           act_dtype=act_dtype, table=table)
        return fantastic4_fused_mlp_stream(
            x, *stacked, shapes=shapes, act_dtype=act_dtype, block_m=bm,
            table=table, smem_budget_bytes=smem_budget_bytes)

    db = schedule == "db"
    bm = block_m or max_fused_block_m(shapes,
                                      smem_budget_bytes=smem_budget_bytes,
                                      act_dtype=act_dtype)
    if bm is None or not fused_mlp_fits(shapes, block_m=bm,
                                        smem_budget_bytes=smem_budget_bytes,
                                        act_dtype=act_dtype,
                                        double_buffer=db):
        return chain()
    table = _layer_table(layers, act_dtype, scales_key, "tiled") \
        if on_cuda else None
    (alpha1s, scales), sealed, _ = _epilogue_entry(layers, act_dtype,
                                                   scales_key)
    if on_cuda or sealed is not None:
        staged.note(table.staged if on_cuda else sealed)
    return fantastic4_fused_mlp(
        x, tuple(l["packed"] for l in layers),
        tuple(l["omega"] for l in layers), alpha1s,
        tuple(l["bias"] for l in layers), scales, shapes=shapes,
        activations=activations, act_dtype=act_dtype, block_m=bm,
        double_buffer=db, table=table)


def ecl_quant(w: torch.Tensor, omega: torch.Tensor, penalty: torch.Tensor,
              use_kernel: bool = True) -> tuple:
    """Fused ECL assign + dequant: (codes uint8, ŵ fp32) of w's shape.

    omega (4,); penalty (16,) is λ·mean(w²)·(−log2 P), already computed.
    A 1-D w runs as one row; an N-D w as ``(w.shape[0], -1)``.
    """
    if not use_kernel:
        return ref.ecl_quant_ref(w, omega, penalty)
    codes, w_hat = _ecl_quant(_as_rows(w), omega, penalty)
    return codes.reshape(w.shape), w_hat.reshape(w.shape)


def _as_rows(w: torch.Tensor) -> torch.Tensor:
    if w.ndim == 2:
        return w
    return w[None, :] if w.ndim == 1 else w.reshape(w.shape[0], -1)


def ecl_quant_many(ws: Sequence[torch.Tensor],
                   omegas: Sequence[torch.Tensor],
                   penalties: Sequence[torch.Tensor]) -> list:
    """:func:`ecl_quant` over a list of tensors in one grouped launch:
    [(codes uint8, ŵ fp32) of each w's shape].  A w with an unbatched ω
    (4,) is reshaped as :func:`ecl_quant` does; a w (*lead, R, C) with a
    batched ω (*lead, 4) and penalty (*lead, 16) runs each leading index
    as a segment of its own."""
    rows = [w if om.ndim > 1 else _as_rows(w) for w, om in zip(ws, omegas)]
    return [(c, v) if r is w else (c.reshape(w.shape), v.reshape(w.shape))
            for w, r, (c, v) in
            zip(ws, rows, _ecl_quant_many(rows, omegas, penalties))]
