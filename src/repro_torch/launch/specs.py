"""Abstract inputs and states for the dry run and the step bundles: the
port of the JAX package's ``launch/specs.py``.

The reference's ``jax.ShapeDtypeStruct`` becomes a tensor on
``torch.device("meta")``: shape and dtype, no storage.  The inits take
``device="meta"`` (their draws become empty meta tensors,
``nn/layers.py`` ``draw``), so the full DeepSeek-V3 train state "builds"
in about a second without allocating.

Shape vocabulary (the reference's four cells):
  train_4k     -> train step  (B=256,  S=4096)
  prefill_32k  -> prefill     (B=32,   S=32768)
  decode_32k   -> decode step (B=128,  KV len 32768, one new token)
  long_500k    -> decode step (B=1,    KV len 524288) -- sub-quadratic archs
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ArchConfig
from ..models import whisper as W
from ..nn import transformer as T
from ..optim import ec4t
from ..tree import map_

META = torch.device("meta")

SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}


def shape_applicable(cfg: ArchConfig, shape_name: str) -> tuple:
    """(runs?, reason if skipped), the reference's rule."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: O(S) KV per token and "
                       "O(S^2) prefill at 524288 — skipped per assignment")
    return True, ""


def abstract(tree: Any) -> Any:
    """A tree with every tensor leaf replaced by a meta tensor of its shape
    and dtype (other leaves pass through)."""
    return map_(lambda l: torch.empty(l.shape, dtype=l.dtype, device=META)
                if isinstance(l, torch.Tensor) else l, tree)


# ------------------------------------------------------------ parameters

def abstract_params(cfg: ArchConfig) -> Any:
    if cfg.family == "audio":
        return W.whisper_init(cfg, device=META)
    return T.lm_init(cfg, device=META)


def abstract_train_state(cfg: ArchConfig) -> Any:
    return ec4t.init_train_state(abstract_params(cfg))


# ----------------------------------------------------------------- inputs

def _tok(b: int, s: int) -> torch.Tensor:
    return torch.empty((b, s), dtype=torch.int32, device=META)


def _emb(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.bfloat16, device=META)


def input_specs(cfg: ArchConfig, shape_name: str) -> dict:
    """Meta stand-ins for every model input of this cell (the whole
    batch; a rank's rows are cut from it)."""
    info = SHAPES[shape_name]
    b, s, kind = info["batch"], info["seq"], info["kind"]

    if kind == "train":
        if cfg.family == "audio":
            # stubbed conv frontend: precomputed frames; the decoder trains
            # on its own (<= 448) context
            tgt = min(s, W.MAX_TGT)
            return {"embeds": _emb(b, cfg.enc_len, cfg.d_model),
                    "tokens": _tok(b, tgt), "labels": _tok(b, tgt)}
        if cfg.family == "vlm":
            # stubbed vision frontend: patch embeddings in place of tokens
            return {"embeds": _emb(b, s, cfg.d_model), "labels": _tok(b, s)}
        return {"tokens": _tok(b, s), "labels": _tok(b, s)}

    if kind == "prefill":
        if cfg.family == "audio":
            return {"embeds": _emb(b, cfg.enc_len, cfg.d_model),
                    "tokens": _tok(b, min(s, W.MAX_TGT))}
        if cfg.family == "vlm":
            return {"embeds": _emb(b, s, cfg.d_model)}
        return {"tokens": _tok(b, s)}

    # decode: one new token against a seq-deep cache
    if cfg.family == "audio":
        hd = cfg.resolved_head_dim
        cross = (_emb(cfg.n_layers, b, cfg.enc_len, cfg.n_kv, hd),) * 2
        return {"tokens": _tok(b, 1), "positions": _tok(b, 1),
                "cache": W.init_dec_cache(cfg, b, W.MAX_TGT, device=META),
                "cross_kv": cross}
    out = {"tokens": _tok(b, 1), "positions": _tok(b, 1),
           "cache": T.init_cache(cfg, b, s, cap_window=True, device=META)}
    if cfg.family == "vlm":
        out["embeds"] = _emb(b, 1, cfg.d_model)
        del out["tokens"]
    return out
