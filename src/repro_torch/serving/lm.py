"""LM block programs: serve a 4-bit frozen transformer through the engine
(the JAX package's ``serving/lm.py``).

The serving stack (micro-batcher, frontend, integrity guard) speaks
:class:`~repro_torch.serving.plans.ServableProgram`.  :class:`LMProgram`
is its second implementation after :class:`ExecutionPlan`: a two-phase
causal-LM program over a 4-bit frozen transformer.

Freezing (:func:`freeze_lm`) reuses the EC4T path: every FC-family
projection (attention q/k/v/o and the FFN matrices) becomes a packed
``{"packed", "omega"}`` leaf; embeddings, norms, biases and the lm head
stay fp32.

The program resolves **kernel-backed plans per block** for the FFN, built
from the *same packed codes* the frozen tree holds (unpacked on the
device, never through the host):

* ``act == "gelu"``   — one 2-layer chain plan per block (fc1 + gelu +
  fc2, biases folded into the §V epilogue);
* ``act == "swiglu"`` — three one-layer plans per block (gate, up,
  down), since each quantized leaf carries its own ω and a pack layer has
  exactly one; ``silu(g) * u`` runs between the plans in fp32, as
  :func:`repro_torch.nn.layers.swiglu` does.

Attention is plain PyTorch over the frozen leaves (``materialize``
decodes the packed q/k/v/o on every call; no decoded copy is kept), one
batched step over the lanes of a decode in place of the reference's
``jax.vmap`` over sequences: each lane keeps its own cache, positions and
length.

Two phases, one wire format.  A request row is

    [seq_id, n_tokens, tok_0 .. tok_{n-1}, 0-padding]      (d_in floats)

``n_tokens >= 1`` prefills a new sequence and emits its first token;
``n_tokens == 0`` advances an existing sequence one decode step.  The
output row is ``[token_id]`` (d_out == 1); token ids travel as float32,
exact below 2**24.  seq_id 0 marks bucket padding (output 0.0); unknown
or invalid rows answer -1.0 rather than failing the bucket.

A decode batch reaches the FFN as ``m = n_seqs`` rows, a prefill as
``m = s`` token rows; each plan binds those row counts to its kernel
schedules.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..configs.base import ArchConfig
from ..core import bitplanes, qat
from ..kernels import ops as kops
from ..nn import attention as attn
from ..nn import transformer as T
from ..nn.layers import linear, rope_cos_sin
from ..nn.module import FP32_CTX
from ..tree import leaves
from . import plans

__all__ = ["freeze_lm", "build_lm_program", "LMProgram"]


def _check_lm_supported(cfg: ArchConfig) -> None:
    """The LM program covers the dense-attention archs."""
    if cfg.family != "dense":
        raise ValueError(
            f"LMProgram serves dense-family archs only, got {cfg.family!r} "
            f"({cfg.name})")
    if cfg.mla is not None or cfg.encdec or cfg.global_attn_layers:
        raise ValueError(
            f"LMProgram does not support mla/encdec/mixed-attn archs "
            f"({cfg.name})")
    if cfg.act not in ("swiglu", "gelu"):
        raise ValueError(f"unsupported FFN act {cfg.act!r}")
    if not cfg.quantize:
        raise ValueError(
            "LMProgram serves 4-bit frozen trees; arch has quantize=False")


def freeze_lm(params: Any, qstate: Any, cfg: ArchConfig,
              lam: Optional[float] = None) -> Any:
    """Freeze a trained transformer for serving: every quantized leaf
    becomes a packed 4-bit ``{"packed", "omega"}`` dict (one grouped ECL
    assignment over the whole tree); embeddings, norms and biases stay
    fp32.  A checked wrapper over :func:`repro_torch.core.qat.freeze_tree`."""
    _check_lm_supported(cfg)
    return qat.freeze_tree(params, qstate, cfg.lam if lam is None else lam)


def _frozen_codes(leaf: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N) uint8 codes, unpacked where the leaf lies, and a (4,) ω of
    the pack's own."""
    if not qat.is_frozen_leaf(leaf):
        raise ValueError(
            "expected a frozen {'packed','omega'} leaf — freeze the tree "
            "with freeze_lm() before building an LMProgram")
    return (bitplanes.unpack_codes_rows(leaf["packed"]),
            leaf["omega"].to(torch.float32).clone())


def _host_or_none(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy().astype(np.float32)


def _lanes(caches: Sequence[dict]) -> dict:
    """Stack batch-1 sequence caches (stacked over blocks) into lanes:
    k, v (n, blocks, len, kv, hd), pos (n, blocks, len), len (n, blocks)."""
    return {"k": torch.stack([c["k"][:, 0] for c in caches]),
            "v": torch.stack([c["v"][:, 0] for c in caches]),
            "pos": torch.stack([c["pos"] for c in caches]),
            "len": torch.stack([c["len"] for c in caches])}


def _lane(lanes: dict, i: int) -> dict:
    """Lane ``i`` back as a batch-1 sequence cache."""
    return {"k": lanes["k"][i][:, None], "v": lanes["v"][i][:, None],
            "pos": lanes["pos"][i], "len": lanes["len"][i]}


class LMProgram:
    """ServableProgram serving greedy prefill/decode of a frozen 4-bit LM.

    Stateful: sequences live in the program between requests (seq_id ->
    its KV caches, position and last token, all on the program's device).
    ``rows_per_request = 1``: each wire row is one whole request.  The
    frozen tree must lie on ``device`` (default CUDA, raising without it).
    The kernel operands of its packs stay pinned until :meth:`forget`.
    """

    rows_per_request: int = 1

    def __init__(self, frozen: Any, cfg: ArchConfig, *,
                 max_prompt: int = 64, max_new: int = 64,
                 mode: str = "auto", max_bucket: int = 64,
                 block_m: Optional[int] = None, device=None):
        _check_lm_supported(cfg)
        if max_prompt < 1 or max_new < 1:
            raise ValueError("max_prompt and max_new must be >= 1")
        if max_prompt > max_bucket:
            raise ValueError(
                f"max_prompt ({max_prompt}) must fit the FFN bucket ceiling "
                f"({max_bucket}): a prefill reaches the FFN as one "
                "s-token row batch")
        self.device = resolve_device(device)
        for t in leaves(frozen):
            if isinstance(t, torch.Tensor) and \
                    t.device.type != self.device.type:
                raise ValueError(f"the frozen tree has a tensor on "
                                 f"{t.device}, the program runs on "
                                 f"{self.device}")
        self.cfg = cfg
        self.frozen = frozen
        self.max_prompt = int(max_prompt)
        self.max_new = int(max_new)
        self.cache_len = self.max_prompt + self.max_new
        if cfg.window is not None and self.cache_len < cfg.window:
            raise ValueError(
                f"KV cache ({self.cache_len}) shorter than the attention "
                f"window ({cfg.window})")

        # --- ServableProgram surface
        self.d_in = 2 + self.max_prompt
        self.d_out = 1
        self.bucket_sizes: Tuple[int, ...] = plans._pow2_buckets(max_bucket)

        # --- per-block frozen params: views of the L-stacked leaves
        stacks = frozen["stacks"]
        if set(stacks.keys()) != {"dense"}:
            raise ValueError(
                f"expected a pure dense stack, got {sorted(stacks)}")
        self._blocks: List[dict] = [T._layer(stacks["dense"], l)
                                    for l in range(cfg.n_layers)]
        self._table = frozen["embed"]["table"].to(torch.float32)
        self._rotary_dim = int(cfg.resolved_head_dim * cfg.rotary_frac)

        # --- FFN plans per block, built from the frozen leaves' own codes
        self._plan_kw = dict(mode=mode, act_dtype="float32",
                             max_bucket=max_bucket, block_m=block_m,
                             device=self.device)
        self._packs: List[dict] = []
        self._plans: List[Dict[str, plans.ExecutionPlan]] = []
        self.layers: List[dict] = []
        for l, blk in enumerate(self._blocks):
            self._plans.append(self._build_block_plans(l, blk["mlp"]))

        # --- per-sequence decode state
        self._states: Dict[int, dict] = {}
        self._next_sid = 1

    # ------------------------------------------------------------- plans

    def _make_plan(self, label: str, layers: List[dict]
                   ) -> plans.ExecutionPlan:
        pack = {"layers": layers, "name": label}
        self._packs.append(pack)
        # the program holds more packs than the operand memos keep: it
        # owns their operands until forget()
        kops.pin_pack_operands(layers)
        self.layers.extend(layers)
        return plans.build_plan(pack, **self._plan_kw)

    def _build_block_plans(self, l: int, mlp: dict
                           ) -> Dict[str, plans.ExecutionPlan]:
        # call-time import: models.mlp imports the serving package
        from ..models.mlp import freeze_dense_layer
        if self.cfg.act == "gelu":
            chain = []
            for name, act in (("fc1", "gelu"), ("fc2", None)):
                codes, omega = _frozen_codes(mlp[name]["kernel"])
                chain.append(freeze_dense_layer(
                    codes, omega, activation=act,
                    bias=_host_or_none(mlp[name].get("bias"))))
            return {"chain": self._make_plan(f"blk{l}.mlp", chain)}
        out = {}
        for name in ("gate", "up", "down"):
            codes, omega = _frozen_codes(mlp[name]["kernel"])
            layer = freeze_dense_layer(
                codes, omega, activation=None,
                bias=_host_or_none(mlp[name].get("bias")))
            out[name] = self._make_plan(f"blk{l}.{name}", [layer])
        return out

    def _ffn(self, l: int, h: torch.Tensor) -> torch.Tensor:
        pl = self._plans[l]
        if "chain" in pl:
            return pl["chain"].run(h)
        g = pl["gate"].run(h)
        u = pl["up"].run(h)
        inner = F.silu(g.to(torch.float32)).to(g.dtype) * u
        return pl["down"].run(inner)

    def staged_operands(self) -> list:
        """Every sealed copy the kernels read, memoized now, over the
        program's packs (what ``GuardedPlan.verify`` checks when no launch
        names them)."""
        return [s for pack in self._packs
                for s in kops.staged_operands(pack["layers"])]

    # ------------------------------------------------------------ forward

    def _fresh_cache(self) -> dict:
        """A sequence's batch-1 KV caches, stacked over blocks."""
        return T.init_cache(self.cfg, 1, self.cache_len, dtype=torch.float32,
                            device=self.device)["dense"]["attn"]

    def _attn(self, p: dict, h: torch.Tensor, pos: torch.Tensor,
              cos_sin: tuple, cache: dict) -> Tuple[torch.Tensor, dict]:
        """GQA over lanes: lane i is sequence i with its own cache (k, v
        (n, len, kv, hd), pos (n, len), len (n,)); it writes its entries at
        its own ``len % size``, as a batch-1 ``_cache_update`` would."""
        cfg = self.cfg
        n, s, _ = h.shape
        q, k, v = attn.gqa_project(p, 0, h, FP32_CTX, n_heads=cfg.n_heads,
                                   n_kv=cfg.n_kv,
                                   head_dim=cfg.resolved_head_dim,
                                   cos_sin=cos_sin)
        slots = attn.cache_slots(cache["len"], cache["k"].shape[1], s)
        lane = torch.arange(n, device=h.device)[:, None].expand(n, s)
        new = {"k": cache["k"].index_put((lane, slots), k),
               "v": cache["v"].index_put((lane, slots), v),
               "pos": cache["pos"].index_put((lane, slots),
                                             pos.to(torch.int32)),
               "len": cache["len"] + s}
        out = attn.softmax_attention(q, new["k"], new["v"], pos, new["pos"],
                                     causal=True, window=cfg.window,
                                     chunk=cfg.attn_chunk)
        y = linear(p["o"], 0, out.reshape(n, s, -1), FP32_CTX)
        return y, new

    def _run(self, tokens: torch.Tensor, positions: torch.Tensor,
             lanes: dict) -> Tuple[torch.Tensor, dict]:
        """One forward over ``n`` independent sequences.

        tokens, positions (n, S) on the device; ``lanes`` the sequences'
        caches (:func:`_lanes`).  Returns (logits (n, vocab) of the last
        position, new lanes).  The dense block math of ``T.lm_apply``,
        with the FFN through the per-block plans."""
        cfg = self.cfg
        n, s = tokens.shape
        x = self._table[tokens]                                # (n, S, d)
        cos_sin = rope_cos_sin(positions, self._rotary_dim, cfg.rope_theta,
                               dtype=torch.float32)
        new = {key: [] for key in lanes}
        for l, blk in enumerate(self._blocks):
            h = T._norm(cfg, blk["ln1"], x)
            ay, nc = self._attn(blk["attn"], h, positions, cos_sin,
                                {key: t[:, l] for key, t in lanes.items()})
            for key, t in nc.items():
                new[key].append(t)
            x = x + ay
            h2 = T._norm(cfg, blk["ln2"], x)
            f = self._ffn(l, h2.reshape(n * s, cfg.d_model))
            x = x + f.reshape(n, s, cfg.d_model).to(torch.float32)
        logits = T.readout(cfg, self.frozen, x[:, -1])[:, :cfg.vocab]
        return (logits,
                {key: torch.stack(ts, 1) for key, ts in new.items()})

    # ----------------------------------------------------- sequence state

    def _alloc_sid(self) -> int:
        sid = self._next_sid
        self._next_sid += 1
        return sid

    def _prefill_seq(self, sid: int, toks) -> Tuple[int, torch.Tensor]:
        """Start sequence ``sid``: (first token, its logits (vocab,))."""
        if sid in self._states:
            raise ValueError(f"seq {sid} already live")
        toks = np.asarray(toks, np.int64).reshape(-1)
        s = toks.shape[0]
        if not 1 <= s <= self.max_prompt:
            raise ValueError(
                f"prompt length {s} outside [1, {self.max_prompt}]")
        tok = torch.from_numpy(toks).to(self.device)[None]
        pos = torch.arange(s, dtype=torch.int32, device=self.device)[None]
        logits, new = self._run(tok, pos, _lanes([self._fresh_cache()]))
        nxt = torch.argmax(logits, dim=-1)
        self._states[sid] = {"cache": _lane(new, 0), "pos": s,
                             "last": nxt[0]}
        return int(nxt[0]), logits[0]

    def _decode_batch(self, sids: Sequence[int]
                      ) -> Tuple[List[int], torch.Tensor]:
        """One decode step of every sequence in ``sids``: (their next
        tokens, logits (len(sids), vocab))."""
        sts = [self._states[s] for s in sids]
        if self.cfg.window is None:
            for sid, st in zip(sids, sts):
                # a wrapped write would overwrite still-visible history
                if st["pos"] >= self.cache_len:
                    raise RuntimeError(
                        f"seq {sid} exhausted its KV cache "
                        f"({self.cache_len} slots); release it")
        n = len(sts)
        n_pad = 1
        while n_pad < n:
            n_pad *= 2
        padded = sts + [sts[0]] * (n_pad - n)   # lanes >= n are discarded
        tokens = torch.stack([st["last"] for st in padded])[:, None]
        pos = torch.tensor([[st["pos"]] for st in padded], dtype=torch.int32,
                           device=self.device)
        logits, new = self._run(tokens, pos,
                                _lanes([st["cache"] for st in padded]))
        nxt = torch.argmax(logits[:n], dim=-1)
        for i, st in enumerate(sts):
            st["cache"] = _lane(new, i)
            st["pos"] += 1
            st["last"] = nxt[i]
        return nxt.tolist(), logits[:n]

    # ------------------------------------------------------- public API

    def prefill(self, tokens, sid: Optional[int] = None) -> Tuple[int, int]:
        """Start a sequence: ingest the prompt, return (sid, first token)."""
        if sid is None:
            sid = self._alloc_sid()
        return int(sid), self._prefill_seq(int(sid), tokens)[0]

    def decode_step(self, sid: int) -> int:
        """Advance one sequence one token (greedy)."""
        if sid not in self._states:
            raise KeyError(f"unknown seq {sid}")
        return self._decode_batch([int(sid)])[0][0]

    def release(self, sid: int) -> None:
        self._states.pop(int(sid), None)

    @property
    def live_sequences(self) -> int:
        return len(self._states)

    def sequence_tensors(self) -> List[torch.Tensor]:
        """Every tensor of the live sequences' state (caches, last token)."""
        return [t for st in self._states.values()
                for t in leaves(st["cache"]) + [st["last"]]]

    def generate(self, prompts, max_new: int, return_logits: bool = False):
        """Direct greedy loop: prefill each row of ``prompts`` (B, S), then
        ``max_new - 1`` batched decode steps, through the same internals
        the engine path drives.  (B, max_new) int64 tokens, and with
        ``return_logits`` also each step's logits (B, max_new, vocab) on
        the device."""
        prompts = np.asarray(prompts)
        if prompts.ndim != 2:
            raise ValueError("prompts must be (B, S)")
        sids, firsts, first_logits = [], [], []
        for b in range(prompts.shape[0]):
            sid = self._alloc_sid()
            tok, lg = self._prefill_seq(sid, prompts[b])
            sids.append(sid)
            firsts.append(tok)
            first_logits.append(lg)
        outs, steps = [firsts], [torch.stack(first_logits)]
        for _ in range(max_new - 1):
            toks, lg = self._decode_batch(sids)
            outs.append(toks)
            steps.append(lg)
        for sid in sids:
            self.release(sid)
        tokens = np.asarray(outs, np.int64).T         # (B, max_new)
        if return_logits:
            return tokens, torch.stack(steps, dim=1)
        return tokens

    # ----------------------------------------------- wire-format helpers

    def encode_prefill(self, sid: int, tokens) -> np.ndarray:
        toks = np.asarray(tokens, np.int32).reshape(-1)
        if not 1 <= toks.shape[0] <= self.max_prompt:
            raise ValueError(
                f"prompt length {toks.shape[0]} outside "
                f"[1, {self.max_prompt}]")
        row = np.zeros((self.d_in,), np.float32)
        row[0] = float(sid)
        row[1] = float(toks.shape[0])
        row[2:2 + toks.shape[0]] = toks.astype(np.float32)
        return row

    def encode_decode(self, sid: int) -> np.ndarray:
        row = np.zeros((self.d_in,), np.float32)
        row[0] = float(sid)
        return row

    # -------------------------------------------- ServableProgram entries

    def bucket_for(self, m: int) -> Optional[int]:
        for b in self.bucket_sizes:
            if m <= b:
                return b
        return None

    def entry(self, bucket: int):
        if bucket not in self.bucket_sizes:
            raise ValueError(f"no bucket {bucket}; have {self.bucket_sizes}")

        def run_bucket(xb):
            X = xb.detach().cpu().numpy() if isinstance(xb, torch.Tensor) \
                else np.asarray(xb, np.float32)
            if X.shape != (bucket, self.d_in):
                raise ValueError(f"entry({bucket}) got {X.shape}")
            out = np.zeros((bucket, self.d_out), np.float32)
            dec_idx: List[int] = []
            dec_sids: List[int] = []
            for i in range(bucket):
                sid = int(round(float(X[i, 0])))
                if sid <= 0:                       # bucket padding
                    continue
                n_tok = int(round(float(X[i, 1])))
                if n_tok > 0:                      # prefill row
                    toks = np.round(X[i, 2:2 + n_tok]).astype(np.int64)
                    try:
                        out[i, 0] = float(self._prefill_seq(sid, toks)[0])
                    except ValueError:
                        out[i, 0] = -1.0           # don't fail the bucket
                elif sid in self._states:          # decode row
                    dec_idx.append(i)
                    dec_sids.append(sid)
                else:
                    out[i, 0] = -1.0               # unknown sequence
            if dec_sids:
                for i, tok in zip(dec_idx, self._decode_batch(dec_sids)[0]):
                    out[i, 0] = float(tok)
            return torch.from_numpy(out).to(self.device)

        # the layers this entry launches from, for the integrity guard
        run_bucket.layers = self.layers
        return run_bucket

    def run(self, x) -> torch.Tensor:
        X = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x, np.float32)
        m = X.shape[0]
        bucket = self.bucket_for(m)
        if bucket is None:
            raise ValueError(
                f"{m} rows exceeds the largest bucket "
                f"({self.bucket_sizes[-1]})")
        if m < bucket:                 # zero rows are inert padding rows
            X = np.concatenate(
                [X, np.zeros((bucket - m, self.d_in), np.float32)])
        return self.entry(bucket)(X)[:m]

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> "LMProgram":
        """Build every FFN plan's kernels and operands (each plan's own
        buckets, or those of ``buckets`` it has), then run one throwaway
        sequence through a prefill and a decode step, so that the first
        served request pays for neither."""
        for pl in self._plans:
            for p in pl.values():
                p.warmup(None if buckets is None else
                         [b for b in buckets if b in p.bucket_sizes])
        sid = -1                           # never a wire sequence id
        self._prefill_seq(sid, [0])
        self._decode_batch([sid])
        self.release(sid)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def forget(self) -> None:
        """Release the pinned kernel operands of every block pack, for a
        retiring program."""
        for pack in self._packs:
            kops.unpin_pack_operands(pack["layers"])

    def describe(self, n_seqs: int = 1) -> dict:
        """The program's surface and resolution.  ``ffn_schedules`` names
        each FFN plan's schedule (block 0's; every block resolves alike)
        at a decode step of ``n_seqs`` sequences and at a full prefill."""
        decode_b = self.bucket_for(n_seqs) or self.bucket_sizes[-1]
        prefill_b = self.bucket_for(self.max_prompt) or self.bucket_sizes[-1]
        return {
            "program": "lm",
            "arch": self.cfg.name,
            "device": str(self.device),
            "blocks": len(self._blocks),
            "ffn": ("fused gelu chain (1 plan/block)"
                    if self.cfg.act == "gelu"
                    else "swiglu split (gate/up/down plans/block)"),
            "wire": ("row = [seq_id, n_tokens, tok...]; n_tokens>0 "
                     "prefill, 0 decode; out = [token_id]"),
            "rows_per_request": self.rows_per_request,
            "d_in": self.d_in,
            "d_out": self.d_out,
            "bucket_sizes": list(self.bucket_sizes),
            "kv_cache": {"slots": self.cache_len,
                         "window": self.cfg.window},
            "live_sequences": self.live_sequences,
            "ffn_schedules": {
                phase: {name: p.schedule_for(b)
                        for name, p in self._plans[0].items()}
                for phase, b in ((f"decode(m={n_seqs})", decode_b),
                                 (f"prefill(m<={self.max_prompt})",
                                  prefill_b))},
            "ffn_bucket_schedules": {
                name: {b: p.schedule_for(b) for b in self.bucket_sizes}
                for name, p in self._plans[0].items()},
            "block0_plans": {k: p.describe()["resolved_mode"]
                             for k, p in self._plans[0].items()},
        }


def build_lm_program(params: Any, qstate: Any, cfg: ArchConfig,
                     lam: Optional[float] = None, **kwargs) -> LMProgram:
    """Freeze + wrap in one call (the common launch path)."""
    return LMProgram(freeze_lm(params, qstate, cfg, lam), cfg, **kwargs)
