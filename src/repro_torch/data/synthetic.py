"""Deterministic synthetic data — seeded per (task, step, host).

A copy of the JAX package's ``data/synthetic.py``, which is numpy only, so
both packages draw the same batches from the same (seed, step).

Every batch is a pure function of (seed, step), so fault-tolerant restart
needs no data-state checkpoint beyond the step counter: skip-ahead is free
and exact (the JAX package's runtime/fault.py relies on this).  Two generators:

* LM token streams with a Zipf-ish marginal and short-range structure
  (next-token = f(prev) + noise) so cross-entropy demonstrably drops during
  the example runs — pure-uniform tokens would make loss curves flat.
* GSC/HR-like feature-vector classification sets for the paper's MLPs,
  with class-conditional Gaussian clusters (linearly separable at a margin,
  so small MLPs reach high accuracy quickly, mirroring the paper's tasks).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataCfg:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def lm_batch(cfg: LMDataCfg, step: int) -> dict:
    """(tokens, labels) uint/int32 arrays for one step (host-side numpy)."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab
    # structured stream: x_{t+1} = (a * x_t + c + noise) mod v
    a = 31337 % v or 1
    x0 = rng.integers(0, v, size=(b, 1))
    noise = rng.integers(0, max(v // 64, 2), size=(b, s))
    toks = np.empty((b, s + 1), np.int64)
    toks[:, :1] = x0
    for t in range(s):
        toks[:, t + 1] = (a * toks[:, t] + 7 + noise[:, t % s]) % v
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def lm_batches(cfg: LMDataCfg, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield lm_batch(cfg, step)
        step += 1


@dataclasses.dataclass(frozen=True)
class ClsDataCfg:
    d_in: int
    n_classes: int
    batch: int
    margin: float = 2.0
    seed: int = 0


def _class_means(cfg: ClsDataCfg) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0xC1A55]))
    m = rng.normal(size=(cfg.n_classes, cfg.d_in))
    return cfg.margin * m / np.linalg.norm(m, axis=1, keepdims=True)


def cls_batch(cfg: ClsDataCfg, step: int) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 1, step]))
    labels = rng.integers(0, cfg.n_classes, size=(cfg.batch,))
    x = _class_means(cfg)[labels] + rng.normal(size=(cfg.batch, cfg.d_in))
    return {"x": x.astype(np.float32), "labels": labels.astype(np.int32)}


def cls_batches(cfg: ClsDataCfg, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield cls_batch(cfg, step)
        step += 1
