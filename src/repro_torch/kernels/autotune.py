"""Block and schedule choice for the serving kernels: the prior only.

The JAX package's ``kernels/autotune.py`` resolves each batch bucket's
(schedule, block_m) by a timed sweep on the accelerator, persisted in a
JSON cache, and answers from a dataflow prior otherwise.  This port keeps
the prior: the timed sweep with CUDA events and its own cache file come
later, so every answer here has ``source="heuristic"`` and nothing is
written anywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

# the fused schedules a bucket can bind to (serving.plans maps them onto
# its bucket paths)
SCHEDULES = ("ws", "batch_tiled", "db", "stream")
ROW_ALIGN = 8


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    block_m: int
    block_n: int
    block_k: int
    source: str = "heuristic"
    schedule: Optional[str] = None


def _round_up(v: int, mult: int) -> int:
    return -(-max(v, 1) // mult) * mult


def heuristic_blocks(m: int, k: int, n: int, *,
                     max_block_m: int = 256) -> BlockConfig:
    """Shape-clamped blocks, no timing.  The CUDA kernels fix their column
    and contraction tiles (64 and 32, ``csrc/fantastic4_common.cuh``), so
    only the row tile varies: the rounded batch, capped by what the fused
    kernel can hold (``max_block_m``, from its shared-memory fit)."""
    return BlockConfig(min(_round_up(m, ROW_ALIGN), max_block_m), 64, 32)


def get_schedule_config(rows: int, k: int, n: int, *,
                        schedules: Sequence[str], prior: str,
                        block_m_hint: Optional[int] = None) -> BlockConfig:
    """One batch bucket's (schedule, block_m) binding from the prior.

    ``schedules`` is the bucket's eligible set (fits and opt-outs already
    applied by the plan) and ``prior`` the dataflow answer; a prior outside
    the set falls back to the set's first entry."""
    if not schedules:
        raise ValueError("schedules must name at least one eligible "
                         "schedule")
    unknown = [s for s in schedules if s not in SCHEDULES]
    if unknown:
        raise ValueError(f"unknown schedules {unknown}; valid: {SCHEDULES}")
    if prior not in schedules:
        prior = schedules[0]
    mp = _round_up(rows, ROW_ALIGN)
    bm = min(block_m_hint, mp) if block_m_hint else \
        heuristic_blocks(rows, k, n).block_m
    return BlockConfig(bm, 0, 0, source="heuristic", schedule=prior)
