"""hymba-1.5b [hybrid] — arXiv:2411.13676.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16;
parallel attention + mamba heads in every layer, outputs mean-combined
after per-branch normalisation.  SWA (1024) everywhere except 3 global
layers (first / middle / last).  Hybrid + SWA => runs long_500k.
(Meta tokens and cross-layer KV sharing from the paper are omitted —
orthogonal to FantastIC4's technique; noted in DESIGN.md.)
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv=5, head_dim=64,
    d_ff=5504, vocab=32001,
    window=1024, global_attn_layers=(0, 15, 31),
    ssm_state=16, ssm_expand=2, ssm_headdim=64,
    rope_theta=10000.0,
))
