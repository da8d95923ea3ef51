"""grok-1-314b [moe] — hf:xai-org/grok-1 (unverified tier).

64L d_model=6144 48H (GQA kv=8) expert d_ff=32768 vocab=131072,
MoE 8 experts top-2 (softmax gate over the selected logits).
8 experts % 16-way model axis != 0 => per-expert tensor parallelism
(expert d_ff sharded), not expert parallelism — DESIGN.md §4.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv=8, head_dim=128,
    d_ff=32768, vocab=131072,
    n_experts=8, top_k=2, moe_gate="softmax",
    rope_theta=10000.0,
))
