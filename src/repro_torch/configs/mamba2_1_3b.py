"""mamba2-1.3b [ssm] — arXiv:2405.21060 (SSD, unverified tier).

48L d_model=2048, attention-free, d_inner=4096 (expand 2), 64 heads of
headdim 64, ssm_state=128, vocab=50280.  O(1)-state decode => runs
long_500k.  The SSD recurrence itself has no weight matmul to quantize;
EC4T covers in/out projections (~90% of params) — DESIGN.md §5.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_groups=1,
    tie_embeddings=True,
))
