"""glm4-9b [dense] — hf:THUDM/glm-4-9b.

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552, partial rotary
(50% of head dims), QKV bias.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv=2, head_dim=128,
    d_ff=13696, vocab=151552,
    rotary_frac=0.5, rope_theta=10000.0, qkv_bias=True,
))
