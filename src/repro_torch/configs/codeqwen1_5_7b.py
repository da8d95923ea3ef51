"""codeqwen1.5-7b [dense] — hf:Qwen/CodeQwen1.5-7B (qwen1.5 arch).

32L d_model=4096 32H (MHA: kv=32) d_ff=13440 vocab=92416, QKV bias,
rope_theta=1e6 (64k context).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=32, head_dim=128,
    d_ff=13440, vocab=92416,
    rope_theta=1e6, qkv_bias=True,
))
