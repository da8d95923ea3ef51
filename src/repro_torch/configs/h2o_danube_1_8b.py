"""h2o-danube-1.8b [dense] — arXiv:2401.16818 (llama+mistral mix, SWA).

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, sliding-window
attention (mistral-style, 4096).  SWA caps the KV cache => runs long_500k.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv=8, head_dim=80,
    d_ff=6912, vocab=32000,
    window=4096, rope_theta=10000.0,
))
