"""whisper-base [audio] — arXiv:2212.04356 (unverified tier).

Enc-dec: 6+6L d_model=512 8H (MHA) d_ff=2048 vocab=51865, LayerNorm +
GELU, sinusoidal encoder positions, learned decoder positions.
Conv frontend is a STUB per the assignment: input_specs() provides
precomputed 1500-frame embeddings (B, 1500, 512).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv=8, head_dim=64,
    d_ff=2048, vocab=51865,
    encdec=True, n_enc_layers=6, enc_len=1500,
    norm="layer", act="gelu",
))
