"""qwen2-vl-2b [vlm] — arXiv:2409.12191 / hf:Qwen/Qwen2-VL-2B-Instruct.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, M-RoPE with
(t,h,w) sections (16,24,24) rotary pairs, QKV bias, tied embeddings.
Vision frontend is a STUB per the assignment: input_specs() feeds
precomputed patch embeddings; the transformer backbone is what runs.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv=2, head_dim=128,
    d_ff=8960, vocab=151936,
    rope_theta=1e6, qkv_bias=True, tie_embeddings=True,
    mrope_sections=(16, 24, 24),
    notes="M-RoPE; dynamic-resolution vision stubbed (patch embeds provided)",
))
