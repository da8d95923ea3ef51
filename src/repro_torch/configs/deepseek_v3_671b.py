"""deepseek-v3-671b [moe] — arXiv:2412.19437.

61L d_model=7168 128H MLA (q_lora 1536, kv_lora 512, nope 128, rope 64,
v 128), MoE: 1 shared + 256 routed experts top-8, expert d_ff=2048,
sigmoid gate with bias-corrected aux-loss-free routing, routed_scaling=2.5,
first 3 layers dense (d_ff 18432), vocab=129280.

MTP (multi-token prediction) head omitted — orthogonal to the paper's
technique (DESIGN.md §5).  MLA latent cache stays 16-bit (activations are
quantization-sensitive, FantastIC4 fig. 2).
"""
from .base import ArchConfig, MLADims, register

CONFIG = register(ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv=128, head_dim=128,
    d_ff=2048, vocab=129280,
    mla=MLADims(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                qk_rope_dim=64, v_head_dim=128),
    n_experts=256, top_k=8, moe_gate="sigmoid", n_shared_experts=1,
    n_dense_layers=3, dense_ff=18432, routed_scaling=2.5,
    rope_theta=10000.0,
))
