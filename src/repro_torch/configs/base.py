"""ArchConfig — one dataclass describing every assigned architecture.

Each ``configs/<id>.py`` instantiates CONFIG with the exact numbers from the
assignment sheet (source cited in the module docstring).  ``smoke()``
produces a reduced same-family variant for CPU tests: fewer/narrower layers,
few experts, tiny vocab — same code paths, same block structure.

Quantization policy fields implement DESIGN.md §5: ``quantize`` turns EC4T
on for FC-family projection weights; embeddings / norms / biases / router /
SSM dynamics always stay high-precision (the paper's mixed-precision rule).

``experts_held`` is the port's own field (the JAX package's ArchConfig has
no such field).  A non-None ``(first, count)`` makes the config one
device's share of an expert-parallel deployment: ``n_experts`` spread over
a ``model`` mesh axis of width tp with ``n_experts % tp == 0`` (where the
reference's ``moe_ffn`` picks ``moe_apply_ep``), shard r holding experts
``[r * n_experts / tp, (r + 1) * n_experts / tp)``.  The layer is the
per-shard body of ``moe_apply_ep`` (its ``local_moe``) without the two
all-to-alls: it routes over every expert and adds its own experts' part.
That holds for the dispatch and the expert FFN, not for the combine: in
``local_moe`` the return all-to-all brings each token's owner the outputs
of all k chosen experts, while the share keeps only its own experts'.  So
a share's output, its loss and its gradients to the router, attention,
embedding and head are not those of any shard of the deployment; only
the per-expert work (dispatch, the held banks' FFN, their ECL pass, Adam
and the probability update) stands for one chip's.
For example grok-1-314b's 8 experts over a 4-wide model axis: shard 0
holds ``(0, 2)``.  The launchers leave it None (every expert held).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLADims:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None          # default d_model // n_heads
    # --- attention flavour
    window: Optional[int] = None            # SWA width (danube, hymba)
    global_attn_layers: Tuple[int, ...] = ()  # hymba: layers with full attn
    rotary_frac: float = 1.0                # glm4: 0.5 partial rotary
    rope_theta: float = 10000.0
    qkv_bias: bool = False                  # qwen-family, glm4
    mrope_sections: Optional[Tuple[int, int, int]] = None   # qwen2-vl
    mla: Optional[MLADims] = None           # deepseek-v3
    # --- block flavour
    norm: str = "rms"                       # rms | layer
    act: str = "swiglu"                     # swiglu | gelu
    tie_embeddings: bool = False
    # --- MoE
    n_experts: int = 0
    top_k: int = 0
    moe_gate: str = "softmax"               # softmax (grok) | sigmoid (dsv3)
    n_shared_experts: int = 0
    n_dense_layers: int = 0                 # deepseek: first 3 layers dense
    dense_ff: Optional[int] = None          # FFN width of those dense layers
    routed_scaling: float = 1.0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.001
    # (first expert, count) held here: one shard of an expert-parallel
    # deployment (see the module docstring); the router keeps all
    # n_experts outputs.  None holds every expert.
    experts_held: Optional[Tuple[int, int]] = None
    # --- SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    # --- enc-dec (whisper)
    encdec: bool = False
    n_enc_layers: int = 0
    enc_len: int = 1500                     # stubbed frame-embedding length
    # --- quantization (the paper's technique)
    quantize: bool = True
    lam: float = 0.02                       # entropy-penalty strength λ
    # --- bookkeeping
    vocab_pad_multiple: int = 256           # pad embedding rows for TP
    attn_chunk: int = 1024                  # online-softmax KV chunk
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    @property
    def d_inner(self) -> int:               # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM, hybrid, or SWA-capped attention."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv=min(self.n_kv, 2) if self.n_kv < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            dense_ff=128 if self.dense_ff else None,
            vocab=256,
            vocab_pad_multiple=32,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_dense_layers=min(self.n_dense_layers, 1),
            mla=MLADims(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                        qk_rope_dim=8, v_head_dim=16) if self.mla else None,
            mrope_sections=(2, 3, 3) if self.mrope_sections else None,
            ssm_state=min(self.ssm_state, 16),
            ssm_headdim=16,
            ssm_chunk=8,
            window=min(self.window, 16) if self.window else None,
            global_attn_layers=tuple(
                g for g in self.global_attn_layers if g < 2),
            enc_len=16 if self.encdec else self.enc_len,
            attn_chunk=16,
        )


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from . import ALL  # noqa: F401  — force-import the config modules
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    from . import ALL  # noqa: F401
    return sorted(_REGISTRY)
