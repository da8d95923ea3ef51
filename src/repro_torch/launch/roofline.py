"""Three-term roofline of a dry-run record: the port of the JAX package's
``launch/roofline.py``.

    compute term    = FLOPs per device / peak FLOP/s
    memory term     = bytes per device / HBM rate
    collective term = Σ per-class collective bytes / link rate

The FLOPs, bytes and collective bytes come from ``launch/dryrun.py``'s
count of the eager step (``launch/op_analysis.py``): its bytes are the
unfused traffic of every operation, so the memory term is an upper
bound of what a fused program would move.

The peaks are the card's, keyed by ``torch.cuda.get_device_name``
(:data:`CARDS`).  NVIDIA H100 SXM (the H100 80GB HBM3), from NVIDIA's
H100 Tensor Core GPU datasheet: 989 TFLOP/s dense bf16 on the tensor
cores, 3.35 TB/s of HBM3, 900 GB/s of NVLink in both directions (450 GB/s
a direction).  No TPU figure is used.  The module's ``PEAK_FLOPS``,
``HBM_BW`` and ``LINK_BW`` are the default card's (the card the port
runs on) and are what :func:`roofline_terms` reads.

``MODEL_FLOPS`` (6·N·D dense, 6·N_active·D MoE) anchors the useful
fraction: counted FLOPs far above it expose rematerialisation, masked
attention and dispatch overhead.
"""
from __future__ import annotations

CARDS = {
    "NVIDIA H100 80GB HBM3": {"flops": 989e12, "hbm": 3.35e12,
                              "link": 450e9},
}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"

PEAK_FLOPS = CARDS[DEFAULT_CARD]["flops"]     # bf16 dense, per card
HBM_BW = CARDS[DEFAULT_CARD]["hbm"]           # bytes/s per card
LINK_BW = CARDS[DEFAULT_CARD]["link"]         # bytes/s, one direction


def model_flops(cfg, shape_info: dict) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) for train; 2·N·D per token for
    prefill; 2·N per sequence for a decode step.  N counts the parameters
    a token touches."""
    n_active = active_params(cfg)
    b, s = shape_info["batch"], shape_info["seq"]
    kind = shape_info["kind"]
    if kind == "train":
        return 6.0 * n_active * b * s
    if kind == "prefill":
        return 2.0 * n_active * b * s
    return 2.0 * n_active * b          # decode: one token a sequence


def active_params(cfg) -> float:
    """Parameters touched per token (MoE: top_k + shared experts only)."""
    d, L = cfg.d_model, cfg.n_layers
    total = cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2)
    hd = cfg.resolved_head_dim

    def attn_params():
        if cfg.mla is not None:
            m = cfg.mla
            qk = m.qk_nope_dim + m.qk_rope_dim
            return (d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qk
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim
                                                      + m.v_head_dim)
                    + cfg.n_heads * m.v_head_dim * d)
        return d * hd * (cfg.n_heads * 2 + cfg.n_kv * 2)

    def ffn_params(ff):
        mult = 3 if cfg.act == "swiglu" else 2
        return mult * d * ff

    def ssm_params():
        di = cfg.d_inner
        dproj = 2 * di + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads
        return d * dproj + di * d

    kinds = {"dense": 0, "moe": 0, "ssm": 0, "hybrid": 0}
    if cfg.family == "moe":
        kinds["dense"] = cfg.n_dense_layers
        kinds["moe"] = L - cfg.n_dense_layers
    elif cfg.family == "ssm":
        kinds["ssm"] = L
    elif cfg.family == "hybrid":
        kinds["hybrid"] = L
    else:
        kinds["dense"] = L

    total += kinds["dense"] * (attn_params() + ffn_params(cfg.dense_ff
                                                          or cfg.d_ff))
    total += kinds["moe"] * (attn_params()
                             + (cfg.top_k + cfg.n_shared_experts)
                             * ffn_params(cfg.d_ff))
    total += kinds["ssm"] * ssm_params()
    total += kinds["hybrid"] * (attn_params() + ssm_params()
                                + ffn_params(cfg.d_ff))
    if cfg.family == "audio":
        total += cfg.n_enc_layers * (attn_params() + ffn_params(cfg.d_ff))
        total += L * (2 * attn_params() + ffn_params(cfg.d_ff))
        total -= L * (attn_params() + ffn_params(cfg.d_ff))  # counted above
    return float(total)


def roofline_terms(rec: dict, cfg=None) -> dict:
    """Seconds a device for each term and the dominant one."""
    compute_s = rec["flops_per_device"] / PEAK_FLOPS
    memory_s = rec["bytes_per_device"] / HBM_BW
    coll = rec.get("collectives", {})
    collective_s = coll.get("total", 0) / LINK_BW
    dom = max(("compute", compute_s), ("memory", memory_s),
              ("collective", collective_s), key=lambda kv: kv[1])
    out = {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dom[0],
        "bound_s": dom[1],
    }
    if cfg is not None:
        from .specs import SHAPES
        info = SHAPES[rec["shape"]]
        mf = model_flops(cfg, info)
        counted = rec["flops_per_device"] * rec["n_devices"]
        out["model_flops"] = mf
        out["hlo_flops_total"] = counted
        out["useful_fraction"] = mf / counted if counted else 0.0
        ideal_s = mf / (rec["n_devices"] * PEAK_FLOPS)
        out["ideal_compute_s"] = ideal_s
        out["roofline_fraction"] = ideal_s / dom[1] if dom[1] else 0.0
    return out
