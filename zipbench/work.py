"""Frozen work arithmetic: model FLOPs of a decode step, and the least bytes
and FLOPs of the routed-expert FFN.  The peaks are one H100 SXM's published
dense rates (NVIDIA's data sheet, at the 700 W limit).

These functions read only sizes (a ModelConfig built from a file of
``zipbench/configs/``); they are the benchmark's yardstick and take nothing
from the program's own accounting.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def n_mat(cfg) -> int:
    """Weight matrices of one MLP: gate, up, down (swiglu) or up, down."""
    return 3 if cfg.act == "swiglu" else 2


def attn_flops(cfg, kv_len: int) -> float:
    """One decode token through one MLA layer over `kv_len` cached
    positions (its own included), in the absorbed form the server decodes
    with: projections, the key/value absorption into the latent, scores over
    latent + rope, the weighted sum over the latent."""
    if cfg.attn != "mla":
        raise NotImplementedError(f"attention {cfg.attn!r}")
    d, H = cfg.d_model, cfg.n_heads
    C, Dr, Dn, Dv = (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim,
                     cfg.v_head_dim)
    if cfg.q_lora_rank:
        q = 2 * d * cfg.q_lora_rank + 2 * cfg.q_lora_rank * H * (Dn + Dr)
    else:
        q = 2 * d * H * (Dn + Dr)
    proj = q + 2 * d * (C + Dr) + 2 * H * Dn * C + 2 * H * C * Dv \
        + 2 * H * Dv * d
    return proj + 2 * H * kv_len * (C + Dr) + 2 * H * kv_len * C


def ffn_flops(cfg, layer: int) -> float:
    d = cfg.d_model
    m = n_mat(cfg)
    if cfg.moe_layer(layer):
        return (2 * d * cfg.n_experts
                + cfg.top_k * m * 2 * d * cfg.d_expert
                + m * 2 * d * cfg.d_expert * cfg.n_shared_experts)
    return m * 2 * d * cfg.d_ff


def token_flops(cfg, kv_len: int) -> float:
    """Model FLOPs of one decode token at KV length `kv_len` through every
    held decoder layer and the LM head."""
    total = 2 * cfg.d_model * cfg.vocab_size
    for i in range(cfg.n_layers):
        total += attn_flops(cfg, kv_len) + ffn_flops(cfg, i)
    return float(total)


def step_flops(cfg, kv_lens) -> float:
    """One decode step: each row's token at its own KV length."""
    return sum(token_flops(cfg, int(t)) for t in kv_lens)


def expert_ffn_work(cfg, n_distinct: int, n_pairs: int):
    """(bytes, flops) the routed-expert FFN of one layer-step needs at
    least: each distinct expert's weights read once, each routed token's
    activation read once and its output written once (bf16), and
    2 * pairs * d * f FLOPs per projection."""
    d, f, m = cfg.d_model, cfg.d_expert, n_mat(cfg)
    nbytes = n_distinct * m * d * f * BF16 + 2 * n_pairs * d * BF16
    flops = 2 * n_pairs * d * f * m
    return float(nbytes), float(flops)


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS)
