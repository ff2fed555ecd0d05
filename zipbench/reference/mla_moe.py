"""DeepSeek-V2 decoder (deepseekv2-lite): multi-head latent attention with
no query LoRA, a dense first layer, then MoE layers of routed top-k experts
(softmax gates, not renormalised) and shared experts; RMSNorm before each
block; untied LM head.

Rotary positions follow the configuration's ``rope_scaling`` (YaRN: its
frequencies and softmax factor; at factor 1, plain RoPE with the plain
1/sqrt(Dn + Dr) scale). One departure from the published model: each
rotated pair is taken as (i, i + Dr/2) of the rope dims, not adjacent dims
(a fixed permutation of the rope columns of ``wq`` and ``wkv_a``).
"""
from __future__ import annotations

import math

import torch

from .common import causal, ffn, mm, rms_norm, rotate, softmax_factor


def mla(p, x, hp, prec):
    """Causal latent attention over x [B, S, d] from position 0."""
    B, S, _ = x.shape
    H, Dn, Dr, C, Dv = (hp.n_heads, hp.qk_nope_dim, hp.qk_rope_dim,
                        hp.kv_lora_rank, hp.v_head_dim)
    pos = torch.arange(S, device=x.device)
    q = mm(x, p["wq"], prec).reshape(B, S, H, Dn + Dr)
    q_nope, q_rope = q.split([Dn, Dr], dim=-1)
    c, k_rope = mm(x, p["wkv_a"], prec).split([C, Dr], dim=-1)
    c = rms_norm(c, p["kv_norm"])
    rs = hp.rope_scaling
    k_rope = rotate(k_rope[:, :, None, :], pos, hp.rope_theta, rs)
    q_rope = rotate(q_rope, pos, hp.rope_theta, rs)
    kv = mm(c, p["wkv_b"], prec).reshape(B, S, H, Dn + Dv)
    k_nope, v = kv.split([Dn, Dv], dim=-1)
    scale = softmax_factor(rs) / math.sqrt(Dn + Dr)
    sc = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
          + torch.einsum("bshd,btd->bhst", q_rope, k_rope[:, :, 0])) * scale
    sc = sc.masked_fill(~causal(S, x.device), float("-inf"))
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(sc, dim=-1), v)
    return mm(out.reshape(B, S, H * Dv), p["wo"], prec)


def logits(params, hp, tokens, prec="f32"):
    """tokens [B, S] -> float32 logits [B, S, V] of a full causal pass."""
    x = params["embed"]["tok"][tokens].float()
    for i, lp in enumerate(params["layers"]):
        x = x + mla(lp["attn"], rms_norm(x, lp["norm1"]["scale"]), hp, prec)
        x = x + ffn(lp["ffn"], rms_norm(x, lp["norm2"]["scale"]), hp, i,
                    prec)
    x = rms_norm(x, params["final_norm"]["scale"])
    return mm(x, params["lm_head"]["w"], prec)
