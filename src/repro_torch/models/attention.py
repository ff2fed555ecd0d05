"""GQA attention for decode (RoPE, optional qk-norm), plain PyTorch in f32.

KV cache per layer: ``{"k": [B, T, Hkv, D], "v": [B, T, Hkv, D]}``.  The
port writes the new token's K/V into the cache **in place** (the JAX
package returns updated copies); ``gqa_decode`` still returns the cache so
callers read the same way.  Scores and softmax run in f32 on f32 inputs,
as the JAX package computes them; ``scaled_dot_product_attention`` is not
used.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import apply_rope, dtype_of, normal

NEG_INF = -1e30


def init_attn(gen, cfg, device):
    dt = dtype_of(cfg)
    d, hd = cfg.d_model, cfg.head_dim

    def dense(shape):
        return normal(gen, shape, (2.0 / (shape[0] + shape[-1])) ** 0.5, dt,
                      device)

    p = {"wq": dense((d, cfg.n_heads * hd)),
         "wk": dense((d, cfg.n_kv_heads * hd)),
         "wv": dense((d, cfg.n_kv_heads * hd)),
         "wo": dense((cfg.n_heads * hd, d))}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
    return p


def init_kv_cache(cfg, batch, length, device, dtype=None):
    """Allocate an (empty) per-layer KV cache."""
    dt = dtype or dtype_of(cfg)
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def rms_norm_headwise(scale, x, eps=1e-6):
    """qk-norm: RMSNorm over the last (head) dim."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


def _gqa_scores_to_out(q, k, v, mask):
    """q: [B,S,Hq,D]; k,v: [B,T,Hkv,D]; mask: bool broadcastable to
    [B,S,T].  f32 scores, softmax and weighted sum."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, S, Hkv, G, D)
    kf = k.float()
    vf = v.float()
    scores = torch.einsum("bshgd,bthd->bhgst", qf, kf)
    scores = scores / math.sqrt(D)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores,
                             torch.tensor(NEG_INF, dtype=scores.dtype,
                                          device=scores.device))
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", attn, vf)
    return out.reshape(B, S, Hq, D).to(q.dtype)


def gqa_decode(p, x, cfg, cache, pos: int):
    """x: [B, 1, d]; cache k/v: [B, T, Hkv, D]; pos: the new token's index.
    Returns (y [B, 1, d], cache) with the cache updated in place."""
    B = x.shape[0]
    hd = cfg.head_dim
    T = cache["k"].shape[1]
    q = (x @ p["wq"]).reshape(B, 1, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(B, 1, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, 1, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(p["q_norm"], q)
        k = rms_norm_headwise(p["k_norm"], k)
    if cfg.pos == "rope":
        posv = torch.full((B, 1), int(pos), dtype=torch.int32,
                          device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
    cache["k"][:, pos] = k[:, 0]
    cache["v"][:, pos] = v[:, 0]
    mask = (torch.arange(T, device=x.device) <= pos)[None, None, :]  # [1,1,T]
    out = _gqa_scores_to_out(q, cache["k"], cache["v"], mask)
    y = out.reshape(B, 1, cfg.n_heads * hd) @ p["wo"]
    return y, cache
