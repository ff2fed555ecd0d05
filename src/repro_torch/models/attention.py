"""GQA attention (RoPE, optional qk-norm), plain PyTorch in f32.

KV cache per layer: ``{"k": [B, T, Hkv, D], "v": [B, T, Hkv, D]}``.  The
decode functions write the new token's K/V into the cache **in place**
(the JAX package returns updated copies) and still return the cache so
callers read the same way:

* :func:`gqa_decode` — every row at one shared position;
* :func:`gqa_decode_rows` — a position per row (continuous batching);
* :func:`gqa_forward` — a whole causal sequence (prefill), optionally
  returning its K/V; at ``S >= CHUNK_THRESHOLD`` it loops over query
  chunks so the scores never hold ``[S, S]`` at once.

Scores and softmax run in f32 on f32 inputs, as the JAX package computes
them; ``scaled_dot_product_attention`` is not used.
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


def _gqa_scores_to_out(q, k, v, mask, *, f32_inputs=True):
    """q: [B,S,Hq,D]; k,v: [B,T,Hkv,D]; mask: bool broadcastable to
    [B,S,T].  f32 scores, softmax and weighted sum.  ``f32_inputs=False``
    is the JAX package's bf16-operand variant: the products still sum in
    f32, but the attention weights are rounded to the activation dtype
    before the weighted sum."""
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
    if not f32_inputs:
        attn = attn.to(q.dtype).float()
    out = torch.einsum("bhgst,bthd->bshgd", attn, vf)
    return out.reshape(B, S, Hq, D).to(q.dtype)


def _causal_mask(S, T, device, offset=0):
    """mask[0, s, t] = t <= s + offset (T is the key length)."""
    return (torch.arange(T, device=device)[None, :]
            <= (torch.arange(S, device=device)[:, None] + offset))[None]


# ----------------------------------------------------------------------------
# chunked causal attention (bounded memory for long sequences)
# ----------------------------------------------------------------------------
# Full [S, S] scores at 32k+ would not fit; above the threshold the query
# runs in chunks with scores [B, H, qc, S] — the same FLOPs, each query
# row against the same keys under the same causal mask.
CHUNK_THRESHOLD = 8192
Q_CHUNK = 512


def _chunked_gqa(q, k, v, q_chunk=Q_CHUNK):
    """Causal attention, q chunked.  q: [B,S,Hq,D]; k,v: [B,S,Hkv,D]."""
    S = q.shape[1]
    outs = [_gqa_scores_to_out(q[:, s0:s0 + q_chunk], k, v,
                               _causal_mask(q_chunk, S, q.device, s0))
            for s0 in range(0, S, q_chunk)]
    return torch.cat(outs, dim=1)


def _project_qkv(p, x, cfg, positions):
    """x: [B, S, d]; positions: [B, S] int.  Returns q [B,S,Hq,D] and k, v
    [B,S,Hkv,D], normed and rotated."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(p["q_norm"], q)
        k = rms_norm_headwise(p["k_norm"], k)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(p, x, cfg, positions, *, causal=True, return_cache=False):
    """Full-sequence GQA.  x: [B, S, d]; positions: [B, S] int.  Returns
    y [B, S, d], and with `return_cache` also ``{"k", "v"}`` [B,S,Hkv,D]."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    if causal and S >= CHUNK_THRESHOLD and S % Q_CHUNK == 0:
        out = _chunked_gqa(q, k, v)
    else:
        mask = _causal_mask(S, S, x.device) if causal else None
        out = _gqa_scores_to_out(q, k, v, mask,
                                 f32_inputs=cfg.attn_f32_inputs)
    y = out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]
    if return_cache:
        return y, {"k": k, "v": v}
    return y


def gqa_decode(p, x, cfg, cache, pos: int):
    """x: [B, 1, d]; cache k/v: [B, T, Hkv, D]; pos: the new token's index.
    Returns (y [B, 1, d], cache) with the cache updated in place."""
    B = x.shape[0]
    T = cache["k"].shape[1]
    posv = torch.full((B, 1), int(pos), dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, posv)
    cache["k"][:, pos] = k[:, 0]
    cache["v"][:, pos] = v[:, 0]
    mask = (torch.arange(T, device=x.device) <= pos)[None, None, :]  # [1,1,T]
    out = _gqa_scores_to_out(q, cache["k"], cache["v"], mask)
    y = out.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return y, cache


def gqa_decode_rows(p, x, cfg, cache, positions):
    """Per-row-position decode (continuous batching): each batch row is an
    independent request at its own sequence position.

    x: [B, 1, d]; cache k/v: [B, T, Hkv, D]; positions: int tensor [B] on
    x's device (row b's new-token index).  Row b's new K/V is written at
    ``(b, positions[b])`` in place, and row b attends over cache positions
    ``<= positions[b]``: later entries (another request's stale bytes, a
    short row's padding) get exactly zero attention weight.  Returns
    (y [B, 1, d], cache)."""
    B = x.shape[0]
    T = cache["k"].shape[1]
    q, k, v = _project_qkv(p, x, cfg, positions[:, None])
    rows = torch.arange(B, device=x.device)
    cache["k"][rows, positions] = k[:, 0]
    cache["v"][rows, positions] = v[:, 0]
    mask = (torch.arange(T, device=x.device)[None, :]
            <= positions[:, None])[:, None]                   # [B,1,T]
    out = _gqa_scores_to_out(q, cache["k"], cache["v"], mask)
    y = out.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return y, cache
