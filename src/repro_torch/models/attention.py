"""Attention: GQA (RoPE or M-RoPE, optional qk-norm), MLA (DeepSeek-V2)
and the encoder-decoders' cross-attention, plain PyTorch in f32.

KV cache per layer::

    GQA:   {"k": [B, T, Hkv, D], "v": [B, T, Hkv, D]}
    MLA:   {"ckv": [B, T, kv_lora_rank], "k_rope": [B, T, qk_rope_dim]}
    cross: {"k": [B, T_enc, H, D], "v": [B, T_enc, H, D]}  (the encoder's,
           made once by :func:`cross_attn_cache` at prefill)

The decode functions write the new token's K/V (MLA: its latent) into the
cache **in place** (the JAX package returns updated copies) and still
return the cache so callers read the same way:

* :func:`gqa_decode` / :func:`mla_decode` — every row at one shared
  position;
* :func:`gqa_decode_rows` / :func:`mla_decode_rows` — a position per row
  (continuous batching);
* :func:`gqa_forward` / :func:`mla_forward` — a whole causal sequence
  (prefill), optionally returning its cache; at ``S >= CHUNK_THRESHOLD``
  they loop over query chunks so the scores never hold ``[S, S]`` at once.

Scores, softmax and (MLA) the absorbed products run in f32 on f32 inputs,
as the JAX package computes them; ``scaled_dot_product_attention`` is not
used.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models.layers import apply_mrope, apply_rope, dtype_of, \
    normal

NEG_INF = -1e30


def init_attn(gen, cfg, device, cross=False):
    """One layer's attention weights; ``cross=True``: an encoder-decoder's
    cross-attention, GQA-shaped with ``n_heads`` K/V heads."""
    dt = dtype_of(cfg)
    d, hd = cfg.d_model, cfg.head_dim

    def dense(shape):
        return normal(gen, shape, (2.0 / (shape[0] + shape[-1])) ** 0.5, dt,
                      device)

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    if cfg.attn == "mla" and not cross:
        qk_head = cfg.qk_nope_dim + cfg.qk_rope_dim
        p = {}
        if cfg.q_lora_rank:
            p["wq_a"] = dense((d, cfg.q_lora_rank))
            p["q_norm"] = ones(cfg.q_lora_rank)
            p["wq_b"] = dense((cfg.q_lora_rank, cfg.n_heads * qk_head))
        else:
            p["wq"] = dense((d, cfg.n_heads * qk_head))
        p["wkv_a"] = dense((d, cfg.kv_lora_rank + cfg.qk_rope_dim))
        p["kv_norm"] = ones(cfg.kv_lora_rank)
        p["wkv_b"] = dense((cfg.kv_lora_rank,
                            cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)))
        p["wo"] = dense((cfg.n_heads * cfg.v_head_dim, d))
        return p
    kvh = cfg.n_heads if cross else cfg.n_kv_heads
    p = {"wq": dense((d, cfg.n_heads * hd)),
         "wk": dense((d, kvh * hd)),
         "wv": dense((d, kvh * hd)),
         "wo": dense((cfg.n_heads * hd, d))}
    if cfg.qk_norm:
        p["q_norm"] = ones(hd)
        p["k_norm"] = ones(hd)
    return p


def init_kv_cache(cfg, batch, length, device, dtype=None):
    """Allocate an (empty) per-layer KV cache."""
    dt = dtype or dtype_of(cfg)
    if cfg.attn == "mla":
        return {"ckv": torch.zeros((batch, length, cfg.kv_lora_rank),
                                   dtype=dt, device=device),
                "k_rope": torch.zeros((batch, length, cfg.qk_rope_dim),
                                      dtype=dt, device=device)}
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def rms_norm_headwise(scale, x, eps=1e-6):
    """qk-norm: RMSNorm over the last (head) dim."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


def _where_mask(sc, mask):
    """`sc` where `mask` holds, NEG_INF elsewhere."""
    return torch.where(mask, sc, torch.tensor(NEG_INF, dtype=sc.dtype,
                                              device=sc.device))


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
        scores = _where_mask(scores, mask[:, None, None, :, :])
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


def _project_qkv(p, x, cfg, positions, mrope_positions=None):
    """x: [B, S, d]; positions: [B, S] int; mrope_positions: [3, B, S] int
    or None.  Returns q [B,S,Hq,D] and k, v [B,S,Hkv,D], normed and
    rotated: an M-RoPE config given its three position channels rotates
    by them, else by `positions`."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(p["q_norm"], q)
        k = rms_norm_headwise(p["k_norm"], k)
    if cfg.pos == "rope":
        if cfg.mrope and mrope_positions is not None:
            q = apply_mrope(q, mrope_positions, cfg.rope_theta)
            k = apply_mrope(k, mrope_positions, cfg.rope_theta)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(p, x, cfg, positions, *, causal=True, mrope_positions=None,
                return_cache=False):
    """Full-sequence GQA.  x: [B, S, d]; positions: [B, S] int;
    mrope_positions: [3, B, S] or None.  ``causal=False`` is an encoder's
    self-attention.  Returns y [B, S, d], and with `return_cache` also
    ``{"k", "v"}`` [B,S,Hkv,D]."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions, mrope_positions)
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


def gqa_decode(p, x, cfg, cache, pos: int, *, mrope_positions=None):
    """x: [B, 1, d]; cache k/v: [B, T, Hkv, D]; pos: the new token's index;
    mrope_positions: [3, B, 1] or None.  Returns (y [B, 1, d], cache) with
    the cache updated in place."""
    B = x.shape[0]
    T = cache["k"].shape[1]
    posv = torch.full((B, 1), int(pos), dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, posv, mrope_positions)
    cache["k"][:, pos] = k[:, 0]
    cache["v"][:, pos] = v[:, 0]
    mask = (torch.arange(T, device=x.device) <= pos)[None, None, :]  # [1,1,T]
    out = _gqa_scores_to_out(q, cache["k"], cache["v"], mask)
    y = out.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return y, cache


def gqa_decode_rows(p, x, cfg, cache, positions, *, mrope_positions=None):
    """Per-row-position decode (continuous batching): each batch row is an
    independent request at its own sequence position.

    x: [B, 1, d]; cache k/v: [B, T, Hkv, D]; positions: int tensor [B] on
    x's device (row b's new-token index).  Row b's new K/V is written at
    ``(b, positions[b])`` in place, and row b attends over cache positions
    ``<= positions[b]``: later entries (another request's stale bytes, a
    short row's padding) get exactly zero attention weight;
    mrope_positions: [3, B, 1] or None.  Returns (y [B, 1, d], cache)."""
    B = x.shape[0]
    T = cache["k"].shape[1]
    q, k, v = _project_qkv(p, x, cfg, positions[:, None], mrope_positions)
    rows = torch.arange(B, device=x.device)
    cache["k"][rows, positions] = k[:, 0]
    cache["v"][rows, positions] = v[:, 0]
    mask = (torch.arange(T, device=x.device)[None, :]
            <= positions[:, None])[:, None]                   # [B,1,T]
    out = _gqa_scores_to_out(q, cache["k"], cache["v"], mask)
    y = out.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return y, cache


# ----------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ----------------------------------------------------------------------------
def _mla_scale(cfg) -> float:
    """1/sqrt(qk_nope_dim + qk_rope_dim), rounded in f32 as the JAX
    package rounds it."""
    return float(np.float32(1.0) / np.sqrt(
        np.float32(cfg.qk_nope_dim + cfg.qk_rope_dim)))


def _mla_q(p, x, cfg):
    """x: [B, S, d] -> (q_nope [B,S,H,Dn], q_rope [B,S,H,Dr]), unrotated;
    with a q-LoRA rank the query goes through wq_a, q_norm and wq_b."""
    B, S, _ = x.shape
    qk_head = cfg.qk_nope_dim + cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = rms_norm_headwise(p["q_norm"], x @ p["wq_a"]) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(B, S, cfg.n_heads, qk_head)
    return q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)


def _mla_kv_latent(p, x, cfg, positions):
    """x: [B, S, d]; positions: [B, S] int -> (ckv [B,S,C] normed with the
    f32 ``kv_norm`` and cast back, k_rope [B,S,Dr] rotated as one head with
    frequencies from ``qk_rope_dim``)."""
    ckv, k_rope = (x @ p["wkv_a"]).split(
        [cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    ckv = rms_norm_headwise(p["kv_norm"], ckv)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return ckv, k_rope


def _mla_scores_to_out(q_nope, q_rope, k_nope, k_rope, v, mask, scale):
    """q_*: [B,S,H,D*]; k_nope, v: [B,T,H,D*]; k_rope: [B,T,Dr]; mask: bool
    broadcastable to [B,H,S,T] or None.  f32 throughout; returns
    [B,S,H,Dv] f32."""
    sc = (torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope.float())
          + torch.einsum("bshd,btd->bhst", q_rope.float(),
                         k_rope.float())) * scale
    if mask is not None:
        sc = _where_mask(sc, mask)
    attn = torch.softmax(sc, dim=-1)
    return torch.einsum("bhst,bthd->bshd", attn, v.float())


def _chunked_mla(q_nope, q_rope, k_nope, k_rope, v, scale, q_chunk=Q_CHUNK):
    """Causal MLA attention, q chunked.  q_*: [B,S,H,D*]; k_rope: [B,S,Dr].
    Returns [B,S,H,Dv] in the activation dtype."""
    S = q_nope.shape[1]
    outs = [_mla_scores_to_out(
        q_nope[:, s0:s0 + q_chunk], q_rope[:, s0:s0 + q_chunk], k_nope,
        k_rope, v, _causal_mask(q_chunk, S, q_nope.device, s0)[:, None],
        scale) for s0 in range(0, S, q_chunk)]
    return torch.cat(outs, dim=1).to(q_nope.dtype)


def mla_forward(p, x, cfg, positions, *, causal=True, return_cache=False):
    """Full-sequence MLA.  x: [B, S, d]; positions: [B, S] int.  Returns
    y [B, S, d], and with `return_cache` also the latent cache
    ``{"ckv": [B,S,C], "k_rope": [B,S,Dr]}``."""
    B, S, _ = x.shape
    q_nope, q_rope = _mla_q(p, x, cfg)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv, k_rope = _mla_kv_latent(p, x, cfg, positions)
    kv = (ckv @ p["wkv_b"]).reshape(B, S, cfg.n_heads,
                                    cfg.qk_nope_dim + cfg.v_head_dim)
    k_nope, v = kv.split([cfg.qk_nope_dim, cfg.v_head_dim], dim=-1)
    scale = _mla_scale(cfg)
    if causal and S >= CHUNK_THRESHOLD and S % Q_CHUNK == 0:
        out = _chunked_mla(q_nope, q_rope, k_nope, k_rope, v, scale)
    else:
        mask = _causal_mask(S, S, x.device)[:, None] if causal else None
        out = _mla_scores_to_out(q_nope, q_rope, k_nope, k_rope, v, mask,
                                 scale).to(x.dtype)
    y = out.reshape(B, S, cfg.n_heads * cfg.v_head_dim) @ p["wo"]
    if return_cache:
        return y, {"ckv": ckv, "k_rope": k_rope}
    return y


def _mla_decode_attend(p, x, cfg, q_nope, q_rope, ckv, k_rope, mask,
                       absorb):
    """One token's MLA attention over the updated latent cache.  mask: bool
    broadcastable to [B, H, 1, T].  ``wkv_b``'s columns are laid out
    ``[C, H, Dn + Dv]``.  ``absorb`` folds the key projection into the
    query and the value projection into the output, so the scores and the
    weighted sum run over the latent; otherwise per-token K/V are rebuilt
    from it.  Both in f32; the same function in another order."""
    scale = _mla_scale(cfg)
    qr, kr, cf = q_rope.float(), k_rope.float(), ckv.float()
    if absorb:
        q_c, w_v = mla_absorb_q(p, cfg, q_nope)
        sc = (torch.einsum("bshc,btc->bhst", q_c, cf)
              + torch.einsum("bshd,btd->bhst", qr, kr)) * scale
        attn = torch.softmax(_where_mask(sc, mask), dim=-1)
        o_c = torch.einsum("bhst,btc->bshc", attn, cf)
        return mla_absorb_out(p, x, cfg, o_c, w_v)
    kv = torch.einsum("btc,chd->bthd", cf, _mla_wkv_b(p, cfg))
    k_nope, v = kv.split([cfg.qk_nope_dim, cfg.v_head_dim], dim=-1)
    sc = (torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope)
          + torch.einsum("bshd,btd->bhst", qr, kr)) * scale
    attn = torch.softmax(_where_mask(sc, mask), dim=-1)
    out = torch.einsum("bhst,bthd->bshd", attn, v)
    return _mla_out(p, x, cfg, out)


def _mla_wkv_b(p, cfg):
    """``wkv_b`` in f32, its columns laid out [C, H, Dn + Dv]."""
    return p["wkv_b"].reshape(cfg.kv_lora_rank, cfg.n_heads,
                              cfg.qk_nope_dim + cfg.v_head_dim).float()


def mla_absorb_q(p, cfg, q_nope):
    """The absorbed form's query: q_nope [B,S,H,Dn] through the key half
    of ``wkv_b`` -> (q_c [B,S,H,C] f32, the value half w_v [C,H,Dv] f32)."""
    wkv_b = _mla_wkv_b(p, cfg)
    w_k = wkv_b[:, :, :cfg.qk_nope_dim]
    q_c = torch.einsum("bshd,chd->bshc", q_nope.float(), w_k)
    return q_c, wkv_b[:, :, cfg.qk_nope_dim:]


def mla_absorb_out(p, x, cfg, o_c, w_v):
    """The absorbed form's output: the latent attention output o_c
    [B,1,H,C] f32 through w_v, then ``wo`` -> y [B, 1, d]."""
    return _mla_out(p, x, cfg, torch.einsum("bshc,chd->bshd", o_c, w_v))


def _mla_out(p, x, cfg, out):
    B = x.shape[0]
    out = out.to(x.dtype).reshape(B, 1, cfg.n_heads * cfg.v_head_dim)
    return out @ p["wo"]


def mla_decode(p, x, cfg, cache, pos: int, *, absorb=True):  # hot-path
    """MLA decode over the latent cache.  x: [B, 1, d]; cache ``{"ckv":
    [B,T,C], "k_rope": [B,T,Dr]}``; pos: the new token's index.  The new
    latent is written at `pos` in place; every row attends over positions
    ``<= pos``.  ``absorb=True`` (what the server runs) is the
    matrix-absorption form.  Returns (y [B, 1, d], cache)."""
    B = x.shape[0]
    T = cache["ckv"].shape[1]
    posv = torch.full((B, 1), int(pos), dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg)
    q_rope = apply_rope(q_rope, posv, cfg.rope_theta)
    ckv_new, k_rope_new = _mla_kv_latent(p, x, cfg, posv)
    cache["ckv"][:, pos] = ckv_new[:, 0]
    cache["k_rope"][:, pos] = k_rope_new[:, 0]
    mask = (torch.arange(T, device=x.device) <= pos)[None, None, None, :]
    y = _mla_decode_attend(p, x, cfg, q_nope, q_rope, cache["ckv"],
                           cache["k_rope"], mask, absorb)
    return y, cache


def mla_decode_rows(p, x, cfg, cache, positions, *,
                    absorb=True):  # hot-path
    """Per-row-position MLA decode (continuous batching), the row-vector
    form of :func:`mla_decode`: positions is an int tensor [B] on x's
    device; row b writes its latent at ``(b, positions[b])`` in place and
    attends over entries ``<= positions[b]`` (later ones get exactly zero
    weight; see :func:`gqa_decode_rows`).  Returns (y [B, 1, d], cache)."""
    B = x.shape[0]
    T = cache["ckv"].shape[1]
    posv = positions[:, None]
    q_nope, q_rope = _mla_q(p, x, cfg)
    q_rope = apply_rope(q_rope, posv, cfg.rope_theta)
    ckv_new, k_rope_new = _mla_kv_latent(p, x, cfg, posv)
    rows = torch.arange(B, device=x.device)
    cache["ckv"][rows, positions] = ckv_new[:, 0]
    cache["k_rope"][rows, positions] = k_rope_new[:, 0]
    mask = (torch.arange(T, device=x.device)[None, :]
            <= positions[:, None])[:, None, None]             # [B,1,1,T]
    y = _mla_decode_attend(p, x, cfg, q_nope, q_rope, cache["ckv"],
                           cache["k_rope"], mask, absorb)
    return y, cache


# ----------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ----------------------------------------------------------------------------
def cross_attn_cache(p, enc_out, cfg):
    """The encoder's K/V for one decoder layer, made once at prefill.
    enc_out: [B, T, d] -> ``{"k", "v"}`` [B, T, H, D]."""
    B, T, _ = enc_out.shape
    hd = cfg.head_dim
    return {"k": (enc_out @ p["wk"]).reshape(B, T, cfg.n_heads, hd),
            "v": (enc_out @ p["wv"]).reshape(B, T, cfg.n_heads, hd)}


def cross_attn(p, x, cfg, kv):
    """x: [B, S, d] attends over every encoder position of `kv` (no mask,
    no rotation).  Returns y [B, S, d]."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    out = _gqa_scores_to_out(q, kv["k"], kv["v"], None)
    return out.reshape(B, S, cfg.n_heads * hd) @ p["wo"]
