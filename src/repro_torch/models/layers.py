"""Core neural-net building blocks (plain PyTorch, functional).

Parameters are plain dicts of tensors, laid out as in the JAX package
(``x @ w`` with ``w`` as [in, out]), so the tests can feed both packages
the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(gen: torch.Generator, shape, std: float, dtype, device
           ) -> torch.Tensor:
    """N(0, std²) draw from `gen` (on `device`), cast to `dtype`."""
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


# ----------------------------------------------------------------------------
# Normalisation
# ----------------------------------------------------------------------------
def init_norm(cfg, device, d=None):
    d = d or cfg.d_model
    p = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


def apply_norm(p, x, cfg, eps=1e-6):
    xf = x.float()
    if cfg.norm == "layernorm":
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
        y = y * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


# ----------------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------------
def rope_freqs(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x, positions, theta):
    """x: [..., S, H, D]; positions: [..., S] int."""
    d = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(d, theta).astype(np.float32)).to(
        x.device)                                             # [D/2]
    angles = positions[..., None].float() * freqs             # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                     # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta, sections=(16, 24, 24)):
    """Qwen2-VL multimodal RoPE.  x: [B, S, H, D]; positions3: [3, B, S]
    int (temporal, height, width channels).  `sections` gives the number
    of frequency pairs each channel rotates (summing to D/2); for another
    head dim they are rescaled in proportion, the last taking the rest."""
    d = x.shape[-1]
    half = d // 2
    secs = list(sections)
    if sum(secs) != half:
        base = [s / sum(sections) for s in sections]
        secs = [int(round(b * half)) for b in base]
        secs[-1] = half - secs[0] - secs[1]
    freqs = torch.from_numpy(rope_freqs(d, theta).astype(np.float32)).to(
        x.device)                                             # [D/2]
    # output_size: the meta device (the dry run) cannot read `secs` back
    chan = torch.repeat_interleave(torch.arange(3, device=x.device),
                                   torch.tensor(secs, device=x.device),
                                   output_size=half)
    p = positions3.permute(1, 2, 0).float()                   # [B, S, 3]
    angles = p[..., chan] * freqs                             # [B, S, D/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Dense MLP (SwiGLU or GELU)
# ----------------------------------------------------------------------------
def silu(x):
    """``x * sigmoid(x)`` in x's dtype, the sigmoid as ``1 / (1 + exp(-x))``
    with each op rounded to that dtype: how the JAX package lowers it
    (``torch.sigmoid`` rounds once and differs in the last bf16 bit)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def init_mlp(gen, cfg, device, d_ff=None, d=None):
    d = d or cfg.d_model
    d_ff = d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    std = (2.0 / (d + d_ff)) ** 0.5
    p = {}
    if cfg.act == "swiglu":
        p["w_gate"] = normal(gen, (d, d_ff), std, dt, device)
    p["w_up"] = normal(gen, (d, d_ff), std, dt, device)
    p["w_down"] = normal(gen, (d_ff, d), std, dt, device)
    return p


def apply_mlp(p, x, cfg):
    if "w_gate" in p:
        h = silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = torch.nn.functional.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


# ----------------------------------------------------------------------------
# Embedding / LM head
# ----------------------------------------------------------------------------
def init_embed(gen, cfg, device):
    """``tok`` [V, d] where the model embeds tokens; with learned positions
    also ``pos``, one row per position: ``max(enc_seq_len, 32768)`` rows
    for an encoder-decoder (its encoder reads the table too), else
    32768."""
    p = {}
    if cfg.embed_inputs:
        p["tok"] = normal(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                          dtype_of(cfg), device)
    if cfg.pos == "learned":
        rows = max(cfg.enc_seq_len, 32768) if cfg.encoder_decoder else 32768
        p["pos"] = normal(gen, (rows, cfg.d_model), 0.02, dtype_of(cfg),
                          device)
    return p


def init_lm_head(gen, cfg, device):
    return {"w": normal(gen, (cfg.d_model, cfg.vocab_size), 0.02,
                        dtype_of(cfg), device)}
