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
    return {"tok": normal(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                          dtype_of(cfg), device)}


def init_lm_head(gen, cfg, device):
    return {"w": normal(gen, (cfg.d_model, cfg.vocab_size), 0.02,
                        dtype_of(cfg), device)}
