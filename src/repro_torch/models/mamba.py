"""Mamba2 block: SSD (state-space duality) chunked prefill and recurrent
decode, plain PyTorch.

Follows the minimal SSD formulation of Dao & Gu (arXiv:2405.21060), as the
JAX package does: a within-chunk quadratic ("attention-like") term plus an
inter-chunk pass of the recurrent state, here a loop over chunks.  Decode
is one recurrence step carrying ``state [B, H, P, N]`` (f32) and a conv
ring of the last ``ssm_conv - 1`` pre-conv inputs ``[B, w - 1, C]``.

softplus(dt), ``A``, the state and the gated RMSNorm run in f32, the
projections and the prefill's depthwise conv in the activation dtype, as
the JAX package computes them.  :func:`mamba_decode` writes the new state
and conv ring into the cache **in place** (the JAX package returns
updated copies) and still returns the cache.

One deliberate difference: a prefill shorter than ``ssm_conv - 1`` tokens
returns its conv ring left-padded with zeros (the inputs before the first
token), so decoding continues as if the sequence had started at position
0.  The JAX package returns the short ring unpadded, and its
``grow_cache`` then places it at the ring's oldest end.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dtype_of, normal, silu


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------
def init_mamba(gen: torch.Generator, cfg, device) -> Dict[str, torch.Tensor]:
    dt = dtype_of(cfg)
    d = cfg.d_model
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv
    std = (2.0 / (d + di)) ** 0.5

    def dense(shape, s=std):
        return normal(gen, shape, s, dt, device)

    def f32(fill, n_):
        return torch.full((n_,), fill, dtype=torch.float32, device=device)

    return {
        "w_z": dense((d, di)),
        "w_x": dense((d, di)),
        "w_B": dense((d, g * n)),
        "w_C": dense((d, g * n)),
        "w_dt": dense((d, h)),
        "dt_bias": f32(0.0, h),
        "conv_w": dense((w, di + 2 * g * n), 0.2),
        "conv_b": torch.zeros(di + 2 * g * n, dtype=dt, device=device),
        "A_log": f32(0.0, h),                   # A = -exp(A_log) = -1
        "D": f32(1.0, h),
        "gate_norm": f32(1.0, di),
        "w_out": dense((di, d)),
    }


def init_ssm_cache(cfg, batch: int, device, dtype=None
                   ) -> Dict[str, torch.Tensor]:
    """An empty decode state: ``state [B, H, P, N]`` f32 and the conv ring
    ``[B, w - 1, C]`` in the activation dtype."""
    dt = dtype or dtype_of(cfg)
    c = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {"state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                                  cfg.ssm_state), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, c), dtype=dt,
                                device=device)}


# ----------------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------------
def _softplus(x):
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it (no
    threshold)."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def _proj(p, x, cfg):
    """x [B,L,d] -> z [B,L,di], xbc [B,L,di+2gn] (pre-conv), dt [B,L,h]
    (raw, f32)."""
    z = x @ p["w_z"]
    xbc = torch.cat([x @ p["w_x"], x @ p["w_B"], x @ p["w_C"]], dim=-1)
    dt = (x @ p["w_dt"]).float() + p["dt_bias"]
    return z, xbc, dt


def _causal_conv(p, xbc, cfg):
    """Depthwise causal conv of width ``ssm_conv`` over [B, L, C], in the
    activation dtype, then silu."""
    w, L = cfg.ssm_conv, xbc.shape[1]
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = pad[:, 0:L, :] * p["conv_w"][0]
    for i in range(1, w):
        out = out + pad[:, i:i + L, :] * p["conv_w"][i]
    return silu(out + p["conv_b"])


def _split_xbc(y, cfg):
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    return y.split([di, gn, gn], dim=-1)


def _bc_heads(t, cfg):
    """[..., g*n] -> [..., H, n]: head i reads group i // (H / g)."""
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    t = t.reshape(t.shape[:-1] + (g, n))
    return t.repeat_interleave(h // g, dim=-2)


def _gate_out(p, y, z, cfg):
    """RMSNorm(y * silu(z)) @ w_out, the norm in f32."""
    gated = y * silu(z.float())
    ms = gated.square().mean(-1, keepdim=True)
    gated = gated * torch.rsqrt(ms + 1e-6) * p["gate_norm"]
    return gated.to(p["w_out"].dtype) @ p["w_out"]


# ----------------------------------------------------------------------------
# full-sequence SSD (prefill)
# ----------------------------------------------------------------------------
def mamba_forward(p, x, cfg, *, return_cache=False):
    """x: [B, L, d] -> y [B, L, d]; with `return_cache` also the decode
    state after the last token (``{"state", "conv"}``).  L must be a
    multiple of the chunk ``min(ssm_chunk, L)``."""
    B, L, _ = x.shape
    h, pdim, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    cl = min(cfg.ssm_chunk, L)
    assert L % cl == 0, f"seq {L} not divisible by chunk {cl}"
    nc = L // cl

    z, xbc_pre, dt_raw = _proj(p, x, cfg)
    xs, B_, C_ = _split_xbc(_causal_conv(p, xbc_pre, cfg), cfg)
    dt = _softplus(dt_raw)                                     # [B,L,h]
    A = -torch.exp(p["A_log"])                                 # [h]

    xh = xs.reshape(B, L, h, pdim).float()
    xdt = xh * dt[..., None]                                   # [B,L,h,p]

    def ck(t):
        return t.reshape((B, nc, cl) + t.shape[2:])
    xdt_c = ck(xdt)
    B_c = ck(_bc_heads(B_, cfg).float())                       # [B,nc,cl,h,n]
    C_c = ck(_bc_heads(C_, cfg).float())
    dA_cs = torch.cumsum((dt * A).reshape(B, nc, cl, h), dim=2)
    dA_tot = dA_cs[:, :, -1, :]                                # [B,nc,h]

    # within-chunk (quadratic) term: L[i, j] = exp(cs[i] - cs[j]), i >= j
    diff = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]   # [B,nc,i,j,h]
    ltri = torch.ones((cl, cl), dtype=torch.bool,
                      device=x.device).tril()[None, None, :, :, None]
    lmat = torch.where(ltri, torch.exp(diff), torch.zeros((), device=x.device))
    scores = torch.einsum("bcihn,bcjhn->bcijh", C_c, B_c) * lmat
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores, xdt_c)

    # each chunk's own contribution to the state at its end
    decay = torch.exp(dA_tot[:, :, None, :] - dA_cs)           # [B,nc,cl,h]
    s_c = torch.einsum("bcjhn,bcjhp->bchpn", B_c * decay[..., None], xdt_c)

    # inter-chunk recurrence: the state entering each chunk
    state = torch.zeros((B, h, pdim, n), dtype=torch.float32,
                        device=x.device)
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = state * torch.exp(dA_tot[:, c])[:, :, None, None] + s_c[:, c]
    s_in = torch.stack(s_in, dim=1)                            # [B,nc,h,p,n]

    y_off = torch.einsum("bcihn,bchpn->bcihp",
                         C_c * torch.exp(dA_cs)[..., None], s_in)
    y = (y_diag + y_off).reshape(B, L, h, pdim) + xh * p["D"][:, None]
    out = _gate_out(p, y.reshape(B, L, cfg.d_inner), z, cfg)
    if not return_cache:
        return out
    w = cfg.ssm_conv
    tail = xbc_pre[:, max(0, L - (w - 1)):, :]
    tail = F.pad(tail, (0, 0, w - 1 - tail.shape[1], 0))
    return out, {"state": state, "conv": tail}


# ----------------------------------------------------------------------------
# single-token decode
# ----------------------------------------------------------------------------
def mamba_decode(p, x, cfg, cache):
    """x: [B, 1, d]; cache ``{"state": [B,H,P,N] f32, "conv": [B,w-1,C]}``,
    updated in place.  Returns (y [B, 1, d], cache)."""
    B = x.shape[0]
    h, pdim = cfg.ssm_heads, cfg.ssm_headdim
    z, xbc_pre, dt_raw = _proj(p, x, cfg)                      # [B,1,*]
    window = torch.cat([cache["conv"], xbc_pre.to(cache["conv"].dtype)],
                       dim=1)                                  # [B,w,C]
    conv = torch.einsum("bwc,wc->bc", window.float(), p["conv_w"].float()) \
        + p["conv_b"].float()
    y = silu(conv)[:, None, :].to(x.dtype)                     # [B,1,C]
    xs, B_, C_ = _split_xbc(y, cfg)
    dt = _softplus(dt_raw)[:, 0]                               # [B,h]
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, h, pdim).float()
    Bh = _bc_heads(B_[:, 0], cfg).float()                      # [B,h,n]
    Ch = _bc_heads(C_[:, 0], cfg).float()
    dA = torch.exp(dt * A)                                     # [B,h]
    state = cache["state"] * dA[:, :, None, None] \
        + (xh * dt[:, :, None])[..., None] * Bh[:, :, None, :]
    yh = torch.einsum("bhpn,bhn->bhp", state, Ch) + xh * p["D"][:, None]
    out = _gate_out(p, yh.reshape(B, 1, cfg.d_inner), z, cfg)
    cache["state"].copy_(state)
    cache["conv"].copy_(window[:, 1:])
    return out, cache
