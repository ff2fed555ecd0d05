"""Mixture-of-Experts layer for decode: router + routed and shared experts.

Routing variants:
* ``router_norm_topk=True`` (Qwen-MoE): softmax → top-k → renormalise.
* default (DeepSeek-V2): softmax over all experts, keep top-k probs as-is.

The routed expert stacks are ``[E, d, f]`` tensors.  At decode every
dispatch group holds one token and the JAX package's per-group capacity is
at least 8 (its ``group_capacity``), so no token is ever dropped and the
routed mixture is exactly ``Σ_k gate_k · expert_k(x)``; :func:`apply_moe_decode`
computes that directly, rounding each gate to the activation dtype before
the weighted sum as the JAX combine einsum does.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import (apply_mlp, dtype_of, init_mlp, normal,
                                       silu)


def init_moe(gen, cfg, device):
    dt = dtype_of(cfg)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    std = (2.0 / (d + f)) ** 0.5
    p = {"router": normal(gen, (d, cfg.n_experts), 0.02, torch.float32,
                          device)}
    if cfg.act == "swiglu":
        p["w_gate"] = normal(gen, (e, d, f), std, dt, device)
    p["w_up"] = normal(gen, (e, d, f), std, dt, device)
    p["w_down"] = normal(gen, (e, f, d), std, dt, device)
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, device,
                               d_ff=cfg.d_expert * cfg.n_shared_experts)
    return p


def route(router_w, x, cfg):
    """x: [..., d] -> (top_p [...,k] f32, top_i [...,k], probs [...,E])."""
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.router_norm_topk:
        top_p = top_p / (top_p.sum(-1, keepdim=True) + 1e-9)
    return top_p, top_i, probs


def apply_moe_decode(p, x, cfg):
    """x: [B, 1, d] -> (y [B, 1, d], top_i [B, 1, k]).  Every token runs
    its k selected experts (batched matmuls over the gathered weights)."""
    B, S, d = x.shape
    k = cfg.top_k
    top_p, top_i, _ = route(p["router"], x, cfg)
    idx = top_i.reshape(-1)                                   # [B*S*k]
    xe = x.reshape(B * S, 1, d).repeat_interleave(k, dim=0)   # [B*S*k, 1, d]
    if "w_gate" in p:
        h = silu(torch.bmm(xe, p["w_gate"][idx])) * \
            torch.bmm(xe, p["w_up"][idx])
    else:
        h = torch.nn.functional.gelu(torch.bmm(xe, p["w_up"][idx]),
                                     approximate="tanh")
    eout = torch.bmm(h, p["w_down"][idx]).reshape(B * S, k, d)
    gate = top_p.reshape(B * S, k, 1).to(x.dtype)
    y = (gate.float() * eout.float()).sum(1).to(x.dtype).reshape(B, S, d)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, cfg)
    return y, top_i
