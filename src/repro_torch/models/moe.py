"""Mixture-of-Experts layer: router + routed and shared experts.

Routing variants (:func:`route`):
* ``router_norm_topk=True`` (Qwen-MoE): softmax → top-k → renormalise.
* default (DeepSeek-V2): softmax over all experts, keep top-k probs as-is.
* ``router_scoring="sigmoid"`` (DeepSeek-V3's ``noaux_tc`` at one group):
  sigmoid scores; the top-k of scores + a per-expert correction bias
  (``router_bias``, [E] f32) choose, the unbiased scores of the chosen
  experts weigh (renormalised with ``router_norm_topk``), times
  ``routed_scale``.

The routed expert stacks are ``[E, d, f]`` tensors.  Two entry points:

* :func:`apply_moe` — full sequences (prefill, training): GShard-style
  dense dispatch/combine einsums (``impl="einsum"``) or a scatter-add
  dispatch and gather combine with no dense dispatch tensor
  (``impl="scatter"``), with a per-group expert capacity
  (:func:`group_capacity`).  A (token, slot) pair whose queue position at
  its expert reaches the capacity is **dropped**, exactly as the JAX
  package drops it; queue positions are slot-major (:func:`_positions`).
* :func:`apply_moe_decode` — one token per dispatch group, where the
  capacity (at least 8) never binds: the routed mixture is exactly
  ``Σ_k gate_k · expert_k(x)``, computed directly, each gate rounded to the
  activation dtype before the weighted sum as the JAX combine einsum does.
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
    if cfg.router_scoring == "sigmoid":     # zeros, as DeepSeek-V3 starts it
        p["router_bias"] = torch.zeros(cfg.n_experts, dtype=torch.float32,
                                       device=device)
    return p


def group_capacity(s: int, cfg) -> int:
    """Per-group expert capacity, rounded up to 8 rows."""
    cap = -(-s * cfg.top_k * int(cfg.capacity_factor * 100)
            // (100 * cfg.n_experts))
    return max(8, (cap + 7) // 8 * 8)


def route(router_w, x, cfg, bias=None):
    """x: [..., d] -> (top_p [...,k] f32, top_i [...,k], probs [...,E]).

    ``probs`` are the softmax probabilities, or with a sigmoid router the
    sigmoid scores; `bias` ([E] f32, a sigmoid router's ``router_bias``)
    moves the choice only, never a gate."""
    logits = x.float() @ router_w
    if cfg.router_scoring == "sigmoid":
        if bias is None:
            raise ValueError(f"{cfg.name}: a sigmoid router needs its "
                             f"correction bias")
        probs = torch.sigmoid(logits)
        top_i = torch.topk(probs + bias, cfg.top_k, dim=-1).indices
        top_p = torch.take_along_dim(probs, top_i, dim=-1)
        if cfg.router_norm_topk:
            top_p = top_p / (top_p.sum(-1, keepdim=True) + 1e-20)
        return top_p * cfg.routed_scale, top_i, probs
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
    top_p, top_i, _ = route(p["router"], x, cfg, p.get("router_bias"))
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


def _positions(top_i, n_experts: int):
    """Queue position of every routing slot at its expert, within its
    group.  top_i: [G, s, k] -> pos [G, s, k] (int64).  Slot-major: every
    slot-0 choice of the group queues before any slot-1 choice (the Switch
    convention the JAX package follows)."""
    G, s, k = top_i.shape
    oh = torch.nn.functional.one_hot(top_i, n_experts)        # [G,s,k,E]
    ohf = oh.transpose(1, 2).reshape(G, k * s, n_experts)     # [G,ks,E]
    pos_f = ohf.cumsum(1) - ohf
    pos_f = pos_f.reshape(G, k, s, n_experts).transpose(1, 2)  # [G,s,k,E]
    return (pos_f * oh).sum(-1)


def _moe_ffn(p, xin):
    """xin: [E, G, C, d] -> [E, G, C, d] through each expert's MLP."""
    if "w_gate" in p:
        h = silu(torch.einsum("egcd,edf->egcf", xin, p["w_gate"])) * \
            torch.einsum("egcd,edf->egcf", xin, p["w_up"])
    else:
        h = torch.nn.functional.gelu(
            torch.einsum("egcd,edf->egcf", xin, p["w_up"]),
            approximate="tanh")
    return torch.einsum("egcf,efd->egcd", h, p["w_down"])


def _apply_einsum(p, xg, cfg, capacity):
    """xg: [G, s, d] grouped tokens -> (y [G, s, d], (top_i, probs))."""
    E, C = p["w_up"].shape[0], capacity
    top_p, top_i, probs = route(p["router"], xg, cfg,
                                p.get("router_bias"))         # [G,s,k]
    pos = _positions(top_i, E)
    keep = (pos < C).float()                                  # [G,s,k]
    # collapse the k slots (a token's expert ids are distinct)
    oh = torch.nn.functional.one_hot(top_i, E).float()        # [G,s,k,E]
    keep_e = torch.einsum("gske,gsk->gse", oh, keep)          # {0, 1}
    pos_e = torch.einsum("gske,gsk->gse", oh, pos.float() * keep)
    gate_e = torch.einsum("gske,gsk->gse", oh, top_p * keep)
    pos_oh = torch.nn.functional.one_hot(pos_e.long(), C).float()  # [G,s,E,C]
    disp = (keep_e[..., None] * pos_oh).to(xg.dtype)
    comb = (gate_e[..., None] * pos_oh).to(xg.dtype)
    xin = torch.einsum("gsec,gsd->egcd", disp, xg)            # [E,G,C,d]
    eout = _moe_ffn(p, xin)
    y = torch.einsum("gsec,egcd->gsd", comb, eout)
    return y, (top_i, probs)


def _apply_scatter(p, xg, cfg, capacity):
    """xg: [G, s, d] grouped tokens -> (y [G, s, d], (top_i, probs)): each
    kept (token, slot) pair is scatter-added into its expert's queue slot
    of ``[E, G, C, d]`` and its output gathered back from there; a dropped
    pair adds zeros at slot 0 and reads back with weight 0."""
    G, s, d = xg.shape
    E, C = p["w_up"].shape[0], capacity
    top_p, top_i, probs = route(p["router"], xg, cfg,
                                p.get("router_bias"))         # [G,s,k]
    pos = _positions(top_i, E)
    keep = pos < C
    posc = torch.where(keep, pos, torch.zeros_like(pos))
    gidx = torch.arange(G, device=xg.device)[:, None, None].expand_as(top_i)
    upd = xg[:, :, None, :] * keep[..., None].to(xg.dtype)    # [G,s,k,d]
    xin = torch.zeros((E, G, C, d), dtype=xg.dtype, device=xg.device)
    xin = xin.index_put((top_i, gidx, posc), upd, accumulate=True)
    eout = _moe_ffn(p, xin)                                   # [E,G,C,d]
    gath = eout[top_i, gidx, posc]                            # [G,s,k,d]
    w = (top_p * keep.float()).to(xg.dtype)
    y = torch.einsum("gskd,gsk->gsd", gath, w)
    return y, (top_i, probs)


def apply_moe(p, x, cfg, *, impl="einsum", capacity=None):
    """x: [B, S, d] -> (y [B, S, d], (top_i, probs)).

    Dispatch groups are the batch rows (G = B, s = S); the einsum dispatch
    splits them further into chunks of ``cfg.moe_group_size`` tokens when
    that divides S, as the JAX package does (its scatter dispatch has no
    dense tensor to shrink and does not)."""
    if impl not in ("einsum", "scatter"):
        raise ValueError(f"apply_moe impl={impl!r} (einsum or scatter)")
    B, S, d = x.shape
    g = cfg.moe_group_size
    if impl == "einsum" and g and S > g and S % g == 0:
        xg, s_eff = x.reshape(B * (S // g), g, d), g
    else:
        xg, s_eff = x, S
    fn = _apply_scatter if impl == "scatter" else _apply_einsum
    y, aux = fn(p, xg, cfg, capacity or group_capacity(s_eff, cfg))
    y = y.reshape(B, S, d)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, cfg)
    return y, aux


def load_balance_loss(probs, top_i, cfg):
    """Switch aux loss: E · Σ_e f_e · P_e (f = routed fraction, P = mean
    router probability).  A sigmoid router's scores are no distribution
    (``noaux_tc`` balances by its bias, with no auxiliary loss): refused."""
    if cfg.router_scoring != "softmax":
        raise ValueError(f"{cfg.name}: the Switch load-balance loss needs "
                         f"softmax probabilities, not "
                         f"{cfg.router_scoring!r} scores")
    E = cfg.n_experts
    frac = torch.nn.functional.one_hot(top_i, E).float().reshape(
        -1, E).mean(0)
    mean_p = probs.reshape(-1, probs.shape[-1]).mean(0)
    return E * (frac * mean_p).sum()
