"""Model facade: init / init_cache / forward / prefill / decode_step for
decoder-only stacks.  Every layer is ``x += mixer(norm(x)); x += ffn(norm(x))``
with mixer ∈ {GQA or MLA attention, Mamba2} and ffn ∈ {MoE, dense MLP,
none}: dense and MoE decoders, the SSM family (mamba2, every layer a
Mamba2 mixer with no FFN) and the hybrid family (jamba's attention every
``attn_every`` layers, Mamba2 elsewhere).

Parameters are a plain dict with a **per-layer list**, not the JAX
package's scanned stack::

    {"embed": {"tok": [V, d]},
     "layers": [{"norm1", "attn" | "mamba", ["norm2", "ffn"]}, ...],
     "final_norm": {"scale"}, "lm_head": {"w": [d, V]}}

and the caches a per-layer list of ``{"kv": ...}`` (attention) or
``{"ssm": {"state", "conv"}}`` (Mamba2).  ``init_params`` draws them from
a seeded ``torch.Generator`` (on the target device);
``repro_torch.convert.params_from_jax`` builds the same structure from the
JAX package's parameter tree.  :func:`prefill` followed by
:func:`decode_step` is the fully resident model that the serving paths
are checked against.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (apply_mlp, apply_norm, init_embed,
                                       init_lm_head, init_mlp, init_norm)


def stack_layout(cfg):
    """(prefix_indices, period, n_superblocks) of the JAX package's scanned
    stack — what the converter needs to unstack its parameters."""
    prefix = list(range(cfg.first_dense))
    period = 1
    if cfg.is_moe and cfg.moe_every > 1:
        period = period * cfg.moe_every // math.gcd(period, cfg.moe_every)
    if cfg.family == "hybrid":
        period = period * cfg.attn_every // math.gcd(period, cfg.attn_every)
    rest = cfg.n_layers - cfg.first_dense
    assert rest % period == 0, (cfg.name, rest, period)
    return prefix, period, rest // period


def mixer_kind(cfg, idx: int) -> str:
    """``"mamba"`` or ``"attn"``: layer `idx`'s sequence mixer."""
    if cfg.family == "ssm" or (cfg.family == "hybrid"
                               and not cfg.attn_layer(idx)):
        return "mamba"
    return "attn"


def ffn_kind(cfg, idx: int) -> str:
    """``"moe"``, ``"mlp"`` or ``"none"`` (mamba2: no FFN at all)."""
    if cfg.moe_layer(idx):
        return "moe"
    return "mlp" if cfg.d_ff else "none"


def check_supported(cfg):
    """Raise ``NotImplementedError`` for a config the port does not serve:
    every entry point that takes a config calls this before any work."""
    fam = cfg.family
    ok = (fam in ("moe", "dense", "ssm", "hybrid")
          and not cfg.encoder_decoder and not cfg.mrope
          and not cfg.tie_embeddings and cfg.embed_inputs)
    if fam == "ssm":           # no attention layer at all
        ok = ok and cfg.attn == "none" and cfg.pos == "none"
    else:
        ok = ok and cfg.attn in ("gqa", "mla") and (
            cfg.pos == "rope" or (fam == "hybrid" and cfg.pos == "none"))
    if fam in ("ssm", "hybrid"):
        # a Mamba2 mixer needs a state, whole heads and whole groups
        ok = ok and cfg.ssm_state > 0 and cfg.ssm_headdim > 0 \
            and cfg.ssm_conv > 1 and cfg.d_inner % cfg.ssm_headdim == 0 \
            and cfg.ssm_groups > 0 and cfg.ssm_heads % cfg.ssm_groups == 0 \
            and (fam == "ssm" or cfg.attn_every > 0)
    if not ok:
        raise NotImplementedError(
            f"{cfg.name}: the port serves decoder-only dense and MoE GQA/MLA "
            f"RoPE models, Mamba2 SSMs and attention/Mamba2 hybrids so far")


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------
def init_layer(gen, cfg, idx: int, device) -> Dict[str, Any]:
    p: Dict[str, Any] = {"norm1": init_norm(cfg, device)}
    if mixer_kind(cfg, idx) == "attn":
        p["attn"] = attn_lib.init_attn(gen, cfg, device)
    else:
        p["mamba"] = mamba_lib.init_mamba(gen, cfg, device)
    fk = ffn_kind(cfg, idx)
    if fk != "none":
        p["norm2"] = init_norm(cfg, device)
        p["ffn"] = (moe_lib.init_moe(gen, cfg, device) if fk == "moe"
                    else init_mlp(gen, cfg, device))
    return p


def init_params(cfg, seed: int = 0, device=None) -> Dict[str, Any]:
    """Seeded random parameters on `device` (the card by default)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    p: Dict[str, Any] = {"embed": init_embed(gen, cfg, dev)}
    p["layers"] = [init_layer(gen, cfg, i, dev) for i in range(cfg.n_layers)]
    p["final_norm"] = init_norm(cfg, dev)
    p["lm_head"] = init_lm_head(gen, cfg, dev)
    return p


def init_layer_cache(cfg, idx: int, batch: int, length: int, device
                     ) -> Dict[str, Any]:
    """Layer `idx`'s empty cache: ``{"kv": ...}`` of `length` tokens, or a
    Mamba2 layer's sequence-free ``{"ssm": {"state", "conv"}}``."""
    if mixer_kind(cfg, idx) == "attn":
        return {"kv": attn_lib.init_kv_cache(cfg, batch, length, device)}
    return {"ssm": mamba_lib.init_ssm_cache(cfg, batch, device)}


def init_cache(cfg, batch: int, length: int, device=None) -> List[Dict]:
    """Per-layer caches on `device` (the card by default)."""
    check_supported(cfg)
    dev = resolve_device(device)
    return [init_layer_cache(cfg, i, batch, length, dev)
            for i in range(cfg.n_layers)]


# ----------------------------------------------------------------------------
# full-sequence passes
# ----------------------------------------------------------------------------
def forward(p, cfg, tokens, *, mode="full", moe_impl="einsum",
            router_ids=None):
    """Full-sequence causal pass.  tokens: [B, S] int.  Returns (logits
    [B, S, V], caches, aux): with ``mode="prefill"`` the per-layer list of
    caches (attention: ``{"kv": {"k", "v"}}`` of length S, with MLA the
    latent ``{"ckv", "k_rope"}``; Mamba2: ``{"ssm": {"state", "conv"}}``
    after the last token), else None; aux is the summed load-balance loss
    of the MoE layers.  A Mamba2 stack needs S to be a multiple of
    ``min(ssm_chunk, S)``.  When `router_ids` is a list, the router's
    [B, S, k] expert ids of each MoE layer are appended to it."""
    assert mode in ("full", "prefill"), mode
    x = p["embed"]["tok"][tokens]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    caches = [] if mode == "prefill" else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    attn_forward = attn_lib.mla_forward if cfg.attn == "mla" else \
        attn_lib.gqa_forward
    for lp in p["layers"]:
        h = apply_norm(lp["norm1"], x, cfg)
        if "mamba" in lp:
            y, c = mamba_lib.mamba_forward(lp["mamba"], h, cfg,
                                           return_cache=True)
            c = {"ssm": c}
        else:
            y, kv = attn_forward(lp["attn"], h, cfg, positions,
                                 return_cache=True)
            c = {"kv": kv}
        if caches is not None:
            caches.append(c)
        x = x + y
        if "ffn" in lp:
            h2 = apply_norm(lp["norm2"], x, cfg)
            if "router" in lp["ffn"]:
                y2, (top_i, probs) = moe_lib.apply_moe(lp["ffn"], h2, cfg,
                                                       impl=moe_impl)
                aux = aux + moe_lib.load_balance_loss(probs, top_i, cfg)
                if router_ids is not None:
                    router_ids.append(top_i)
            else:
                y2 = apply_mlp(lp["ffn"], h2, cfg)
            x = x + y2
    x = apply_norm(p["final_norm"], x, cfg)
    return x @ p["lm_head"]["w"], caches, aux


def prefill(p, cfg, tokens, *, moe_impl="einsum", router_ids=None):
    """tokens: [B, S] -> (logits [B, S, V], per-layer caches of length S)."""
    logits, caches, _ = forward(p, cfg, tokens, mode="prefill",
                                moe_impl=moe_impl, router_ids=router_ids)
    return logits, caches


# ----------------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------------
def decode_step(p, cfg, tokens, caches, pos: int, router_ids=None):
    """One decode step.  tokens: [B, 1] int; caches: per-layer list (updated
    in place); pos: index of the new token.  Returns (logits [B,1,V],
    caches).  When `router_ids` is a list, the router's [B,1,k] expert ids
    of each MoE layer are appended to it."""
    x = p["embed"]["tok"][tokens]
    attn_decode = attn_lib.mla_decode if cfg.attn == "mla" else \
        attn_lib.gqa_decode
    for lp, cache in zip(p["layers"], caches):
        h = apply_norm(lp["norm1"], x, cfg)
        if "mamba" in lp:
            y, _ = mamba_lib.mamba_decode(lp["mamba"], h, cfg, cache["ssm"])
        else:
            y, _ = attn_decode(lp["attn"], h, cfg, cache["kv"], pos)
        x = x + y
        if "ffn" in lp:
            h2 = apply_norm(lp["norm2"], x, cfg)
            if "router" in lp["ffn"]:
                y2, ids = moe_lib.apply_moe_decode(lp["ffn"], h2, cfg)
                if router_ids is not None:
                    router_ids.append(ids)
            else:
                y2 = apply_mlp(lp["ffn"], h2, cfg)
            x = x + y2
    x = apply_norm(p["final_norm"], x, cfg)
    return x @ p["lm_head"]["w"], caches
