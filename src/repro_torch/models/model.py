"""Model facade for decode: init / init_cache / decode_step (MoE and dense
GQA decoders).

Parameters are a plain dict with a **per-layer list**, not the JAX
package's scanned stack::

    {"embed": {"tok": [V, d]},
     "layers": [{"norm1", "attn", "norm2", "ffn"}, ...],
     "final_norm": {"scale"}, "lm_head": {"w": [d, V]}}

``init_params`` draws them from a seeded ``torch.Generator`` (on the target
device); ``repro_torch.convert.params_from_jax`` builds the same structure
from the JAX package's parameter tree.  :func:`decode_step` is the fully
resident model that the serving path is checked against.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
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


def _check_supported(cfg):
    if cfg.attn != "gqa" or cfg.family not in ("moe", "dense") or \
            cfg.encoder_decoder or cfg.mrope or cfg.pos != "rope" or \
            cfg.tie_embeddings or not cfg.embed_inputs:
        raise NotImplementedError(
            f"{cfg.name}: the port serves decoder-only GQA/RoPE models with "
            f"MoE or dense FFNs so far")


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------
def init_layer(gen, cfg, idx: int, device) -> Dict[str, Any]:
    p: Dict[str, Any] = {"norm1": init_norm(cfg, device),
                         "attn": attn_lib.init_attn(gen, cfg, device)}
    if cfg.moe_layer(idx):
        p["norm2"] = init_norm(cfg, device)
        p["ffn"] = moe_lib.init_moe(gen, cfg, device)
    elif cfg.d_ff:
        p["norm2"] = init_norm(cfg, device)
        p["ffn"] = init_mlp(gen, cfg, device)
    return p


def init_params(cfg, seed: int = 0, device=None) -> Dict[str, Any]:
    """Seeded random parameters on `device` (the card by default)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    p: Dict[str, Any] = {"embed": init_embed(gen, cfg, dev)}
    p["layers"] = [init_layer(gen, cfg, i, dev) for i in range(cfg.n_layers)]
    p["final_norm"] = init_norm(cfg, dev)
    p["lm_head"] = init_lm_head(gen, cfg, dev)
    return p


def init_cache(cfg, batch: int, length: int, device=None) -> List[Dict]:
    """Per-layer KV caches on `device` (the card by default)."""
    dev = resolve_device(device)
    return [{"kv": attn_lib.init_kv_cache(cfg, batch, length, dev)}
            for _ in range(cfg.n_layers)]


# ----------------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------------
def decode_step(p, cfg, tokens, caches, pos: int, router_ids=None):
    """One decode step.  tokens: [B, 1] int; caches: per-layer list (updated
    in place); pos: index of the new token.  Returns (logits [B,1,V],
    caches).  When `router_ids` is a list, the router's [B,1,k] expert ids
    of each MoE layer are appended to it."""
    x = p["embed"]["tok"][tokens]
    for lp, cache in zip(p["layers"], caches):
        h = apply_norm(lp["norm1"], x, cfg)
        y, _ = attn_lib.gqa_decode(lp["attn"], h, cfg, cache["kv"], pos)
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
