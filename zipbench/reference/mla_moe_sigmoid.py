"""DeepSeek-V3 decoder at one routing group (kanana-2-30b-a3b): multi-head
latent attention with no query LoRA, dense first layers, then MoE layers of
routed top-k experts and shared experts; RMSNorm before each block; untied
LM head.

The router (``scoring_func`` sigmoid, ``topk_method`` noaux_tc with one
group), in float32: scores = sigmoid(x @ router); the k experts of the
largest scores + ``router_bias`` are chosen; their gates are their
unbiased scores, divided by the gates' sum when ``norm_topk_prob``, times
``routed_scaling_factor``.  The router's keys are read from the file's own
(``hp.published``), not from the program's mapping of them.

Attention is ``mla_moe.mla``.  One departure from the published model, the
one ``mla_moe.py`` documents: ``rope_interleave`` (adjacent rope dims
rotated as pairs) is taken as the fixed permutation of the rope columns of
``wq`` and ``wkv_a`` that rotates (i, i + Dr/2) instead.
"""
from __future__ import annotations

import torch

from .common import is_moe_layer, mlp, mm, no_tf32, rms_norm
from .mla_moe import mla


def choose(biased, k, chosen=None, tol=0.0, ties=None):
    """The k experts of the largest `biased` scores [N, E]; with `chosen`
    [N, k] (another computation's choice), that choice on each row where
    it is a near-tie: its lowest biased score within `tol` of the k-th
    largest.  `ties` (a dict) counts ``rows``, ``forced`` (rows taken from
    `chosen` that differ from the own choice), ``far`` (rows where
    `chosen` is further than `tol`: the own choice is kept) and keeps
    ``margin_max``, the widest margin among the forced rows."""
    top = torch.topk(biased, k, dim=-1)
    if chosen is None:
        return top.indices
    chosen = chosen.to(biased.device)
    margin = (top.values[:, -1] - biased.gather(-1, chosen).amin(-1)
              ).clamp(min=0)
    near = margin <= tol
    differs = margin > 0
    if ties is not None:
        forced = near & differs
        ties["rows"] = ties.get("rows", 0) + int(near.numel())
        ties["forced"] = ties.get("forced", 0) + int(forced.sum())
        ties["far"] = ties.get("far", 0) + int((~near).sum())
        if forced.any():
            ties["margin_max"] = max(ties.get("margin_max", 0.0),
                                     float(margin[forced].max()))
    return torch.where(near[:, None], chosen, top.indices)


def moe(p, x, hp, prec, chosen=None, tol=0.0, ties=None):
    """Routed experts plus shared ones on x [N, d] -> (y, the chosen
    experts [N, k]); `chosen`, `tol`, `ties`: see :func:`choose`."""
    pub = hp.published
    if pub["scoring_func"] != "sigmoid" or pub["topk_method"] != "noaux_tc":
        raise NotImplementedError(f"router {pub['scoring_func']!r} "
                                  f"{pub['topk_method']!r}")
    scores = torch.sigmoid(x.float() @ p["router"].float())
    top_i = choose(scores + p["router_bias"].float(),
                   pub["num_experts_per_tok"], chosen, tol, ties)
    top_p = scores.gather(-1, top_i)
    if pub["norm_topk_prob"]:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    top_p = top_p * pub["routed_scaling_factor"]
    y = torch.zeros_like(x, dtype=torch.float32)
    for e in torch.unique(top_i).tolist():
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        out = mlp(p, x[rows], hp.act, prec, w=e)
        y.index_add_(0, rows, top_p[rows, slot, None] * out)
    if "shared" in p:
        y = y + mlp(p["shared"], x, hp.act, prec)
    return y, top_i


def ffn(p, x, hp, i, prec, chosen=None, tol=0.0, ties=None, record=None):
    """Layer i's FFN on x [B, S, d]; `chosen` [B, S, k] or None; a MoE
    layer's choice [B, S, k] goes to ``record[i]``."""
    B, S, d = x.shape
    flat = x.reshape(B * S, d)
    if not is_moe_layer(hp, i):
        return mlp(p, flat, hp.act, prec).reshape(B, S, d)
    if chosen is not None:
        chosen = chosen.reshape(B * S, -1)
    y, top_i = moe(p, flat, hp, prec, chosen, tol, ties)
    if record is not None:
        record[i] = top_i.reshape(B, S, -1)
    return y.reshape(B, S, d)


def logits(params, hp, tokens, prec="f32", routes=None, tol=0.0, ties=None,
           record=None):
    """tokens [B, S] -> float32 logits [B, S, V] of a full causal pass.

    `routes` ({layer: [B, S, k] expert ids}, another computation's choice
    at each position) is taken where it is a near-tie within `tol` of the
    biased scores (:func:`choose`), so a choice that bf16 rounding decides
    either way is followed, not counted against the program; `ties`
    gathers the counts; `record` (a dict) receives the experts chosen."""
    routes = routes or {}
    with no_tf32():
        x = params["embed"]["tok"][tokens].float()
        for i, lp in enumerate(params["layers"]):
            x = x + mla(lp["attn"], rms_norm(x, lp["norm1"]["scale"]), hp,
                        prec)
            x = x + ffn(lp["ffn"], rms_norm(x, lp["norm2"]["scale"]), hp, i,
                        prec, routes.get(i), tol, ties, record)
        x = rms_norm(x, params["final_norm"]["scale"])
        return mm(x, params["lm_head"]["w"], prec)
