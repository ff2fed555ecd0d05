"""DeepSeek-V3 (``model_type`` ``deepseek_v3``) at one routing group:
latent attention, dense first layers, then experts chosen by sigmoid
scores plus a per-expert correction bias (``noaux_tc``) and weighed by the
unbiased scores, renormalised and scaled, plus shared experts.

What the port does not run is refused naming its key: grouped routing
(``n_group`` or ``topk_group`` above 1), another ``scoring_func`` or
``topk_method``, multi-token prediction layers, and any ``rope_scaling``
but none or YaRN at factor 1.
"""
from __future__ import annotations

import torch

from zipbench.families import deepseek_v2
from zipbench.reference import mla_moe_sigmoid

REFERENCE = mla_moe_sigmoid

# the correction bias is drawn N(0, BIAS_STD^2); a configuration file states
# it under ``assumed.router_bias_std``
BIAS_STD = 0.01
BIAS_LEAF = "router_bias"


def fields(c: dict) -> dict:
    name = c["name"]
    need = {"scoring_func": "sigmoid", "topk_method": "noaux_tc"}
    for k, v in need.items():
        if c.get(k) != v:
            raise ValueError(f"{name}: {k}={c.get(k)!r}: the port runs "
                             f"{v!r} only")
    for k in ("n_group", "topk_group"):
        if (c.get(k) or 1) > 1:
            raise ValueError(f"{name}: {k}={c[k]!r}: the port routes over "
                             f"one group only (grouped routing is not run)")
    if c.get("num_nextn_predict_layers", 0):
        raise ValueError(f"{name}: num_nextn_predict_layers="
                         f"{c['num_nextn_predict_layers']!r}: the port has "
                         f"no multi-token prediction layers")
    if c.get("head_dim", c["qk_rope_head_dim"]) != c["qk_rope_head_dim"]:
        raise ValueError(f"{name}: head_dim={c['head_dim']!r} is not "
                         f"qk_rope_head_dim={c['qk_rope_head_dim']!r}")
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    if c.get("qk_head_dim", qk) != qk:
        raise ValueError(f"{name}: qk_head_dim={c['qk_head_dim']!r} is not "
                         f"qk_nope_head_dim + qk_rope_head_dim = {qk}")
    std = c.get("assumed", {}).get("router_bias_std", BIAS_STD)
    if std != BIAS_STD:
        raise ValueError(f"{name}: assumed.router_bias_std={std!r}: the "
                         f"family draws the bias at {BIAS_STD}")
    # every other key maps, and is refused, as DeepSeek-V2's
    plain = deepseek_v2.fields(dict(c, scoring_func="softmax",
                                    topk_method="greedy",
                                    routed_scaling_factor=1))
    return dict(plain, router_scoring="sigmoid",
                routed_scale=float(c["routed_scaling_factor"]))


def leaf_rule(path, t, gen):
    """The correction bias, N(0, BIAS_STD^2); no other leaf."""
    if path[-1] != BIAS_LEAF:
        return None
    return BIAS_STD * torch.randn(t.shape, generator=gen, dtype=t.dtype,
                                  device=gen.device)
