"""Expert-activation traces from a model's own routers.

The planner consumes historical expert activation counts; this utility
produces them from full-sequence forward passes (rather than synthetic
Zipf workloads), per MoE layer, so ``plan_pools`` can be fitted to the
model's own routing distribution.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set

import numpy as np
import torch

from repro_torch.models.model import forward


def collect_routing_trace(params, cfg, token_batches: Sequence[np.ndarray]
                          ) -> Dict[int, List[Set[int]]]:
    """Run a full-sequence forward per batch and record, per MoE layer, the
    set of experts its router activated (one trace entry per batch).

    Returns {layer_idx: [set(expert_ids), ...]}."""
    moe_layers = [i for i, lp in enumerate(params["layers"])
                  if "ffn" in lp and "router" in lp["ffn"]]
    traces: Dict[int, List[Set[int]]] = {i: [] for i in moe_layers}
    dev = params["embed"]["tok"].device
    for tokens in token_batches:
        ids: List[torch.Tensor] = []
        forward(params, cfg, torch.as_tensor(np.asarray(tokens),
                                             device=dev).long(),
                router_ids=ids)
        for i, ti in zip(moe_layers, ids):
            traces[i].append({int(e) for e in ti.reshape(-1).cpu().numpy()})
    return traces


def fit_plan_from_trace(trace: Sequence[Set[int]], cfg, mem_budget: float,
                        bytes_per_state, consts, **kw):
    """Trace -> rank inclusion probabilities -> pool plan."""
    from repro_torch.core.planner import plan_pools
    from repro_torch.core.workload import effective_k, rank_inclusion_probs
    f = rank_inclusion_probs(trace, cfg.n_experts)
    k = min(effective_k(trace), cfg.n_experts)
    return plan_pools(f, k, mem_budget, bytes_per_state, consts, **kw)
