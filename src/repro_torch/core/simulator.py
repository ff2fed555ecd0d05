"""Discrete-event serving simulator: ZipMoE end-to-end latency model.

Drives the *same* scheduler (Algorithm 1), cache pools, and planner as the
real engine, over an expert-activation trace, with profiled hardware
constants.  Used by the benchmark harness to reproduce the paper's Figs 7–10
(TPOT/TTFT vs memory budget, throughput vs batch, e2e latency, cache
ablation); the real threaded engine (engine.py) validates the same logic with
actual I/O + zstd decompression.

Hardware model (constants profiled or taken from the paper's testbed):
  storage_bw   : offload-tier read bandwidth (3.5 GB/s Samsung 970 EVO)
  dec_bw       : per-thread decompression throughput (bytes of *compressed*
                 exponent input per second)
  p_exec       : accelerator time per expert per step
  attn_time    : non-MoE (attention etc.) accelerator time per layer
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from repro_torch.core.cache import FlatCache, HierarchicalCache
from repro_torch.core.planner import PlanConsts, plan_pools
from repro_torch.core.scheduler import schedule
from repro_torch.core.states import CState, Task
from repro_torch.core.workload import FreqTracker, rank_inclusion_probs


@dataclass(frozen=True)
class HW:
    storage_bw: float = 3.5e9        # B/s (NVMe read)
    dec_bw: float = 1.2e9            # B/s per worker (zstd decompress, compressed input)
    L: int = 4                       # decompression workers
    recover_bw: float = 60e9         # accelerator recovery kernel (memory-bound)
    flop_rate: float = 20e12         # accelerator FLOP/s (edge-class)


@dataclass(frozen=True)
class MoESpec:
    n_layers: int
    n_experts: int
    top_k: int
    d_model: int
    d_expert: int
    n_tensors: int = 3               # w_gate, w_up, w_down
    rho: float = 0.41                # compressed/raw exponent bytes (measured)
    K: int = 4

    @property
    def tensor_elems(self) -> int:
        return self.d_model * self.d_expert

    @property
    def expert_bytes_full(self) -> int:
        return 2 * self.n_tensors * self.tensor_elems

    def bytes_per_state(self) -> Dict[str, float]:
        full = self.expert_bytes_full
        sm = full / 2
        e = self.rho * full / 2
        return {"F": full, "C": sm + e, "S": sm, "E": e}


def profile_consts(spec: MoESpec, hw: HW) -> PlanConsts:
    sm_bytes = spec.tensor_elems                  # 1 B/elem per tensor
    e_bytes = spec.rho * spec.tensor_elems / spec.K
    u = sm_bytes / hw.storage_bw
    v = e_bytes / hw.storage_bw
    c = e_bytes / hw.dec_bw
    return PlanConsts(u=u, v=v, c=c, L=hw.L, K=spec.K,
                      n_tensors=spec.n_tensors)


def exec_time(spec: MoESpec, hw: HW, tokens: int = 1) -> float:
    """Accelerator time for one expert's FFN on `tokens` tokens."""
    flops = 2 * spec.n_tensors * spec.tensor_elems * tokens
    return flops / hw.flop_rate


# ----------------------------------------------------------------------------
# ZipMoE simulator
# ----------------------------------------------------------------------------
class ZipMoESim:
    """Per-layer hierarchical caches + cache-affinity scheduling."""

    name = "zipmoe"

    def __init__(self, spec: MoESpec, hw: HW, mem_budget: float, *,
                 warm_trace: Optional[Sequence[Set[int]]] = None,
                 plan: bool = True, eviction: str = "rank",
                 attn_time: float = 0.0, step_grid: float = 0.125):
        self.spec, self.hw = spec, hw
        self.consts = profile_consts(spec, hw)
        self.attn_time = attn_time
        per_layer_budget = mem_budget / spec.n_layers
        bps = spec.bytes_per_state()
        if plan and warm_trace:
            f = rank_inclusion_probs(warm_trace, spec.n_experts)
            k_eff = max(1, min(spec.n_experts,
                               round(np.mean([len(s) for s in warm_trace]))))
            self.plan = plan_pools(f, k_eff, per_layer_budget, bps, self.consts,
                                   step=step_grid)
            sizes = self.plan.sizes
        else:
            self.plan = None
            sizes = {"F": int(per_layer_budget / bps["F"]), "C": 0, "S": 0, "E": 0}
        self.layers = []
        for _ in range(spec.n_layers):
            tr = FreqTracker(spec.n_experts)
            if eviction == "rank":
                cache = HierarchicalCache(sizes, tr)
            else:
                cap = int(per_layer_budget / bps["F"])
                cache = FlatCache(cap, eviction)
            self.layers.append((cache, tr))

    def _layer_states(self, cache, experts) -> Dict[int, CState]:
        if isinstance(cache, HierarchicalCache):
            return cache.record_access(list(experts))
        out = {}
        for e in experts:
            out[e] = cache.residency(e)
            cache.access(e)
        return out

    def step(self, selections: Sequence[Set[int]], tokens_per_expert=None
             ) -> float:
        """One decode step: `selections[l]` = experts activated at layer l.
        Returns the step latency (sum of per-layer makespans)."""
        total = 0.0
        cst = self.consts
        for l, experts in enumerate(selections):
            cache, _ = self.layers[l]
            states = self._layer_states(cache, experts)
            tasks = []
            uid = 0
            for e in experts:
                tpe = (tokens_per_expert or {}).get(e, 1)
                p = exec_time(self.spec, self.hw, tpe)
                for t in range(self.spec.n_tensors):
                    tasks.append(Task(expert=e, tensor=t, state=states[e],
                                      p=p, sm_cost=cst.u, e_cost=cst.v,
                                      dec_cost=cst.c, k_shards=cst.K, uid=uid))
                    uid += 1
            _, tl = schedule(tasks, self.hw.L)
            total += max(tl.makespan, self.attn_time)
            if isinstance(cache, HierarchicalCache):
                for e in experts:
                    cache.admit(e)
        return total


# ----------------------------------------------------------------------------
# generic run helpers
# ----------------------------------------------------------------------------
def run_decode(sim, trace_layers: Sequence[Sequence[Set[int]]],
               tokens_per_expert=None) -> List[float]:
    """trace_layers[t][l] = expert set at step t, layer l."""
    return [sim.step(step_sel, tokens_per_expert) for step_sel in trace_layers]


def make_layer_trace(n_layers: int, n_experts: int, k: int, steps: int, *,
                     alpha: float = 1.0, batch: int = 1, seed: int = 0):
    """Independent zipf trace per layer."""
    from repro_torch.core.workload import zipf_trace
    per_layer = [zipf_trace(n_experts, k, steps, alpha=alpha, batch=batch,
                            seed=seed * 1000 + l) for l in range(n_layers)]
    return [[per_layer[l][t] for l in range(n_layers)] for t in range(steps)]
