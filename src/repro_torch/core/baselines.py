"""Baseline serving-system models (§5 comparison targets).

Latency models of the three baselines the paper compares against, driven by
the same traces and hardware constants as ZipMoESim:

* ``AccelerateSim``  — plain offloading: LRU cache of *full* expert tensors;
  every miss is a blocking full-tensor read; no overlap, no compression.
* ``DeepSpeedSim``   — ZeRO-3-style sliding-window streaming: every layer's
  *entire* parameter set is fetched each step (activation-agnostic), with the
  fetch of layer l+1 overlapped with layer l's compute.  Memory-budget
  agnostic below model size (matches the paper's Fig. 7 observation).
* ``MoEInfinitySim`` — sparsity-aware full-tensor caching + activation-based
  prefetch: an LFU cache of full experts; next-layer experts are predicted
  with accuracy ``prefetch_acc`` and prefetched during the current layer's
  compute; correct predictions hide their I/O.
"""
from __future__ import annotations

from typing import Sequence, Set

import numpy as np

from repro_torch.core.cache import FlatCache
from repro_torch.core.simulator import HW, MoESpec, exec_time


class AccelerateSim:
    name = "accelerate"

    def __init__(self, spec: MoESpec, hw: HW, mem_budget: float, *,
                 attn_time: float = 0.0, **_):
        self.spec, self.hw = spec, hw
        self.attn_time = attn_time
        cap = int(mem_budget / spec.n_layers / spec.expert_bytes_full)
        self.caches = [FlatCache(cap, "lru") for _ in range(spec.n_layers)]

    def step(self, selections: Sequence[Set[int]], tokens_per_expert=None) -> float:
        total = 0.0
        read_t = self.spec.expert_bytes_full / self.hw.storage_bw
        for l, experts in enumerate(selections):
            cache = self.caches[l]
            io = 0.0
            ex = 0.0
            for e in experts:
                hit = cache.access(e)
                if not hit:
                    io += read_t
                tpe = (tokens_per_expert or {}).get(e, 1)
                ex += exec_time(self.spec, self.hw, tpe)
            total += io + max(ex, self.attn_time)   # blocking I/O, then compute
        return total


class DeepSpeedSim:
    name = "deepspeed"

    def __init__(self, spec: MoESpec, hw: HW, mem_budget: float = 0.0, *,
                 attn_time: float = 0.0, **_):
        self.spec, self.hw = spec, hw
        self.attn_time = attn_time

    def step(self, selections: Sequence[Set[int]], tokens_per_expert=None) -> float:
        # stream ALL experts of every layer; overlap layer l+1 I/O with layer l
        layer_io = (self.spec.n_experts * self.spec.expert_bytes_full
                    / self.hw.storage_bw)
        total = layer_io                                   # first layer: no overlap
        for l, experts in enumerate(selections):
            ex = sum(exec_time(self.spec, self.hw,
                               (tokens_per_expert or {}).get(e, 1))
                     for e in experts)
            comp = max(ex, self.attn_time)
            if l < len(selections) - 1:
                total += max(comp, layer_io)               # pipelined
            else:
                total += comp
        return total


class MoEInfinitySim:
    name = "moe-infinity"

    def __init__(self, spec: MoESpec, hw: HW, mem_budget: float, *,
                 attn_time: float = 0.0, prefetch_acc: float = 0.7, seed: int = 0,
                 **_):
        self.spec, self.hw = spec, hw
        self.attn_time = attn_time
        self.acc = prefetch_acc
        cap = int(mem_budget / spec.n_layers / spec.expert_bytes_full)
        self.caches = [FlatCache(cap, "lfu") for _ in range(spec.n_layers)]
        self.rng = np.random.default_rng(seed)

    def step(self, selections: Sequence[Set[int]], tokens_per_expert=None) -> float:
        total = 0.0
        read_t = self.spec.expert_bytes_full / self.hw.storage_bw
        prev_comp = 0.0
        for l, experts in enumerate(selections):
            cache = self.caches[l]
            blocking_io = 0.0
            hidden_io = 0.0
            ex = 0.0
            for e in experts:
                hit = cache.access(e)
                tpe = (tokens_per_expert or {}).get(e, 1)
                ex += exec_time(self.spec, self.hw, tpe)
                if not hit:
                    # prefetched during the previous layer's compute with prob acc
                    if self.rng.random() < self.acc:
                        hidden_io += read_t
                    else:
                        blocking_io += read_t
            comp = max(ex, self.attn_time)
            # hidden I/O only hides under the previous layer's compute window
            total += blocking_io + max(0.0, hidden_io - prev_comp) + comp
            prev_comp = comp
        return total


BASELINES = {"accelerate": AccelerateSim, "deepspeed": DeepSpeedSim,
             "moe-infinity": MoEInfinitySim}
