"""Compression-state abstraction and DAG task model (§3.2, Fig. 6).

A *task* is the reconstruction of one tensor of one expert.  Its DAG depends
on the expert's runtime compression state:

  state M (miss)        : read_e[k] -> decomp[k] ─┐
                          read_sm ────────────────┴─> recover
  state E (E cached)    : decomp[k] (data in mem) ─┐
                          read_sm ─────────────────┴─> recover
  state S (SM cached)   : read_e[k] -> decomp[k] ──> recover
  state C (compressed)  : decomp[k] ──────────────> recover
  state F (full)        : (no task)
  state P (peer HBM)    : collective fetch from the owner device's slab
                          (no host I/O, no decompression; serialized on the
                          interconnect link — see ``peer_cost``)

Within a block the I/O thread loads E-chunks before SM-chunks (§3.3), so
decompression overlaps the SM reads.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Tuple


class CState(enum.Enum):
    M = "miss"
    E = "e_cached"
    S = "sm_cached"
    C = "compressed_cached"
    F = "full_cached"
    P = "peer_cached"


# state -> (needs E-chunk I/O, needs SM I/O, needs decompression)
STATE_NEEDS = {
    CState.M: (True, True, True),
    CState.E: (False, True, True),
    CState.S: (True, False, True),
    CState.C: (False, False, True),
    CState.F: (False, False, False),
    # peer-HBM resident: like F w.r.t. the host pipeline (no reads, no
    # decompression) — the link transfer is priced separately (peer_cost)
    CState.P: (False, False, False),
}


@dataclass
class Task:
    """One tensor-reconstruction task (DAG instance)."""
    expert: int                      # expert id n(j)
    tensor: int                      # tensor index within the expert
    state: CState
    p: float                         # GPU exec time of the whole expert (p_n)
    sm_cost: float                   # u       : SM-chunk read latency
    e_cost: float                    # ρu/K    : one E-chunk read latency
    dec_cost: float                  # c       : one E-chunk decompression
    k_shards: int                    # K
    uid: int = -1
    layer: int = 0                   # owning sparse layer (cross-layer jobs)
    peer_cost: float = 0.0           # interconnect fetch time (state P only)

    @property
    def expert_key(self) -> Tuple[int, int]:
        """Identity of the expert this task reconstructs.  Expert ids are
        only unique within a layer; one block list may span layers (a step's
        demand plus a later layer's predictions), so grouping/execution is
        keyed by (layer, expert)."""
        return (self.layer, self.expert)

    @property
    def needs_e_io(self) -> bool:
        return STATE_NEEDS[self.state][0]

    @property
    def needs_sm_io(self) -> bool:
        return STATE_NEEDS[self.state][1]

    @property
    def needs_decomp(self) -> bool:
        return STATE_NEEDS[self.state][2]

    @property
    def type_i(self) -> bool:
        """Type-I: requires loading SM-chunks (expensive blocking I/O)."""
        return self.needs_sm_io

    @property
    def io_workload(self) -> float:
        """v_j in Lemma B.3."""
        w = 0.0
        if self.needs_e_io:
            w += self.k_shards * self.e_cost
        if self.needs_sm_io:
            w += self.sm_cost
        return w

    @property
    def compute_workload(self) -> float:
        return self.k_shards * self.dec_cost if self.needs_decomp else 0.0

    def critical_path(self, L: int) -> float:
        """z_j in Definition B.2."""
        z = 0.0
        if self.needs_e_io:
            z += self.k_shards * self.e_cost                   # ρu
        dec = (self.k_shards * self.dec_cost) / min(self.k_shards, L) \
            if self.needs_decomp else 0.0
        sm = self.sm_cost if self.needs_sm_io else 0.0
        return z + max(dec, sm) + self.peer_cost + self.p


def make_tasks(expert_ids, states, p_times, *, n_tensors=1, u=1.0, rho=0.4,
               c=0.15, K=4, layer=0) -> List[Task]:
    """Uniform-cost task set (matches the paper's analytical model)."""
    tasks = []
    uid = 0
    for n, st, p in zip(expert_ids, states, p_times):
        for t in range(n_tensors):
            tasks.append(Task(expert=n, tensor=t, state=st, p=p,
                              sm_cost=u, e_cost=rho * u / K, dec_cost=c,
                              k_shards=K, uid=uid, layer=layer))
            uid += 1
    return tasks


def lower_bound(tasks: List[Task], L: int) -> float:
    """Lemma B.3: OPT >= max{I, C/L, P, Z} (+ the peer link workload,
    a serial resource like the I/O thread, when P-state tasks exist)."""
    I = sum(t.io_workload for t in tasks)
    C = sum(t.compute_workload for t in tasks)
    # P: each expert's exec counted once (keyed per layer — cross-layer
    # block lists may repeat an expert id in a different layer)
    seen = {}
    link = {}
    for t in tasks:
        seen[t.expert_key] = t.p
        if t.peer_cost:
            link[t.expert_key] = t.peer_cost
    P = sum(seen.values())
    LNK = sum(link.values())
    Z = max((t.critical_path(L) for t in tasks), default=0.0)
    return max(I, C / max(1, L), P, Z, LNK)
