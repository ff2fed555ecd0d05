"""Cache-affinity scheduler (§3.3, Appendix A, Algorithm 1).

Resources: one I/O thread (SSD/host-channel reads), L decompression worker
threads, one accelerator stream (recovery + expert execution).

Execution semantics (work-conserving, Appendix A): blocks impose a priority
order; within a block the I/O thread loads E-chunks before SM-chunks, each in
task-priority order.  Workers take the highest-priority *ready* decompression
op whenever free.  Expert execution serialises on the accelerator stream once
all of the expert's tensors are recovered.

``simulate`` is the discrete-event evaluator used both by the runtime engine
(to order real thread work) and by the benchmarks; ``build_blocks`` is
Algorithm 1; ``lower_bound`` (states.py) gives the Lemma B.3 bound used by the
Theorem 3.1 property tests.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.states import Task, lower_bound


# ----------------------------------------------------------------------------
# discrete-event simulation of an ordered block list
# ----------------------------------------------------------------------------
@dataclass
class Timeline:
    makespan: float                 # completion of the last expert execution
    io_end: float
    worker_ends: List[float]
    worker_idle: float              # total decompression-thread idle (gaps)
    task_ready: Dict[int, float]    # uid -> all-tensors-recovered time
    expert_done: Dict[Tuple[int, int], float]   # (layer, expert) -> done time
    events: List[Tuple[str, int, float, float]] = field(default_factory=list)


def simulate(blocks: Sequence[Sequence[Task]], L: int, *,
             record_events: bool = False,
             worker_speeds: Optional[Sequence[float]] = None) -> Timeline:
    """worker_speeds: per-worker throughput multipliers (straggler modelling;
    1.0 = nominal).  Work-conservation bounds a slow worker's damage: it only
    stretches ops assigned to it, and free fast workers keep draining the
    ready queue (benchmarks/straggler rows; tests/test_scheduler)."""
    tasks = [t for b in blocks for t in b]
    # --- I/O thread ---------------------------------------------------------
    e_avail: Dict[Tuple[int, int], float] = {}
    sm_avail: Dict[int, float] = {}
    events = []
    io_t = 0.0
    for blk in blocks:
        for t in blk:                        # E-chunks first (task order)
            if t.needs_e_io:
                for k in range(t.k_shards):
                    s = io_t
                    io_t += t.e_cost
                    e_avail[(t.uid, k)] = io_t
                    if record_events:
                        events.append(("io_e", t.uid, s, io_t))
        for t in blk:                        # then SM-chunks
            if t.needs_sm_io:
                s = io_t
                io_t += t.sm_cost
                sm_avail[t.uid] = io_t
                if record_events:
                    events.append(("io_sm", t.uid, s, io_t))
    for t in tasks:                          # cached components: ready at 0
        if not t.needs_e_io:
            for k in range(t.k_shards):
                e_avail[(t.uid, k)] = 0.0
        if not t.needs_sm_io:
            sm_avail[t.uid] = 0.0

    # --- peer interconnect (P tier): a serial link, like the I/O thread -----
    # peer-resident tasks carry no host I/O or decompression, but their
    # collective fetches queue on the interconnect in block/task order —
    # that transfer time gates the expert's readiness (priced per task from
    # the profiled link bandwidth; 0 everywhere without a P tier)
    peer_avail: Dict[int, float] = {}
    link_t = 0.0
    for blk in blocks:
        for t in blk:
            if t.peer_cost:
                s = link_t
                link_t += t.peer_cost
                peer_avail[t.uid] = link_t
                if record_events:
                    events.append(("link", t.uid, s, link_t))

    # --- L decompression workers (work-conserving, priority order) ----------
    prio = {t.uid: i for i, t in enumerate(tasks)}
    pend = [(prio[t.uid], t.uid, k, e_avail[(t.uid, k)], t.dec_cost)
            for t in tasks if t.needs_decomp for k in range(t.k_shards)]
    pend.sort()
    dec_end: Dict[int, float] = {t.uid: 0.0 for t in tasks}
    workers = [0.0] * max(1, L)
    w_idle = [0.0] * max(1, L)
    heap = [(0.0, i) for i in range(max(1, L))]
    heapq.heapify(heap)
    remaining = list(pend)
    while remaining:
        wt, wi = heapq.heappop(heap)
        ready = [op for op in remaining if op[3] <= wt + 1e-12]
        if ready:
            op = min(ready)                      # highest priority ready
            start = wt
        else:
            nxt = min(op[3] for op in remaining)
            ready = [op for op in remaining if op[3] <= nxt + 1e-12]
            op = min(ready)
            start = nxt
        remaining.remove(op)
        _, uid, k, ready_at, cost = op
        speed = worker_speeds[wi] if worker_speeds else 1.0
        end = start + cost / max(speed, 1e-9)
        w_idle[wi] += start - wt
        dec_end[uid] = max(dec_end[uid], end)
        if record_events:
            events.append((f"dec_w{wi}", uid, start, end))
        heapq.heappush(heap, (end, wi))
        workers[wi] = end

    # --- task-ready and expert execution on the accelerator stream ----------
    # experts are keyed (layer, expert): a cross-layer block list may carry
    # the same expert id for two different layers (two distinct executions)
    task_ready = {}
    for t in tasks:
        r = 0.0
        if t.needs_decomp:
            r = max(r, dec_end[t.uid])
        if t.needs_sm_io:
            r = max(r, sm_avail[t.uid])
        if t.uid in peer_avail:
            r = max(r, peer_avail[t.uid])
        task_ready[t.uid] = r
    expert_ready: Dict[Tuple[int, int], float] = {}
    expert_p: Dict[Tuple[int, int], float] = {}
    for t in tasks:
        expert_ready[t.expert_key] = max(expert_ready.get(t.expert_key, 0.0),
                                         task_ready[t.uid])
        expert_p[t.expert_key] = t.p
    gpu_t = 0.0
    expert_done = {}
    for n in sorted(expert_ready, key=lambda n: expert_ready[n]):
        gpu_t = max(gpu_t, expert_ready[n]) + expert_p[n]
        expert_done[n] = gpu_t
        if record_events:
            events.append(("gpu", n, gpu_t - expert_p[n], gpu_t))
    return Timeline(makespan=gpu_t, io_end=io_t, worker_ends=workers,
                    worker_idle=sum(w_idle), task_ready=task_ready,
                    expert_done=expert_done, events=events)


# ----------------------------------------------------------------------------
# Definition A.1: compute-dominant check
# ----------------------------------------------------------------------------
def compute_dominant(block: Sequence[Task], L: int) -> bool:
    if not block:
        return False
    tl = simulate([list(block)], L)
    ecost = max(t.e_cost for t in block)
    K = max(t.k_shards for t in block)
    ends = sorted(tl.worker_ends)
    kk = min(L, K)
    for l in range(1, kk + 1):
        if l - 1 >= len(ends):
            break
        if ends[l - 1] - tl.io_end < l * ecost - 1e-12:
            return False
    return True


# ----------------------------------------------------------------------------
# Algorithm 1: block construction
# ----------------------------------------------------------------------------
def _sorted_group(tasks: List[Task]) -> List[Task]:
    """Non-increasing p, same-expert tasks consecutive (per layer: a
    cross-layer set may repeat expert ids across layers)."""
    return sorted(tasks, key=lambda t: (-t.p, t.layer, t.expert, t.tensor))


def build_blocks(tasks: Sequence[Task], L: int, *,
                 fast_threshold: int = 48) -> List[List[Task]]:
    # F-state tasks carry no I/O/decompression ops but their expert execution
    # still serialises on the accelerator stream — keep them (as Type-II).
    #
    # Concurrency contract (tools/zipcheck): this module is pure functions
    # over caller-owned Task lists — no module/self state, so no locks.  The
    # one mutation below touches the caller's Tasks before the job is
    # published to the worker pool (submit_steps holds them single-threaded
    # until the `with self._cv` publish).
    live = list(tasks)
    for i, t in enumerate(live):
        if t.uid < 0:
            t.uid = i           # single-writer: decode (pre-publish)
    s1 = _sorted_group([t for t in live if t.type_i])
    s2 = _sorted_group([t for t in live if not t.type_i])
    blocks: List[List[Task]] = []
    if not s1:                      # no Type-I: a single block of Type-II tasks
        return [s2] if s2 else []
    if len(live) > fast_threshold:
        # O(n) fallback for large task sets (batched prefill): interleave
        # Type-II under Type-I in priority order — the work-conserving
        # executor saturates anyway once the pipeline is deep (the O(n^3)
        # insertion search only pays off for small interactive sets).
        return [_interleave(s1, s2)]
    while s1:
        U: List[Task] = list(s2) + list(s1)
        B: List[Task] = [s1.pop(0)]
        U.remove(B[0])
        while not compute_dominant(B, L) and U:
            j = U.pop(0)
            base_idle = simulate([B], L).worker_idle
            placed = False
            # a task may only be placed BEHIND every task of higher-or-equal
            # priority: within a block the I/O thread reads chunks in task
            # order, so inserting at an earlier position would let j's I/O
            # jump work with larger p.  (Historical bug: the search started
            # at pos 0, and since equal-cost candidates tie on worker idle,
            # it reliably inserted at the *front* — reversing the priority
            # order and putting speculative I/O ahead of demand I/O.)
            min_pos = max((i + 1 for i, t in enumerate(B) if t.p >= j.p),
                          default=0)
            for pos in range(min_pos, len(B) + 1):
                cand = B[:pos] + [j] + B[pos:]
                if simulate([cand], L).worker_idle <= base_idle + 1e-12:
                    B = cand
                    placed = True
                    break
            if not placed:
                # append after the last job (Type-II preferred) with p >= p_j
                t2_pos = [i for i, t in enumerate(B)
                          if (not t.type_i) and t.p >= j.p]
                t1_pos = [i for i, t in enumerate(B) if t.type_i and t.p >= j.p]
                if t2_pos:
                    B.insert(t2_pos[-1] + 1, j)
                elif t1_pos:
                    B.insert(t1_pos[-1] + 1, j)
                else:
                    B.append(j)
            if j in s1:
                s1.remove(j)
            else:
                s2.remove(j)
        blocks.append(B)
    if s2:                          # leftover Type-II tasks form a final block
        blocks.append(list(s2))
    return blocks


def _interleave(s1: List[Task], s2: List[Task]) -> List[Task]:
    """Merge Type-II tasks between Type-I tasks proportionally."""
    if not s2:
        return list(s1)
    out: List[Task] = []
    ratio = max(1, len(s2) // max(1, len(s1)))
    j = 0
    for t in s1:
        out.append(t)
        for _ in range(ratio):
            if j < len(s2):
                out.append(s2[j])
                j += 1
    out.extend(s2[j:])
    return out


def schedule(tasks: Sequence[Task], L: int, *, record_events=False
             ) -> Tuple[List[List[Task]], Timeline]:
    blocks = build_blocks(tasks, L)
    return blocks, simulate(blocks, L, record_events=record_events)


# ----------------------------------------------------------------------------
# references for tests / ablations
# ----------------------------------------------------------------------------
def naive_schedule(tasks: Sequence[Task], L: int) -> Timeline:
    """No overlap intelligence: single block, arrival order."""
    live = list(tasks)
    for i, t in enumerate(live):
        if t.uid < 0:
            t.uid = i
    return simulate([live], L)


def brute_force_best(tasks: Sequence[Task], L: int, limit: int = 7) -> float:
    """Best makespan over all task permutations (single-block semantics) and
    all contiguous block partitions.  Exponential — tiny instances only."""
    live = list(tasks)
    for i, t in enumerate(live):
        if t.uid < 0:
            t.uid = i
    if len(live) > limit:
        raise ValueError("instance too large for brute force")
    best = float("inf")
    n = len(live)
    for perm in itertools.permutations(live):
        # partitions: each gap either splits or not (2^(n-1))
        for mask in range(1 << max(0, n - 1)):
            blocks, cur = [], [perm[0]]
            for i in range(1, n):
                if mask >> (i - 1) & 1:
                    blocks.append(cur)
                    cur = [perm[i]]
                else:
                    cur.append(perm[i])
            blocks.append(cur)
            best = min(best, simulate(blocks, L).makespan)
    return best
