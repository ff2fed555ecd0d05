"""Compression-aware hierarchical cache (§3.4).

The hierarchy is an explicit, ordered tier stack (``core/tiers.py``); the
default stack reproduces the paper's pools in order F ≺ C ≺ S ≺ E:
  F : fully reconstructed tensors          (bytes/expert: 2·n_elems)
  C : compressed E-chunks + SM-chunks      (sm + e_compressed)
  S : SM-chunks only                        (sm)
  E : E-chunks only                         (e_compressed)

Dispatch: an expert with observed rank r goes to the first pool i whose
cumulative-capacity threshold ``τ_i = Σ_{j⪯i} S_j + δ`` exceeds r.  Overflow
evicts the pool's least-frequently-activated *unpinned* resident.  Experts
beyond every threshold are evicted right after execution.

Live-engine extensions (used by core/engine.py):

* ``pin``/``unpin`` — experts selected in the current decode step are pinned
  while their fetch is in flight, so overflow churn from admitting one
  selected expert can never evict another one mid-step.
* residency-state transition counters (``transitions``) and eviction counts,
  surfaced by ``summary()`` next to per-pool hit rates.

``FlatCache`` provides the FIFO / LRU / Marking baselines for the Fig. 10
ablation (single full-tensor pool, classic eviction policies, simulator
cost model).  ``LiveFlatCache`` is its live-engine counterpart: the same
classic policies behind the HierarchicalCache interface, holding fully
reconstructed tensors only — the "flat reconstructed-tensor map" baseline
the Fig. 10 live ablation compares against.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Set, Tuple

from repro_torch.core import checkz
from repro_torch.core.states import CState
from repro_torch.core.tiers import DEFAULT_STACK, TierStack
from repro_torch.core.workload import FreqTracker

# historical alias: the default (paper) tier order.  The live caches now
# carry their own ``self.order`` derived from an explicit TierStack; this
# constant remains for the simulator and for callers of the 4-tier default.
POOL_ORDER = DEFAULT_STACK.order


def pool_summary(mode: str, hits, misses: int, occupancy, capacity,
                 transitions, evictions: int, pinned: int,
                 occupancy_bytes=None,
                 capacity_bytes=None) -> Dict[str, object]:
    """Shared §3.4 telemetry schema of HierarchicalCache and LiveFlatCache
    (consumed and Counter-merged by ``engine.cache_summary``).  The byte
    views are present whenever residency costs are known (the live engine
    derives them from the store's real chunk sizes) — the planner thinks
    in bytes, so the telemetry must too."""
    n_hits = sum(hits.values())
    acc = n_hits + misses
    return {
        "mode": mode,
        "hits": dict(hits),
        "misses": misses,
        "accesses": acc,
        "hit_rate": n_hits / acc if acc else 0.0,
        "occupancy": dict(occupancy),
        "capacity": dict(capacity),
        "occupancy_bytes": dict(occupancy_bytes or {}),
        "capacity_bytes": dict(capacity_bytes or {}),
        "transitions": {f"{a}->{b}": n
                        for (a, b), n in sorted(transitions.items())},
        "evictions": evictions,
        "pinned": pinned,
    }

# pool residency -> compression state of an expert
def residency_state(in_f: bool, has_e: bool, has_sm: bool) -> CState:
    if in_f:
        return CState.F
    if has_e and has_sm:
        return CState.C
    if has_sm:
        return CState.S
    if has_e:
        return CState.E
    return CState.M


@dataclass
class PoolEntry:
    expert: int
    payload: object = None          # engine attaches real buffers here


class _LiveCacheTelemetry:
    """Shared hit/transition/pin bookkeeping of the live caches
    (HierarchicalCache and LiveFlatCache report the same schema and must
    never diverge — see pool_summary)."""

    def _init_telemetry(self):
        # the live caches have NO locks by design: every mutator runs on the
        # engine caller's (decode) thread.  ZIPMOE_CHECK=1 turns that prose
        # contract into an owning-thread assertion (checkz.MutatorGuard).
        self._guard = checkz.make_guard(f"{type(self).__name__}")
        self.hits = collections.Counter()
        self.misses = 0
        # per-expert residency cost per pool (bytes), set by the engine from
        # the layer's real tensor/chunk sizes; None = byte view unavailable
        self.cost_bytes: Optional[Dict[str, float]] = None
        # planned byte capacity per pool (the §3.4 planner's γ_p · budget);
        # kept next to the derived expert-count caps for telemetry
        self.cap_bytes: Optional[Dict[str, float]] = None
        # refcounted pins: an expert can be pinned independently by the step
        # that selected it AND by the submit_step fetching it; membership
        # (`e in pinned`) means "pinned by at least one owner"
        self.pinned = collections.Counter()
        self.transitions = collections.Counter()   # (from_state, to_state)
        self.evictions = 0                         # residents dropped to M

    def pin(self, experts: Sequence[int]):
        """Protect `experts` from eviction until a matching :meth:`unpin`.
        Refcounted: each pin() call needs its own unpin(), so a step's pin
        survives a fetch job independently releasing its own.  The engine
        pins a step's selected experts while their fetch is in flight so
        admitting one of them can never churn another out mid-step."""
        self._guard.check()
        for e in experts:
            self.pinned[int(e)] += 1

    def unpin(self, experts: Sequence[int]):
        self._guard.check()
        for e in experts:
            k = int(e)
            n = self.pinned.get(k, 0) - 1
            if n > 0:
                self.pinned[k] = n
            else:
                self.pinned.pop(k, None)

    def reset_stats(self):
        """Zero the telemetry counters (hit/miss/transition/eviction) without
        touching residency — e.g. to report steady state after a warmup."""
        self.hits.clear()
        self.misses = 0
        self.transitions.clear()
        self.evictions = 0

    def residency_many(self, experts) -> Dict[int, "CState"]:
        """Bulk *pure* residency lookup: no stats, tracker, or recency
        mutation (unlike record_access) — the attribution primitive for
        per-request hit accounting when several requests share one step's
        union selection."""
        return {int(e): self.residency(int(e)) for e in experts}

    def bytes_occupancy(self) -> Dict[str, float]:
        """Resident bytes per pool (occupancy × per-expert residency cost);
        empty when the byte costs are unknown (simulator)."""
        if self.cost_bytes is None:
            return {}
        return {p: len(self.pools[p]) * float(self.cost_bytes.get(p, 0.0))
                for p in self.order}

    def bytes_capacity(self) -> Dict[str, float]:
        """Byte capacity per pool: the planner's cap_bytes when planned,
        else derived from the expert-count caps × residency costs."""
        if self.cap_bytes is not None:
            return dict(self.cap_bytes)
        if self.cost_bytes is None:
            return {}
        return {p: self.cap.get(p, 0) * float(self.cost_bytes.get(p, 0.0))
                for p in self.order}


class HierarchicalCache(_LiveCacheTelemetry):
    """Bookkeeping for one sparse layer's expert cache."""

    mode = "hier"

    def __init__(self, capacities: Dict[str, int], tracker: FreqTracker,
                 delta: int = 1, stack: Optional[TierStack] = None):
        # the residency hierarchy is an explicit ordered TierStack; the
        # default reproduces the paper's F ≺ C ≺ S ≺ E exactly
        self.stack = stack if stack is not None else DEFAULT_STACK
        self.order = self.stack.order
        self.cap = {p: int(capacities.get(p, 0)) for p in self.order}
        self.tracker = tracker
        self.delta = delta
        self.pools: Dict[str, Dict[int, PoolEntry]] = {p: {} for p in self.order}
        self._init_telemetry()
        # optional live-engine hook: (payload, target_pool) -> payload|None.
        # Downgrades a demoted resident's payload to the bytes the target
        # pool can actually serve; None means nothing real backs the pool and
        # the entry is dropped rather than kept as a byte-less placeholder
        # (which would count as a hit but cost a full fetch).  Unset in the
        # simulator, where payloads are not used and membership is the state.
        self.demote_payload = None

    # -- state queries --------------------------------------------------------
    def residency(self, expert: int) -> CState:
        # full-payload tiers (F, and P when stacked) win in stack order;
        # partial residency then combines the component pools as before
        for t in self.stack.tiers:
            if t.payload == "full" and expert in self.pools[t.name]:
                return t.state
        in_c = expert in self.pools.get("C", {})
        has_e = in_c or expert in self.pools.get("E", {})
        has_sm = in_c or expert in self.pools.get("S", {})
        return residency_state(False, has_e, has_sm)

    def thresholds(self) -> Dict[str, int]:
        t, cum = {}, 0
        for p in self.order:
            cum += self.cap[p]
            t[p] = cum + self.delta
        return t

    def target_pool(self, expert: int) -> Optional[str]:
        r = self.tracker.rank(expert)
        for p, tau in self.thresholds().items():
            if self.cap[p] > 0 and r < tau:
                return p
        return None

    # -- mutation ---------------------------------------------------------------
    def _fit_payload(self, payload, pool: str) -> Tuple[bool, object]:
        """(ok, fitted): downgrade `payload` to what `pool` can back via the
        live-engine hook.  No hook or no payload (simulator / fresh admit,
        whose payload is attached post-placement): pass through untouched."""
        if payload is None or self.demote_payload is None:
            return True, payload
        fitted = self.demote_payload(payload, pool)
        return fitted is not None, fitted

    def _place(self, expert: int, start_pool: str, payload=None,
               depth: int = 0) -> Optional[str]:
        """Insert `expert` at `start_pool` or the first lower pool that admits
        its rank.  On overflow the *least-frequent unpinned* of
        {residents ∪ incoming} loses and cascades down — the δ-tolerance
        margin can therefore never churn a hot expert out of the cache
        entirely, and a pinned (in-flight) resident never loses its slot."""
        if depth > len(self.order) + 2:
            return None
        taus = self.thresholds()
        r = self.tracker.rank(expert)
        started = False
        for p in self.order:
            if p == start_pool:
                started = True
            if not started or self.cap[p] <= 0 or r >= taus[p]:
                continue
            ok, pl = self._fit_payload(payload, p)
            if not ok:
                continue           # nothing real to back this pool: cascade
            if len(self.pools[p]) < self.cap[p]:
                self.pools[p][expert] = PoolEntry(expert, pl)
                return p
            candidates = [e for e in self.pools[p] if e not in self.pinned]
            if not candidates:
                continue               # every resident pinned: try next pool
            victim = self.tracker.least_frequent(candidates)
            if self.tracker.counts[victim] < self.tracker.counts[expert]:
                ent = self.pools[p].pop(victim)
                self.pools[p][expert] = PoolEntry(expert, pl)
                # demote the displaced resident (with its bytes) down a tier
                nxt = self.order.index(p) + 1
                placed = None
                if nxt < len(self.order):
                    placed = self._place(victim, self.order[nxt], ent.payload,
                                         depth + 1)
                self.transitions[(p, placed or "M")] += 1
                if placed is None:
                    self.evictions += 1
                return p
            # incoming loses: try the next pool down for it
        return None

    def admit(self, expert: int, payload=None) -> Optional[str]:
        """Place expert per dispatch rule (called after its execution)."""
        self._guard.check()
        prev = self.residency(expert)
        target = self.target_pool(expert)
        # drop from any other pool (state change / re-placement)
        prev_pool, prev_ent = None, None
        for p in self.order:
            if expert in self.pools[p]:
                prev_pool, prev_ent = p, self.pools[p].pop(expert)
        if expert in self.pinned and prev_pool is not None and (
                target is None
                or self.order.index(target) > self.order.index(prev_pool)):
            # a pinned (mid-step) resident whose rank would now dispatch it
            # DOWN (or out) keeps its pool until unpinned: its current
            # payload may be backing in-flight weights — in device_cache
            # mode an F slot the FFN is about to gather from — so
            # re-dispatch is deferred to its next unpinned admission.  The
            # fresher payload still replaces the old one when it fits.
            ok, pl = self._fit_payload(payload, prev_pool)
            if not (ok and pl is not None):
                pl = prev_ent.payload
            self.pools[prev_pool][expert] = PoolEntry(expert, pl)
            return prev_pool
        placed = self._place(expert, target, payload) if target else None
        if placed is None and expert in self.pinned and prev_pool is not None:
            # a pinned (in-flight) resident must never lose residency to its
            # own re-admission — e.g. when every slot below its new rank is
            # held by pinned step-mates.  Restore it (with the fresher
            # payload when it fits the pool; _place mutates nothing on
            # failure, so its old slot is still free).
            ok, pl = self._fit_payload(payload, prev_pool)
            if not (ok and pl is not None):
                pl = prev_ent.payload
            self.pools[prev_pool][expert] = PoolEntry(expert, pl)
            placed = prev_pool
        new = self.residency(expert)
        if prev is not new:
            self.transitions[(prev.name, new.name)] += 1
            if new is CState.M and prev is not CState.M:
                self.evictions += 1
        return placed

    def resize(self, capacities: Dict[str, int],
               cap_bytes: Optional[Dict[str, float]] = None):
        """Re-point the pool capacities at a new §3.4 plan (live
        re-planning; the engine calls this between decode steps).

        Grow is churn-free: capacities rise, every resident keeps its pool
        and payload.  Shrink is graceful: each over-capacity pool demotes
        its least-frequent *unpinned* residents one pool down (the payload
        travels and is downgraded by the demotion hook, exactly like an
        overflow demotion), cascading F→C→S→E→M in hierarchy order so a
        pool's arrivals are counted before it is trimmed itself.  A pinned
        (mid-step / in-flight) resident is never touched — if every
        resident of an over-full pool is pinned the trim is deferred to the
        residents' next admission (``_place`` enforces the new caps from
        now on)."""
        self._guard.check()
        self.cap = {p: int(capacities.get(p, 0)) for p in self.order}
        if cap_bytes is not None:
            self.cap_bytes = {p: float(cap_bytes.get(p, 0.0))
                              for p in self.order}
        for i, p in enumerate(self.order):
            pool = self.pools[p]
            while len(pool) > self.cap[p]:
                cand = [e for e in pool if e not in self.pinned]
                if not cand:
                    break              # everything pinned: defer the trim
                victim = self.tracker.least_frequent(cand)
                ent = pool.pop(victim)
                placed = None
                if i + 1 < len(self.order):
                    placed = self._place(victim, self.order[i + 1],
                                         ent.payload)
                self.transitions[(p, placed or "M")] += 1
                if placed is None:
                    self.evictions += 1

    def record_access(self, experts: Sequence[int]) -> Dict[int, CState]:
        """Look up states for a step's selected experts + update stats."""
        self._guard.check()
        self.tracker.record(experts)
        out = {}
        for e in experts:
            st = self.residency(e)
            out[e] = st
            if st is CState.M:
                self.misses += 1
            else:
                self.hits[st.name] += 1
        return out

    def occupancy(self) -> Dict[str, int]:
        return {p: len(self.pools[p]) for p in self.order}

    def summary(self) -> Dict[str, object]:
        """Per-pool hit rates + residency-transition counts (§3.4 telemetry)."""
        return pool_summary(self.mode, self.hits, self.misses,
                            self.occupancy(), self.cap, self.transitions,
                            self.evictions, len(self.pinned),
                            self.bytes_occupancy(), self.bytes_capacity())


# ----------------------------------------------------------------------------
# classic-eviction baselines (Fig. 10 ablation)
# ----------------------------------------------------------------------------
def select_victim(order: Sequence[int], policy: str, freq, marks: Set[int],
                  rng, exclude=frozenset()) -> Optional[int]:
    """Shared fifo/lru/lfu/marking victim selection (FlatCache and
    LiveFlatCache use the same policies; only the exclusion set differs).

    `order` is the entries' insertion/recency order, `freq` maps
    expert -> activation count.  Returns None when every candidate is
    excluded (e.g. pinned)."""
    cand = [e for e in order if e not in exclude]
    if not cand:
        return None
    if policy in ("fifo", "lru"):
        return cand[0]                 # insertion / recency order head
    if policy == "lfu":
        return min(cand, key=freq)
    # marking: evict a random unmarked page; new phase if all marked
    unmarked = [e for e in cand if e not in marks]
    if not unmarked:
        marks.clear()
        unmarked = cand
    victim = rng.choice(unmarked)
    marks.discard(victim)
    return victim


class FlatCache:
    """Single full-tensor pool with FIFO / LRU / Marking / LFU eviction."""

    def __init__(self, capacity: int, policy: str = "lru"):
        assert policy in ("fifo", "lru", "marking", "lfu")
        self.capacity = capacity
        self.policy = policy
        self.entries: "collections.OrderedDict[int, PoolEntry]" = collections.OrderedDict()
        self.marks: Set[int] = set()
        self.freq = collections.Counter()
        self.hits = 0
        self.misses = 0
        import random
        self._rng = random.Random(0)

    def residency(self, expert: int) -> CState:
        return CState.F if expert in self.entries else CState.M

    def access(self, expert: int, payload=None) -> bool:
        """Touch expert; insert on miss.  Returns hit?"""
        self.freq[expert] += 1
        if expert in self.entries:
            self.hits += 1
            if self.policy == "lru":
                self.entries.move_to_end(expert)
            if self.policy == "marking":
                self.marks.add(expert)
            return True
        self.misses += 1
        if self.capacity <= 0:
            return False
        while len(self.entries) >= self.capacity:
            self._evict()
        self.entries[expert] = PoolEntry(expert, payload)
        if self.policy == "marking":
            self.marks.add(expert)
        return False

    def _evict(self):
        victim = select_victim(list(self.entries), self.policy,
                               lambda e: self.freq[e], self.marks, self._rng)
        del self.entries[victim]


# ----------------------------------------------------------------------------
# live flat-cache baseline (engine-compatible interface)
# ----------------------------------------------------------------------------
class LiveFlatCache(_LiveCacheTelemetry):
    """Single full-tensor pool behind the HierarchicalCache interface.

    The engine's ``cache_mode="flat"`` baseline: experts are either fully
    reconstructed in memory (state F) or absent (state M) — no intermediate
    compressed residency.  Eviction is one of the classic policies (fifo /
    lru / lfu / marking); pinned (in-flight) experts are never victims.

    The shared ``FreqTracker`` is still fed on access so the serving layer's
    prefetch prediction (``predict_topk``) works identically in both cache
    modes — only the *dispatch/eviction* policy differs, which is exactly
    what the Fig. 10 live ablation isolates.
    """

    def __init__(self, capacity: int, tracker: FreqTracker,
                 policy: str = "lru"):
        assert policy in ("fifo", "lru", "marking", "lfu")
        # the flat baseline reports the default stack's telemetry schema
        # (only F is ever populated) so the flat≡hier harness can diff it
        self.stack = DEFAULT_STACK
        self.order = self.stack.order
        self.capacity = int(capacity)
        self.cap = {p: 0 for p in self.order}
        self.cap["F"] = self.capacity
        self.mode = f"flat-{policy}"
        self.policy = policy
        self.tracker = tracker
        self.entries: "collections.OrderedDict[int, PoolEntry]" = \
            collections.OrderedDict()
        # engine iterates .pools in hierarchy order; only F is ever populated
        self.pools: Dict[str, Dict[int, PoolEntry]] = \
            {p: {} for p in self.order}
        self.pools["F"] = self.entries
        self.marks: Set[int] = set()
        self._init_telemetry()
        import random
        self._rng = random.Random(0)

    # -- state queries --------------------------------------------------------
    def residency(self, expert: int) -> CState:
        return CState.F if expert in self.entries else CState.M

    # -- access / admission ---------------------------------------------------
    def record_access(self, experts: Sequence[int]) -> Dict[int, CState]:
        """Probe-only lookup: stats + recency/marks/tracker updates, no
        insertion (admission happens post-reconstruction via :meth:`admit`)."""
        self._guard.check()
        self.tracker.record(experts)
        out = {}
        for e in experts:
            st = self.residency(e)
            out[e] = st
            if st is CState.F:
                self.hits["F"] += 1
                if self.policy == "lru":
                    self.entries.move_to_end(e)
                if self.policy == "marking":
                    self.marks.add(e)
            else:
                self.misses += 1
        return out

    def admit(self, expert: int, payload=None) -> Optional[str]:
        """Insert (classic caches always admit on miss), evicting an unpinned
        victim per policy when full."""
        self._guard.check()
        if expert in self.entries:
            if payload is not None:
                self.entries[expert].payload = payload
            return "F"
        if self.capacity <= 0:
            return None
        while len(self.entries) >= self.capacity:
            if not self._evict():
                return None            # every resident pinned: don't admit
        self.entries[expert] = PoolEntry(expert, payload)
        if self.policy == "marking":
            self.marks.add(expert)
        self.transitions[("M", "F")] += 1
        return "F"

    def _evict(self) -> bool:
        victim = select_victim(list(self.entries), self.policy,
                               lambda e: self.tracker.counts[e], self.marks,
                               self._rng, exclude=self.pinned)
        if victim is None:
            return False
        del self.entries[victim]
        self.transitions[("F", "M")] += 1
        self.evictions += 1
        return True

    def resize(self, capacity: int,
               cap_bytes: Optional[Dict[str, float]] = None):
        """Re-point the flat capacity (live re-planning: the byte budget ÷
        full-tensor cost).  Shrink evicts unpinned residents per the
        configured policy until occupancy fits; pinned (mid-step) experts
        are never victims — an all-pinned overflow defers to the next
        admission.  Grow is churn-free."""
        self._guard.check()
        self.capacity = int(capacity)
        self.cap = {p: 0 for p in self.order}
        self.cap["F"] = self.capacity
        if cap_bytes is not None:
            self.cap_bytes = {p: float(cap_bytes.get(p, 0.0))
                              for p in self.order}
        while len(self.entries) > self.capacity:
            if not self._evict():
                break                  # everything pinned: defer the trim

    def occupancy(self) -> Dict[str, int]:
        occ = {p: 0 for p in self.order}
        occ["F"] = len(self.entries)
        return occ

    def summary(self) -> Dict[str, object]:
        return pool_summary(self.mode, self.hits, self.misses,
                            self.occupancy(), self.cap, self.transitions,
                            self.evictions, len(self.pinned),
                            self.bytes_occupancy(), self.bytes_capacity())
