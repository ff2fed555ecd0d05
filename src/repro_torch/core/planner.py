"""Hierarchical cache-pool planning (§3.4, Appendix C/D; Algorithms 2–4).

Pipeline:
  1. ``ipf_selection_probs`` — modified iterative proportional fitting (Chen
     et al., 1994) recovers per-rank Bernoulli selection probabilities q_r
     whose conditional-on-k distribution is the *maximum-entropy* distribution
     consistent with the observed inclusion probabilities f_r (Theorem 3.2).
  2. ``poisson_binomial`` — Algorithm 2: hit-count distribution Φ_S(h) within
     a pool's contiguous rank interval.
  3. ``estimate_makespan`` — Algorithm 3: coarse two-bottleneck makespan model
     (I/O aggregate vs per-thread decompression) for a given hit pattern.
  4. ``plan_pools`` — Algorithm 4: grid search over pool-memory ratios γ,
     scoring E[makespan] under the joint conditional hit distribution
     P(h | Σh = k) = Φ_M(k_rem)/Φ_N(k) · Π_p Φ_p(h_p).

``plan_pools`` is fast enough to run *online*: Φ tables are memoized per
rank interval across the γ grid (many candidates share interval
boundaries), DPs are truncated at h = k (the recurrence only flows
upward, so low entries stay exact), duplicate size-vectors are scored
once, and a candidate whose partial expected cost already exceeds the
incumbent is pruned mid-sum.  ``LivePlanner`` builds on that: per-MoE-layer
plans from live rank statistics under one global byte budget (split by
observed layer activity), with a drift test on the windowed hit-rate
series deciding when to re-plan — the engine applies the resulting plans
between decode steps (see ``engine.configure_planner``).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.tiers import DEFAULT_STACK

# historical alias: the default (paper) tier order.  Every scoring routine
# below takes an explicit ``order`` — the tier-stack names in hierarchy
# order — and reproduces the 4-tier behavior bit-identically by default.
POOL_ORDER = DEFAULT_STACK.order

# which tiers' hits skip which reconstruction resources (Algorithm 3's
# accounting, keyed by tier name; P serves full tensors over the link)
_SKIPS_SM = frozenset(("F", "P", "C", "S"))
_SKIPS_E = frozenset(("F", "P", "C", "E"))
_SKIPS_DEC = frozenset(("F", "P"))


# ----------------------------------------------------------------------------
# Theorem 3.2 machinery: max-entropy selection probabilities via IPF
# ----------------------------------------------------------------------------
def esp(weights: np.ndarray, k: int) -> np.ndarray:
    """Elementary symmetric polynomials R(0..k, weights) via stable DP."""
    R = np.zeros(k + 1, dtype=np.float64)
    R[0] = 1.0
    for w in weights:
        R[1:k + 1] = R[1:k + 1] + w * R[0:k].copy()
    return R


def esp_without(weights: np.ndarray, R: np.ndarray, i: int, k: int) -> np.ndarray:
    """R(0..k, weights \\ {i}) by dividing item i out of the full DP.

    The divide-out recurrence is unstable for large w_i (catastrophic
    cancellation); fall back to a direct DP excluding item i when the result
    goes negative or non-finite."""
    w = weights[i]
    out = np.zeros(k + 1, dtype=np.float64)
    out[0] = 1.0
    ok = True
    for j in range(1, k + 1):
        out[j] = R[j] - w * out[j - 1]
        if not np.isfinite(out[j]) or out[j] < 0:
            ok = False
            break
    if ok:
        return out
    rest = np.delete(weights, i)
    return esp(rest, k)


def project_feasible(f: np.ndarray, k: int, *, eps: float = 1e-9
                     ) -> np.ndarray:
    """Project onto the feasible set of inclusion probabilities:
    eps <= f_i <= 1-eps and Σf = k (Chen et al. 1994 requirement).
    Values forced to the upper bound stay there; the free mass rescales."""
    f = np.clip(np.asarray(f, dtype=np.float64), eps, None)
    k = float(k)
    for _ in range(100):
        hi = f >= 1 - eps
        f[hi] = 1 - eps
        free = ~hi
        target = k - hi.sum() * (1 - eps)
        s = f[free].sum()
        if not free.any() or target <= 0 or s <= 0:
            break
        f[free] = f[free] * (target / s)
        if (f[free] < 1 - eps).all():
            break
    return np.clip(f, eps, 1 - eps)


def ipf_selection_probs(f: np.ndarray, k: int, *, iters: int = 600,
                        tol: float = 1e-10,
                        q0: Optional[np.ndarray] = None,
                        f0: Optional[np.ndarray] = None) -> np.ndarray:
    """f: inclusion probabilities (Σf = k expected).  Returns q_r ∈ (0,1).
    Infeasible inputs (f_i ≥ 1 after rescale) are projected first.

    ``q0`` warm-starts the fit from a previous solution's q (same expert
    count): under live re-planning f drifts slowly between plans, so the
    old fixed point is a near-solution — an unchanged f (a budget-only
    re-plan) converges in one sweep instead of tens-to-hundreds.  ``f0``
    (the inclusion probs q0 was fitted FOR) additionally applies a
    first-order odds correction ``w0 = w_prev · odds(f)/odds(f0)`` that
    absorbs most of the drift.  The IPF fixed point for a given (f, k) is
    unique up to the weight scale (normalised away each sweep), so warm
    and cold starts converge to the same q — only faster
    (``tests/test_live_planner.py`` pins the equivalence,
    ``benchmarks/planner_bench.py`` the speedup).

    The sweep loop also exits when the error stops improving (relative
    progress < 0.1% for 30 consecutive sweeps): stiff fits (entries
    projected against the q < 1 boundary) hit a numerical error floor
    above ``tol`` and further sweeps only burn time at the floor."""
    k = int(k)
    f = project_feasible(f, k)
    n = f.size
    if q0 is not None and np.asarray(q0).size == n:
        q0 = np.clip(np.asarray(q0, np.float64), 1e-12, 1 - 1e-12)
        w = q0 / (1.0 - q0)
        if f0 is not None and np.asarray(f0).size == n:
            f0p = project_feasible(np.asarray(f0, np.float64), k)
            w = w * ((f / (1.0 - f)) / (f0p / (1.0 - f0p)))
    else:
        w = f / (1.0 - f)
    best_err, stall = np.inf, 0
    for _ in range(iters):
        w = w / np.max(w)            # scale-invariant; keeps the DP in range
        R = esp(w, k)
        fi = np.empty(n)
        for i in range(n):
            Rwo = esp_without(w, R, i, k)
            fi[i] = w[i] * Rwo[k - 1] / max(R[k], 1e-300)
        fi = np.clip(np.nan_to_num(fi, nan=1e-12), 1e-12, None)
        err = np.max(np.abs(fi - f))
        w = w * (f / fi)
        if err < tol:
            break
        if err < best_err * (1.0 - 1e-3):
            best_err, stall = err, 0
        else:
            stall += 1
            if stall >= 30:
                break                # converged to the numerical floor
    return np.clip(w / (1.0 + w), 1e-12, 1 - 1e-12)


def inclusion_from_q(q: np.ndarray, k: int) -> np.ndarray:
    """Check helper: implied inclusion probs P(i ∈ S | |S|=k) for given q."""
    w = q / (1.0 - q)
    R = esp(w, k)
    out = np.empty(q.size)
    for i in range(q.size):
        Rwo = esp_without(w, R, i, k)
        out[i] = w[i] * Rwo[k - 1] / R[k]
    return out


# ----------------------------------------------------------------------------
# Algorithm 2: Poisson-binomial hit distribution
# ----------------------------------------------------------------------------
def poisson_binomial(qs: Sequence[float],
                     max_h: Optional[int] = None) -> np.ndarray:
    """Φ(h) for h = 0..len(qs): P[#successes = h].

    ``max_h`` truncates the DP at h = max_h: the recurrence only moves
    probability mass upward, so entries 0..max_h stay *exact* — the planner
    never indexes past h = k, which turns the per-interval cost from
    O(n²) to O(n·k) for the online re-planning path."""
    hi = len(qs) if max_h is None else min(int(max_h), len(qs))
    phi = np.zeros(hi + 1, dtype=np.float64)
    phi[0] = 1.0
    for i, q in enumerate(qs):
        top = min(i + 1, hi)
        phi[1:top + 1] = phi[1:top + 1] * (1 - q) + phi[0:top] * q
        phi[0] *= (1 - q)
    return phi


# ----------------------------------------------------------------------------
# Algorithm 3: makespan estimation for a hit pattern
# ----------------------------------------------------------------------------
@dataclass(frozen=True)
class PlanConsts:
    u: float            # SM-chunk read delay
    v: float            # single E-chunk read delay (≈ ρu/K)
    c: float            # single E-chunk decompression delay
    L: int              # worker threads
    K: int              # exponent shards per tensor
    n_tensors: int      # tensors per expert
    # per-expert peer-HBM fetch delay over the interconnect (0 = no P tier);
    # trailing default keeps every existing positional construction valid
    peer: float = 0.0


def estimate_makespan(k: int, h: Dict[str, int], consts: PlanConsts,
                      order: Sequence[str] = POOL_ORDER) -> float:
    n, K, L = consts.n_tensors, consts.K, consts.L
    h_sm = h_e = h_dec = 0
    for p in order:
        hp = h.get(p, 0)
        if p in _SKIPS_SM:
            h_sm += hp
        if p in _SKIPS_E:
            h_e += hp
        if p in _SKIPS_DEC:
            h_dec += hp
    n_sm = n * (k - h_sm)
    n_e = n * K * (k - h_e)
    t_io = n_sm * consts.u + n_e * consts.v
    n_d = n * K * (k - h_dec)
    t_dec = (n_e * consts.v + n_d * consts.c) / max(1, L)
    out = max(t_io, t_dec)
    if consts.peer:
        # third bottleneck: the interconnect is a serial resource — every
        # peer-resident hit's fetch queues on the link
        t_peer = h.get("P", 0) * consts.peer
        if t_peer > out:
            out = t_peer
    return out


# ----------------------------------------------------------------------------
# Algorithm 4: grid-search pool planning
# ----------------------------------------------------------------------------
@dataclass
class Plan:
    ratios: Dict[str, float]
    sizes: Dict[str, int]           # experts per pool
    cost: float
    q: Optional[np.ndarray] = None  # fitted selection probs (warm-start seed)


def _ratio_grid(active: Sequence[str], step: float):
    m = int(round(1.0 / step))
    for parts in itertools.product(range(m + 1), repeat=len(active) - 1):
        if sum(parts) <= m:
            last = m - sum(parts)
            yield dict(zip(active, [p / m for p in parts] + [last / m]))


def _score_candidate(k: int, sizes: Dict[str, int],
                     phi_p: Dict[str, np.ndarray], phi_M: np.ndarray,
                     denom: float, consts: PlanConsts,
                     limit: Optional[float] = None,
                     order: Sequence[str] = POOL_ORDER) -> Optional[float]:
    """E[makespan] of one size-vector candidate under the conditional joint
    hit distribution (reference scalar evaluation).  Every term is
    non-negative, so once the partial sum reaches ``limit`` (the
    incumbent's cost) the candidate can never win — returns None (pruned).

    The hit grid iterates the stack's tiers in lexicographic order — the
    exact loop nest (and fp summation order) of the historical 4-pool
    code when ``order`` is the default stack."""
    cost = 0.0
    for hs in itertools.product(*(range(min(sizes[p], k) + 1)
                                  for p in order)):
        rem = k - sum(hs)
        if rem < 0 or rem >= phi_M.size:
            continue
        pr = phi_M[rem] / denom
        for p, hv in zip(order, hs):
            pr = pr * phi_p[p][hv]
        if pr <= 0:
            continue
        cost += pr * estimate_makespan(k, dict(zip(order, hs)), consts,
                                       order)
        if limit is not None and cost >= limit:
            return None
    return cost


def _score_candidate_np(k: int, sizes: Dict[str, int],
                        phi_p: Dict[str, np.ndarray], phi_M: np.ndarray,
                        denom: float, consts: PlanConsts,
                        order: Sequence[str] = POOL_ORDER) -> float:
    """Vectorised `_score_candidate`: the whole per-tier hit grid —
    probabilities AND Algorithm-3 makespans — as one broadcast expression.
    Exact same sum as the scalar loop (modulo fp summation order); ~10–30×
    faster, which is what makes per-layer online re-planning affordable.

    Generalised over the tier stack: each tier gets one broadcast axis in
    stack order, so the default stack reproduces the historical
    (h_F, h_C, h_S, h_E) grid — same arrays, same op order, same bits."""
    n, K, L = consts.n_tensors, consts.K, consts.L
    axes = np.ix_(*(np.arange(min(sizes[p], k) + 1) for p in order))
    H = dict(zip(order, axes))
    rem = k
    for a in axes:
        rem = rem - a
    valid = (rem >= 0) & (rem < phi_M.size)
    pr = phi_M[np.clip(rem, 0, phi_M.size - 1)] / denom
    for p in order:
        pr = pr * phi_p[p][H[p]]
    h_sm = h_e = h_dec = 0
    for p in order:
        if p in _SKIPS_SM:
            h_sm = h_sm + H[p]
        if p in _SKIPS_E:
            h_e = h_e + H[p]
        if p in _SKIPS_DEC:
            h_dec = h_dec + H[p]
    n_sm = n * (k - h_sm)
    n_e = n * K * (k - h_e)
    t_io = n_sm * consts.u + n_e * consts.v
    n_d = n * K * (k - h_dec)
    t_dec = (n_e * consts.v + n_d * consts.c) / max(1, L)
    d = np.maximum(t_io, t_dec)
    if consts.peer and "P" in H:
        d = np.maximum(d, H["P"] * consts.peer)
    return float((np.where(valid, pr, 0.0) * d).sum())


def plan_pools(f: np.ndarray, k: int, mem_budget: float,
               bytes_per_state: Dict[str, float], consts: PlanConsts, *,
               active: Sequence[str] = POOL_ORDER, step: float = 0.125,
               q: Optional[np.ndarray] = None, memoize: bool = True,
               prune: bool = True, q0: Optional[np.ndarray] = None,
               f0: Optional[np.ndarray] = None,
               order: Sequence[str] = POOL_ORDER) -> Plan:
    """Returns the expected-makespan-minimising pool partition.

    bytes_per_state: per-expert residency cost per tier of ``order`` (the
    tier-stack names in hierarchy order; default = the paper's F/C/S/E).

    ``q0``/``f0`` warm-start the IPF fit from a previous plan's fitted q
    (and the f it was fitted for); ignored when ``q`` is supplied directly.
    The returned plan carries its q so the live planner can chain warm
    starts across re-plans.

    ``memoize`` shares Φ interval tables (truncated at h = k) across the γ
    grid and scores each distinct size-vector once; ``prune`` abandons a
    candidate whose partial expected cost already exceeds the incumbent.
    Both are exact — the returned plan is identical to the naive
    evaluation's (``tests/test_live_planner.py`` pins it); together they
    make per-layer *online* re-planning affordable (``benchmarks.run
    --only planner`` measures the gap)."""
    order = tuple(order)
    n_experts = f.size
    q = ipf_selection_probs(f, k, q0=q0, f0=f0) if q is None \
        else np.asarray(q)
    phi_N = poisson_binomial(q, k)     # only Φ_N(k) is read: truncate
    denom = phi_N[k] if k < phi_N.size else 0.0
    phi_cache: Dict[Tuple[int, int], np.ndarray] = {}

    def phi_interval(a: int, b: int) -> np.ndarray:
        if not memoize:
            return poisson_binomial(q[a:b], k)
        tab = phi_cache.get((a, b))
        if tab is None:
            tab = phi_cache[(a, b)] = poisson_binomial(q[a:b], k)
        return tab

    best: Optional[Plan] = None
    seen_sizes: set = set()
    # the prune certificate below relies on Alg. 3 being monotone
    # NON-INCREASING in every hit count — true of the I/O and decompression
    # bottlenecks but not of the peer-link term (increasing in h_P), so the
    # lower bound is evaluated link-free (still valid: dropping a max() arm
    # can only lower the bound)
    lb_consts = consts if not consts.peer else \
        PlanConsts(consts.u, consts.v, consts.c, consts.L, consts.K,
                   consts.n_tensors)
    for ratios in _ratio_grid(list(active), step):
        sizes = {p: 0 for p in order}
        for p in active:
            sizes[p] = int(ratios[p] * mem_budget / bytes_per_state[p])
        # map pools to contiguous rank intervals in hierarchy order
        intervals, u0 = {}, 0
        for p in order:
            s = min(sizes[p], n_experts - u0)
            sizes[p] = s
            intervals[p] = (u0, u0 + s)
            u0 += s
        if memoize:
            key = tuple(sizes[p] for p in order)
            if key in seen_sizes:
                continue        # same size vector: same cost, first one kept
            seen_sizes.add(key)
        if denom <= 0:
            continue
        if prune and best is not None:
            # cheap certificate: the makespan at the componentwise-maximal
            # hit pattern lower-bounds every pattern's makespan (Alg. 3 is
            # monotone non-increasing in each h), and the conditional joint
            # distribution sums to 1 — so E[makespan] >= that bound.  A
            # candidate whose bound already exceeds the incumbent is
            # skipped without building its Φ tables or scoring the grid.
            lb = max(0.0, estimate_makespan(
                k, {p: min(sizes[p], k) for p in order}, lb_consts, order))
            if lb * (1.0 - 1e-9) >= best.cost:
                continue
        phi_p = {p: phi_interval(a, b) for p, (a, b) in intervals.items()}
        phi_M = phi_interval(u0, n_experts)
        if memoize:
            cost = _score_candidate_np(k, sizes, phi_p, phi_M, denom, consts,
                                       order)
        else:
            cost = _score_candidate(
                k, sizes, phi_p, phi_M, denom, consts,
                limit=best.cost if (prune and best is not None) else None,
                order=order)
            if cost is None:
                continue                      # pruned: cannot beat incumbent
        if best is None or cost < best.cost:
            best = Plan(dict(ratios), dict(sizes), cost, q=q)
    assert best is not None
    return best


def plan_peer_shards(f_shards: Sequence[np.ndarray], budget_per_dev: float,
                     bytes_full: float, consts: PlanConsts) -> List[int]:
    """Per-device peer-HBM slot counts: the §3.4 solver run per device over
    its shard's rank statistics.

    Each device owns a contiguous expert block (the EP rule of
    ``distributed/sharding.py``); its peer slab is a single full-tensor
    pool, so the Algorithm-4 grid collapses to ``active=("F",)`` — exactly
    the flat mode's byte budgeting — under the device's own byte budget.

    ``f_shards[d]``: the shard's rank-sorted selection mass (any positive
    scale; renormalised to the shard's effective per-step selection size).
    Returns the solved slot count per device (0 when the shard is cold or
    the budget cannot hold one resident)."""
    caps: List[int] = []
    for f in f_shards:
        f = np.asarray(f, np.float64).ravel()
        mass = float(f.sum())
        if (f.size == 0 or mass <= 0 or bytes_full <= 0
                or budget_per_dev < bytes_full):
            caps.append(0)
            continue
        # effective per-step selections landing on this shard: the shard's
        # share of the global top-k mass, at least one, below the shard size
        k = int(np.clip(round(mass), 1, max(1, f.size - 1)))
        p = plan_pools(f, k, budget_per_dev, {"F": bytes_full}, consts,
                       active=("F",))
        caps.append(int(p.sizes.get("F", 0)))
    return caps


# ----------------------------------------------------------------------------
# Live (online) planning: per-layer byte budgets + drift-triggered re-planning
# ----------------------------------------------------------------------------
@dataclass
class LayerPlan:
    """One layer's byte-budgeted pool plan (what the engine applies)."""
    layer: int
    sizes: Dict[str, int]            # experts per pool (cache capacities)
    cap_bytes: Dict[str, float]      # byte capacity per pool (γ_p · budget)
    ratios: Dict[str, float]
    cost: float                      # E[makespan] under the fitted workload
    budget: float                    # this layer's share of the global budget


class LivePlanner:
    """Online §3.4 planner: one global byte budget, per-layer pool plans.

    Pure solver — no engine or store dependencies (unit-testable like
    GemmProfiler).  The caller supplies, per MoE layer, the live rank-based
    inclusion probabilities ``(f, k)`` (``FreqTracker.inclusion_probs``),
    the layer's real per-expert residency costs (``bytes_per_state`` from
    the store's chunk sizes), its profiled :class:`PlanConsts`, and an
    activity weight.  :meth:`plan` splits the global budget across layers
    proportionally to activity (a layer nobody routes to gets ~nothing —
    its pools shrink to zero and, in device mode, its slab is freed
    entirely) and solves Algorithm 4 per layer on its share.

    Re-planning policy (:meth:`should_replan`): the first call plans
    unconditionally; afterwards a re-plan triggers when the recent windowed
    hit rate drops more than ``drift_margin`` below the best rate seen
    since the last plan — the signature of activation-rank drift making the
    current partition stale.  The decision is evaluated every
    ``replan_every`` steps by the engine's step clock (``note_step``)."""

    def __init__(self, mem_budget: float, *, step: float = 0.125,
                 drift_margin: float = 0.05, drift_min_accesses: int = 0,
                 active: Sequence[str] = POOL_ORDER,
                 order: Sequence[str] = POOL_ORDER,
                 budget_split: str = "proportional"):
        assert mem_budget >= 0, mem_budget
        assert budget_split in ("proportional", "waterfill"), budget_split
        self.mem_budget = float(mem_budget)
        self.step = float(step)
        self.drift_margin = float(drift_margin)
        # tier names in hierarchy order (the cache's stack); plans carry a
        # size/cap entry per tier of this order
        self.order = tuple(order)
        # cross-layer split rule: "proportional" (historical default —
        # budget shares follow activity weights) or "waterfill" (greedy on
        # dE[makespan]/dbyte; see _waterfill_budgets)
        self.budget_split = budget_split
        # probe windows with fewer accesses than this are ignored by the
        # drift policy (neither trigger nor move the baseline): under
        # multi-tenant request churn a window can cover a drain phase where
        # one straggler drives the whole cache — its hit rate is noise, not
        # rank drift.  0 keeps the historical always-evaluate behavior.
        self.drift_min_accesses = int(drift_min_accesses)
        # pools the grid may allocate to: ("F",) collapses the search to a
        # single full-tensor pool — the flat-cache mode's byte budgeting
        self.active = tuple(active)
        self.plans: Dict[int, LayerPlan] = {}
        self.replans: List[Dict[str, object]] = []    # event log
        # per-layer (f, fitted q) from the last solve: warm-starts the next
        # re-plan's IPF fit (the dominant share of live re-plan latency)
        self._prev_fit: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._plan_hit: Optional[float] = None  # best windowed rate since plan
        self._seeded = False                    # external static capacities
        self._replan_on_stats = False           # bootstrap plan needs revisit

    def seed(self):
        """Mark externally-provided capacities (an explicit ``pool_sizes``
        override) as the live baseline: :meth:`should_replan` then never
        fires the unconditional "initial" bootstrap — only observed drift
        replaces the static configuration."""
        self._seeded = True

    # -- budget split -------------------------------------------------------
    def layer_budgets(self, weights: Dict[int, float]) -> Dict[int, float]:
        """Global budget → per-layer shares, proportional to activity
        weight; uniform when nothing has been observed yet."""
        layers = sorted(weights)
        total = sum(max(0.0, w) for w in weights.values())
        if total <= 0:
            share = self.mem_budget / max(1, len(layers))
            return {l: share for l in layers}
        return {l: self.mem_budget * max(0.0, weights[l]) / total
                for l in layers}

    def _waterfill_budgets(self, stats: Dict[int, Tuple[np.ndarray, int]],
                           bytes_per_state: Dict[int, Dict[str, float]],
                           consts: Dict[int, PlanConsts],
                           weights: Dict[int, float]) -> Dict[int, float]:
        """Water-filling on dE[makespan]/dbyte: grant the global budget in
        full-expert quanta, each to the layer whose next resident buys the
        largest expected makespan reduction per byte.

        Granting layer l its r-th quantum promotes its rank-r expert from
        miss to hit; the marginal gain is

            g_l(r) = w_l · f_l[r] · miss_cost_l / bytes_F_l

        — selection probability of that rank × the serial cost its miss
        path would add (Algorithm 3 at a single all-miss expert) per byte
        spent.  Gains are non-increasing in r (f is rank-sorted), so the
        greedy sweep IS the water-filling solution.  When marginal gains
        are uniform across layers the result equals the proportional split
        (equality pinned by tests/test_tiers.py); leftover budget below
        every layer's quantum — or beyond every layer's expert count —
        falls back to the proportional rule."""
        layers = sorted(stats)
        w = {l: max(0.0, weights.get(l, 0.0)) for l in layers}
        if sum(w.values()) <= 0:
            w = {l: 1.0 for l in layers}
        quanta = {l: max(1e-12, float(bytes_per_state[l].get("F", 0.0)))
                  for l in layers}
        miss_cost = {l: max(0.0, estimate_makespan(1, {}, consts[l],
                                                   self.order))
                     for l in layers}
        f_by_l = {l: np.asarray(stats[l][0], np.float64) for l in layers}
        budgets = {l: 0.0 for l in layers}
        grants = {l: 0 for l in layers}
        rem = self.mem_budget
        while True:
            best_l, best_g = None, 0.0
            for l in layers:
                if quanta[l] > rem or grants[l] >= f_by_l[l].size:
                    continue
                g = w[l] * float(f_by_l[l][grants[l]]) * miss_cost[l] \
                    / quanta[l]
                if g > best_g:
                    best_l, best_g = l, g
            if best_l is None:
                break
            budgets[best_l] += quanta[best_l]
            grants[best_l] += 1
            rem -= quanta[best_l]
        if rem > 0 and layers:
            tw = sum(w.values())
            for l in layers:
                budgets[l] += rem * w[l] / tw if tw > 0 else rem / len(layers)
        return budgets

    # -- planning -----------------------------------------------------------
    def plan(self, stats: Dict[int, Tuple[np.ndarray, int]],
             bytes_per_state: Dict[int, Dict[str, float]],
             consts: Dict[int, PlanConsts],
             weights: Optional[Dict[int, float]] = None
             ) -> Dict[int, LayerPlan]:
        """Solve every layer's pool partition on its budget share.

        ``stats[l] = (f, k)``: the layer's rank-ordered inclusion
        probabilities and effective per-step selection size."""
        if weights is None:
            weights = {l: 1.0 for l in stats}
        if self.budget_split == "waterfill":
            budgets = self._waterfill_budgets(
                stats, bytes_per_state, consts,
                {l: weights.get(l, 0.0) for l in stats})
        else:
            budgets = self.layer_budgets(
                {l: weights.get(l, 0.0) for l in stats})
        plans: Dict[int, LayerPlan] = {}
        for l, (f, k) in sorted(stats.items()):
            budget = budgets.get(l, 0.0)
            bps = bytes_per_state[l]
            if budget < min(bps.values()):
                # cold layer: its share cannot hold even one resident in the
                # cheapest pool — release everything
                plans[l] = LayerPlan(
                    layer=l, sizes={p: 0 for p in self.order},
                    cap_bytes={p: 0.0 for p in self.order},
                    ratios={p: 0.0 for p in self.order}, cost=float("inf"),
                    budget=budget)
                continue
            f64 = np.asarray(f, np.float64)
            f_prev, q_prev = self._prev_fit.get(l, (None, None))
            p = plan_pools(f64, int(k), budget, bps,
                           consts[l], step=self.step, active=self.active,
                           q0=q_prev, f0=f_prev, order=self.order)
            if p.q is not None:
                self._prev_fit[l] = (f64, p.q)
            plans[l] = LayerPlan(
                layer=l, sizes=dict(p.sizes),
                cap_bytes={k2: r * budget for k2, r in p.ratios.items()},
                ratios=dict(p.ratios), cost=p.cost, budget=budget)
        self.plans = plans
        return plans

    # -- re-plan policy -----------------------------------------------------
    def should_replan(self, hit_rate: Optional[float],
                      accesses: Optional[int] = None) -> Optional[str]:
        """Reason to re-plan now, or None.  ``hit_rate`` is the windowed
        (recent-delta) cache hit rate; the first window after a plan
        establishes the baseline, later windows trigger on degradation.
        ``accesses`` (when provided) is the window's access count —
        windows under ``drift_min_accesses`` are skipped entirely.  With
        neither a plan nor seeded capacities the first probe plans
        unconditionally ("initial")."""
        if not self.plans and not self._seeded:
            return "initial"
        if hit_rate is None:
            return None
        if accesses is not None and accesses < self.drift_min_accesses:
            return None
        if self._replan_on_stats:
            # the bootstrap plan was solved from zero observations (uniform
            # f, k_eff=1); the first probe with real traffic behind it
            # re-plans once unconditionally — a stable workload would never
            # degrade past the drift margin, leaving the maximum-ignorance
            # partition permanent otherwise
            return "warmup"
        if self._plan_hit is None:
            self._plan_hit = hit_rate         # post-plan baseline window
            return None
        ref = self._plan_hit
        self._plan_hit = max(ref, hit_rate)
        if hit_rate < ref - self.drift_margin:
            return "drift"
        return None

    def note_plan(self, step: int, reason: str,
                  hit_rate: Optional[float] = None):
        """Record one applied plan in the event log and reset the drift
        baseline (the next window re-establishes it).  A bootstrap
        ("initial") plan arms the one-shot warmup re-plan."""
        self._plan_hit = None
        self._replan_on_stats = reason == "initial"
        self.replans.append({
            "step": int(step), "reason": reason, "hit_rate": hit_rate,
            "budgets": {l: p.budget for l, p in self.plans.items()},
            "sizes": {l: dict(p.sizes) for l, p in self.plans.items()},
        })

    def summary(self) -> Dict[str, object]:
        return {
            "mem_budget": self.mem_budget,
            "n_plans": len(self.replans),
            # the unconditional bootstrap plan is not a RE-plan: a static
            # (plan-once) run must report 0 here
            "n_replans": sum(1 for ev in self.replans
                             if ev["reason"] != "initial"),
            "replans": [dict(ev) for ev in self.replans],
            "layers": {l: {"sizes": dict(p.sizes),
                           "cap_bytes": dict(p.cap_bytes),
                           "budget": p.budget,
                           "cost": p.cost}
                       for l, p in sorted(self.plans.items())},
        }
