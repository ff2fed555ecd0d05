"""Rank-based workload modeling (§3.4).

The planner is agnostic to expert identities: it consumes a *rank-based
marginal inclusion probability list* ``(f_r)`` — the stationary probability
that the rank-r most popular expert of a layer is activated in a decode step —
estimated from historical activation counts.  The runtime keeps a frequency
list to map concrete expert ids to ranks.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Set

import numpy as np


class FreqTracker:
    """Runtime activation counts + rank lookup for one sparse layer."""

    def __init__(self, n_experts: int, decay: float = 1.0):
        self.n = n_experts
        self.counts = np.zeros(n_experts, dtype=np.float64)
        self.decay = decay
        self.n_records = 0           # record() calls (≈ steps touching this layer)
        self.k_ema = 0.0             # EMA of per-record selection size
        self._order_dirty = True
        self._ranks = np.arange(n_experts)

    def record(self, experts: Iterable[int]):
        experts = list(experts)
        if self.decay < 1.0:
            self.counts *= self.decay
        for e in experts:
            self.counts[e] += 1.0
        if experts:
            self.n_records += 1
            self.k_ema += 0.25 * (len(experts) - self.k_ema) if self.k_ema \
                else len(experts)
        self._order_dirty = True

    def _refresh(self):
        if self._order_dirty:
            order = np.argsort(-self.counts, kind="stable")
            self._ranks = np.empty(self.n, dtype=np.int64)
            self._ranks[order] = np.arange(self.n)
            self._order_dirty = False

    def rank(self, expert: int) -> int:
        self._refresh()
        return int(self._ranks[expert])

    def ranks(self) -> np.ndarray:
        self._refresh()
        return self._ranks.copy()

    def experts_by_rank(self) -> np.ndarray:
        self._refresh()
        order = np.empty(self.n, dtype=np.int64)
        order[self._ranks] = np.arange(self.n)
        return order

    def least_frequent(self, candidates: Sequence[int]) -> int:
        return min(candidates, key=lambda e: self.counts[e])

    def inclusion_probs(self) -> "tuple[np.ndarray, int]":
        """Live rank-based workload model for the §3.4 planner: the
        rank-ordered inclusion probabilities ``(f_r)`` (normalised so
        Σf = k_eff) and the effective per-step selection size k_eff.  With
        ``decay < 1`` the counts — and therefore f — track popularity
        drift instead of the all-time average.  Before any traffic the
        model is uniform (maximum ignorance ⇒ maximum entropy)."""
        k = int(round(self.k_ema)) if self.n_records else 1
        k = max(1, min(k, self.n - 1 if self.n > 1 else 1))
        total = self.counts.sum()
        if total <= 0:
            return np.full(self.n, k / self.n), k
        f = np.sort(self.counts)[::-1] * (k / total)
        return f, k


# ----------------------------------------------------------------------------
# trace generation + rank statistics
# ----------------------------------------------------------------------------
def zipf_trace(n_experts: int, k: int, steps: int, *, alpha: float = 1.0,
               batch: int = 1, seed: int = 0, shuffle_every: int = 0
               ) -> List[Set[int]]:
    """Synthetic skewed MoE activations: per step, the union over `batch`
    tokens of k experts drawn (w/o replacement) from a Zipf(alpha) law."""
    rng = np.random.default_rng(seed)
    base = 1.0 / np.arange(1, n_experts + 1) ** alpha
    perm = rng.permutation(n_experts)
    trace = []
    for t in range(steps):
        if shuffle_every and t and t % shuffle_every == 0:
            # slow drift of which experts occupy which popularity rank
            i, j = rng.integers(0, n_experts, 2)
            perm[[i, j]] = perm[[j, i]]
        p = base / base.sum()
        sel: Set[int] = set()
        for _ in range(batch):
            picks = rng.choice(n_experts, size=k, replace=False, p=p)
            sel.update(int(perm[x]) for x in picks)
        trace.append(sel)
    return trace


def rank_inclusion_probs(trace: Sequence[Set[int]], n_experts: int
                         ) -> np.ndarray:
    """(f_r): empirical inclusion probability of the rank-r expert."""
    counts = np.zeros(n_experts)
    for sel in trace:
        for e in sel:
            counts[e] += 1
    order = np.argsort(-counts, kind="stable")
    hit = np.zeros(n_experts)
    rank_of = np.empty(n_experts, dtype=np.int64)
    rank_of[order] = np.arange(n_experts)
    for sel in trace:
        for e in sel:
            hit[rank_of[e]] += 1
    return hit / max(1, len(trace))


def effective_k(trace: Sequence[Set[int]]) -> int:
    """Mean number of distinct experts per step (= k for batch 1)."""
    if not trace:
        return 1
    return max(1, round(sum(len(s) for s in trace) / len(trace)))
