"""Profiled per-expert execution times — the p_n feeding Algorithm 1 (§3.3).

Algorithm 1 orders reconstruction work by non-increasing expert execution
time p_n, and its compute-dominance test (Definition A.1) compares worker
slack against p-scaled I/O; both are only as good as the p values they see.
The live engine historically fed them class constants (demand 1e-4,
speculative 1e-6), which preserves demand-before-speculative ordering but
makes every same-class expert a tie — the scheduler can neither pack blocks
by true compute cover nor prefer the expensive expert's chunks first.

``GemmProfiler`` replaces the constants with *measured* grouped-GEMM times:

* **Shape- and batch-dependent** — keys are (layer, active-expert-count
  bucket, token-column bucket); both counts are bucketed to the next power
  of two so a handful of measurements covers a whole serving run while
  still separating "2 experts × 8 tokens" from "8 experts × 64 tokens".
* **Measured on first use** — :meth:`p_times` takes a ``runner`` callable
  executing one representative grouped GEMM for the bucket; the first
  lookup of a bucket runs it (after a warmup call that eats jit compile)
  and caches the per-expert time.
* **Refined online** — the serving layer can feed back the wall time of the
  *actual* grouped FFN each step via :meth:`record`; measurements converge
  by exponential moving average, so drifting batch shapes stay honest.

The profiler is deliberately engine-agnostic: it imports no tensor library
and can be driven by any timed callable, which keeps it unit-testable
without a store or a device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Tuple

Key = Tuple[int, int, int]          # (layer, n_experts bucket, cols bucket)


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (n <= 0 maps to 1)."""
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


@dataclass
class ProfileEntry:
    """One bucket's measured per-expert execution time."""
    p: float                        # seconds per expert
    n_samples: int = 1
    source: str = "measured"        # "measured" | "observed"


class GemmProfiler:
    """Measured per-expert grouped-GEMM times, bucketed by shape and batch.

    ``p_time``/``p_times`` return seconds-per-expert for a (layer,
    active-expert-count, token-columns) bucket; unknown buckets either run
    the supplied measurement ``runner`` once (cached) or fall back to
    ``default_p`` — the engine's historical demand constant, so a profiler
    with no data reproduces constant-p scheduling exactly.
    """

    def __init__(self, default_p: float = 1e-4, ema: float = 0.25):
        assert 0.0 < ema <= 1.0
        self.default_p = float(default_p)
        self.ema = float(ema)
        self.entries: Dict[Key, ProfileEntry] = {}
        self.measure_wall_s = 0.0   # total time spent inside runners
        self.n_measurements = 0

    # ------------------------------------------------------------------
    def key(self, layer: int, n_experts: int, cols: int = 1) -> Key:
        return (int(layer), pow2_bucket(n_experts), pow2_bucket(cols))

    def has(self, layer: int, n_experts: int, cols: int = 1) -> bool:
        return self.key(layer, n_experts, cols) in self.entries

    # ------------------------------------------------------------------
    def measure(self, layer: int, n_experts: int, cols: int,
                runner: Callable[[int, int], float]) -> float:
        """Measure a bucket now (idempotent: cached buckets return as-is).

        ``runner(n_experts_bucket, cols_bucket)`` executes one grouped GEMM
        of the bucket's shape and returns its wall time in seconds — or
        None to decline (the bucket then falls back to ``default_p``)."""
        k = self.key(layer, n_experts, cols)
        ent = self.entries.get(k)
        if ent is not None:
            return ent.p
        t0 = time.perf_counter()
        total = runner(k[1], k[2])
        self.measure_wall_s += time.perf_counter() - t0
        if total is None:
            # cache the decline too — measure() is once-per-bucket either way
            self.entries[k] = ProfileEntry(p=self.default_p,
                                           source="declined")
            return self.default_p
        self.n_measurements += 1
        p = max(float(total), 0.0) / k[1]
        self.entries[k] = ProfileEntry(p=p, source="measured")
        return p

    def record(self, layer: int, n_experts: int, cols: int, total_s: float):
        """Fold one *observed* grouped-FFN wall time (all ``n_experts``
        experts together) into the bucket's per-expert estimate (EMA).
        The divisor is the ACTUAL expert count, not the bucket size — the
        observation ran n_experts experts, unlike measure(), whose runner
        executes the full bucket."""
        if total_s < 0 or n_experts <= 0:
            return
        k = self.key(layer, n_experts, cols)
        p = float(total_s) / int(n_experts)
        ent = self.entries.get(k)
        if ent is None:
            self.entries[k] = ProfileEntry(p=p, source="observed")
        else:
            ent.p += self.ema * (p - ent.p)
            ent.n_samples += 1
            ent.source = "observed" if ent.source == "observed" \
                else "measured+observed"

    # ------------------------------------------------------------------
    def p_time(self, layer: int, n_experts: int, cols: int = 1, *,
               runner: Optional[Callable[[int, int], float]] = None) -> float:
        """Per-expert execution time for the bucket (measuring on first use
        when a ``runner`` is supplied, else ``default_p``)."""
        k = self.key(layer, n_experts, cols)
        ent = self.entries.get(k)
        if ent is not None:
            return ent.p
        if runner is not None:
            return self.measure(layer, n_experts, cols, runner)
        return self.default_p

    def p_times(self, layer: int, experts: Iterable[int], cols: int = 1, *,
                runner: Optional[Callable[[int, int], float]] = None
                ) -> Dict[int, float]:
        """``{expert: p_n}`` for one layer's expert set — what
        ``engine.submit_steps`` consumes.  All experts of one step share the
        bucket's per-expert time (the grouped GEMM executes them together)."""
        ids = [int(e) for e in experts]
        if not ids:
            return {}
        p = self.p_time(layer, len(ids), cols, runner=runner)
        return {e: p for e in ids}

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, object]:
        return {
            "n_buckets": len(self.entries),
            "n_measurements": self.n_measurements,
            "measure_wall_s": self.measure_wall_s,
            "buckets": {
                f"L{l}/E{ne}/C{c}": {"p_us": ent.p * 1e6,
                                     "samples": ent.n_samples,
                                     "source": ent.source}
                for (l, ne, c), ent in sorted(self.entries.items())},
        }


class LinkProfiler:
    """Profiled peer-interconnect fetch-cost model for the P tier.

    Predicts the wall time of fetching `nbytes` from a peer device's slab
    over the mesh interconnect.  Seeded analytically from a nominal link
    bandwidth (``bytes / seed_bw + seed_lat``) so the very first pricing
    decision is sane; every real fetch then feeds its measured wall time
    back via :meth:`record` and the effective bandwidth converges by EMA —
    the same measure-then-refine contract as :class:`GemmProfiler`, and
    equally engine-agnostic (no tensor library; tests drive it with
    plain numbers).

    The engine compares ``p_time(full_expert_bytes)`` against the expert's
    local decode-path estimate per task, and the planner consumes the same
    number as ``PlanConsts.peer`` (the third Algorithm-3 bottleneck).
    """

    def __init__(self, seed_bw: float = 50e9, seed_lat: float = 5e-6,
                 ema: float = 0.25):
        assert seed_bw > 0 and 0.0 < ema <= 1.0
        self.seed_bw = float(seed_bw)       # nominal link bandwidth (B/s)
        self.seed_lat = float(seed_lat)     # per-fetch launch latency (s)
        self.ema = float(ema)
        self.bw = float(seed_bw)            # effective measured bandwidth
        self.lat = float(seed_lat)
        self.n_samples = 0
        self.fetch_wall_s = 0.0             # total measured fetch time

    def p_time(self, nbytes: int) -> float:
        """Predicted fetch wall time for `nbytes` over the link."""
        return self.lat + max(0, int(nbytes)) / self.bw

    def record(self, nbytes: int, seconds: float):
        """Fold one measured fetch into the effective bandwidth (EMA).
        Sub-latency samples only tighten the latency term."""
        if seconds <= 0 or nbytes <= 0:
            return
        self.n_samples += 1
        self.fetch_wall_s += float(seconds)
        xfer = float(seconds) - self.lat
        if xfer > 0:
            bw = int(nbytes) / xfer
            self.bw += self.ema * (bw - self.bw)
        else:
            self.lat += self.ema * (float(seconds) - self.lat)

    def summary(self) -> Dict[str, object]:
        return {
            "seed_bw": self.seed_bw,
            "bw": self.bw,
            "lat_s": self.lat,
            "n_samples": self.n_samples,
            "fetch_wall_s": self.fetch_wall_s,
        }
