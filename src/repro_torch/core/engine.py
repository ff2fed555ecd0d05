"""Real threaded ZipMoE runtime (§3.1 runtime half, §4 implementation notes).

One persistent I/O thread (exact-range chunk reads from the ExpertStore,
optionally bandwidth-throttled), L persistent decompression worker threads
(zstd/zlib), and a recovery stage (the bf16 bit-splice — the numpy splice
on the host, or the CUDA splice kernels of ``kernels/`` on the card).

The engine executes the *same* block schedule that Algorithm 1 constructs:
the I/O thread walks chunks in block order (E-chunks before SM-chunks), and
workers take the highest-priority ready decompression op (work-conserving).

Fetches are asynchronous: :meth:`submit_step` is the per-decode-step entry
point of the §3.3/§3.4 co-design — it takes the router's *selected* experts
(demand) together with the *predicted* experts for the layer's next step
(speculative) and builds ONE Algorithm-1 block list over the union, so the
I/O thread and the workers drain the whole step's reconstruction work in
block priority order: demand tensors first (their blocks sort ahead via the
expert-execution-time priority p), predicted tensors behind them, E-chunks
before SM-chunks within each block.  :meth:`submit_steps` is the
cross-layer generalisation: one block list spanning layer i's step plus
later layers' predictions, with per-task ``(layer, expert)`` identity so
the I/O thread sequences work across layers under a single priority order.
Execution-time priorities are either the class constants or *profiled*
per-expert p-times (``p_times`` per part, fed from
``core/profiles.GemmProfiler``) — classes stay strictly tiered (demand ≻
near-layer predictions ≻ far-layer predictions) no matter what the
measurements say.  The returned :class:`FetchHandle` is two-phase:
``result()`` blocks only until the demand subset is recovered (the decode
step can run its FFN), while the speculative tail keeps reconstructing in
the background and is collected next step via ``spec_result()``;
``result_subset(ids, layer=j)`` waits on exactly one layer's named experts
and never on another layer's tail.  :meth:`prefetch_experts` /
:meth:`fetch_experts` are the single-class wrappers (all-demand or
all-speculative jobs).

Demand jobs are *urgent*: they jump the I/O queue ahead of speculative work,
and a running job yields to newly-arrived urgent jobs at block boundaries
once its own demand I/O is done.  Speculative ids skip the frequency/hit
accounting so mispredictions don't pollute the workload model; the serving
layer records the *actual* access via :meth:`note_access`.  A step's
selected experts are **pinned** in their layer cache for the life of the
fetch: admitting one selected expert can never evict another one mid-step
(see HierarchicalCache.pin).

Payload semantics per cache pool:
  F : reconstructed bf16 tensors (zero work on hit): bf16 bits as uint16
      ndarrays in host mode, SlotRefs into a device slab in device mode,
      the tensors' two bit-planes (the serving layer's ``BitPlanes``) when
      a ``recover_fn`` defers the splice to a fused GEMM
  C : raw SM bytes + compressed E bytes (decompress + recover on hit)
  S : raw SM bytes (E-chunk reads + decompress + recover on hit)
  E : compressed E bytes (SM read + decompress + recover on hit)

``cache_mode="flat"`` swaps every layer's hierarchical cache for a
:class:`~repro_torch.core.cache.LiveFlatCache` (full tensors only, classic
eviction) — the live baseline the Fig. 10 ablation compares against; the
reconstruction pipeline and block scheduling are identical, so flat and
hierarchical serving produce bit-identical outputs.

``device_cache=True`` moves the F tier onto the accelerator: recovery
uploads the two u8 planes once, F-pool admission splices them straight
into a per-layer :class:`~repro_torch.core.slab.DeviceSlabCache` slot with the
in-place splice-admit kernel, and payloads carry :class:`SlotRef` handles
instead of ndarrays — so a cache-hit decode step moves zero expert-weight
bytes host→device (``transfer_summary()['h2d_bytes']``).  Slot lifecycle is
reconciled against F-pool residency on the decode thread after every
collect phase; generation counters make stale refs detectable, and the
demotion hook re-derives the SM plane from a one-time slot download on F→S.

Plane uploads run on the worker threads as synchronous ``.to(device)``
copies on the device's default stream, the stream the decode thread's
kernels run on: a worker hands its planes over only after the copy was
enqueued, so every splice-admit is ordered after the upload it reads.

Live §3.4 planning (:meth:`ZipMoEEngine.configure_planner`) splits one
global byte budget across the layers by observed activity, solves each
layer's pools with ``core/planner``, and applies the plans between decode
steps: a re-sized slab's residents move slot to slot on the device (a view
of the old slot copied into the new one), and the old slab is retired.
The copy and the old buffer's release both run on the decode thread's
stream, so the allocator cannot hand the old memory out before the copy
has read it.

The peer-HBM (P) tier (``peer_devices``, two or more devices) puts
F ≺ P ≺ C ≺ S ≺ E in place of the paper's stack: P residents live in a
:class:`~repro_torch.core.slab.PeerSlabMesh` row on their EP owner's
device, and a demand or speculative hit on one is priced against local
reconstruction by the :class:`~repro_torch.core.profiles.LinkProfiler`
and, when the link wins, copied to the compute device (``peer_devices[0]``)
at submit time, on the decode thread, before the host pipeline sees the
expert.  The planner budgets each device's row separately
(``configure_planner(peer_budget=)``).  A one-device configuration has no
peer context and runs the default stack exactly.
"""
from __future__ import annotations

import collections
import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bitfield, checkz
from repro_torch.core.cache import HierarchicalCache, LiveFlatCache, pool_summary
from repro_torch.core.faults import (FetchError, FetchTimeout, PeerLinkError,
                                     WorkerKilled)
from repro_torch.core.scheduler import build_blocks
from repro_torch.core.slab import (DevicePlanes, DeviceSlabCache, PeerRef,
                                   PeerSlabMesh, SlotRef)
from repro_torch.core.states import CState, Task
from repro_torch.core.store import ExpertStore
from repro_torch.core.tiers import DEFAULT_STACK, PEER_STACK
from repro_torch.core.workload import FreqTracker
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import (host_u8, recover_bf16_device,
                                     splice_planes_device)


@dataclass
class ExpertPayload:
    """What a pool entry holds for one expert (per tensor index)."""
    sm: Dict[int, bytes] = field(default_factory=dict)
    e: Dict[Tuple[int, int], bytes] = field(default_factory=dict)   # (tidx, shard)
    full: Dict[int, object] = field(default_factory=dict)


@dataclass
class FetchStats:
    wall: float = 0.0
    io_bytes: int = 0
    dec_ops: int = 0
    hits: Dict[str, int] = field(default_factory=dict)


class _PeerContext:
    """Shared state of the peer-HBM (P) tier: the mesh's devices ('ep'
    axis; device 0 computes), the per-layer slab rows, the collective
    traffic ledger, and the profiled link-cost model.  Built only when the
    engine is given two or more devices — a 1-device configuration carries
    no peer context at all and runs the exact pre-peer stack."""

    def __init__(self, devices):
        from repro_torch.core.profiles import LinkProfiler
        from repro_torch.distributed.collectives import CollectiveLedger
        self.devices = [torch.device(d) for d in devices]
        self.n_dev = len(self.devices)
        self.ledger = CollectiveLedger()
        self.link = LinkProfiler()
        # single-writer: decode thread (lazy slab builds + plan application)
        self.slabs: Dict[int, Optional[PeerSlabMesh]] = {}
        # single-writer: decode thread (per-device planned slot grants)
        self.dev_caps: Dict[int, List[int]] = {}
        # the per-device byte budget each layer's grants were solved under
        self.row_budgets: Dict[int, float] = {}
        # single-writer: decode thread (submit-time serve/fallback tallies)
        self.served = 0        # P-resident experts materialised via the link
        self.fallbacks = 0     # P-resident but priced/failed to local decode


class _FetchJob:
    """All shared state of one in-flight fetch (owned by the engine pool).

    A job covers *demand* experts (the router's current selection for its
    primary layer, waited on by ``FetchHandle.result()``) plus optional
    *speculative* experts — next-step predictions for the same layer and,
    for cross-layer submissions, for later layers — under a single
    Algorithm-1 block schedule.  Expert identity is ``(layer, expert)``
    throughout: one block list may carry the same expert id for two
    different layers."""

    def __init__(self, seq: int, parts: List[Tuple[int, List[int], List[int]]]):
        # parts: ordered [(layer, selected, predicted)]; demand (selected)
        # may only appear in the first part — result() waits one layer's
        # demand set, never a union across layers
        self.seq = seq
        self.parts = parts
        self.layers = [l for l, _, _ in parts]
        self.layer = self.layers[0]              # primary layer
        self.demand_keys = {(parts[0][0], int(e)) for e in parts[0][1]}
        self.expert_keys: List[Tuple[int, int]] = [
            (l, int(e)) for l, sel, pred in parts
            for e in list(sel) + list(pred)]
        self.speculative = not self.demand_keys   # pure-prediction job
        self.last_demand_io_blk = -1   # last block index with demand I/O
        self.t_submit = time.perf_counter()
        self.t_ready: Optional[float] = None
        self.t_demand_ready: Optional[float] = None
        self.tasks: List[Task] = []
        self.blocks: List[List[Task]] = []
        self.metas: Dict[int, Tuple[int, int, int]] = {}  # uid -> (layer, e, tidx)
        self.task_by_uid: Dict[int, Task] = {}
        self.prio: Dict[int, int] = {}
        self.urg: Dict[int, int] = {}   # uid -> 0 (demand) / 1 (speculative)
        self.payloads: Dict[Tuple[int, int], ExpertPayload] = {}
        self.e_data: Dict[Tuple[int, int], bytes] = {}    # (uid, shard)
        self.sm_data: Dict[int, bytes] = {}               # uid -> sm bytes
        # uid -> preallocated exponent plane; workers decompress each
        # E-shard directly into its shard_bounds slice (zero-copy assembly,
        # no per-shard arrays + full-plane concatenate)
        self.exp_buf: Dict[int, np.ndarray] = {}
        self.dec_needed: Dict[int, int] = {}
        # (layer, expert, tidx) -> recovered tensor
        self.done_tensors: Dict[Tuple[int, int, int], np.ndarray] = {}
        self.claimed: set = set()                         # uids being recovered
        self.n_done = 0
        self.n_total = 0
        self.demand_done = 0
        self.demand_total = 0
        # stats already surfaced by an earlier collect phase — each phase
        # reports only its increment, so summing result() and spec_result()
        # stats never double-counts
        self.io_reported = 0
        self.dec_reported = 0
        self.wall_reported = 0.0
        self.collected: set = set()    # (layer, e) already admitted to cache
        self.unpinned: set = set()     # demand pins this job already released
        # failure routing (guarded-by: engine._cv): an expert whose chunks
        # could not be fetched/recovered after retries+fallback is marked
        # here; its unfinished uids count as done so the job's events still
        # fire (no silent hangs) and _collect raises/drops per class
        self.failed: Dict[Tuple[int, int], str] = {}   # (l, e) -> reason
        self.failed_uids: set = set()
        # (uid, shard) pairs already decompressed — dedups the watchdog's
        # requeue of a dead worker's in-flight heap items
        self.dec_done: set = set()
        self.spec_drop_counted: set = set()   # failed spec keys tallied once
        self.stats = FetchStats()
        self.done_ev = threading.Event()
        self.demand_ev = threading.Event()


class FetchHandle:
    """Two-phase future for one step's expert fetch.

    ``result()`` blocks only until the job's *demand* subset is
    reconstructed, assembles those tensors, and admits them to the cache
    pools (unpinning them).  ``spec_result()`` blocks until the whole job —
    including the speculative prediction tail, across every covered layer —
    is done and collects the remaining experts.  For single-class jobs
    (plain ``fetch_experts`` / speculative ``prefetch_experts``)
    ``result()`` covers every expert.

    Returned weight dicts are keyed by expert id when the collected subset
    lives in one layer (the common case — demand is always single-layer),
    and by ``(layer, expert)`` when a multi-layer speculative tail is
    collected at once."""

    def __init__(self, engine: "ZipMoEEngine", job: _FetchJob):
        self._engine = engine
        self._job = job
        self._result: Optional[Tuple[Dict, FetchStats]] = None
        self._spec_result: Optional[Tuple[Dict, FetchStats]] = None
        self.wait_s = 0.0          # time result()/spec_result() blocked

    @property
    def layer(self) -> int:
        return self._job.layer

    @property
    def layers(self) -> List[int]:
        return list(self._job.layers)

    @property
    def expert_ids(self) -> List[int]:
        """Primary-layer expert ids (use ``expert_keys`` cross-layer)."""
        return [e for l, e in self._job.expert_keys if l == self._job.layer]

    @property
    def expert_keys(self) -> List[Tuple[int, int]]:
        return list(self._job.expert_keys)

    def done(self) -> bool:
        return self._job.done_ev.is_set()

    @staticmethod
    def _flatten(out: Dict[Tuple[int, int], Dict[str, np.ndarray]]):
        """{(layer, e): w} -> {e: w} when one layer is covered."""
        if len({l for l, _ in out}) <= 1:
            return {e: w for (_, e), w in out.items()}
        return out

    def _wait(self, ev: threading.Event, deadline_s: Optional[float]):
        """Deadline-bounded event wait.  ``deadline_s=None`` uses the
        engine's ``fetch_deadline_s``; expiry raises :class:`FetchTimeout`
        instead of blocking forever on a dead pipeline."""
        eng = self._engine
        dl = eng.fetch_deadline_s if deadline_s is None else deadline_s
        t0 = time.perf_counter()
        ok = ev.wait(dl)
        self.wait_s = time.perf_counter() - t0
        if not ok:
            with eng._cv:
                eng.deadline_hits += 1
            raise FetchTimeout(
                f"fetch job {self._job.seq} (layer {self._job.layer}) "
                f"incomplete after {dl}s")

    def result(self, deadline_s: Optional[float] = None
               ) -> Tuple[Dict[int, Dict[str, np.ndarray]], FetchStats]:
        """Weights of the demand experts (all experts for single-class
        jobs).  Raises :class:`FetchError` when a demand expert failed
        after retries, :class:`FetchTimeout` past the deadline."""
        job = self._job
        if self._result is None:
            subset = sorted(job.demand_keys) if job.demand_keys else \
                list(job.expert_keys)
            ev = job.demand_ev if job.demand_keys else job.done_ev
            self._wait(ev, deadline_s)
            out, stats = self._engine._collect(job, subset)
            self._result = (self._flatten(out), stats)
        return self._result

    def result_subset(self, experts: Sequence[int], layer: Optional[int] = None,
                      deadline_s: Optional[float] = None
                      ) -> Tuple[Dict[int, Dict[str, np.ndarray]],
                                 FetchStats]:
        """Weights of just `experts` of `layer` (default: the primary
        layer), waiting only until THEIR tensors are recovered — never on
        the rest of the job, and in particular never on another layer's
        speculative tail.  Lets a consumer of a prediction job block on
        exactly the experts the router actually selected while the unused
        tail keeps reconstructing in the background."""
        job = self._job
        l = job.layer if layer is None else int(layer)
        want = {(l, int(e)) for e in experts}
        assert want <= set(job.expert_keys), (want, job.expert_keys)
        eng = self._engine
        dl = eng.fetch_deadline_s if deadline_s is None else deadline_s
        t0 = time.perf_counter()
        with eng._cv:
            def ready():
                # failed uids never land: treat them as ready so the wait
                # ends and _collect raises the structured error instead
                return all(job.metas[t.uid] in job.done_tensors
                           or t.uid in job.failed_uids
                           for t in job.tasks if t.expert_key in want)
            while not (job.done_ev.is_set() or ready()):
                if dl is not None and time.perf_counter() - t0 > dl:
                    eng.deadline_hits += 1
                    raise FetchTimeout(
                        f"fetch job {job.seq} subset {sorted(want)} "
                        f"incomplete after {dl}s")
                eng._cv.wait(0.1)
        self.wait_s = time.perf_counter() - t0
        out, stats = eng._collect(job, sorted(want))
        return self._flatten(out), stats

    def spec_result(self, deadline_s: Optional[float] = None
                    ) -> Tuple[Dict, FetchStats]:
        """Weights of ALL the job's experts (demand + speculative tail);
        waits for the whole job.  Already-collected experts are returned
        without re-admission; reported stats cover only the increment past
        earlier collect phases.  Never raises for failed experts —
        speculative failures are dropped and counted (``spec_drops``)."""
        job = self._job
        if self._spec_result is None:
            self._wait(job.done_ev, deadline_s)
            out, stats = self._engine._collect(job, list(job.expert_keys),
                                               strict=False)
            self._spec_result = (self._flatten(out), stats)
        return self._spec_result


class ZipMoEEngine:
    """Expert fetch engine for one model (all layers share the store)."""

    def __init__(self, store: ExpertStore, n_experts: int, n_layers: int, *,
                 L: int = 4, pool_sizes: Optional[Dict[str, int]] = None,
                 recover_fn: Optional[Callable] = None, delta: int = 1,
                 cache_mode: str = "hier", flat_capacity: Optional[int] = None,
                 flat_policy: str = "lru", freq_decay: float = 1.0,
                 device_cache: bool = False, device=None, peer_devices=None,
                 fetch_deadline_s: Optional[float] = 120.0,
                 worker_stall_s: Optional[float] = None,
                 watchdog_interval_s: float = 0.05):
        assert cache_mode in ("hier", "flat")
        assert 0.0 < freq_decay <= 1.0, freq_decay
        assert not (device_cache and recover_fn is not None), \
            "device_cache owns recovery (device splice + slab residency)"
        self.store = store
        self.L = L
        self.n_experts = int(n_experts)
        self.cache_mode = cache_mode
        self.freq_decay = freq_decay
        self.device_cache = device_cache
        # device_cache mode keeps the F tier on `device` (the card unless
        # the caller names another); host mode needs no device
        self.device = resolve_device(device) \
            if device_cache or device is not None else None
        # peer-HBM tier (P): expert slab rows on the devices of a mesh
        # ('ep' axis).  A 1-device mesh is pointless as a peer ring, so it
        # degenerates to no peer context — the stack, caches, and
        # telemetry are then EXACTLY the default configuration.
        self.peer: Optional[_PeerContext] = None
        if peer_devices is not None and len(peer_devices) > 1:
            assert cache_mode == "hier", \
                "the peer tier is a pool of the hierarchical stack"
            self.peer = _PeerContext(peer_devices)
            if self.device is not None and \
                    self.peer.devices[0] != self.device:
                raise ValueError(f"peer_devices[0] is "
                                 f"{self.peer.devices[0]}, but the engine "
                                 f"computes on {self.device}")
        self.stack = PEER_STACK if self.peer is not None else DEFAULT_STACK
        # h2d/splice telemetry (device mode uploads the two u8 planes once
        # per reconstruction; the serving layer also charges host-array
        # GEMM staging here so "zero weight bytes moved" is provable).
        # Written from the io/dec workers AND the decode thread -> locked.
        self.h2d_bytes = 0      # guarded-by: _cv
        self.d2h_bytes = 0      # guarded-by: _cv
        self.splice_s = 0.0     # guarded-by: _cv
        self.splice_ops = 0     # guarded-by: _cv
        # per-step expert-weight COPY bytes (device-side gather/stack
        # staging the serving layer materializes for the GEMM).  The
        # slot-indexed megakernel reads the slab in place: a fully
        # cache-hit device-mode step must add ZERO here — the companion
        # acceptance counter to h2d_bytes (which meters host→device only).
        self.w_copy_bytes = 0   # guarded-by: _cv
        self._slabs: Dict[int, Optional[DeviceSlabCache]] = {}
        # live-planned slab slot counts (derived from planned F-pool BYTES);
        # fallback: mirror the F pool's expert-count capacity
        self._slab_caps: Dict[int, int] = {}
        if device_cache:
            # fused demand-miss path: workers upload the planes, the splice
            # lands straight in a slab slot at collect time (one launch)
            self.recover = self._recover_device_planes
        else:
            self.recover = recover_fn or (
                lambda e, sm, shape: bitfield.reconstruct_np(
                    e, np.frombuffer(sm, np.uint8), shape))
        sizes = pool_sizes or {"F": 4, "C": 4, "S": 8, "E": 8}
        if self.peer is not None and "P" not in sizes:
            # default the peer pool to the whole expert set: the mesh's
            # aggregate memory can hold every shard, and the per-device
            # planner (plan_peer_shards) narrows the logical grants under
            # a budget
            sizes = dict(sizes)
            sizes["P"] = self.n_experts
        self.caches: Dict[int, object] = {}
        self.trackers: Dict[int, FreqTracker] = {}
        # windowed cache telemetry (§3.4): note_step() closes a per-N-steps
        # window of hit/miss/eviction deltas when enabled
        self._window_every = 0
        self._window_steps = 0
        self._windows: List[Dict[str, object]] = []
        self._window_base: Optional[Dict[str, object]] = None
        for l in range(n_layers):
            tr = FreqTracker(n_experts, decay=freq_decay)
            self.trackers[l] = tr
            if cache_mode == "flat":
                cap = flat_capacity if flat_capacity is not None \
                    else sum(sizes.values())
                self.caches[l] = LiveFlatCache(cap, tr, policy=flat_policy)
            else:
                self.caches[l] = HierarchicalCache(sizes, tr, delta=delta,
                                                   stack=self.stack)
                self.caches[l].demote_payload = self._demote_payload
        # profiled constants (rough; refreshed by profile());
        # per-layer u/c/ρ overlay the global probe (profile_layers())
        self.u = 1e-3
        self.c = 3e-4
        self.rho = store.rho()
        self._u_layer: Dict[int, float] = {}
        self._c_layer: Dict[int, float] = {}
        self._rho_layer: Dict[int, float] = {}
        # per-expert residency cost per pool, from the layer's REAL tensor
        # shapes + codec state sizes — the §3.4 byte denomination
        for l in range(n_layers):
            bps = self._bytes_per_state(l)
            if bps is None:
                continue
            self.caches[l].cost_bytes = bps if cache_mode != "flat" else \
                {"F": bps["F"], "C": 0.0, "S": 0.0, "E": 0.0}
        # live §3.4 planner (configure_planner): byte-budgeted pool plans
        # applied atomically between steps, re-planned under drift
        self.planner = None
        self.replan_every = 0
        self._plan_steps = 0
        self._plan_probe_base: Optional[Dict[str, object]] = None
        self._plan_access_base: Dict[int, int] = {}
        self._probe_acc_base: Dict[int, int] = {}
        self._layer_rates: Dict[int, float] = {}   # EMA accesses per probe
        # ---- persistent worker pool (one I/O thread + L decompressors) ----
        # checkz factories return plain primitives unless ZIPMOE_CHECK=1,
        # in which case acquires feed the lock-order cycle detector.
        self._mu = checkz.make_lock("engine._mu")
        self._cv = checkz.make_condition(self._mu, "engine._cv")
        # demand (urgent) fetches are served before speculative prefetches so
        # a misprediction fallback never queues behind background warming
        self._io_urgent: "collections.deque[_FetchJob]" = \
            collections.deque()                    # guarded-by: _cv
        self._io_spec: "collections.deque[_FetchJob]" = \
            collections.deque()                    # guarded-by: _cv
        self._dec_ready: List[Tuple[int, int, int, int, int]] = []  # guarded-by: _cv
        #                 (urgency, seq, prio, uid, shard)
        self._io_busy = False                      # guarded-by: _cv
        self._jobs: Dict[int, _FetchJob] = {}      # guarded-by: _cv
        self._seq = itertools.count()
        self._stop = False                         # guarded-by: _cv
        # ---- failure model (core/faults; DESIGN.md §Failure model) -------
        # every handle wait is bounded (None opts back into unbounded);
        # the watchdog respawns dead workers and requeues their in-flight
        # work; worker_stall_s additionally abandons *stuck* workers
        # (None: off — a stalled read is indistinguishable from a slow one)
        self.fetch_deadline_s = fetch_deadline_s
        self.worker_stall_s = worker_stall_s
        self.watchdog_interval_s = watchdog_interval_s
        self.faults = getattr(store, "faults", None)   # injection shim
        self.worker_restarts = 0                   # guarded-by: _cv
        self.deadline_hits = 0                     # guarded-by: _cv
        self.spec_drops = 0                        # guarded-by: _cv
        self.fallback_loads = 0                    # guarded-by: _cv
        self.peer_link_failures = 0                # guarded-by: _cv
        self.failed_experts = 0                    # guarded-by: _cv
        # per-worker-slot generation counters: the watchdog bumps a slot's
        # gen when replacing its thread, and an abandoned thread exits at
        # its next loop top instead of double-draining the queues
        self._worker_gen: Dict[str, int] = {
            "io": 0, **{f"dec{i}": 0 for i in range(self.L)}}
        self._heartbeat: Dict[str, float] = {}     # guarded-by: _cv
        # in-flight work the watchdog requeues on worker death: the I/O
        # thread's job stack (nested urgent jobs append) and each dec
        # worker's currently-held heap item
        self._io_inflight: List[_FetchJob] = []    # guarded-by: _cv
        self._dec_inflight: Dict[str, Tuple] = {}  # guarded-by: _cv
        self._io_thread = self._spawn_worker("io")
        self._dec_threads = [self._spawn_worker(f"dec{i}")
                             for i in range(self.L)]
        self._watchdog = threading.Thread(target=self._watchdog_loop,
                                          daemon=True, name="zipmoe-watchdog")
        self._watchdog.start()

    def _spawn_worker(self, slot: str) -> threading.Thread:
        gen = self._worker_gen[slot]
        if slot == "io":
            body, args = self._io_loop, (gen,)
        else:
            body, args = self._dec_loop, (int(slot[3:]), gen)

        # worker-exc-routed: loop bodies route Exception into FetchError
        def run():
            try:
                body(*args)
            except WorkerKilled:
                # injected crash (FaultPlan): die without the excepthook
                # traceback — the watchdog detects death via is_alive()
                pass

        th = threading.Thread(target=run, daemon=True, name=f"zipmoe-{slot}")
        th.start()
        return th

    def shutdown(self):
        """Stop the pool.  In-flight jobs are finished first; the store's
        cached FDs are released once the I/O thread is down."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for th in [self._io_thread, *self._dec_threads, self._watchdog]:
            th.join(timeout=5.0)
        close = getattr(self.store, "close", None)
        if close is not None:
            close()

    def release(self):
        """After :meth:`shutdown`: free the device slabs and peer rows now
        (every SlotRef and PeerRef into them turns stale) and drop the
        references back to the engine that its caches' demotion hook and
        its recover hook hold, so the engine and the payloads in its pools
        are freed by reference counting, without waiting for the cycle
        collector.  Counters and telemetry stay readable; the engine
        fetches nothing afterwards."""
        for slab in self._slabs.values():
            if slab is not None:
                slab.retire()
        if self.peer is not None:
            for slab in self.peer.slabs.values():
                if slab is not None:
                    slab.retire()
        for cache in self.caches.values():
            cache.demote_payload = None
        self.recover = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # ------------------------------------------------------------------
    def profile(self, layer: int = None, expert: int = None, reps: int = 3):
        """Measure u (SM read) and c (E-chunk decompress) on this host.

        ``layer``/``expert`` pick the probe group; omitting ``expert`` uses
        the layer's first expert group (regression: ``profile(layer=L)``
        used to die with ``KeyError: (L, None)``).  A layer-targeted probe
        also lands in the per-layer u/c overlay (shard sizes differ per
        layer, so the I/O and decompression costs do too) — the scheduler's
        task costs and the planner's PlanConsts read the overlay with the
        global probe as fallback."""
        if layer is None:
            key = next(iter(self.store.groups))
        else:
            if expert is None:
                expert = min((e for (l, e) in self.store.groups if l == layer),
                             default=None)
                if expert is None:
                    raise KeyError(f"no expert groups for layer {layer}")
            key = (layer, expert)
        g = self.store.groups[key]
        t0 = time.perf_counter()
        for _ in range(reps):
            self.store.read_sm(key, 0)
        self.u = (time.perf_counter() - t0) / reps
        raw = self.store.read_e(key, 0, 0)
        t0 = time.perf_counter()
        for _ in range(reps):
            self.store.decompress_e(key, 0, 0, raw)
        self.c = (time.perf_counter() - t0) / reps
        if layer is not None:
            self._u_layer[layer] = self.u
            self._c_layer[layer] = self.c
        return self.u, self.c

    def profile_layers(self, reps: int = 2) -> Dict[int, Tuple[float, float]]:
        """Per-layer u/c from each layer's real shard sizes: one probe per
        layer that has expert groups.  Sharpens both the scheduler's
        compute-dominance test and the live planner's per-layer
        PlanConsts."""
        out = {}
        for l in sorted({l for (l, _) in self.store.groups}):
            out[l] = self.profile(layer=l, reps=reps)
        return out

    def _layer_costs(self, layer: int) -> Tuple[float, float, float]:
        """(u, c, ρ) for one layer: the profiled per-layer overlay when
        present, the global probe otherwise."""
        rho = self._rho_layer.get(layer)
        if rho is None:
            has = any(l == layer for (l, _) in self.store.groups)
            rho = self._rho_layer[layer] = \
                self.store.layer_rho(layer) if has else self.rho
        return (self._u_layer.get(layer, self.u),
                self._c_layer.get(layer, self.c), rho)

    def _bytes_per_state(self, layer: int) -> Optional[Dict[str, float]]:
        """Per-expert residency cost (bytes) per pool, from the layer's
        real tensor shapes and codec state sizes via each tier's declared
        payload kind: F/P = reconstructed bf16, S = raw SM planes,
        E = compressed E-chunks, C = S + E."""
        expert = min((e for (l, e) in self.store.groups if l == layer),
                     default=None)
        if expert is None:
            return None
        g = self.store.groups[(layer, expert)]
        return self.stack.bytes_per_state({
            "full": float(g.full_bytes), "sm": float(g.sm_bytes),
            "e": float(g.e_bytes)})

    def plan_consts(self, layer: int):
        """The layer's :class:`~repro_torch.core.planner.PlanConsts`, from
        the per-layer profiled u/c/ρ and the layer's real chunk layout."""
        from repro_torch.core.planner import PlanConsts
        expert = min((e for (l, e) in self.store.groups if l == layer),
                     default=None)
        if expert is None:
            raise KeyError(f"no expert groups for layer {layer}")
        g = self.store.groups[(layer, expert)]
        K = max(1, len(g.tensors[0].e_sizes))
        u, c, rho = self._layer_costs(layer)
        # profiled per-expert peer-fetch cost: the third Algorithm-3
        # bottleneck (0 without a mesh — the term vanishes exactly)
        peer = self.peer.link.p_time(int(g.full_bytes)) \
            if self.peer is not None else 0.0
        return PlanConsts(u=u, v=rho * u / K, c=c, L=self.L, K=K,
                          n_tensors=len(g.tensors), peer=peer)

    # ------------------------------------------------------------------
    # device-resident slabs (device_cache mode)
    # ------------------------------------------------------------------
    def count_h2d(self, nbytes: int):
        """Charge `nbytes` of host->device expert-weight traffic (the
        serving layer calls this when it stages host arrays for the GEMM)."""
        with self._cv:
            self.h2d_bytes += int(nbytes)

    def count_w_copy(self, nbytes: int):
        """Charge `nbytes` of per-step expert-weight COPY staging (the
        serving layer's gather/stack materialization for the GEMM — device
        OR host side).  The slot-indexed megakernel path charges nothing:
        ``w_copy_bytes`` flat across a cache-hit step is the proof that
        expert compute runs zero-copy out of the slab."""
        with self._cv:
            self.w_copy_bytes += int(nbytes)

    def _sync(self):
        """Wait for the device's queued work (timed device splices)."""
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _recover_device(self, exp, sm, shape):  # hot-path
        """Device recovery hook: upload the two u8 planes once, splice on
        device (the CUDA kernel on the card), return the bf16 tensor
        WITHOUT downloading it — the slab write / GEMM consume it in
        place."""
        n = int(np.prod(shape))
        t0 = time.perf_counter()
        out = recover_bf16_device(exp, sm, shape, self.device)
        self._sync()     # host-sync-ok: timed splice, off decode thread
        dt = time.perf_counter() - t0
        with self._cv:
            self.h2d_bytes += 2 * n
            self.splice_s += dt
            self.splice_ops += 1
        return out

    def _recover_device_planes(self, exp, sm, shape):  # hot-path
        """Fused-miss recovery hook (device_cache mode): upload the two u8
        planes and STOP — no splice, no bf16 materialisation.  The decode
        thread's slab reconcile later lands the splice directly into a slab
        slot via the in-place splice-admit kernel, so a demand miss costs
        ONE kernel launch and warms the slab as a side effect.  The upload
        is a synchronous copy on the device's default stream (see the
        module docstring).  Returns a :class:`DevicePlanes` placeholder
        holding the uploaded planes; ``_collect``/``_reconcile_slab``
        resolve it to a SlotRef."""
        exp_d = host_u8(exp).to(self.device)
        sm_d = host_u8(sm).to(self.device)
        with self._cv:
            self.h2d_bytes += exp_d.numel() + sm_d.numel()
        return DevicePlanes(exp=exp_d, sm=sm_d, shape=tuple(shape))

    def _splice_planes(self, dp: DevicePlanes):
        """Materialise a DevicePlanes placeholder into a standalone bf16
        device tensor — the fused-admit fallback whenever no slab slot can
        take the planes (slab overflow, peer demotion, flat mode).  Charged
        to the engine splice counters like any other device splice."""
        t0 = time.perf_counter()
        out = splice_planes_device(dp.exp, dp.sm, dp.shape)
        self._sync()     # host-sync-ok: timed splice, off hot loop
        dt = time.perf_counter() - t0
        with self._cv:
            self.splice_s += dt
            self.splice_ops += 1
        return out

    def _slab(self, layer: int) -> Optional[DeviceSlabCache]:
        """The layer's slab (lazily built from the store's tensor shapes;
        capacity = the live-planned F-pool byte budget when planning is on,
        else the F pool's expert-count size).  None when the capacity is 0."""
        if not self.device_cache:
            return None
        if layer not in self._slabs:
            cap = self._slab_caps.get(layer,
                                      self.caches[layer].cap.get("F", 0))
            if cap <= 0:
                self._slabs[layer] = None
            else:
                expert = min((e for (l, e) in self.store.groups
                              if l == layer), default=None)
                if expert is None:
                    self._slabs[layer] = None
                else:
                    shapes = {t.name: tuple(t.shape) for t in
                              self.store.groups[(layer, expert)].tensors}
                    self._slabs[layer] = DeviceSlabCache(layer, shapes, cap,
                                                         self.device)
        return self._slabs[layer]

    def _reconcile_slab(self, layer: int):
        """Sync the layer's slab with its F pool (decode thread, after the
        admissions of one collect phase): slots of experts that left F are
        freed (generation bump — outstanding SlotRefs turn stale), and
        newly F-resident experts' device tensors are written into a slot
        in place (the splice-admit kernel for uploaded planes), their
        payloads swapped to SlotRefs.  Because F occupancy never exceeds the slab capacity,
        freeing the leavers always leaves room for the arrivals."""
        slab = self._slab(layer)
        if slab is None:
            return
        fpool = self.caches[layer].pools["F"]
        for e in [e for e in slab.slot_of if e not in fpool]:
            slab.free(e)
        names = None
        for e, ent in fpool.items():
            pl = ent.payload
            if pl is None or not isinstance(pl, ExpertPayload) or not pl.full:
                continue
            if all(isinstance(v, SlotRef) and v.valid
                   for v in pl.full.values()):
                continue               # already slab-resident
            if e not in slab.slot_of and not slab._free:
                # a re-plan shrink deferred by all-pinned residents can
                # leave F transiently over the slab capacity: keep the
                # overflow's payload host/device-array-backed (still
                # servable) instead of asserting on a full slab.  Pending
                # fused-admit planes can't stay pending — splice standalone.
                for tidx, v in pl.full.items():
                    if isinstance(v, DevicePlanes):
                        pl.full[tidx] = self._splice_planes(v)
                continue
            if names is None:
                names = [t.name for t in
                         self.store.groups[(layer, e)].tensors]
            tensors = {}
            for tidx, v in pl.full.items():
                if isinstance(v, SlotRef):
                    # a stale ref (its slab re-sized/retired mid-flight)
                    # has lost its device bytes: re-load from the store
                    tensors[names[tidx]] = v.read() if v.valid \
                        else self._refetch_tensor(layer, e, tidx)
                else:
                    tensors[names[tidx]] = v
            refs = slab.put(e, tensors)
            pl.full = {tidx: refs[names[tidx]] for tidx in pl.full}

    def _refetch_tensor(self, l: int, e: int, tidx: int):
        """Materialise one tensor whose slab SlotRef went stale while its
        job was pending: exact-range store reads on the caller's thread,
        uploaded (and charged to ``h2d_bytes``) in device mode."""
        arr = self.store.load_tensor((l, e), tidx)
        if not self.device_cache:
            return arr
        with self._cv:
            self.h2d_bytes += arr.nbytes
        return bitfield.from_bits(arr).to(self.device)

    # ------------------------------------------------------------------
    # peer-HBM tier (P): slab rows on the mesh's devices + demand fetches
    # ------------------------------------------------------------------
    def _peer_owner(self, expert: int) -> int:
        """EP owner device of `expert` (contiguous blocks, matching the
        store/param sharding rule; balanced fallback off-divisibility)."""
        from repro_torch.distributed.sharding import ep_ok, ep_owner
        n, d = self.n_experts, self.peer.n_dev
        if ep_ok(n, d):
            return ep_owner(expert, n, d)
        return min(d - 1, int(expert) * d // max(1, n))

    def _peer_slab(self, layer: int) -> Optional[PeerSlabMesh]:
        """The layer's peer slab mesh (lazily built).  Physical row size is
        the device's whole expert shard — the mesh's aggregate memory is
        the P tier's backing store — while the *logical* per-device slot
        grants (``set_dev_caps``) carry the planned budget."""
        if self.peer is None:
            return None
        slabs = self.peer.slabs
        if layer not in slabs:
            cap = self.caches[layer].cap.get("P", 0)
            expert = min((e for (l, e) in self.store.groups if l == layer),
                         default=None)
            if cap <= 0 or expert is None:
                slabs[layer] = None
            else:
                shapes = {t.name: tuple(t.shape) for t in
                          self.store.groups[(layer, expert)].tensors}
                blk = -(-self.n_experts // self.peer.n_dev)
                slab = PeerSlabMesh(layer, shapes, blk, self.peer.devices,
                                    ledger=self.peer.ledger,
                                    link=self.peer.link)
                slab.faults = self.faults
                slab.set_dev_caps(self.peer.dev_caps.get(layer)
                                  or self._even_dev_caps(cap))
                slabs[layer] = slab
        return slabs[layer]

    def _even_dev_caps(self, cap: int) -> List[int]:
        """Unplanned default: split the P pool's expert-count capacity
        evenly over the mesh (low device ids take the remainder)."""
        d = self.peer.n_dev
        base, rem = divmod(max(0, int(cap)), d)
        return [min(base + (1 if i < rem else 0),
                    -(-self.n_experts // d)) for i in range(d)]

    def _peer_fetch(self, layer: int, expert: int) -> Optional["ExpertPayload"]:
        """Fetch a peer-slab resident to the compute device and wrap it as
        an F-like payload (full device tensors).  A failed link (injected
        or real) returns None — the caller falls back to the local store
        path priced by the LinkProfiler."""
        slab = self._peer_slab(layer)
        if slab is None or expert not in slab:
            return None
        try:
            got = slab.fetch(expert)
        except PeerLinkError:
            with self._cv:
                self.peer_link_failures += 1
            return None
        if got is None:
            return None
        g = self.store.groups[(layer, expert)]
        return ExpertPayload(full={tidx: got[tm.name]
                                   for tidx, tm in enumerate(g.tensors)})

    def _serve_peer_residents(self, job: "_FetchJob"):
        """Materialise P-resident experts at submit time (decode thread).

        A demand/speculative expert whose bytes live in a peer device's
        slab row is priced link-fetch vs local reconstruction from the
        profiled link model; when the link wins, the fetch runs
        synchronously here and the job seeds the fetched tensors exactly
        like an F hit — the host pipeline (I/O thread, decompress workers,
        host→device staging) never sees the expert.  P-pool entries still
        backed by their own tensors (admitted but not yet in a row, or over
        their row's planned grant) serve those in place at zero link cost.
        """
        for (l, e) in job.expert_keys:
            ent = self.caches[l].pools.get("P", {}).get(e)
            if ent is None:
                continue
            pl = ent.payload
            if isinstance(pl, ExpertPayload) and pl.full and \
                    not any(isinstance(v, PeerRef)
                            for v in pl.full.values()) and \
                    self._full_payload_usable(pl):
                job.payloads[(l, e)] = pl
                self.peer.served += 1
                continue
            g = self.store.groups.get((l, e))
            if g is None:
                continue
            u_l, c_l, rho_l = self._layer_costs(l)
            K = max(1, len(g.tensors[0].e_sizes))
            # full-miss local estimate (P sits above C, so a P resident
            # holds no host bytes): SM + E reads, then K decompressions
            # over min(L, K) workers, per tensor
            local = len(g.tensors) * (u_l * (1.0 + rho_l)
                                      + c_l * K / max(1, min(self.L, K)))
            if self.peer.link.p_time(int(g.full_bytes)) >= local:
                self.peer.fallbacks += 1
                continue
            got = self._peer_fetch(l, e)
            if got is None:
                self.peer.fallbacks += 1
                continue
            job.payloads[(l, e)] = got
            self.peer.served += 1

    def _reconcile_peer(self, layer: int):
        """Sync the layer's peer slab with its P pool (decode thread, after
        a collect phase's admissions) — the peer analogue of
        :meth:`_reconcile_slab`: slots of experts that left P are freed
        (generation bump — outstanding PeerRefs turn stale); already
        row-resident arrivals just swap their payload back to refs (expert
        weights are immutable, so no rewrite); new residents are written
        into their EP owner's row (charged to the ledger's
        ``peer_put_bytes``).  A row out of planned slots keeps the resident
        backed by its own tensors — still servable in place by
        :meth:`_serve_peer_residents`."""
        slab = self._peer_slab(layer)
        if slab is None:
            return
        ppool = self.caches[layer].pools["P"]
        for e in [e for e in slab.slot_of if e not in ppool]:
            slab.free(e)
        names = None
        for e, ent in ppool.items():
            pl = ent.payload
            if not isinstance(pl, ExpertPayload) or not pl.full:
                continue
            if all(isinstance(v, PeerRef) and v.valid
                   for v in pl.full.values()):
                continue               # already row-resident via refs
            if names is None:
                names = [t.name for t in
                         self.store.groups[(layer, e)].tensors]
            if e in slab.slot_of:
                refs = slab.refs(e)    # immutable weights: no rewrite
                pl.full = {tidx: refs[names[tidx]] for tidx in pl.full}
                continue
            if any(isinstance(v, PeerRef) for v in pl.full.values()):
                # stale refs, bytes gone: the entry self-heals on its next
                # access (fetch misses the slab -> local decode -> re-admit)
                continue
            dev = self._peer_owner(e)
            if not slab.has_free(dev):
                continue               # over the row's planned grant
            tensors, usable = {}, True
            for tidx, v in pl.full.items():
                if isinstance(v, SlotRef):    # F->P demotion in device mode
                    if not v.valid:
                        usable = False
                        break
                    v = v.read()
                elif isinstance(v, DevicePlanes):
                    # fused-admit planes demoted before any slab landed
                    # them: splice standalone (peer rows hold bf16 bytes)
                    v = self._splice_planes(v)
                    pl.full[tidx] = v
                tensors[names[tidx]] = v
            if not usable:
                continue
            refs = slab.put(e, dev, tensors)
            pl.full = {tidx: refs[names[tidx]] for tidx in pl.full}

    def peer_summary(self) -> Dict[str, object]:
        """Peer-tier telemetry: the collective-traffic ledger, the profiled
        link model, submit-time serve/fallback decisions, and per-layer
        slab occupancy.  ``{"enabled": False}`` without a mesh."""
        if self.peer is None:
            return {"enabled": False}
        out: Dict[str, object] = {
            "enabled": True, "n_dev": self.peer.n_dev,
            "served": self.peer.served, "fallbacks": self.peer.fallbacks}
        out.update(self.peer.ledger.summary())
        out["link"] = self.peer.link.summary()
        out["slabs"] = {l: s.summary() for l, s in
                        sorted(self.peer.slabs.items()) if s is not None}
        return out

    def fault_summary(self) -> Dict[str, object]:
        """Failure-model telemetry (DESIGN.md §Failure model): store
        integrity counters (retries/checksum failures/quarantines), the
        engine's watchdog/deadline/degradation counters, peer-link
        failures, and — when a FaultPlan is active — its fired counts."""
        with self._cv:
            out: Dict[str, object] = {
                "worker_restarts": self.worker_restarts,
                "deadline_hits": self.deadline_hits,
                "spec_drops": self.spec_drops,
                "fallback_loads": self.fallback_loads,
                "peer_link_failures": self.peer_link_failures,
                "failed_experts": self.failed_experts,
            }
        store_fs = getattr(self.store, "fault_summary", None)
        out["store"] = store_fs() if store_fs is not None else {}
        if self.faults is not None:
            out["injected"] = self.faults.summary()
        return out

    @staticmethod
    def _full_payload_usable(pl: "ExpertPayload") -> bool:
        """No stale refs: a freed/reused slot — device slab or peer row —
        must never be re-admitted as if it still held the old expert's
        weights."""
        return all((not isinstance(v, (SlotRef, PeerRef))) or v.valid
                   for v in pl.full.values())

    @staticmethod
    def _sm_plane_of(arr) -> Optional[bytes]:
        """Re-derive one tensor's SM plane for F→S demotion, whatever the F
        payload holds: host bf16 bits (cheap numpy bit-split), uploaded
        DevicePlanes (already split; one plane download), fused-mode host
        BitPlanes (already split), a slab SlotRef (one-time slot download),
        or a device tensor."""
        if isinstance(arr, np.ndarray):
            return bitfield.decompose_np(arr)[1].tobytes()
        if isinstance(arr, DevicePlanes):
            return arr.sm.cpu().numpy().tobytes()
        if hasattr(arr, "sm"):                 # fused-mode BitPlanes
            return np.asarray(arr.sm).tobytes()
        if isinstance(arr, SlotRef):
            if not arr.valid:
                return None
            return bitfield.decompose_np(arr.read_np())[1].tobytes()
        if isinstance(arr, PeerRef):
            # peer-row bytes are not host bytes: no SM plane to re-derive
            return None
        if isinstance(arr, torch.Tensor):
            return bitfield.decompose_np(arr)[1].tobytes()
        return None

    def _demote_payload(self, payload, pool: str) -> Optional["ExpertPayload"]:
        """§3.4 demotion hook: keep only the bytes the target pool can serve
        (C→S keeps SM-chunks, C→E keeps E-chunks, F→S re-derives the SM plane
        from the resident tensors — a numpy bit-split, preceded by a one-time
        slot download when the tensors live in a device slab).  Returns None
        when nothing real can back the pool, so the cache drops the entry
        instead of keeping a byte-less placeholder that would count as a hit
        but cost a full refetch."""
        if not isinstance(payload, ExpertPayload):
            return None
        if pool == "F":
            if not payload.full or not self._full_payload_usable(payload):
                return None
            if any(isinstance(v, PeerRef) for v in payload.full.values()):
                # peer-row bytes can't back F without a link fetch; the
                # entry cascades to P and is promoted on its next demand
                # hit, whose fetch materialises compute-device tensors
                return None
            return ExpertPayload(full=dict(payload.full))
        if pool == "P":
            if self.peer is None or not payload.full or \
                    not self._full_payload_usable(payload):
                return None
            return ExpertPayload(full=dict(payload.full))
        has_sm = bool(payload.sm)
        has_e = bool(payload.e)
        if pool == "C":
            if has_sm and has_e:
                return ExpertPayload(sm=dict(payload.sm), e=dict(payload.e))
            return None
        if pool == "S":
            if has_sm:
                return ExpertPayload(sm=dict(payload.sm))
            if payload.full:
                sm = {}
                for tidx, arr in payload.full.items():
                    smb = self._sm_plane_of(arr)
                    if smb is None:
                        return None
                    sm[tidx] = smb
                return ExpertPayload(sm=sm)
            return None
        if pool == "E":
            return ExpertPayload(e=dict(payload.e)) if has_e else None
        return None

    def _payload(self, layer: int, expert: int) -> Optional[ExpertPayload]:
        # peer tiers are skipped: their payloads carry PeerRefs (bytes in a
        # neighbor device's memory), which the host reconstruction pipeline
        # can't consume — _serve_peer_residents intercepts those instead
        cache = self.caches[layer]
        for t in self.stack.tiers:
            if t.peer:
                continue
            ent = cache.pools[t.name].get(expert)
            if ent is not None:
                if ent.payload is None:
                    ent.payload = ExpertPayload()
                return ent.payload
        return None

    def predict_topk(self, layer: int, k: int) -> List[int]:
        """Most-frequent k experts of `layer` per the runtime FreqTracker —
        the prefetch seed when the next layer's router hasn't run yet."""
        order = self.trackers[layer].experts_by_rank()
        return [int(e) for e in order[:k]]

    def note_access(self, layer: int, expert_ids: Sequence[int]):
        """Record an *actual* router selection served from a speculative
        prefetch (tracker counts + hit/miss stats).  Call BEFORE the
        selection's weights are collected so the hit/miss tally reflects
        residency at step start, not post-admission state."""
        return self.caches[layer].record_access(list(expert_ids))

    def residency_states(self, layer: int, expert_ids) -> Dict[int, CState]:
        """Pure residency snapshot (no stats/tracker mutation) — the
        per-request hit attribution under a multi-tenant union selection,
        where the shared record_access tallies each unique expert once but
        several requests may have routed to it."""
        return self.caches[layer].residency_many(expert_ids)

    def pin_experts(self, layer: int, expert_ids: Sequence[int]):
        """Pin a step's selected experts (served from prediction jobs, so
        not pinned by any submit_step) against mid-step eviction churn."""
        self.caches[layer].pin(expert_ids)

    def unpin_experts(self, layer: int, expert_ids: Sequence[int]):
        self.caches[layer].unpin(expert_ids)

    def reset_cache_stats(self):
        """Zero every layer's cache telemetry (residency untouched) — used
        to report steady state after a warmup pass."""
        for cache in self.caches.values():
            cache.reset_stats()
        if self._window_every:
            self._window_base = self._cache_counters()
        if self.planner is not None:
            self._plan_probe_base = self._cache_counters()
            # hit/miss counters restart at zero: restart the per-layer
            # access deltas with them or replan weights would go negative
            self._plan_access_base = {}
            self._probe_acc_base = {}

    # ---- live §3.4 planning (byte-budgeted pools, online re-planning) ----
    def configure_planner(self, mem_budget: float, *, replan_every: int = 32,
                          plan_step: float = 0.125,
                          drift_margin: float = 0.05,
                          drift_min_accesses: int = 0,
                          profile_per_layer: bool = True,
                          initial_plan: bool = True,
                          budget_split: str = "proportional",
                          peer_budget: Optional[float] = None):
        """Turn on byte-budgeted live pool planning: one global byte budget
        for ALL layers' pools, split by observed layer activity and solved
        per layer by the §3.4 planner on that layer's live rank statistics,
        real residency costs, and per-layer profiled PlanConsts.  Plans are
        applied atomically between decode steps; every ``replan_every``
        calls to :meth:`note_step` the windowed hit rate is probed and a
        drift (see ``LivePlanner.should_replan``) triggers a re-plan.
        ``initial_plan=False`` keeps the constructor capacities (e.g. an
        explicit ``pool_sizes`` override) until the first drift re-plan.

        ``budget_split="waterfill"`` grants the cross-layer budget by
        marginal expected-makespan gain per byte instead of proportionally
        to activity (see ``LivePlanner._waterfill_budgets``).  With a peer
        mesh, ``peer_budget`` is each device's own byte budget for its
        slab row (default: ``mem_budget``) — the P tier's memory is the
        mesh's, not the host's, so it is budgeted separately and solved per
        device over that shard's rank statistics (``plan_peer_shards``)."""
        from repro_torch.core.planner import LivePlanner
        active = ("F",) if self.cache_mode == "flat" else \
            ("F", "C", "S", "E")
        self.planner = LivePlanner(mem_budget, step=plan_step,
                                   drift_margin=drift_margin,
                                   drift_min_accesses=drift_min_accesses,
                                   active=active, order=self.stack.order,
                                   budget_split=budget_split)
        self._peer_budget = float(mem_budget if peer_budget is None
                                  else peer_budget)
        self.replan_every = max(0, int(replan_every))
        self._plan_steps = 0
        self._plan_probe_base = None
        self._plan_access_base = {}
        self._probe_acc_base = {}
        self._layer_rates = {}
        if profile_per_layer:
            self.profile_layers()
        if initial_plan:
            self.replan(reason="initial")
        else:
            # explicit pool_sizes override: the static capacities are the
            # baseline — only observed drift replaces them, never the
            # bootstrap "initial" probe
            self.planner.seed()
        return self.planner

    def replan(self, reason: str = "manual",
               hit_rate: Optional[float] = None):
        """Solve fresh per-layer plans from the live trackers and apply
        them.  Must run on the decode thread between steps (the same
        single-mutator discipline as cache admission) — :meth:`note_step`
        calls it there; tests and the smoke may call it directly to force a
        re-plan.  The event it logs also carries the host wall time of the
        solve and the apply (``wall_s``; slab migrations are enqueued on the
        card, not waited for)."""
        assert self.planner is not None, "configure_planner() first"
        t0 = time.perf_counter()
        layers = sorted({l for (l, _) in self.store.groups})
        stats, bps, consts, acc = {}, {}, {}, {}
        for l in layers:
            tr = self.trackers[l]
            stats[l] = tr.inclusion_probs()
            bps[l] = self._bytes_per_state(l)
            consts[l] = self.plan_consts(l)
            acc[l] = sum(self.caches[l].hits.values()) + self.caches[l].misses
        # budget weights = RECENT per-layer activity — the probe-interval
        # EMA when the step clock is running, else accesses since the last
        # plan.  A layer traffic has abandoned goes genuinely cold (its
        # tracker counts only decay on its own records, so all-time mass
        # would keep feeding it budget).  First plan / empty interval falls
        # back to the decayed tracker mass.
        weights = {l: self._layer_rates.get(l, 0.0) for l in layers}
        if not any(weights.values()):
            base = self._plan_access_base
            weights = {l: float(max(0, acc[l] - base.get(l, 0)))
                       for l in layers}
        if not any(weights.values()):
            weights = {l: float(self.trackers[l].counts.sum())
                       for l in layers}
        self._plan_access_base = acc
        plans = self.planner.plan(stats, bps, consts, weights=weights)
        if self.peer is not None:
            self._plan_peer(plans, bps, consts, weights)
        self.apply_plans(plans)
        self.planner.note_plan(self._plan_steps, reason, hit_rate)
        self.planner.replans[-1]["wall_s"] = time.perf_counter() - t0
        return plans

    def apply_plans(self, plans):
        """Apply per-layer :class:`~repro_torch.core.planner.LayerPlan`s
        between steps: resize each layer's pools (graceful shrink —
        pinned/mid-step residents are never evicted; churn-free grow), then
        re-size the layer's device slab from the planned F-pool **bytes** —
        a cold layer (zero F bytes) releases its slab's device memory
        entirely, with generation-counter invalidation of outstanding
        SlotRefs."""
        for l, plan in sorted(plans.items()):
            cache = self.caches[l]
            if self.cache_mode == "flat":
                cache.resize(plan.sizes.get("F", 0), plan.cap_bytes)
            else:
                cache.resize(plan.sizes, plan.cap_bytes)
            if self.device_cache:
                bps = self._bytes_per_state(l)
                slab_cap = 0
                if bps and bps["F"] > 0:
                    slab_cap = int(plan.cap_bytes.get("F", 0.0) // bps["F"])
                self._apply_slab_plan(l, min(slab_cap, self.trackers[l].n))
            if self.peer is not None:
                self._apply_peer_plan(l)

    def _apply_slab_plan(self, layer: int, new_cap: int):
        """Grow/shrink/free one layer's device slab to the byte-planned
        slot count.  Residents migrate on the device (a view of the old
        slot copied into the new slab's slot on the decode thread's stream,
        payload refs swapped); the old slab is then retired so every
        outstanding SlotRef to it turns stale.  Its buffers are released on
        the same stream, after the copies that read them."""
        self._slab_caps[layer] = max(0, int(new_cap))
        old = self._slabs.pop(layer, None)
        if old is None:
            # not built yet (or memoized as capacity-0): the next _slab()
            # call lazily builds at the newly planned capacity
            return
        if new_cap == old.capacity:
            self._slabs[layer] = old
            return
        if new_cap <= 0:
            old.retire()
            self._slabs[layer] = None
            return
        new = DeviceSlabCache(layer, old.shapes, new_cap, self.device)
        fpool = self.caches[layer].pools["F"]
        names = None
        for e, ent in fpool.items():
            pl = ent.payload
            if not isinstance(pl, ExpertPayload) or not pl.full:
                continue
            if not self._full_payload_usable(pl):
                continue               # stale refs: _collect refetches later
            if not new._free:
                break    # deferred-trim overflow (all pinned): keep old refs
            if names is None:
                names = [t.name for t in
                         self.store.groups[(layer, e)].tensors]
            tensors = {}
            for tidx, v in pl.full.items():
                tensors[names[tidx]] = v.read() if isinstance(v, SlotRef) \
                    else v
            refs = new.put(e, tensors)
            pl.full = {tidx: refs[names[tidx]] for tidx in pl.full}
        old.retire()
        self._slabs[layer] = new

    def _peer_shard_stats(self, layer: int) -> List[np.ndarray]:
        """Per-device rank statistics: each EP shard's per-expert inclusion
        probabilities (the layer tracker's mass restricted to the shard's
        ids, rank-sorted) — what ``plan_peer_shards`` solves over."""
        tr = self.trackers[layer]
        n, d = self.n_experts, self.peer.n_dev
        k = int(round(tr.k_ema)) if tr.n_records else 1
        k = max(1, min(k, n - 1 if n > 1 else 1))
        total = tr.counts.sum()
        per = np.full(n, k / n) if total <= 0 else tr.counts * (k / total)
        ids_by_dev: List[List[int]] = [[] for _ in range(d)]
        for e in range(n):
            ids_by_dev[self._peer_owner(e)].append(e)
        return [np.sort(per[ids])[::-1] if ids else np.zeros(0)
                for ids in ids_by_dev]

    def _plan_peer(self, plans, bps, consts, weights: Dict[int, float]):
        """Per-device §3.4 peer-row budgeting: each device's slab row gets
        the layer's activity share of the per-device budget, and the solver
        runs over THAT shard's rank statistics (plan_peer_shards) — a
        device owning the hot shard earns more slots.  The layer's P size
        is the sum of its shard grants; cap_bytes follows at the
        full-tensor cost.  Runs between planner.plan and apply_plans so
        cache resize + slab grants land atomically with the host plan."""
        from repro_torch.core.planner import plan_peer_shards
        total_w = sum(max(0.0, w) for w in weights.values())
        dev_budget = getattr(self, "_peer_budget", self.planner.mem_budget)
        for l, plan in plans.items():
            full = (bps.get(l) or {}).get("F", 0.0)
            if full <= 0:
                continue
            share = (max(0.0, weights.get(l, 0.0)) / total_w) if total_w \
                else 1.0 / max(1, len(plans))
            grants = plan_peer_shards(self._peer_shard_stats(l),
                                      dev_budget * share, full, consts[l])
            self.peer.dev_caps[l] = grants
            self.peer.row_budgets[l] = dev_budget * share
            plan.sizes["P"] = int(sum(grants))
            plan.cap_bytes["P"] = float(sum(grants)) * full

    def _apply_peer_plan(self, layer: int):
        """Push the layer's planned per-device slot grants into its peer
        slab.  Physical rows never move — grants only gate admissions
        (``has_free``), and the cache resize above already demoted any
        over-plan P residents, whose slots the next reconcile frees."""
        caps = self.peer.dev_caps.get(layer)
        if caps is None:
            return
        slab = self.peer.slabs.get(layer)
        if slab is None:
            if sum(caps) > 0:
                # unbuilt (or memoized at capacity 0): drop the memo so the
                # next _peer_slab() call lazily builds under the new plan
                self.peer.slabs.pop(layer, None)
            return
        slab.set_dev_caps(caps)

    def _planner_probe(self) -> Tuple[Optional[float], int]:
        """(hit rate, accesses) over the steps since the last probe — the
        drift signal, windowed on the planner's own clock so it works at
        any ``cache_window`` setting (hit rate None before any accesses;
        the access count lets ``should_replan`` ignore near-empty windows).
        The probe also refreshes each layer's recent-activity rate (EMA of
        accesses per probe interval), which is what the budget split
        weighs — a layer traffic has abandoned decays toward a zero share
        within a couple of probe windows."""
        acc_l = {l: sum(c.hits.values()) + c.misses
                 for l, c in self.caches.items()}
        if self._probe_acc_base:
            for l, a in acc_l.items():
                d = max(0, a - self._probe_acc_base.get(l, 0))
                r = self._layer_rates.get(l)
                self._layer_rates[l] = d if r is None else 0.3 * r + 0.7 * d
        self._probe_acc_base = acc_l
        cur = self._cache_counters()
        base = self._plan_probe_base
        self._plan_probe_base = cur
        if base is None:
            return None, 0
        hits = sum(cur["hits"].values()) - sum(base["hits"].values())
        misses = cur["misses"] - base["misses"]
        acc = hits + misses
        return (hits / acc if acc > 0 else None), acc

    def plan_summary(self) -> Dict[str, object]:
        """Live §3.4 planning telemetry: per-layer plans (sizes +
        cap_bytes + budget share), the replan event log, and resident
        bytes vs the global budget — the byte-denominated complement to
        :meth:`cache_summary`."""
        occ = collections.Counter()
        for cache in self.caches.values():
            occ.update(cache.bytes_occupancy())
        out: Dict[str, object] = {
            "enabled": self.planner is not None,
            "bytes_occupancy": dict(occ),
            "bytes_resident": float(sum(occ.values())),
        }
        if self.planner is not None:
            out.update(self.planner.summary())
            out["replan_every"] = self.replan_every
            out["plan_steps"] = self._plan_steps
        return out

    # ---- windowed telemetry (warm-up vs steady state) --------------------
    def _cache_counters(self) -> Dict[str, object]:
        """Cumulative hit/miss/eviction counters summed across layers."""
        hits = collections.Counter()
        misses = evictions = 0
        for cache in self.caches.values():
            hits.update(cache.hits)
            misses += cache.misses
            evictions += cache.evictions
        return {"hits": hits, "misses": misses, "evictions": evictions}

    def enable_cache_windows(self, every: int):
        """Record a hit/miss/eviction delta snapshot every `every` calls to
        :meth:`note_step` — benchmarks read the series via
        ``cache_summary(windows=True)`` to separate warm-up from steady
        state.  ``every=0`` disables."""
        self._window_every = max(0, int(every))
        self._window_steps = 0
        self._windows = []
        self._window_base = self._cache_counters() if self._window_every \
            else None

    def note_step(self):
        """Advance the windowed-telemetry and live-planner step clocks (one
        decode step).  The serving layer calls this once per
        ``decode_step``; a replayed trace calls it once per trace step.
        Every ``replan_every`` steps the planner probes the recent hit rate
        and — on drift (or when no plan exists yet) — re-plans and applies
        the new pool plan right here, i.e. atomically *between* steps on
        the decode thread."""
        if self.planner is not None and self.replan_every:
            self._plan_steps += 1
            if self._plan_steps % self.replan_every == 0:
                hr, acc = self._planner_probe()
                reason = self.planner.should_replan(hr, accesses=acc)
                if reason:
                    self.replan(reason=reason, hit_rate=hr)
        if not self._window_every:
            return
        self._window_steps += 1
        if self._window_steps % self._window_every == 0:
            cur = self._cache_counters()
            base = self._window_base
            hits = {k: v - base["hits"].get(k, 0)
                    for k, v in cur["hits"].items()
                    if v - base["hits"].get(k, 0)}
            n_hits = sum(hits.values())
            misses = cur["misses"] - base["misses"]
            acc = n_hits + misses
            self._windows.append({
                "step_end": self._window_steps,
                "steps": self._window_every,
                "hits": hits,
                "misses": misses,
                "hit_rate": n_hits / acc if acc else 0.0,
                "evictions": cur["evictions"] - base["evictions"],
            })
            self._window_base = cur

    def cache_summary(self, per_layer: bool = False,
                      windows: bool = False) -> Dict[str, object]:
        """Aggregate §3.4 cache telemetry across layers (same schema as the
        per-layer summaries, via cache.pool_summary).  ``per_layer=True``
        appends each layer's own summary; ``windows=True`` appends the
        per-N-steps delta series recorded by :meth:`note_step` (see
        :meth:`enable_cache_windows`) so consumers can split warm-up from
        steady state instead of reading cumulative totals only."""
        hits = collections.Counter()
        transitions = collections.Counter()
        occupancy = collections.Counter()
        capacity = collections.Counter()
        occ_bytes = collections.Counter()
        cap_bytes = collections.Counter()
        misses = evictions = pinned = 0
        layers = {}
        mode = self.cache_mode
        for l, cache in self.caches.items():
            mode = cache.mode
            hits.update(cache.hits)
            transitions.update(cache.transitions)
            occupancy.update(cache.occupancy())
            capacity.update(cache.cap)
            occ_bytes.update(cache.bytes_occupancy())
            cap_bytes.update(cache.bytes_capacity())
            misses += cache.misses
            evictions += cache.evictions
            pinned += len(cache.pinned)
            if per_layer:
                layers[l] = cache.summary()
        out = pool_summary(mode, hits, misses, occupancy, capacity,
                           transitions, evictions, pinned, occ_bytes,
                           cap_bytes)
        if per_layer:
            out["layers"] = layers
        if windows:
            out["window_steps"] = self._window_every
            out["windows"] = [dict(w) for w in self._windows]
        return out

    def transfer_summary(self) -> Dict[str, float]:
        """Host↔device weight-traffic telemetry: bytes uploaded for plane
        recovery / host-array GEMM staging (``h2d_bytes``), bytes downloaded
        for F→S demotions (``d2h_bytes``), device-splice wall time, and slab
        occupancy.  A fully cache-hit decode step must add zero to
        ``h2d_bytes`` in device_cache mode — the regression test's
        acceptance criterion."""
        slabs = [s for s in self._slabs.values() if s is not None]
        with self._cv:   # counters are written by the io/dec workers
            return {
                "device_cache": self.device_cache,
                "h2d_bytes": self.h2d_bytes,
                "d2h_bytes": self.d2h_bytes + sum(s.d2h_bytes for s in slabs),
                # fused splice-admits land inside the slabs; standalone
                # splices on the engine — one merged ledger for both
                "splice_ms": (self.splice_s
                              + sum(s.splice_s for s in slabs)) * 1e3,
                "splice_ops": (self.splice_ops
                               + sum(s.splice_writes for s in slabs)),
                "w_copy_bytes": self.w_copy_bytes,
                "slab_writes": sum(s.writes for s in slabs),
                "slab_resident": sum(len(s.slot_of) for s in slabs),
                "slab_bytes": sum(s.nbytes() for s in slabs),
            }

    # ------------------------------------------------------------------
    def fetch_experts(self, layer: int, expert_ids: Sequence[int],
                      p_times: Optional[Dict[int, float]] = None
                      ) -> Tuple[Dict[int, Dict[str, np.ndarray]], FetchStats]:
        """Blocking fetch: reconstruct all tensors of the given experts."""
        return self.prefetch_experts(layer, expert_ids, p_times).result()

    def prefetch_experts(self, layer: int, expert_ids: Sequence[int],
                         p_times: Optional[Dict[int, float]] = None, *,
                         speculative: bool = False) -> FetchHandle:
        """Single-class fetch: all ids demand, or (``speculative=True``) all
        ids predicted.  Thin wrapper over :meth:`submit_step`."""
        if speculative:
            return self.submit_step(layer, [], expert_ids, p_times)
        return self.submit_step(layer, expert_ids, [], p_times)

    # class fallbacks when no profiled p-times are supplied: demand experts
    # sort ahead of predictions inside build_blocks via the expert-execution
    # -time priority p (Algorithm 1 orders non-increasing p)
    _DEMAND_P = 1e-4
    _SPEC_P = 1e-6

    def submit_step(self, layer: int, selected: Sequence[int],
                    predicted: Sequence[int],
                    p_times: Optional[Dict[int, float]] = None) -> FetchHandle:
        """Enqueue one decode step's reconstruction work (§3.3 + §3.4).

        ``selected`` is the router's top-k union for `layer` (demand: the
        caller's ``result()`` blocks on exactly these), ``predicted`` the
        forecast for the layer's *next* step (speculative: reconstructed
        behind the demand work under the same Algorithm-1 block schedule and
        collected later via ``spec_result()``).  ``p_times`` maps expert id
        to its measured execution time (see core/profiles.GemmProfiler);
        without it the class constants apply.  Single-layer wrapper over
        :meth:`submit_steps`."""
        return self.submit_steps([(layer, selected, predicted, p_times)])

    def submit_steps(self, parts: Sequence[Tuple[int, Sequence[int],
                                                 Sequence[int],
                                                 Optional[Dict[int, float]]]]
                     ) -> FetchHandle:
        """Enqueue one *cross-layer* schedule: a single Algorithm-1 block
        list covering layer i's step (selected + predicted) plus later
        layers' predictions, drained by the I/O thread and workers in one
        priority order so the pipeline sequences work across layers too.

        ``parts`` is an ordered list of ``(layer, selected, predicted,
        p_times)`` — layers distinct, demand (``selected``) only allowed in
        the first part (``result()`` waits exactly one layer's demand set;
        ``result_subset(ids, layer=j)`` waits one layer's named experts).

        Priorities: within each class, profiled p-times order experts by
        true execution cost (Algorithm 1 sorts non-increasing p).  Classes
        are then *tiered* — demand strictly ahead of the primary layer's
        predictions, which sort strictly ahead of the next layer's, and so
        on — by rescaling each tier below the minimum of the previous one
        (relative order within a tier is preserved).  A profiled
        speculative p can therefore never outrank demand work, and a far
        layer's prediction can never starve a near layer's.

        Selected ids are recorded in the frequency tracker / hit stats and
        pinned against eviction until their admission; predicted ids are NOT
        recorded (mispredictions must not feed the workload model) — the
        serving layer records true accesses via :meth:`note_access`.
        """
        norm: List[Tuple[int, List[int], List[int]]] = []
        p_in: List[Optional[Dict[int, float]]] = []
        for pi, (layer, selected, predicted, *rest) in enumerate(parts):
            sel = sorted({int(e) for e in selected})
            assert pi == 0 or not sel, \
                "demand experts only allowed in the first part"
            pred, seen = [], set(sel)
            for e in predicted:
                e = int(e)
                if e not in seen:
                    seen.add(e)
                    pred.append(e)
            if sel or pred:
                norm.append((int(layer), sel, pred))
                p_in.append(rest[0] if rest else None)
        assert norm, "empty submission"
        layers_seen = [l for l, _, _ in norm]
        assert len(set(layers_seen)) == len(layers_seen), \
            f"duplicate layers in one submission: {layers_seen}"
        job = _FetchJob(next(self._seq), norm)
        demand = job.demand_keys
        for pi, (layer, sel, pred) in enumerate(norm):
            if sel:
                cache = self.caches[layer]
                cache.record_access(sel)
                cache.pin(sel)   # pin-release: _collect (unpinned at drain)
        job.payloads = {(l, e): self._payload(l, e) or ExpertPayload()
                        for l, e in job.expert_keys}
        if self.peer is not None:
            # P-tier interception: peer-slab residents are priced and (when
            # the link wins) fetched synchronously right here, seeding their
            # tensors below exactly like F hits
            self._serve_peer_residents(job)

        # ---- per-key execution-time priorities (tiered classes) ----------
        key_p: Dict[Tuple[int, int], float] = {}
        tiers: List[Dict[Tuple[int, int], float]] = []
        d_tier = {}
        for pi, (layer, sel, pred) in enumerate(norm):
            pt = p_in[pi] or {}
            for e in sel:
                d_tier[(layer, e)] = float(pt.get(e, self._DEMAND_P))
        tiers.append(d_tier)
        for pi, (layer, sel, pred) in enumerate(norm):
            pt = p_in[pi] or {}
            tiers.append({(layer, e): float(pt.get(e, self._SPEC_P))
                          for e in pred})
        floor = None
        for tier in tiers:
            if not tier:
                continue
            hi = max(tier.values())
            if floor is not None and hi >= floor:
                scale = 0.5 * floor / max(hi, 1e-30)
                tier = {k: v * scale for k, v in tier.items()}
            floor = min(tier.values())
            key_p.update(tier)

        # ---- build the task set (one task per tensor) --------------------
        # Effective per-tensor state is derived from what the payload actually
        # holds (robust to demotions, which keep residency but drop bytes).
        def tensor_state(pl: ExpertPayload, tidx: int, k: int) -> CState:
            if tidx in pl.full:
                return CState.F
            has_sm = tidx in pl.sm and pl.sm[tidx] is not None
            has_e = all((tidx, kk) in pl.e and pl.e[(tidx, kk)] is not None
                        for kk in range(k))
            if has_sm and has_e:
                return CState.C
            if has_sm:
                return CState.S
            if has_e:
                return CState.E
            return CState.M

        uid = 0
        for (l, e) in job.expert_keys:
            g = self.store.groups[(l, e)]
            base_p = key_p[(l, e)]
            # per-layer profiled I/O + decompression costs (global fallback):
            # shard sizes differ per layer, so the block build prices each
            # layer's chunks at ITS measured u/c/ρ
            u_l, c_l, rho_l = self._layer_costs(l)
            for tidx, tm in enumerate(g.tensors):
                st_t = tensor_state(job.payloads[(l, e)], tidx,
                                    len(tm.e_sizes))
                job.tasks.append(Task(
                    expert=e, tensor=tidx, state=st_t, p=base_p,
                    sm_cost=u_l, e_cost=rho_l * u_l / len(tm.e_sizes),
                    dec_cost=c_l, k_shards=len(tm.e_sizes), uid=uid,
                    layer=l))
                job.metas[uid] = (l, e, tidx)
                uid += 1
        job.n_total = len(job.tasks)
        job.demand_total = sum(1 for t in job.tasks
                               if t.expert_key in demand)
        job.blocks = build_blocks(job.tasks, self.L)
        job.task_by_uid = {t.uid: t for t in job.tasks}
        for i, t in enumerate(t for b in job.blocks for t in b):
            job.prio[t.uid] = i
        # per-task decompression urgency: a mixed step job's prediction tail
        # must not outrank a newer job's demand work on the worker heap
        job.urg = {t.uid: 0 if t.expert_key in demand else 1
                   for t in job.tasks}
        # the I/O thread may yield to other urgent jobs only once it is past
        # the last block that still carries demand I/O
        for bi, blk in enumerate(job.blocks):
            if any(t.expert_key in demand and (t.needs_e_io or t.needs_sm_io)
                   for t in blk):
                job.last_demand_io_blk = bi

        # ---- seed cached components; publish the job to the pool ---------
        seeded: List[Tuple[int, int, int, int, int]] = []
        for t in job.tasks:
            l, e, tidx = job.metas[t.uid]
            pl = job.payloads[(l, e)]
            if t.state is CState.F:
                job.done_tensors[(l, e, tidx)] = pl.full[tidx]
                job.n_done += 1
                if (l, e) in demand:
                    job.demand_done += 1
                continue
            job.dec_needed[t.uid] = t.k_shards
            if not t.needs_sm_io:
                job.sm_data[t.uid] = pl.sm[tidx]
            if not t.needs_e_io:
                for k in range(t.k_shards):
                    job.e_data[(t.uid, k)] = pl.e[(tidx, k)]
                    seeded.append((job.urg[t.uid], job.seq, job.prio[t.uid],
                                   t.uid, k))

        if job.demand_done == job.demand_total:  # demand fully F-cached
            job.t_demand_ready = time.perf_counter()
            job.demand_ev.set()
        if job.n_done == job.n_total:            # pure F-pool hit: no work
            job.t_ready = time.perf_counter()
            job.done_ev.set()
            return FetchHandle(self, job)

        with self._cv:
            self._jobs[job.seq] = job
            for item in seeded:
                heapq.heappush(self._dec_ready, item)
            (self._io_spec if job.speculative else self._io_urgent).append(job)
            self._cv.notify_all()
        return FetchHandle(self, job)

    # ---- persistent I/O thread -------------------------------------------
    def _io_loop(self, gen: int = 0):
        while True:
            with self._cv:
                while not (self._io_urgent or self._io_spec) \
                        and not self._stop \
                        and self._worker_gen["io"] == gen:
                    self._cv.wait()
                if self._worker_gen["io"] != gen:
                    return             # replaced by the watchdog: stand down
                if not (self._io_urgent or self._io_spec) and self._stop:
                    return
                job = (self._io_urgent.popleft() if self._io_urgent
                       else self._io_spec.popleft())
                self._io_busy = True
                self._heartbeat["io"] = time.monotonic()
            self._io_run_tracked(job)
            with self._cv:
                self._io_busy = False
                self._heartbeat["io"] = time.monotonic()
                self._cv.notify_all()

    def _io_run_tracked(self, job: _FetchJob):
        """Run one job on the I/O thread with failure routing: the job is
        registered in ``_io_inflight`` for the watchdog's requeue, an
        ``Exception`` fails the job's remaining experts (structured
        FetchError — never a silently dead thread), and ``WorkerKilled``
        (BaseException) escapes so the thread really dies."""
        with self._cv:
            self._io_inflight.append(job)
        try:
            self._io_run_job(job)
        except Exception as exc:  # worker-exc-routed
            self._fail_job_remainder(job, exc)
        # not reached on WorkerKilled: the job stays registered and the
        # watchdog requeues it when it replaces the dead thread
        with self._cv:
            if job in self._io_inflight:
                self._io_inflight.remove(job)

    def _io_run_job(self, job: _FetchJob):
        for bi, blk in enumerate(job.blocks):
            # yield to urgent demand fetches at block boundaries — always for
            # speculative jobs, and for mixed step jobs once their own demand
            # I/O has been fully issued (only the prediction tail remains)
            while job.speculative or bi > job.last_demand_io_blk:
                with self._cv:
                    urgent = (self._io_urgent.popleft()
                              if self._io_urgent else None)
                if urgent is None:
                    break
                self._io_run_tracked(urgent)
            for t in blk:
                if t.needs_e_io:
                    self._io_read_e(job, t)
            for t in blk:
                if t.needs_sm_io:
                    self._io_read_sm(job, t)

    def _io_read_e(self, job: _FetchJob, t: Task):
        l, e, tidx = job.metas[t.uid]
        with self._cv:
            if (l, e) in job.failed or t.uid in job.claimed:
                return
            self._heartbeat["io"] = time.monotonic()
        try:
            if self.faults is not None:
                self.faults.worker("io")
            for k in range(t.k_shards):
                with self._cv:
                    if (t.uid, k) in job.e_data:   # watchdog-requeue dedup
                        continue
                data = self.store.read_e((l, e), tidx, k)
                with self._cv:
                    job.stats.io_bytes += len(data)
                    job.e_data[(t.uid, k)] = data
                    heapq.heappush(
                        self._dec_ready,
                        (job.urg[t.uid], job.seq, job.prio[t.uid],
                         t.uid, k))
                    self._cv.notify_all()
        except Exception as exc:  # worker-exc-routed
            self._io_fallback(job, t, exc)

    def _io_read_sm(self, job: _FetchJob, t: Task):
        l, e, tidx = job.metas[t.uid]
        with self._cv:
            if (l, e) in job.failed or t.uid in job.claimed:
                return
            have = t.uid in job.sm_data        # watchdog-requeue dedup
            self._heartbeat["io"] = time.monotonic()
        try:
            if not have:
                if self.faults is not None:
                    self.faults.worker("io")
                data = self.store.read_sm((l, e), tidx)
                with self._cv:
                    job.stats.io_bytes += len(data)
                    job.sm_data[t.uid] = data
            with self._cv:
                ready = self._claim_if_ready(job, t)
            if ready:                  # decompression already finished
                self._finish_tensor(job, t)
        except Exception as exc:  # worker-exc-routed
            self._io_fallback(job, t, exc)

    def _io_fallback(self, job: _FetchJob, t: Task, exc: Exception):
        """The exact-range chunk path failed one tensor (integrity retries
        exhausted, chunk quarantined): fall back to a full verified
        re-read via the store's bypass path; if that fails too, fail the
        expert — never serve unverified bytes, never hang."""
        l, e, tidx = job.metas[t.uid]
        try:
            arr = self.store.load_tensor((l, e), tidx)
        except Exception as exc2:
            self._fail_expert(job, (l, e),
                              f"{exc!r}; fallback re-read: {exc2!r}")
            return
        with self._cv:
            self.fallback_loads += 1
        self._finish_tensor_direct(job, t, arr)

    # ---- persistent decompression workers --------------------------------
    def _drained_locked(self) -> bool:  # holds-lock: _cv
        """With the lock held: stopping AND no work can still appear —
        workers may only exit then, or an in-flight fetch would strand."""
        return (self._stop and not self._dec_ready and not self._io_urgent
                and not self._io_spec and not self._io_busy)

    def _dec_loop(self, widx: int = 0, gen: int = 0):
        slot = f"dec{widx}"
        while True:
            with self._cv:
                while not self._dec_ready and not self._drained_locked() \
                        and self._worker_gen[slot] == gen:
                    self._cv.wait()
                if self._worker_gen[slot] != gen:
                    return             # replaced by the watchdog: stand down
                if not self._dec_ready:
                    return
                item = heapq.heappop(self._dec_ready)
                _, seq, _, uid, k = item
                job = self._jobs.get(seq)
                if job is None or (uid, k) in job.dec_done \
                        or uid in job.claimed or uid in job.failed_uids:
                    continue           # finished/failed elsewhere (requeue)
                self._dec_inflight[slot] = item
                self._heartbeat[slot] = time.monotonic()
                data = job.e_data[(uid, k)]
                l, e, tidx = job.metas[uid]
                buf = job.exp_buf.get(uid)
                if buf is None:
                    tm = self.store.groups[(l, e)].tensors[tidx]
                    buf = job.exp_buf[uid] = np.empty(tm.n_elems, np.uint8)
            t = job.task_by_uid[uid]
            try:
                if self.faults is not None:
                    self.faults.worker(slot)
                # shards land at disjoint shard_bounds offsets of one
                # preallocated plane — concurrent workers never overlap, and
                # _finish_tensor consumes the plane without a concatenate
                try:
                    self.store.decompress_e_into((l, e), tidx, k, data, buf)
                    ok = True
                except Exception as dec_exc:
                    ok = self._dec_recover(job, t, k, buf, dec_exc)
                if ok:
                    with self._cv:
                        job.dec_done.add((uid, k))
                        job.dec_needed[uid] -= 1
                        job.stats.dec_ops += 1
                        ready = self._claim_if_ready(job, t)
                        self._cv.notify_all()
                    if ready:
                        self._finish_tensor(job, t)
            except Exception as exc:  # worker-exc-routed
                self._fail_expert(job, (l, e), repr(exc))
            with self._cv:
                self._dec_inflight.pop(slot, None)

    def _dec_recover(self, job: _FetchJob, t: Task, k: int, buf, exc):
        """A shard failed to decompress (corrupt payload): re-read its
        E-chunk (verified) and retry once; then fall back to a full
        tensor re-read; then fail the expert.  Returns True when the
        shard landed in ``buf`` and normal bookkeeping should proceed."""
        l, e, tidx = job.metas[t.uid]
        try:
            data = self.store.read_e((l, e), tidx, k)
            with self._cv:
                job.stats.io_bytes += len(data)
                job.e_data[(t.uid, k)] = data
            self.store.decompress_e_into((l, e), tidx, k, data, buf)
            return True
        except Exception:
            pass
        self._io_fallback(job, t, exc)
        return False

    # ---- failure routing + watchdog --------------------------------------
    def _fail_expert(self, job: _FetchJob, key: Tuple[int, int], reason: str):
        """Mark every unfinished tensor of ``key`` failed: unfinished uids
        count as done so the job's events fire (waiters wake instead of
        hanging) and ``_collect`` raises/drops the expert per class."""
        l, e = key
        with self._cv:
            marked = False
            for t in job.tasks:
                if t.expert_key != key:
                    continue
                u = t.uid
                if job.metas[u] in job.done_tensors or u in job.failed_uids:
                    continue
                if u in job.claimed:
                    continue           # mid-recovery: let that one finish
                job.failed_uids.add(u)
                job.claimed.add(u)     # nothing should pick it up anymore
                marked = True
                job.n_done += 1
                if key in job.demand_keys:
                    job.demand_done += 1
            if marked and key not in job.failed:
                job.failed[key] = reason
                self.failed_experts += 1
            if job.demand_done == job.demand_total \
                    and not job.demand_ev.is_set():
                job.t_demand_ready = time.perf_counter()
                job.demand_ev.set()
            if job.n_done == job.n_total and not job.done_ev.is_set():
                job.t_ready = time.perf_counter()
                self._jobs.pop(job.seq, None)
                job.done_ev.set()
            self._cv.notify_all()

    def _fail_job_remainder(self, job: _FetchJob, exc: Exception):
        """Route an unexpected worker-loop exception into the job's
        FetchError state: every expert with unfinished tensors fails."""
        for key in dict.fromkeys(t.expert_key for t in job.tasks):
            self._fail_expert(job, key, repr(exc))

    def _watchdog_loop(self):
        """Detect dead (or, with ``worker_stall_s``, stuck) workers,
        respawn them, and requeue their in-flight work.  Requeues are
        idempotent: landed reads (``e_data``/``sm_data``), decompressed
        shards (``dec_done``) and finished tensors are all skipped."""
        while True:
            try:
                with self._cv:
                    if self._stop:
                        return
                    self._cv.wait(self.watchdog_interval_s)
                    if self._stop:
                        return
                    self._check_workers_locked()
            except Exception:
                # the watchdog is the recovery mechanism of last resort: a
                # bug in a check must not silently kill it (workers would
                # then die unreplaced) — skip the tick and keep watching
                continue

    def _check_workers_locked(self):  # holds-lock: _cv
        now = time.monotonic()
        stall = self.worker_stall_s

        def stuck(slot: str, busy: bool) -> bool:
            return (stall is not None and busy
                    and now - self._heartbeat.get(slot, now) > stall)

        if not self._io_thread.is_alive() or stuck("io", self._io_busy):
            self.worker_restarts += 1
            self._worker_gen["io"] += 1
            for job in reversed(self._io_inflight):
                self._requeue_io_locked(job)
            self._io_inflight.clear()
            self._io_busy = False
            self._io_thread = self._spawn_worker("io")
            self._cv.notify_all()
        for i in range(self.L):
            slot = f"dec{i}"
            if self._dec_threads[i].is_alive() \
                    and not stuck(slot, slot in self._dec_inflight):
                continue
            self.worker_restarts += 1
            self._worker_gen[slot] += 1
            item = self._dec_inflight.pop(slot, None)
            if item is not None:
                _, seq, _, uid, k = item
                job = self._jobs.get(seq)
                if job is not None and (uid, k) not in job.dec_done \
                        and uid not in job.failed_uids:
                    if uid in job.claimed \
                            and job.metas[uid] not in job.done_tensors:
                        job.claimed.discard(uid)
                    heapq.heappush(self._dec_ready, item)
            self._dec_threads[i] = self._spawn_worker(slot)
            self._cv.notify_all()

    def _requeue_io_locked(self, job: _FetchJob):  # holds-lock: _cv
        """Put a dead I/O thread's in-flight job back at the front of its
        queue.  Claims whose tensors never finished are released so the
        respawned thread (or a dec worker) can redo them; duplicate
        finishes are deduped in ``_mark_tensor_done``."""
        if job.done_ev.is_set():
            return
        for t in job.tasks:
            u = t.uid
            if u in job.claimed and job.metas[u] not in job.done_tensors \
                    and u not in job.failed_uids:
                job.claimed.discard(u)
        if job in self._io_urgent or job in self._io_spec:
            return
        (self._io_spec if job.speculative else
         self._io_urgent).appendleft(job)

    # ---- recovery + completion -------------------------------------------
    def _claim_if_ready(self, job: _FetchJob, t: Task) -> bool:  # holds-lock: _cv
        """With the pool lock held: claim `t` for recovery iff all of its
        inputs are in and nobody else claimed it."""
        u = t.uid
        if job.dec_needed.get(u, 1) != 0 or u not in job.sm_data:
            return False
        if u in job.claimed:
            return False
        job.claimed.add(u)
        return True

    def _finish_tensor(self, job: _FetchJob, t: Task):
        """Bit-splice recovery, off the pool lock (claimed by one thread)."""
        u = t.uid
        l, e, tidx = job.metas[u]
        with self._cv:
            exp = job.exp_buf.pop(u, None)  # fully assembled (dec_needed 0)
        if exp is None:
            return        # duplicate claim after a watchdog requeue: done
        tm = self.store.groups[(l, e)].tensors[tidx]
        arr = self.recover(exp, job.sm_data[u], tm.shape)
        self._mark_tensor_done(job, t, arr)

    def _finish_tensor_direct(self, job: _FetchJob, t: Task, arr):
        """Record a tensor recovered OUTSIDE the chunk pipeline (the full
        verified fallback re-read): claim it so no worker redoes it."""
        with self._cv:
            job.exp_buf.pop(t.uid, None)
            job.claimed.add(t.uid)
        self._mark_tensor_done(job, t, arr)

    def _mark_tensor_done(self, job: _FetchJob, t: Task, arr):
        u = t.uid
        l, e, tidx = job.metas[u]
        with self._cv:
            if (l, e, tidx) in job.done_tensors or u in job.failed_uids:
                return     # duplicate finish (watchdog requeue) / failed
            job.done_tensors[(l, e, tidx)] = arr
            job.n_done += 1
            if (l, e) in job.demand_keys:
                job.demand_done += 1
                if job.demand_done == job.demand_total:
                    job.t_demand_ready = time.perf_counter()
                    job.demand_ev.set()
            if job.n_done == job.n_total:
                job.t_ready = time.perf_counter()
                self._jobs.pop(job.seq, None)
                job.done_ev.set()
            self._cv.notify_all()      # wake result_subset() waiters

    # ---- result assembly + cache update (caller's thread) ----------------
    def _collect(self, job: _FetchJob, subset: Sequence[Tuple[int, int]],
                 strict: bool = True
                 ) -> Tuple[Dict[Tuple[int, int], Dict[str, np.ndarray]],
                            FetchStats]:
        """Assemble `subset`'s tensors ((layer, expert) keys) and admit each
        to its layer's cache.

        Called on the caller's thread (the only thread that mutates cache
        pools).  Demand experts are unpinned once the whole subset has been
        admitted — not one by one — so intra-step admission overflow can
        never evict a selected expert that was admitted a moment earlier.

        Failed experts are excluded from assembly/admission but still
        unpinned (no pin leaks).  With ``strict`` (the result()/
        result_subset() paths) a failed *demand* key raises
        :class:`FetchError` after all cache bookkeeping; without it
        (spec_result / background drains) failures are dropped and
        counted once per key in ``spec_drops``.
        """
        want = set(subset)
        requested = set(subset)        # incl. failed keys (unpin below)
        with self._cv:
            failed = {k: job.failed[k] for k in want if k in job.failed}
        want -= set(failed)
        missing = [job.metas[t.uid] for t in job.tasks
                   if t.expert_key in want and
                   job.metas[t.uid] not in job.done_tensors]
        assert not missing, f"unreconstructed tensors: {missing}"
        subset = sorted(want)
        out: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}
        for (l, e) in subset:
            g = self.store.groups[(l, e)]
            w = {}
            for tidx, tm in enumerate(g.tensors):
                v = job.done_tensors[(l, e, tidx)]
                if isinstance(v, SlotRef) and not v.valid:
                    # the job seeded this tensor as an F no-op, but the
                    # expert was evicted (slot freed, maybe reused) while
                    # the job was pending — e.g. a cross-layer drain
                    # admitting into a later layer's cache before that
                    # layer's step pins exist.  The device bytes are gone:
                    # re-load from the store (rare; the write-back below
                    # also re-warms the cache on this expert's admission)
                    v = self._refetch_tensor(l, e, tidx)
                    job.done_tensors[(l, e, tidx)] = v
                w[tm.name] = v
            out[(l, e)] = w
        for (l, e) in subset:
            cache = self.caches[l]
            if (l, e) in job.collected and \
                    cache.residency(e) is not CState.M:
                continue               # still resident: nothing to re-admit
            job.collected.add((l, e))
            # build the comprehensive payload (everything this fetch holds)
            # and let admission trim it to the dispatched pool via the
            # _demote_payload fit — payload travels WITH the admit, so a
            # cascade triggered by a later admit can never orphan it
            g = self.store.groups[(l, e)]
            pl = ExpertPayload()
            pl.full = {tidx: job.done_tensors[(l, e, tidx)]
                       for tidx in range(len(g.tensors))}
            if self.cache_mode != "flat":
                for t in job.tasks:
                    if t.expert_key != (l, e):
                        continue
                    tidx = job.metas[t.uid][2]
                    smb = job.sm_data.get(t.uid,
                                          job.payloads[(l, e)].sm.get(tidx))
                    if smb is not None:
                        pl.sm[tidx] = smb
                    for k in range(t.k_shards):
                        eb = job.e_data.get(
                            (t.uid, k),
                            job.payloads[(l, e)].e.get((tidx, k)))
                        if eb is not None:
                            pl.e[(tidx, k)] = eb
            elif self.device_cache and not self._full_payload_usable(pl):
                # a speculative tail seeded from F-residency whose slot was
                # since freed: the bytes are gone, never admit the stale
                # refs as if they still named this expert's weights (the
                # hierarchical path handles this inside the demote hook)
                continue
            cache.admit(e, pl)
        # peer reconcile runs FIRST: an F->P demotion's payload may carry
        # device-slab SlotRefs, which must be read into the peer row before
        # the slab reconcile frees the leaver's slot (staling the refs)
        if self.peer is not None:
            for l in {l for l, _ in subset}:
                self._reconcile_peer(l)
        if self.device_cache:
            for l in {l for l, _ in subset}:
                self._reconcile_slab(l)
            # fused-miss fix-up: DevicePlanes handed out above resolve to
            # real tensors now that the reconcile ran — to the payload's
            # fresh SlotRef when the fused admit landed the planes in a
            # slab slot (the common case: splice and slab write were ONE
            # launch), else to a standalone splice
            for (l, e) in subset:
                w = out[(l, e)]
                if not any(isinstance(v, DevicePlanes) for v in w.values()):
                    continue
                g = self.store.groups[(l, e)]
                pl = self._payload(l, e)
                for tidx, tm in enumerate(g.tensors):
                    if not isinstance(w[tm.name], DevicePlanes):
                        continue
                    v = None
                    if pl is not None and pl.full:
                        cand = pl.full.get(tidx)
                        if isinstance(cand, SlotRef):
                            if cand.valid:
                                v = cand
                        elif not isinstance(cand, (DevicePlanes, PeerRef,
                                                   type(None))):
                            v = cand   # already materialised (overflow arm)
                    if v is None:
                        v = self._splice_planes(w[tm.name])
                        if pl is not None and \
                                isinstance(pl.full.get(tidx), DevicePlanes):
                            pl.full[tidx] = v
                    w[tm.name] = v
                    with self._cv:
                        job.done_tensors[(l, e, tidx)] = v
        # release this job's own demand pins exactly once per expert (pins
        # are refcounted: a step's independent pin on the same expert, taken
        # via pin_experts, survives this release) — failed keys included,
        # or a failed demand expert would leak its pin forever
        by_layer: Dict[int, List[int]] = collections.defaultdict(list)
        for (l, e) in sorted(requested):
            if (l, e) in job.demand_keys and (l, e) not in job.unpinned:
                job.unpinned.add((l, e))
                by_layer[l].append(e)
        for l, es in by_layer.items():
            self.caches[l].unpin(es)
        demand_phase = bool(job.demand_keys) and \
            requested <= job.demand_keys
        primary_cache = self.caches[job.layer]
        with self._cv:
            now = time.perf_counter()
            t_demand = job.t_demand_ready or now
            t_all = job.t_ready or now
            # cumulative wall up to this phase's completion point; each
            # collect reports only the increment past what was already
            # surfaced (so e.g. spec_result() of a job whose prediction tail
            # was empty reports 0, not the demand wall again)
            cum = (t_demand if demand_phase else t_all) - job.t_submit
            wall = max(0.0, cum - job.wall_reported)
            job.wall_reported = max(job.wall_reported, cum)
            io_new = job.stats.io_bytes - job.io_reported
            job.io_reported = job.stats.io_bytes
            dec_new = job.stats.dec_ops - job.dec_reported
            job.dec_reported = job.stats.dec_ops
            stats = FetchStats(wall=wall, io_bytes=io_new, dec_ops=dec_new,
                               hits={k: v
                                     for k, v in primary_cache.hits.items()})
        if failed:
            demand_failed = {k: v for k, v in failed.items()
                             if k in job.demand_keys}
            if strict and demand_failed:
                raise FetchError(demand_failed)
            with self._cv:             # dropped: count each key once
                for k in failed:
                    if k not in job.spec_drop_counted:
                        job.spec_drop_counted.add(k)
                        self.spec_drops += 1
        return out, stats
