"""ZipMoE-integrated serving: decode with engine-fed expert weights.

The end-to-end demonstration of the paper's system: routed expert weights
live ONLY in the compressed on-disk store; at every MoE layer the router's
top-k selection is handed to the ZipMoE engine, which reconstructs exactly
those experts (cache pools + Algorithm-1 scheduling + parallel
decompression + bit-splice recovery) before the FFN runs.

* **Per-step block scheduling** (§3.3 + §3.4 co-design) — every fetch is an
  ``engine.submit_step`` job whose Algorithm-1 block list orders demand
  work ahead of speculative work.  On a layer's cold/sync step the job
  combines the router's selection with the layer's *next-step* prediction
  (previous selection + FreqTracker top-k); in steady state a router
  misprediction triggers an urgent demand-only fetch that jumps the I/O
  queue and overlaps the in-flight predictions' tails.  The decode thread
  blocks ONLY on selected experts, and new predictions exclude every
  in-flight expert, so speculative work is never duplicated.  With
  ``cross_layer_depth=N`` each submission carries the next N MoE layers'
  predictions in the SAME block list.
* **Slot-indexed ragged grouped FFN** (``ffn_impl="ragged"``) — the step's
  tokens are CSR-concatenated by expert (each group padded only to the
  kernel's 8-row tile, the total tile count bucketed to a fixed rung) and
  pushed through ``kernels/ops.slab_gemm``: the CUDA kernel takes the WHOLE
  per-layer slab buffer plus a per-tile slot vector and reads each
  expert's weights in place — no per-step weight materialisation
  (``w_copy_bytes`` == 0 on a cache-hit device step) and no pad-to-max-C
  token FLOPs (``pad_frac`` telemetry).  The expert outputs are combined
  by a gather-sum in CSR order: deterministic on the card (no atomics) and
  the order the JAX package adds in.
* **Device-resident expert slabs** (``device_cache=True``) — the F pool
  lives on the card: a demand miss uploads the two u8 planes once and the
  decode thread's slab reconcile lands the bit-splice directly in a
  ``core/slab.DeviceSlabCache`` slot through ONE kernel launch (fused
  splice-admit), and the ragged FFN reads the slab in place by slot index
  — a fully cache-hit decode step moves **zero** expert-weight bytes
  host→device and stages **zero** weight-copy bytes
  (``overlap_summary()['h2d_bytes']`` / ``['w_copy_bytes']``).

Not ported yet (they raise ``NotImplementedError``): the padded
``"grouped"`` and per-token ``"loop"`` FFNs (their kernel is the grouped
GEMM), ``fused_recovery`` (the fused splice+GEMM kernels),
``profile_p_times`` (its runner needs the grouped GEMM), ``mem_budget``
live planning and the multi-device peer tier (``mesh_devices``), and
continuous batching (``decode_rows``).

``ZipServer.decode_step`` is validated against the fully-resident
``models.decode_step`` and against the JAX package's ``ZipServer``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bitfield
from repro_torch.core.engine import FetchHandle, ZipMoEEngine
from repro_torch.core.faults import FetchError, FetchTimeout, StepFault
from repro_torch.core.profiles import GemmProfiler
from repro_torch.core.slab import SlotRef
from repro_torch.core.store import EXPERT_TENSORS, ExpertStore
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import bucket_rows, slab_gemm
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import apply_mlp, apply_norm, silu
from repro_torch.models.model import init_cache
from repro_torch.models.moe import route

class ZipServer:
    # cross_layer_depth="auto" tuning knobs: adjust once per window of
    # decode steps; deepen while < RAISE_BELOW of fetch time is hidden,
    # shallow out above LOWER_ABOVE (see _tune_depth)
    _DEPTH_WINDOW = 8
    _DEPTH_RAISE_BELOW = 0.90
    _DEPTH_LOWER_ABOVE = 0.98

    def __init__(self, params, cfg, store_path: str, *, L: int = 4,
                 pool_sizes: Optional[Dict[str, int]] = None,
                 bandwidth_gbps: Optional[float] = None,
                 prefetch: bool = True, prefetch_width: Optional[int] = None,
                 ffn_impl: str = "ragged", fused_recovery: bool = False,
                 cache_mode: str = "hier", flat_capacity: Optional[int] = None,
                 flat_policy: str = "lru", delta: int = 1,
                 profile_p_times: bool = False, cross_layer_depth=0,
                 freq_decay: float = 1.0, cache_window: int = 0,
                 device_cache: bool = False,
                 mem_budget: Optional[float] = None, mesh_devices: int = 1,
                 verify: Optional[bool] = None, faults=None,
                 fetch_deadline_s: Optional[float] = 120.0, device=None):
        if ffn_impl != "ragged":
            raise NotImplementedError(
                f"ffn_impl={ffn_impl!r}: only the slot-indexed ragged FFN is "
                f"ported (the grouped GEMM kernel is not)")
        for name, on in (("fused_recovery", fused_recovery),
                         ("profile_p_times", profile_p_times),
                         ("mem_budget", mem_budget is not None),
                         ("mesh_devices", mesh_devices != 1)):
            if on:
                raise NotImplementedError(f"{name} is not ported yet")
        # "auto": start synchronous and let the observed hidden-fetch
        # fraction tune the depth online (see _tune_depth)
        self._auto_depth = cross_layer_depth == "auto"
        if self._auto_depth:
            cross_layer_depth = 0
        assert cross_layer_depth >= 0
        self.device = resolve_device(device)
        self.cfg = cfg
        self.prefetch = prefetch
        self.prefetch_width = prefetch_width
        self.ffn_impl = ffn_impl
        self.device_cache = device_cache
        self.cross_layer_depth = cross_layer_depth
        self._depth_events: List[Dict[str, float]] = []
        self._depth_steps = 0
        self._depth_base: Optional[Dict[str, float]] = None
        # per-layer dict copies: stripping the routed weights below must not
        # touch the caller's params (they may serve as the resident model)
        self.layers = [{k: (dict(v) if k == "ffn" else v)
                        for k, v in lp.items()} for lp in params["layers"]]
        self.globals = {k: v for k, v in params.items() if k != "layers"}
        store = ExpertStore(store_path, bandwidth_gbps=bandwidth_gbps,
                            verify=verify, faults=faults)
        self.engine = ZipMoEEngine(
            store, n_experts=max(1, cfg.n_experts), n_layers=cfg.n_layers,
            L=L, pool_sizes=pool_sizes, cache_mode=cache_mode,
            flat_capacity=flat_capacity, flat_policy=flat_policy,
            delta=delta, freq_decay=freq_decay, device_cache=device_cache,
            device=self.device, fetch_deadline_s=fetch_deadline_s)
        self.engine.profile()
        if cache_window:
            self.engine.enable_cache_windows(cache_window)
        # constant-p scheduling: p-times stay the engine's class constants
        # until the measured-p profiler's runner is ported
        self.profiler = GemmProfiler(default_p=ZipMoEEngine._DEMAND_P)
        # strip routed expert weights from the resident copy (they live on disk)
        for lp in self.layers:
            if "ffn" in lp and "router" in lp["ffn"]:
                for name in EXPERT_TENSORS:
                    lp["ffn"].pop(name, None)
        self._moe_layers = [i for i, lp in enumerate(self.layers)
                            if "ffn" in lp and "router" in lp["ffn"]]
        # per layer: live prediction jobs (handle, predicted-id set).  A step
        # waits only on the covered subset of each; finished jobs are drained
        # (tail admitted to the cache) lazily on the decode thread
        self._pending: Dict[int, List[Tuple[FetchHandle, frozenset]]] = {}
        self._last_ids: Dict[int, List[int]] = {}
        self.stats: List[Dict] = []
        self.overlap_stats = {
            "pred_hits": 0, "pred_misses": 0, "sync_fetches": 0,
            "fetch_wall_s": 0.0,     # background wall time of prefetched jobs
            "fetch_wait_s": 0.0,     # of which the decode thread was blocked
            "blocking_s": 0.0,       # sync / fallback fetch wall time
            "fault_refetches": 0,    # demand re-fetches of failed spec work
            "tokens_real": 0,        # routed (token, expert) pairs per GEMM
            "tokens_padded": 0,      # GEMM rows actually computed (w/ pads)
            "gemm_compiles": 0,      # distinct expert-GEMM shape keys seen
        }
        self._gemm_shapes: set = set()

    def close(self):
        self.engine.shutdown()

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, length: int):
        return init_cache(self.cfg, batch, length, device=self.device)

    # ------------------------------------------------------------------
    # expert acquisition: prefetch consumption + blocking fallback
    # ------------------------------------------------------------------
    def _next_moe_layer(self, layer_idx: int) -> Optional[int]:
        """The MoE layer whose fetch can overlap from `layer_idx` on
        (wrapping to the first MoE layer of the next decode step)."""
        if not self._moe_layers:
            return None
        for j in self._moe_layers:
            if j > layer_idx:
                return j
        return self._moe_layers[0]

    def _predict(self, layer_idx: int, batch: int, exclude) -> List[int]:
        """Predicted experts for `layer_idx`'s next decode step: the layer's
        previous-step selection (temporal locality) topped up with the
        FreqTracker's most-frequent experts."""
        width = self.prefetch_width or min(self.cfg.n_experts,
                                           batch * self.cfg.top_k
                                           + self.cfg.top_k)
        # filter exclusions DURING building so the prediction keeps its full
        # width, topping up from the frequency ranking past excluded ids
        pred = [e for e in self._last_ids.get(layer_idx, ())
                if e not in exclude]
        for e in self.engine.predict_topk(layer_idx, width + len(exclude)):
            if len(pred) >= width:
                break
            if e not in pred and e not in exclude:
                pred.append(e)
        return pred[:width]

    def _in_flight(self, layer_idx: int) -> frozenset:
        """Experts covered by this layer's live prediction jobs."""
        return frozenset().union(*(s for _, s in
                                   self._pending.get(layer_idx, [])))

    def _moe_layers_after(self, layer_idx: int, depth: int) -> List[int]:
        """Up to `depth` distinct MoE layers following `layer_idx` in decode
        order (wrapping to the next step's first MoE layer) — the layers a
        cross-layer submission extends its predictions to."""
        out: List[int] = []
        j = layer_idx
        for _ in range(depth):
            j = self._next_moe_layer(j)
            if j is None or j == layer_idx or j in out:
                break
            out.append(j)
        return out

    def _drain(self, layer_idx: int) -> int:
        """Collect finished prediction jobs of `layer_idx` on the decode
        thread: their unused tails are admitted to the cache pools (warming
        them) and leave the in-flight set.  Returns the drained io_bytes.

        A cross-layer job appears in every covered layer's pending list;
        ``spec_result()`` caches, and the stats are credited only on the
        first drain (the flag guard), so multi-list membership never
        double-counts wall time or bytes."""
        ov = self.overlap_stats
        live, io = [], 0
        for h, s in self._pending.get(layer_idx, []):
            if h.done():
                _, st = h.spec_result()    # background work: fully hidden
                if not getattr(h, "_drained_stats", False):
                    h._drained_stats = True
                    ov["fetch_wall_s"] += st.wall
                    io += st.io_bytes
            else:
                live.append((h, s))
        if layer_idx in self._pending:
            self._pending[layer_idx] = live
        return io

    def _issue_step(self, layer_idx: int, demand_ids: List[int], batch: int):
        """One Algorithm-1 step submission anchored at `layer_idx`: the
        demand ids (this step's selection still missing from every pending
        prediction) plus the layer's next-step prediction, under a single
        block schedule.  With ``cross_layer_depth > 0`` the same submission
        also carries predictions for the next MoE layers in decode order,
        and the job registers in every covered layer's pending list.
        In-flight experts are excluded from every layer's prediction (their
        job already reconstructs them — no duplicate work) but stay covered
        through their own pending entry."""
        pred = (self._predict(layer_idx, batch,
                              set(demand_ids) | self._in_flight(layer_idx))
                if self.prefetch else [])
        parts = []
        if demand_ids or pred:
            parts.append((layer_idx, demand_ids, pred, None))
        extra: List[Tuple[int, List[int]]] = []
        if self.prefetch and self.cross_layer_depth:
            for j in self._moe_layers_after(layer_idx,
                                            self.cross_layer_depth):
                pred_j = self._predict(j, batch, self._in_flight(j))
                if pred_j:
                    parts.append((j, [], pred_j, None))
                    extra.append((j, pred_j))
        if not parts:
            return None
        h = self.engine.submit_steps(parts)
        if self.prefetch:
            # the demand half counts as predicted for the NEXT step too: it
            # is reconstructed by this very job, so a re-selected expert is
            # a prediction hit, never a sticky demand refetch
            if demand_ids or pred:
                self._pending.setdefault(layer_idx, []).append(
                    (h, frozenset(pred) | set(demand_ids)))
            for j, pred_j in extra:
                self._pending.setdefault(j, []).append(
                    (h, frozenset(pred_j)))
        return h

    def _issue_prefetch(self, layer_idx: Optional[int], batch: int):
        """Cold-start speculative submission (no demand half) for a layer
        that has no pending step job yet."""
        if layer_idx is None or not self.prefetch \
                or self._pending.get(layer_idx):
            return
        self._issue_step(layer_idx, [], batch)

    def _acquire_experts(self, layer_idx: int, ids: List[int], batch: int):
        """Expert weights for `ids`, consuming the pending prediction jobs.

        Returns (weights, io_bytes, blocked_s) where blocked_s is the wall
        time the decode thread actually spent waiting on reconstruction —
        only the selected experts are waited on, never a prediction job's
        unused tail.
        """
        ov = self.overlap_stats
        pend = list(self._pending.get(layer_idx, []))
        if not pend:
            # no prediction in flight: everything is demand; the same
            # submission still carries the layer's next-step prediction
            h = self._issue_step(layer_idx, ids, batch)
            weights, fstats = h.result()
            ov["sync_fetches"] += 1
            ov["blocking_s"] += fstats.wall
            return weights, fstats.io_bytes, fstats.wall
        io_bytes = 0
        in_flight = self._in_flight(layer_idx)
        covered = [e for e in ids if e in in_flight]
        missing = [e for e in ids if e not in in_flight]
        # pin the WHOLE selection for the step (pins are refcounted) and
        # record the access BEFORE any of this step's admissions, so
        # hit/miss telemetry reflects residency at step start
        self.engine.pin_experts(layer_idx, ids)
        self.engine.note_access(layer_idx, covered)
        # a misprediction's demand fetch is submitted BEFORE waiting on the
        # prediction jobs: `missing` is disjoint from every in-flight
        # prediction by construction, and the urgent job jumps the I/O
        # queue so it overlaps their tails
        h_m = (self.engine.prefetch_experts(layer_idx, missing)
               if missing else None)
        if h_m is not None and self.prefetch:
            self._pending.setdefault(layer_idx, []).append(
                (h_m, frozenset(missing)))
        t0 = time.perf_counter()     # CPU-side submit cost stays excluded
        weights: Dict[int, Dict] = {}
        try:
            remaining = set(covered)
            for h, s in pend:
                take = [e for e in remaining if e in s]
                if not take:
                    continue
                remaining.difference_update(take)
                # blocks on `take` of THIS layer only — never on the job's
                # other layers' speculative tails
                w, st = h.result_subset(take, layer=layer_idx)
                weights.update(w)
                ov["fetch_wall_s"] += st.wall
                ov["fetch_wait_s"] += h.wait_s
                io_bytes += st.io_bytes
            if h_m is not None:
                ov["pred_misses"] += 1
                extra, fs2 = h_m.result()
                weights.update(extra)
                io_bytes += fs2.io_bytes
                ov["fetch_wall_s"] += fs2.wall
                ov["fetch_wait_s"] += h_m.wait_s
            else:
                ov["pred_hits"] += 1
            # graceful degradation: a selected expert whose SPECULATIVE
            # fetch failed is re-fetched on demand through a fresh job
            lost = [e for e in ids if e not in weights]
            if lost:
                ov["fault_refetches"] += 1
                h_r = self.engine.prefetch_experts(layer_idx, lost)
                w_r, fs_r = h_r.result()
                weights.update(w_r)
                io_bytes += fs_r.io_bytes
                ov["blocking_s"] += fs_r.wall
            blocked = time.perf_counter() - t0
            # drain finished prediction jobs AFTER they served this step's
            # coverage; the step pins are still held through the drain, so
            # its admissions can never evict (and free the slab slot of) a
            # selected expert before the FFN consumes it
            io_bytes += self._drain(layer_idx)
        finally:
            # on the failure path too: an unreleased step pin would leak
            self.engine.unpin_experts(layer_idx, ids)
        self._issue_step(layer_idx, [], batch)
        return weights, io_bytes, blocked

    def overlap_summary(self) -> Dict[str, float]:
        """Fetch time hidden under compute / total fetch wall time, plus
        the host↔device weight-traffic counters (``h2d_bytes`` /
        ``w_copy_bytes`` / ``splice_ops`` — zero h2d and zero weight copy on
        a fully cache-hit device-mode step)."""
        ov = self.overlap_stats
        total = ov["fetch_wall_s"] + ov["blocking_s"]
        hidden = ov["fetch_wall_s"] - ov["fetch_wait_s"]
        padded = ov["tokens_padded"]
        return {**ov, **self.engine.transfer_summary(),
                "total_fetch_s": total, "hidden_fetch_s": hidden,
                "hidden_frac": hidden / total if total > 0 else 0.0,
                # fraction of expert-GEMM token FLOPs spent on padding rows
                "pad_frac": (padded - ov["tokens_real"]) / padded
                            if padded > 0 else 0.0,
                "cross_layer_depth": self.cross_layer_depth,
                "auto_depth": self._auto_depth,
                "depth_events": list(self._depth_events)}

    def fault_summary(self) -> Dict[str, object]:
        """Failure-handling telemetry: engine and store counters plus the
        serving layer's demand re-fetches of failed speculative work."""
        out = self.engine.fault_summary()
        out["fault_refetches"] = self.overlap_stats["fault_refetches"]
        return out

    def _tune_depth(self):
        """Auto-tune ``cross_layer_depth`` from the observed hidden-fetch
        fraction (``cross_layer_depth="auto"``): every window of decode
        steps, deepen the cross-layer horizon while a meaningful share of
        fetch time blocked the decode thread, shallow it out when
        essentially everything was hidden.  Bounds: [0, #MoE layers]."""
        self._depth_steps += 1
        if self._depth_steps % self._DEPTH_WINDOW:
            return
        ov = self.overlap_stats
        cur = {"fetch_wall_s": ov["fetch_wall_s"],
               "fetch_wait_s": ov["fetch_wait_s"],
               "blocking_s": ov["blocking_s"]}
        base = self._depth_base or {k: 0.0 for k in cur}
        self._depth_base = cur
        wall = cur["fetch_wall_s"] - base["fetch_wall_s"]
        wait = cur["fetch_wait_s"] - base["fetch_wait_s"]
        blocked = cur["blocking_s"] - base["blocking_s"]
        total = wall + blocked
        if total <= 0.0:                  # all-hit window: nothing to tune
            return
        hidden_frac = max(0.0, wall - wait) / total
        depth = self.cross_layer_depth
        if hidden_frac < self._DEPTH_RAISE_BELOW:
            depth = min(depth + 1, len(self._moe_layers))
        elif hidden_frac > self._DEPTH_LOWER_ABOVE:
            depth = max(depth - 1, 0)
        if depth != self.cross_layer_depth:
            self._depth_events.append({
                "step": float(self._depth_steps),
                "from": float(self.cross_layer_depth),
                "to": float(depth), "hidden_frac": hidden_frac})
            self.cross_layer_depth = depth

    def cache_summary(self, per_layer: bool = False,
                      windows: bool = False) -> Dict[str, object]:
        """Live §3.4 cache telemetry (per-pool hit rates, residency-state
        transition counts, evictions)."""
        return self.engine.cache_summary(per_layer=per_layer,
                                         windows=windows)

    def p_time_summary(self) -> Dict[str, object]:
        """Measured p-time buckets feeding Algorithm 1 (empty: constant-p
        scheduling in this port so far)."""
        return self.profiler.summary()

    # ------------------------------------------------------------------
    # the slot-indexed ragged FFN
    # ------------------------------------------------------------------
    def _assign_by_expert(self, top_p: np.ndarray, top_i: np.ndarray, ids):
        """Per-expert (token row, gate) lists in ``ids`` order — the CSR
        front half of the gather tables."""
        cfg = self.cfg
        B = top_i.shape[0]
        ti = top_i.reshape(B, cfg.top_k)
        tp = top_p.reshape(B, cfg.top_k)
        row = {e: r for r, e in enumerate(ids)}
        assign: List[List[Tuple[int, float]]] = [[] for _ in ids]
        for b in range(B):
            for slot in range(cfg.top_k):
                assign[row[int(ti[b, slot])]].append((b, float(tp[b, slot])))
        return assign, B

    def _gather_by_expert_ragged(self, top_p, top_i, ids, block_c: int = 8):
        """CSR token->expert tables for the slot-indexed ragged GEMM.

        Token rows are concatenated group by group (``ids`` order); each
        group is padded only to a ``block_c``-row tile boundary (a tile
        must not straddle experts), and the TOTAL tile count is bucketed to
        a fixed rung.  Pad rows aim at the zero token B with gate 0 and
        tiles past the last group at expert row 0 (any valid slot), so they
        contribute nothing.  Returns (gather [T] int64, gates [T] f32,
        tile_row [T/block_c] int32 rows into ``ids``, rows_of [B, k] int64:
        each token's k positions in ascending CSR order).
        """
        assign, B = self._assign_by_expert(top_p, top_i, ids)
        tiles = [-(-max(len(a), 1) // block_c) for a in assign]
        n_tiles = bucket_rows(sum(tiles), align=1)
        T = n_tiles * block_c
        gather = np.full(T, B, np.int64)               # B = zero-pad token
        gates = np.zeros(T, np.float32)
        tile_row = np.zeros(n_tiles, np.int32)
        rows_of: List[List[int]] = [[] for _ in range(B)]
        t = 0
        for r, a in enumerate(assign):
            tile_row[t // block_c: t // block_c + tiles[r]] = r
            for b, g in a:
                gather[t] = b
                gates[t] = g
                rows_of[b].append(t)
                t += 1
            t = -(-t // block_c) * block_c             # next tile boundary
        self.overlap_stats["tokens_real"] += sum(len(a) for a in assign)
        self.overlap_stats["tokens_padded"] += T
        return gather, gates, tile_row, np.asarray(rows_of, np.int64)

    def _as_weight(self, v) -> torch.Tensor:
        """One expert tensor as a device tensor: slab slots read in place,
        device tensors pass through, host bf16 bits pay (and are charged)
        an upload."""
        if isinstance(v, SlotRef):
            return v.read()
        if isinstance(v, np.ndarray):
            self.engine.count_h2d(v.nbytes)
            return bitfield.from_bits(v).to(self.device)
        return v

    def _slab_sources(self, name: str, weights, ids):  # hot-path
        """(buffer, slots) weight source for the slot-indexed ragged GEMM.

        Zero-copy fast path: every selected expert's tensor is a valid
        SlotRef into the SAME layer slab — return the slab's buffer itself
        (read in place by the kernel) plus the per-expert slot vector; no
        weight bytes move, nothing is charged.  Otherwise fall back to a
        stacked [Ea, ...] batch (charged to ``w_copy_bytes``) indexed by
        stack row."""
        vals = [weights[e][name] for e in ids]
        if vals and all(isinstance(v, SlotRef) for v in vals):
            slab = vals[0].slab
            if all(v.slab is slab and v.valid for v in vals):
                return (slab.bufs[name],
                        # host-sync-ok: host slot-index vector, no transfer
                        np.asarray([v.slot for v in vals], np.int32))
        # host-sync-ok: fallback — mixed/host steps stage a weight copy
        w = torch.stack([self._as_weight(v) for v in vals])
        self.engine.count_w_copy(w.numel() * w.element_size())
        return w, np.arange(len(ids), dtype=np.int32)

    def _note_gemm_shape(self, *key):
        """Count DISTINCT expert-GEMM shape keys (see ``bucket_rows``)."""
        if key not in self._gemm_shapes:
            self._gemm_shapes.add(key)
            self.overlap_stats["gemm_compiles"] += 1

    def _ffn_ragged(self, x, top_p, top_i, weights, ids):  # hot-path
        """Slot-indexed ragged grouped FFN — the megakernel hot path.

        Tokens ride in CSR order (per-group tile padding only, total tile
        count bucketed); the kernel reads each expert's weights straight
        out of the slab buffer by the per-tile slot vector — zero
        weight-copy bytes on the all-slab-resident fast path
        (``_slab_sources``).  The combine is a gather-sum: token b adds its
        k contributions in ascending CSR position, starting from the first
        — the per-destination order of the JAX package's scatter-add on the
        CPU, and deterministic on the card (no atomics)."""
        B, _, d = x.shape
        block_c = 8
        gather, gates, tile_row, rows_of = self._gather_by_expert_ragged(
            top_p, top_i, ids, block_c)
        dev = x.device
        xf = x.reshape(B, d)
        xpad = torch.cat([xf, xf.new_zeros(1, d)])
        xg = xpad.index_select(0, torch.from_numpy(gather).to(dev))  # [T, d]
        self._note_gemm_shape("ragged", gather.size)

        def sg(a, src):                                    # one kernel launch
            buf, slots = src
            return slab_gemm(a, buf, slots[tile_row], block_c=block_c)

        if "w_gate" in weights[ids[0]]:
            h = silu(sg(xg, self._slab_sources("w_gate", weights, ids))) * \
                sg(xg, self._slab_sources("w_up", weights, ids))
        else:
            h = torch.nn.functional.gelu(
                sg(xg, self._slab_sources("w_up", weights, ids)),
                approximate="tanh")
        eout = sg(h, self._slab_sources("w_down", weights, ids))   # [T, d]
        contrib = torch.from_numpy(gates).to(dev)[:, None] * eout.float()
        idx = torch.from_numpy(rows_of).to(dev)                   # [B, k]
        comb = contrib.index_select(0, idx[:, 0])
        for j in range(1, idx.shape[1]):  # loop-ok: top-k slots, not experts
            comb = comb + contrib.index_select(0, idx[:, j])
        return comb.to(x.dtype).reshape(B, 1, d)

    def _zip_moe_ffn(self, lp, x, layer_idx: int):
        """x: [B, 1, d].  Router -> engine fetch -> ragged expert FFN."""
        cfg = self.cfg
        ffn = lp["ffn"]
        top_p, top_i, _ = route(ffn["router"], x, cfg)       # [B,1,k]
        # host-sync-ok: the router's choice drives host-side scheduling
        ti = top_i.cpu().numpy()
        tp = top_p.float().cpu().numpy()
        ids = sorted({int(e) for e in ti.reshape(-1)})
        B = x.shape[0]
        self._last_ids[layer_idx] = ids
        # expert-weight transfer attributed to this layer-step (0 on a full
        # cache hit, the whole re-upload on a host-mode hit)
        h2d0 = self.engine.h2d_bytes
        splice0 = self.engine.splice_s
        wcopy0 = self.engine.w_copy_bytes
        if self.prefetch:
            # overlap the next MoE layer's reconstruction with this layer's
            # FFN and the following layers' attention compute
            self._issue_prefetch(self._next_moe_layer(layer_idx), B)
        t0 = time.perf_counter()
        try:
            weights, io_bytes, blocked_s = self._acquire_experts(
                layer_idx, ids, B)
        except (FetchError, FetchTimeout) as exc:
            # map the failed experts through the router's selection to the
            # batch rows that needed them — the server retires ONLY those
            # rows.  A timeout names no experts: the whole step is suspect.
            failed = {e for (l, e) in getattr(exc, "failures", {})
                      if l == layer_idx} or set(ids)
            tib = ti.reshape(B, -1)
            rows = [b for b in range(B)
                    if {int(v) for v in tib[b]} & failed]
            raise StepFault(layer_idx, failed, rows or range(B), exc) \
                from exc
        fetch_s = time.perf_counter() - t0
        y = self._ffn_ragged(x, tp, ti, weights, ids)
        if "shared" in ffn:
            y = y + apply_mlp(ffn["shared"], x, cfg)
        self.stats.append({"layer": layer_idx, "fetch_s": fetch_s,
                           "blocked_s": blocked_s, "io_bytes": io_bytes,
                           "n_experts": len(ids),
                           "routes": ti.reshape(B, cfg.top_k),
                           "h2d_bytes": self.engine.h2d_bytes - h2d0,
                           "w_copy_bytes": self.engine.w_copy_bytes - wcopy0,
                           "splice_s": self.engine.splice_s - splice0})
        return y

    def decode_step(self, tokens, caches: list, pos: int
                    ) -> Tuple[torch.Tensor, list]:  # hot-path
        """tokens: [B, 1] -> (logits [B,1,V], caches updated in place)."""
        cfg = self.cfg
        p = self.globals
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = p["embed"]["tok"][tokens]
        # loop-ok: per-LAYER structure (hot-path bans per-EXPERT loops;
        # expert work inside goes through the ragged-GEMM path)
        for idx, (lp, cache) in enumerate(zip(self.layers, caches)):
            h = apply_norm(lp["norm1"], x, cfg)
            y, _ = attn_lib.gqa_decode(lp["attn"], h, cfg, cache["kv"], pos)
            x = x + y
            if "ffn" in lp:
                h2 = apply_norm(lp["norm2"], x, cfg)
                if "router" in lp["ffn"]:
                    x = x + self._zip_moe_ffn(lp, h2, idx)
                else:
                    x = x + apply_mlp(lp["ffn"], h2, cfg)
        x = apply_norm(p["final_norm"], x, cfg)
        if self._auto_depth:
            self._tune_depth()
        self.engine.note_step()       # windowed cache telemetry step clock
        return x @ p["lm_head"]["w"], caches

    def drain_pending(self) -> int:
        """Finish every in-flight prediction job and credit its stats (end
        of serving), so the cache pools' byte accounting and the overlap
        telemetry are stable with no job left half-collected.  Blocks until
        the jobs complete; returns the drained io_bytes."""
        ov = self.overlap_stats
        io = 0
        for layer in list(self._pending):
            for h, _ in self._pending[layer]:
                try:
                    _, st = h.spec_result()
                except FetchTimeout:
                    # a hung speculative job must not wedge shutdown
                    continue
                if not getattr(h, "_drained_stats", False):
                    h._drained_stats = True
                    ov["fetch_wall_s"] += st.wall
                    io += st.io_bytes
            self._pending[layer] = []
        return io

    # ------------------------------------------------------------------
    def generate(self, prompt_last_token, caches, start_pos: int,
                 max_new_tokens: int = 16):
        """Greedy decode loop from an existing cache state.  Each step's
        token is read back to the host, so ``tpot_s`` times whole steps."""
        tok = torch.as_tensor(prompt_last_token, device=self.device).long()
        out = []
        t_steps = []
        for i in range(max_new_tokens):
            t0 = time.perf_counter()
            logits, caches = self.decode_step(tok, caches, start_pos + i)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out.append(tok.cpu().numpy())
            t_steps.append(time.perf_counter() - t0)
        return np.concatenate(out, axis=1), caches, {
            "tpot_s": float(np.mean(t_steps)), "steps_s": t_steps,
            "overlap": self.overlap_summary()}
