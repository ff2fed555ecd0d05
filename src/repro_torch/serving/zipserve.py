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
* **Padded grouped FFN** (``ffn_impl="grouped"``) — the step's tokens are
  gathered into an [E_active, C, d] batch (C the largest group, bucketed)
  and pushed through ``kernels/ops.grouped_expert_gemm``; the active
  experts' weights are stacked first (a slab gather on a cache-hit device
  step, charged to ``w_copy_bytes``).  Bit-identical to the ragged path:
  every GEMM row is one f32 sum in k order and the combine is the same
  gather-sum.  ``ffn_impl="loop"`` is the per-token, per-slot oracle in
  plain ``torch.matmul``.
* **Fused recovery** (``fused_recovery=True``) — the engine hands back the
  raw bit-planes (:class:`BitPlanes`) and ONE ``zip_gemm_batch`` launch per
  projection splices them to bf16 in registers inside the GEMM, so no bf16
  weight is written to device memory; ``ffn_impl="loop"`` runs the same
  kernel once per expert (``fused_zip_gemm``), bit-equal to the batch.
* **Measured p-times** (``profile_p_times=True``) — Algorithm 1 sorts by
  per-expert grouped-GEMM times measured on the card on first use of each
  (layer, expert-count, token-column) bucket and refined from the real FFN
  wall time, instead of class constants.
* **Byte-budgeted live pool planning** (``mem_budget=...``) — instead of
  fixed per-layer expert counts, one global byte budget is split across
  MoE layers by observed activity and each layer's F/C/S/E partition is
  solved by the §3.4 planner (``core/planner``) on its live rank
  statistics, real per-expert residency costs, and per-layer profiled
  u/c.  Every ``replan_every`` steps a windowed hit-rate probe detects
  drift and re-plans; plans apply between steps (graceful pool shrink,
  churn-free grow, device slabs re-sized from the planned F-pool *bytes*,
  their residents moved slot to slot on the card — a cold layer's slab is
  freed entirely).  ``plan_summary()`` reports per-layer plans, replan
  events, and byte occupancy.

* **Continuous batching** (``decode_rows``) — every batch row is a request
  at its own position (KV views from ``serving/kv_cache.KVPagePool``); each
  MoE layer submits ONE Algorithm-1 block list over the union of all rows'
  demand and predicted experts, and per-request hits are attributed by
  pure residency queries (``request_summary()``).

Model families: GQA and MLA attention (``cfg.attn``); an encoder-decoder
(switch-large-128, whisper-small) adds its learned position to the step's
input and runs each decoder layer's cross-attention over the cache's
``xkv`` (the resident prefill's encoder K/V) between the mixer and the
FFN, its encoder and cross-attention weights resident (the JAX package's
``ZipServer`` skips that step and returns caches without ``xkv``); an MLA
config decodes through ``mla_decode`` / ``mla_decode_rows`` (absorbed)
over the latent KV cache, and a dense layer (deepseek-v2's first, jamba's even
layers) stays resident while the store still holds it as group
``(layer, 0)``, as the JAX package serves it.  A Mamba2 layer (the ssm and
hybrid families) decodes with ``mamba_decode`` over its sequence-free
``ssm`` cache, one recurrence step per row whatever the row's position;
mamba2's FFN-less layers keep their projections resident while the store
holds them as group ``(layer, 0)``.  ``decode_rows`` refuses an
encoder-decoder, and the server a config fed input embeddings (qwen2-vl-2b):
``models.model.refusal`` says why.

* **Peer-HBM tier** (``mesh_devices > 1``) — the expert store's shards
  get slab rows on ``peer_devices`` (default ``cuda:0`` .. ``cuda:N-1``;
  ``["cuda:0"] * N`` stands N rows on one card, ``["cpu"] * N`` runs on
  the CPU); the stack becomes F ≺ P ≺ C ≺ S ≺ E, and a hit on a P resident
  is copied from its owner's row to ``peer_devices[0]`` (the compute
  device) when the profiled link beats local reconstruction.
  ``peer_budget`` is each row's byte budget under ``mem_budget`` planning;
  ``peer_summary()`` reports served / fallback counts, the ledger's
  ``collective-permute`` bytes and the link model.  The peer rows hold
  spliced tensors, so ``fused_recovery`` is refused.

``ZipServer.decode_step`` is validated against the fully-resident
``models.decode_step`` and against the JAX package's ``ZipServer``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bitfield
from repro_torch.core.engine import FetchHandle, ZipMoEEngine
from repro_torch.core.faults import FetchError, FetchTimeout, StepFault
from repro_torch.core.profiles import GemmProfiler
from repro_torch.core.slab import SlotRef
from repro_torch.core.store import EXPERT_TENSORS, ExpertStore
from repro_torch.device import resolve_device, resolve_peer_devices
from repro_torch.kernels.moe_gemm import BLOCK_C
from repro_torch.kernels.ops import (bucket_rows, fused_zip_gemm,
                                     grouped_expert_gemm, recover_bf16_host,
                                     slab_gemm, zip_gemm_batch)
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models.layers import apply_mlp, apply_norm, silu
from repro_torch.models.model import (apply_cross, check_supported,
                                      decode_inputs, init_cache,
                                      lm_head_weight, refusal)
from repro_torch.models.moe import route


@dataclass
class BitPlanes:
    """A tensor kept as its ZipMoE bit-planes (fused-recovery mode)."""
    exp: np.ndarray          # u8, flat
    sm: np.ndarray           # u8, flat
    shape: Tuple[int, ...]


def _planes_recover(exp: np.ndarray, sm, shape) -> BitPlanes:
    """Engine recover hook that skips the splice: the fused GEMM does it."""
    sm_arr = (np.frombuffer(sm, np.uint8)
              if isinstance(sm, (bytes, bytearray)) else np.asarray(sm))
    return BitPlanes(np.asarray(exp), sm_arr, tuple(shape))


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


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
                 device_recovery: bool = False,
                 prefetch: bool = True, prefetch_width: Optional[int] = None,
                 ffn_impl: str = "ragged", fused_recovery: bool = False,
                 cache_mode: str = "hier", flat_capacity: Optional[int] = None,
                 flat_policy: str = "lru", delta: int = 1,
                 profile_p_times: bool = False, cross_layer_depth=0,
                 freq_decay: float = 1.0, cache_window: int = 0,
                 device_cache: bool = False,
                 mem_budget: Optional[float] = None,
                 replan_every: int = 32, plan_step: float = 0.125,
                 budget_split: str = "proportional", mesh_devices: int = 1,
                 peer_budget: Optional[float] = None,
                 verify: Optional[bool] = None, faults=None,
                 fetch_deadline_s: Optional[float] = 120.0, device=None,
                 peer_devices=None):
        """``device_recovery`` (the JAX package's ``use_pallas_recovery``)
        splices host-mode recoveries with the splice kernel on `device`
        instead of numpy: the grouped/ragged FFNs then take the spliced
        tensor on the device, the ``"loop"`` oracle downloads it.
        ``mesh_devices > 1`` adds the peer-HBM tier over ``peer_devices``
        (see the module docstring), whose first entry must be `device`."""
        check_supported(cfg, "zipserver")
        self._rows_refusal = refusal(cfg, "rows")
        assert ffn_impl in ("ragged", "grouped", "loop"), ffn_impl
        assert mesh_devices >= 1
        assert not (mesh_devices > 1 and fused_recovery), \
            "fused_recovery payloads are host bit-planes; the peer tier " \
            "slabs hold spliced device tensors — pick one"
        # "auto": start synchronous and let the observed hidden-fetch
        # fraction tune the depth online (see _tune_depth)
        self._auto_depth = cross_layer_depth == "auto"
        if self._auto_depth:
            cross_layer_depth = 0
        assert cross_layer_depth >= 0
        assert not (device_cache and fused_recovery), \
            "fused_recovery keeps weights as host bit-planes; device_cache " \
            "keeps them spliced on device — pick one"
        self.device = resolve_device(device)
        peer_devs = None
        if mesh_devices > 1:
            # the compressed store's shards get slab rows on the mesh's
            # devices ('ep' axis); the compute device is device 0
            peer_devs = resolve_peer_devices(mesh_devices, peer_devices)
        self.cfg = cfg
        self.prefetch = prefetch
        self.prefetch_width = prefetch_width
        self.ffn_impl = ffn_impl
        self.fused_recovery = fused_recovery
        self.device_cache = device_cache
        self.profile_p_times = profile_p_times
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
        recover = None
        if fused_recovery:
            recover = _planes_recover
        elif device_recovery and not device_cache and ffn_impl == "loop":
            dev = self.device
            recover = (lambda e, sm, shape:      # host-loop oracle: numpy
                       recover_bf16_host(e, sm, shape, dev))
        self.engine = ZipMoEEngine(
            store, n_experts=max(1, cfg.n_experts), n_layers=cfg.n_layers,
            L=L, pool_sizes=pool_sizes, recover_fn=recover,
            cache_mode=cache_mode, flat_capacity=flat_capacity,
            flat_policy=flat_policy, delta=delta, freq_decay=freq_decay,
            device_cache=device_cache, device=self.device,
            peer_devices=peer_devs, fetch_deadline_s=fetch_deadline_s)
        if device_recovery and not device_cache and ffn_impl != "loop":
            # the grouped/ragged GEMM consumes the spliced tensor on the
            # device — keep it there, through the engine's counting hook so
            # the plane uploads and splice time land in h2d_bytes/splice_ms
            self.engine.recover = self.engine._recover_device
        self.engine.profile()
        if mem_budget is not None:
            # byte-budgeted live pool planning (§3.4 online): per-layer
            # plans from one global byte budget, re-planned under drift.
            # An explicit pool_sizes override keeps the static capacities
            # until the first drift-triggered re-plan.
            self.engine.configure_planner(mem_budget,
                                          replan_every=replan_every,
                                          plan_step=plan_step,
                                          initial_plan=pool_sizes is None,
                                          budget_split=budget_split,
                                          peer_budget=peer_budget)
        if cache_window:
            self.engine.enable_cache_windows(cache_window)
        # measured per-expert grouped-GEMM times feeding Algorithm 1's p_n
        # (constant-p scheduling when profile_p_times is off: p_times=None
        # falls back to the engine's class constants)
        self.profiler = GemmProfiler(default_p=ZipMoEEngine._DEMAND_P)
        self._gemm_runners: Dict[int, object] = {}   # layer -> runner|None
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
        # per-request cache accounting of decode_rows (request_summary)
        self.req_stats: Dict[int, Dict[str, int]] = {}
        self._closed = False

    def close(self):
        """Stop the engine's workers and release the server's device
        memory now, not when the cycle collector runs: the expert slabs
        are retired (every SlotRef into them turns stale) and the
        references from the engine's caches and recover hook back to the
        engine are dropped, so the engine, its pools and their device
        tensors go with the last outside reference to the server.
        Telemetry (``overlap_summary``, ``cache_summary``, ...) stays
        readable; a closed server serves no more steps."""
        if self._closed:
            return
        self._closed = True
        self.engine.shutdown()
        self.engine.release()
        self._pending.clear()
        self._gemm_runners.clear()

    def _check_open(self):
        if self._closed:
            raise RuntimeError("ZipServer is closed")

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

    # ------------------------------------------------------------------
    # profiled p-times (GemmProfiler -> Algorithm 1's p_n)
    # ------------------------------------------------------------------
    def _sync(self):
        """Wait for the device's queued work (timed FFN runs)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _gemm_runner(self, layer_idx: int):
        """Measurement closure for the profiler: runs one representative
        grouped FFN of this layer's expert shapes on the device, from
        seeded random inputs (an untimed warm-up run first, then one timed
        run ended by a device synchronise)."""
        groups = self.engine.store.groups
        experts = [e for (l, e) in groups if l == layer_idx]
        if not experts:
            return None
        shapes = {t.name: tuple(t.shape)
                  for t in groups[(layer_idx, min(experts))].tensors}
        if "w_up" not in shapes or "w_down" not in shapes:
            return None
        dev = self.device

        def run(ne: int, cols: int) -> float:
            g = torch.Generator(device=dev).manual_seed(0)
            d, f = shapes["w_up"]
            # the kernel takes whole 8-row tiles: fewer columns run one
            rows = -(-cols // BLOCK_C) * BLOCK_C

            def rnd(*shape):
                return torch.randn(shape, generator=g, device=dev).to(
                    torch.bfloat16)

            x, wu, wd = rnd(ne, rows, d), rnd(ne, d, f), rnd(ne, f, d)
            wg = rnd(ne, d, f) if "w_gate" in shapes else None

            def once():
                h = silu(grouped_expert_gemm(x, wg)) * \
                    grouped_expert_gemm(x, wu) if wg is not None \
                    else _gelu(grouped_expert_gemm(x, wu))
                return grouped_expert_gemm(h, wd)

            once()
            self._sync()
            t0 = time.perf_counter()
            once()
            self._sync()
            return time.perf_counter() - t0

        return run

    def _exec_group_size(self, layer_idx: int, batch: int) -> int:
        """Expected number of experts that execute *together* in one of this
        layer's decode steps — the profiler's bucket key: the step's last
        observed selection size, falling back to the batch top-k bound."""
        last = self._last_ids.get(layer_idx)
        if last:
            return len(last)
        return max(1, min(self.cfg.n_experts, batch * self.cfg.top_k))

    def _p_times_for(self, layer_idx: int, ids: List[int], batch: int
                     ) -> Optional[Dict[int, float]]:
        """Measured per-expert p_n for one submission part, or None for the
        engine's class constants (constant-p scheduling).  The runner is
        built once per layer and only handed over when the bucket is not
        yet cached — this sits on the decode hot path."""
        if not self.profile_p_times or not ids:
            return None
        cols = max(1, batch * self.cfg.top_k)
        group = self._exec_group_size(layer_idx, batch)
        runner = None
        if not self.profiler.has(layer_idx, group, cols):
            if layer_idx not in self._gemm_runners:
                self._gemm_runners[layer_idx] = self._gemm_runner(layer_idx)
            runner = self._gemm_runners[layer_idx]
        p = self.profiler.p_time(layer_idx, group, cols, runner=runner)
        return {int(e): p for e in ids}

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
            parts.append((layer_idx, demand_ids, pred,
                          self._p_times_for(layer_idx,
                                            list(demand_ids) + pred, batch)))
        extra: List[Tuple[int, List[int]]] = []
        if self.prefetch and self.cross_layer_depth:
            for j in self._moe_layers_after(layer_idx,
                                            self.cross_layer_depth):
                pred_j = self._predict(j, batch, self._in_flight(j))
                if pred_j:
                    parts.append((j, [], pred_j,
                                  self._p_times_for(j, pred_j, batch)))
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
        h_m = (self.engine.prefetch_experts(
                   layer_idx, missing,
                   self._p_times_for(layer_idx, missing, batch))
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
                h_r = self.engine.prefetch_experts(
                    layer_idx, lost, self._p_times_for(layer_idx, lost,
                                                       batch))
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
        """Measured p-time buckets feeding Algorithm 1 (empty when
        ``profile_p_times`` is off)."""
        return self.profiler.summary()

    def plan_summary(self) -> Dict[str, object]:
        """Live §3.4 planning telemetry (``mem_budget`` mode): per-layer
        plans, replan events, and byte occupancy — next to
        :meth:`cache_summary` / :meth:`overlap_summary`."""
        return self.engine.plan_summary()

    def peer_summary(self) -> Dict[str, object]:
        """Peer-HBM (P tier) telemetry: link-served vs fallback counts,
        collective-traffic ledger, profiled link model, and per-layer slab
        occupancy.  ``{"enabled": False}`` without a mesh."""
        return self.engine.peer_summary()

    # ------------------------------------------------------------------
    # expert FFN implementations
    # ------------------------------------------------------------------
    def _ffn_loop(self, x, top_p: np.ndarray, top_i: np.ndarray, weights):
        """Per-token, per-slot loop (validation oracle): plain
        ``torch.matmul`` on bf16 with a bf16 running sum, as the JAX
        package's loop computes it outside any kernel."""
        cfg = self.cfg
        B = x.shape[0]
        ti = top_i.reshape(B, cfg.top_k)
        tp = top_p.reshape(B, cfg.top_k)
        ys = []
        for b in range(B):   # loop-ok: validation oracle path
            xb = x[b:b + 1]
            acc = torch.zeros_like(xb)
            for slot in range(cfg.top_k):
                w = {k: self._as_weight(v)
                     for k, v in weights[int(ti[b, slot])].items()}
                h = silu(xb @ w["w_gate"]) * (xb @ w["w_up"]) \
                    if "w_gate" in w else _gelu(xb @ w["w_up"])
                gate = torch.tensor(float(tp[b, slot]), dtype=x.dtype,
                                    device=x.device)
                acc = acc + gate * (h @ w["w_down"])
            ys.append(acc)
        return torch.cat(ys)

    def _assign_by_expert(self, top_p: np.ndarray, top_i: np.ndarray, ids):
        """Per-expert (token row, gate) lists in ``ids`` order — the shared
        front half of both gather builders."""
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

    def _gather_by_expert(self, top_p, top_i, ids):
        """Token->expert tables for the PADDED grouped batch.

        Returns (gather [Ea, C] int64 token rows, padded with the zero token
        B; gates [Ea, C] f32 routing weights, 0 on pads; rows_of [B, k]
        int64: each token's k positions in the flattened [Ea·C] layout,
        ascending).  C is the largest group bucketed to a fixed rung
        (``bucket_rows``, at least 8), so the set of GEMM shapes stays small
        and the kernel's 8-row tiles divide it."""
        assign, B = self._assign_by_expert(top_p, top_i, ids)
        C = bucket_rows(max(len(a) for a in assign))
        gather = np.full((len(ids), C), B, np.int64)   # B = zero-pad token
        gates = np.zeros((len(ids), C), np.float32)
        rows_of: List[List[int]] = [[] for _ in range(B)]
        for r, a in enumerate(assign):
            for c, (b, g) in enumerate(a):
                gather[r, c] = b
                gates[r, c] = g
                rows_of[b].append(r * C + c)
        self.overlap_stats["tokens_real"] += sum(len(a) for a in assign)
        self.overlap_stats["tokens_padded"] += len(ids) * C
        return gather, gates, np.asarray(rows_of, np.int64)

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

    @staticmethod
    def _gathered_tokens(x, gather: np.ndarray) -> torch.Tensor:
        """x [B, 1, d] -> x rows at `gather` (B = the zero pad token),
        shaped ``gather.shape + (d,)``."""
        B, _, d = x.shape
        xf = x.reshape(B, d)
        xpad = torch.cat([xf, xf.new_zeros(1, d)])
        idx = torch.from_numpy(gather.reshape(-1)).to(x.device)
        return xpad.index_select(0, idx).reshape(*gather.shape, d)

    @staticmethod
    def _combine(x, eout: torch.Tensor, gates: np.ndarray,
                 rows_of: np.ndarray) -> torch.Tensor:
        """Gate-weighted sum of each token's k expert outputs.  eout: [N, d]
        GEMM rows; gates: [N] f32; rows_of: [B, k] ascending positions into
        them.  Token b adds its k contributions in ascending position,
        starting from the first — the per-destination order of the JAX
        package's scatter-add on the CPU, and deterministic on the card (no
        atomics).  Every FFN path but the loop oracle combines here, so
        they agree bit for bit when their GEMM rows do."""
        B, _, d = x.shape
        dev = x.device
        contrib = torch.from_numpy(gates).to(dev)[:, None] * eout.float()
        idx = torch.from_numpy(rows_of).to(dev)                   # [B, k]
        comb = contrib.index_select(0, idx[:, 0])
        for j in range(1, idx.shape[1]):  # loop-ok: top-k slots, not experts
            comb = comb + contrib.index_select(0, idx[:, j])
        return comb.to(x.dtype).reshape(B, 1, d)

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

    def _stack(self, vals) -> torch.Tensor:  # hot-path
        """[Ea, ...] stack of expert tensors on the device, charged to
        ``w_copy_bytes`` (host bf16 bits also pay the upload, ``h2d_bytes``)."""
        # host-sync-ok: fallback — host/mixed steps stage a weight copy
        w = torch.stack([self._as_weight(v) for v in vals])
        self.engine.count_w_copy(w.numel() * w.element_size())
        return w

    @staticmethod
    def _one_slab(vals):
        """The slab every value is a valid SlotRef into, else None.  A
        stale ref falls through to ``_as_weight``, whose ``read()``
        asserts: it is never read as the slot's new occupant."""
        if vals and all(isinstance(v, SlotRef) for v in vals):
            slab = vals[0].slab
            if all(v.slab is slab and v.valid for v in vals):
                return slab
        return None

    def _stack_weights(self, name: str, weights, ids) -> torch.Tensor:  # hot-path
        """[Ea, d, f] stacked expert weights for the grouped GEMM.  With
        every selected expert in the SAME layer slab, one device gather
        copies them out of it — zero weight bytes cross host→device, but
        the copy is charged to ``w_copy_bytes`` (the staging the ragged
        path avoids)."""
        vals = [weights[e][name] for e in ids]
        slab = self._one_slab(vals)
        if slab is None:
            return self._stack(vals)
        w = slab.gather(name, [v.slot for v in vals])  # gen-checked: _one_slab
        self.engine.count_w_copy(w.numel() * w.element_size())
        return w

    def _slab_sources(self, name: str, weights, ids):  # hot-path
        """(buffer, slots) weight source for the slot-indexed ragged GEMM.

        Zero-copy fast path: every selected expert's tensor is a valid
        SlotRef into the SAME layer slab — return the slab's buffer itself
        (read in place by the kernel) plus the per-expert slot vector; no
        weight bytes move, nothing is charged.  Otherwise fall back to a
        stacked [Ea, ...] batch (charged to ``w_copy_bytes``) indexed by
        stack row."""
        vals = [weights[e][name] for e in ids]
        slab = self._one_slab(vals)
        if slab is not None:
            return (slab.bufs[name],
                    # host-sync-ok: host slot-index vector, no transfer
                    np.asarray([v.slot for v in vals], np.int32))
        return self._stack(vals), np.arange(len(ids), dtype=np.int32)

    def _note_gemm_shape(self, *key):
        """Count DISTINCT expert-GEMM shape keys (see ``bucket_rows``)."""
        if key not in self._gemm_shapes:
            self._gemm_shapes.add(key)
            self.overlap_stats["gemm_compiles"] += 1

    @staticmethod
    def _expert_mlp(gemm, a, weights, ids, src):
        """The expert MLP through one GEMM callable per projection:
        ``gemm(a, src(name))``."""
        if "w_gate" in weights[ids[0]]:
            h = silu(gemm(a, src("w_gate"))) * gemm(a, src("w_up"))
        else:
            h = _gelu(gemm(a, src("w_up")))
        return gemm(h, src("w_down"))

    def _ffn_grouped(self, x, top_p, top_i, weights, ids):  # hot-path
        """Gather-by-expert padded batch [Ea, C, d] on the grouped-GEMM
        kernel.  Bit-identical to ``_ffn_ragged``: every GEMM row is one f32
        sum in k order whatever the batching, and the combine is the same
        gather-sum in the same per-token order."""
        gather, gates, rows_of = self._gather_by_expert(top_p, top_i, ids)
        xg = self._gathered_tokens(x, gather)                # [Ea, C, d]
        self._note_gemm_shape("grouped", *gather.shape)
        eout = self._expert_mlp(
            grouped_expert_gemm, xg, weights, ids,
            lambda name: self._stack_weights(name, weights, ids))
        return self._combine(x, eout.reshape(-1, x.shape[-1]),
                             gates.reshape(-1), rows_of)

    def _ffn_ragged(self, x, top_p, top_i, weights, ids):  # hot-path
        """Slot-indexed ragged grouped FFN — the megakernel hot path.

        Tokens ride in CSR order (per-group tile padding only, total tile
        count bucketed); the kernel reads each expert's weights straight
        out of the slab buffer by the per-tile slot vector — zero
        weight-copy bytes on the all-slab-resident fast path
        (``_slab_sources``)."""
        gather, gates, tile_row, rows_of = self._gather_by_expert_ragged(
            top_p, top_i, ids, BLOCK_C)
        xg = self._gathered_tokens(x, gather)                # [T, d]
        self._note_gemm_shape("ragged", gather.size)

        def sg(a, src):                                    # one kernel launch
            buf, slots = src
            return slab_gemm(a, buf, slots[tile_row], block_c=BLOCK_C)

        eout = self._expert_mlp(
            sg, xg, weights, ids,
            lambda name: self._slab_sources(name, weights, ids))
        return self._combine(x, eout, gates, rows_of)

    def _planes_to_device(self, ps: List[BitPlanes]):
        """Upload bit-planes [len(ps), D, F] (u8 exp, u8 sm) and charge
        them to ``h2d_bytes``: 2 B per weight element."""
        D, F = ps[0].shape
        exp = np.stack([p.exp.reshape(D, F) for p in ps])
        sm = np.stack([p.sm.reshape(D, F) for p in ps])
        self.engine.count_h2d(exp.nbytes + sm.nbytes)
        return (torch.from_numpy(exp).to(self.device),
                torch.from_numpy(sm).to(self.device))

    def _ffn_zip_gemm(self, x, top_p, top_i, weights, ids):
        """Fused recovery+GEMM, ONE batched launch per projection: expert
        weights stay u8 bit-planes and ``zip_gemm_batch`` splices them to
        bf16 in registers inside the GEMM, for every active expert of the
        step at once.  Plane uploads are charged to ``h2d_bytes``."""
        gather, gates, rows_of = self._gather_by_expert(top_p, top_i, ids)
        xg = self._gathered_tokens(x.to(torch.bfloat16), gather)
        self._note_gemm_shape("zip", *gather.shape)
        eout = self._expert_mlp(
            lambda a, pl: zip_gemm_batch(a, *pl), xg, weights, ids,
            lambda name: self._planes_to_device(
                [weights[e][name] for e in ids]))
        return self._combine(x, eout.reshape(-1, x.shape[-1]),
                             gates.reshape(-1), rows_of)

    def _ffn_zip_loop(self, x, top_p, top_i, weights, ids):
        """Per-expert fused recovery+GEMM (one ``fused_zip_gemm`` launch per
        expert and projection), bit-equal to :meth:`_ffn_zip_gemm`: the same
        kernel rows and the same combine.  Plane uploads are charged to
        ``h2d_bytes``."""
        gather, gates, rows_of = self._gather_by_expert(top_p, top_i, ids)
        xg = self._gathered_tokens(x.to(torch.bfloat16), gather)

        def zg(a, pl):
            exp, sm = pl
            return fused_zip_gemm(a, exp[0], sm[0])

        outs = []
        for r, e in enumerate(ids):   # loop-ok: the per-expert fused path
            outs.append(self._expert_mlp(
                zg, xg[r], weights, [e],
                lambda name: self._planes_to_device([weights[e][name]])))
        eout = torch.stack(outs)                             # [Ea, C, d]
        return self._combine(x, eout.reshape(-1, x.shape[-1]),
                             gates.reshape(-1), rows_of)

    def _note_request_access(self, layer_idx: int, ti: np.ndarray, owners):
        """Per-request hit attribution under the multi-tenant union: row
        ``b``'s owner is charged one access per routed expert, a hit when
        that expert was resident at step start.  Pure residency queries on
        the router's host copy `ti` [B, k] — the shared record_access
        tallies (one per unique expert per step) are untouched."""
        states = self.engine.residency_states(
            layer_idx, {int(e) for e in ti.reshape(-1)})
        for b, rid in enumerate(owners):
            st = self.req_stats.setdefault(
                rid, {"accesses": 0, "hits": 0, "steps": 0})
            for e in {int(v) for v in ti[b]}:
                st["accesses"] += 1
                st["hits"] += int(states[e].name != "M")

    def _zip_moe_ffn(self, lp, x, layer_idx: int, owners=None):
        """x: [B, 1, d].  Router -> engine fetch -> expert FFN.

        ``owners`` (continuous batching) maps batch rows to request ids:
        the selection UNION across rows feeds one Algorithm-1 submission,
        while per-request accounting runs on pure residency queries."""
        cfg = self.cfg
        ffn = lp["ffn"]
        top_p, top_i, _ = route(ffn["router"], x, cfg)       # [B,1,k]
        # host-sync-ok: the router's choice drives host-side scheduling
        ti = top_i.cpu().numpy()
        tp = top_p.float().cpu().numpy()
        ids = sorted({int(e) for e in ti.reshape(-1)})
        B = x.shape[0]
        self._last_ids[layer_idx] = ids
        if owners is not None:
            self._note_request_access(layer_idx, ti.reshape(B, cfg.top_k),
                                      owners)
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
        t_ffn = time.perf_counter()
        if self.fused_recovery:
            y = (self._ffn_zip_loop if self.ffn_impl == "loop"
                 else self._ffn_zip_gemm)(x, tp, ti, weights, ids)
        elif self.ffn_impl == "loop":
            y = self._ffn_loop(x, tp, ti, weights)
        elif self.ffn_impl == "grouped":
            y = self._ffn_grouped(x, tp, ti, weights, ids)
        else:
            y = self._ffn_ragged(x, tp, ti, weights, ids)
        if self.profile_p_times:
            # refine the measured bucket with the *actual* expert FFN wall
            # time (EMA), at the cost of one device synchronise per MoE
            # layer.  Only already-measured buckets are refined: observed-
            # only buckets the scheduler never reads would pile up.
            cols = max(1, B * cfg.top_k)
            if self.profiler.has(layer_idx, len(ids), cols):
                self._sync()
                self.profiler.record(layer_idx, len(ids), cols,
                                     time.perf_counter() - t_ffn)
        if "shared" in ffn:
            y = y + apply_mlp(ffn["shared"], x, cfg)
        self.stats.append({"layer": layer_idx, "fetch_s": fetch_s,
                           "blocked_s": blocked_s, "io_bytes": io_bytes,
                           "n_experts": len(ids),
                           "routes": ti.reshape(B, cfg.top_k),
                           "owners": None if owners is None else list(owners),
                           "h2d_bytes": self.engine.h2d_bytes - h2d0,
                           "w_copy_bytes": self.engine.w_copy_bytes - wcopy0,
                           "splice_s": self.engine.splice_s - splice0})
        return y

    def decode_step(self, tokens, caches: list, pos: int
                    ) -> Tuple[torch.Tensor, list]:  # hot-path
        """tokens: [B, 1] -> (logits [B,1,V], caches updated in place)."""
        self._check_open()
        cfg = self.cfg
        p = self.globals
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = decode_inputs(p, cfg, tokens, pos)
        # loop-ok: per-LAYER structure (hot-path bans per-EXPERT loops;
        # expert work inside goes through the grouped-GEMM kernels)
        for idx, (lp, cache) in enumerate(zip(self.layers, caches)):
            h = apply_norm(lp["norm1"], x, cfg)
            if "mamba" in lp:
                y, _ = mamba_lib.mamba_decode(lp["mamba"], h, cfg,
                                              cache["ssm"])
            elif cfg.attn == "mla":
                y, _ = attn_lib.mla_decode(lp["attn"], h, cfg, cache["kv"],
                                           pos)
            else:
                y, _ = attn_lib.gqa_decode(lp["attn"], h, cfg, cache["kv"],
                                           pos)
            x = x + y
            if "xattn" in lp:
                x = apply_cross(lp, x, cfg, cache["xkv"])
            if "ffn" in lp:
                h2 = apply_norm(lp["norm2"], x, cfg)
                if "router" in lp["ffn"]:
                    x = x + self._zip_moe_ffn(lp, h2, idx)
                else:
                    x = x + apply_mlp(lp["ffn"], h2, cfg)
        x = apply_norm(p["final_norm"], x, cfg)
        if self._auto_depth:
            self._tune_depth()
        self.engine.note_step()   # cache-window and live-planner step clocks
        return x @ lm_head_weight(p, cfg), caches

    def decode_rows(self, tokens, caches: list, positions, owners=None
                    ) -> Tuple[torch.Tensor, list]:  # hot-path
        """Multi-request decode step (continuous batching): each batch row
        is an independent request at its own sequence position.

        tokens: [B, 1]; caches: per-layer views from ``KVPagePool.gather``
        (the new K/V is written into them in place); positions: int [B]
        on the host (row b's new-token index); owners: optional per-row
        request ids for per-request cache accounting.  Rows share ONE
        forward pass — every MoE layer submits a single Algorithm-1 block
        list over the union of all rows' demand and predicted experts, so
        the cache pools, device slabs and live planner serve the whole
        active set as shared multi-tenant resources.  Returns (logits
        [B, 1, V], caches).  Refuses an encoder-decoder."""
        self._check_open()
        if self._rows_refusal is not None:
            raise NotImplementedError(self._rows_refusal)
        cfg = self.cfg
        p = self.globals
        tokens = torch.as_tensor(tokens, device=self.device).long()
        positions = torch.as_tensor(np.asarray(positions, np.int64),
                                    device=self.device)
        x = p["embed"]["tok"][tokens]
        # loop-ok: per-LAYER structure (hot-path bans per-EXPERT loops;
        # expert work inside goes through the grouped-GEMM kernels)
        for idx, (lp, cache) in enumerate(zip(self.layers, caches)):
            h = apply_norm(lp["norm1"], x, cfg)
            if "mamba" in lp:      # sequence-free: one step per row as is
                y, _ = mamba_lib.mamba_decode(lp["mamba"], h, cfg,
                                              cache["ssm"])
            elif cfg.attn == "mla":
                y, _ = attn_lib.mla_decode_rows(lp["attn"], h, cfg,
                                                cache["kv"], positions)
            else:
                y, _ = attn_lib.gqa_decode_rows(lp["attn"], h, cfg,
                                                cache["kv"], positions)
            x = x + y
            if "ffn" in lp:
                h2 = apply_norm(lp["norm2"], x, cfg)
                if "router" in lp["ffn"]:
                    x = x + self._zip_moe_ffn(lp, h2, idx, owners=owners)
                else:
                    x = x + apply_mlp(lp["ffn"], h2, cfg)
        x = apply_norm(p["final_norm"], x, cfg)
        for rid in owners or ():
            self.req_stats.setdefault(
                rid, {"accesses": 0, "hits": 0, "steps": 0})["steps"] += 1
        if self._auto_depth:
            self._tune_depth()
        self.engine.note_step()   # cache-window and live-planner step clocks
        return x @ lm_head_weight(p, cfg), caches

    def request_summary(self) -> Dict[int, Dict[str, float]]:
        """Per-request cache accounting (continuous batching): expert
        accesses, hits at step start, hit rate, and decode steps served —
        the fairness complement to the shared-pool :meth:`cache_summary`."""
        out = {}
        for rid, st in sorted(self.req_stats.items()):
            acc = st["accesses"]
            out[rid] = {"accesses": acc, "hits": st["hits"],
                        "hit_rate": st["hits"] / acc if acc else 0.0,
                        "steps": st["steps"]}
        return out

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
