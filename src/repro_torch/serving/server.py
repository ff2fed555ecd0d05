"""Batched request server: continuous batching over the compressed store,
and the epoch (static) batching baseline.

Two serving disciplines:

* **Continuous batching** (the default on the ZipMoE path): requests are
  admitted and retired *between decode steps*.  Every active request is a
  token stream at its own sequence position — prompt tokens are consumed
  one per step ("prefill-as-decode", which keeps every step the same
  single-token shape and lets the engine's prefetch overlap it), then
  sampled tokens until EOS / ``max_new_tokens``.  Per-request KV state
  lives in a shared fixed-size :class:`~repro_torch.serving.kv_cache.KVPagePool`
  (allocated at admission, freed at retirement — no whole-cache copies),
  and each step runs ONE ``ZipServer.decode_rows`` pass whose MoE layers
  submit a single Algorithm-1 block list over the union of all active
  requests' demand and predicted experts: the hierarchical cache, device
  slab and live planner are shared multi-tenant resources.  Retirement
  backfills the freed slot from the queue at the next step boundary, and
  ``arrival_s`` offsets replay an arrival trace.
* **Epoch batching** (``continuous=False``, and the resident-params path):
  bucket same-length prompts, prefill together, decode in lockstep until
  every request of the bucket finishes, then refill — the static-batch
  baseline.

API:
  Request      — one prompt and its accounting (``ttft``, ``tpot_s``,
                 ``queue_delay_s``, ``output``, the host time each output
                 token reached the host, ``token_s``, optional per-token
                 ``logits``).
  BatchServer  — ``submit(prompt, max_new_tokens, arrival_s=..,
                 eos_token=..) -> rid``; ``run()`` serves the queue;
                 ``metrics()`` aggregates TTFT (from the time a request
                 was due: submitted, or its arrival offset if later) /
                 TPOT / inter-token-gap / queue-delay percentiles and
                 throughput plus, on the ZipMoE path, the
                 engine's ``overlap_*`` / ``cache_*`` telemetry;
                 ``request_summary()`` is the per-request report (cache
                 hit rates included); ``cache_summary()`` the nested cache
                 report.

``submit()`` clamps ``max_new_tokens`` against ``max_len - S`` so the KV
allocation never overflows; the page pool's ``commit`` also refuses any
write past a request's allocation.  Sampling is keyed per request: each
request draws from its own ``torch.Generator`` seeded from ``(seed,
rid)``, once per output token, so its trajectory does not depend on what
shares its batch.  Logits, tokens and sampled ids reach the host once per
step, for the whole batch.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import spans
from repro_torch.core.faults import StepFault
from repro_torch.models.model import check_supported
from repro_torch.serving.generate import (make_generator, make_steps,
                                          sample_tokens)
from repro_torch.serving.kv_cache import KVPagePool, grow_cache


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S]
    max_new_tokens: int = 16
    arrival_s: float = 0.0        # offset from run() start (trace replay)
    eos_token: Optional[int] = None
    record_logits: bool = False   # keep each output token's logits (f32)
    submitted: float = field(default_factory=time.perf_counter)
    due: Optional[float] = None   # max(submitted, run start + arrival_s)
    admitted: Optional[float] = None
    ttft: Optional[float] = None  # first token - due (- submitted: epoch)
    done: Optional[float] = None
    output: List[int] = field(default_factory=list)
    token_s: List[float] = field(default_factory=list)  # per output token
    logits: List[np.ndarray] = field(default_factory=list)
    queue_delay_s: Optional[float] = None   # admission - eligibility
    error: Optional[str] = None   # set when retired by a StepFault

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token after the first token."""
        if not self.token_s or self.done is None or len(self.output) < 2:
            return None
        return (self.done - self.token_s[0]) / (len(self.output) - 1)


@dataclass
class _Slot:
    """One active request's decode-loop state (continuous batching)."""
    req: Request
    gen: Optional[torch.Generator]   # per-request sampler (None: greedy)
    pos: int = 0                  # next token index to write
    next_tok: int = 0             # step input: prompt token or last sample


def _pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def request_seed(seed: int, rid: int) -> int:
    """The sampling seed of request `rid` under server seed `seed`."""
    return int(np.random.SeedSequence([seed, rid]).generate_state(1)[0])


class BatchServer:
    """Continuous batching (ZipMoE path) / epoch batching (resident path,
    or ``continuous=False`` as the static-batch baseline)."""

    def __init__(self, params, cfg, *, max_batch: int = 8, max_len: int = 256,
                 temperature: float = 0.0, zip_server=None,
                 max_concurrency: Optional[int] = None,
                 continuous: bool = True, page_size: int = 16,
                 n_pages: Optional[int] = None, seed: int = 0):
        check_supported(cfg, "rows")
        self.params, self.cfg = params, cfg
        self.max_batch, self.max_len = max_batch, max_len
        self.max_concurrency = max_concurrency or max_batch
        self.temperature = temperature
        self.zip = zip_server
        self.continuous = continuous and zip_server is not None
        self.page_size = page_size
        self.n_pages = n_pages
        self.seed = seed
        if zip_server is None:
            self.pf, self.dec = make_steps(cfg)
        self.queue: "collections.deque[Request]" = collections.deque()
        self.finished: List[Request] = []
        self._rid = 0
        # called right after a request retires (its pages freed, stats
        # final): tests assert cache invariants here, between steps
        self.on_retire: Optional[Callable[[Request], None]] = None

    @property
    def device(self) -> torch.device:
        return (self.zip.device if self.zip is not None
                else self.params["embed"]["tok"].device)

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16, *,
               arrival_s: float = 0.0, eos_token: Optional[int] = None,
               record_logits: bool = False) -> int:
        """Enqueue a request.  Prompts that leave no room for even one new
        token under ``max_len`` are rejected; oversized ``max_new_tokens``
        are clamped so S + new never overflows the KV allocation.
        ``arrival_s`` delays admission to that offset from ``run()`` start
        (arrival-trace replay; 0 = immediately eligible)."""
        prompt = np.asarray(prompt, np.int32)
        S = len(prompt)
        if S < 1 or S + 1 > self.max_len:
            raise ValueError(
                f"prompt length {S} must be in [1, max_len={self.max_len})")
        max_new_tokens = max(1, min(max_new_tokens, self.max_len - S))
        self._rid += 1
        self.queue.append(Request(self._rid, prompt, max_new_tokens,
                                  arrival_s=float(arrival_s),
                                  eos_token=eos_token,
                                  record_logits=record_logits))
        return self._rid

    def run(self) -> List[Request]:
        if self.continuous:
            return self._run_continuous()
        while self.queue:
            self._serve_batch(self._take_batch())
        return self.finished

    # -- continuous batching (ZipMoE path) -------------------------------
    def _make_pool(self) -> KVPagePool:
        cc = self.max_concurrency
        pages_per = -(-self.max_len // self.page_size)
        # default: every slot can hold a max_len request, so admission
        # never stalls on pages; a smaller explicit n_pages makes pages
        # the admission constraint instead (all-or-nothing at admission —
        # active requests hold their full budget, so no deadlock)
        n_pages = self.n_pages or cc * pages_per
        return KVPagePool(self.cfg, page_size=self.page_size,
                          n_pages=n_pages, max_slots=cc, device=self.device)

    def _admit(self, active: List[_Slot], pool: KVPagePool, t0: float):
        """Admit queued requests into free slots at a step boundary.
        Strict FIFO; a head whose ``arrival_s`` is still in the future
        blocks admission (and is slept for when nothing is active)."""
        while self.queue and len(active) < self.max_concurrency:
            wait = (t0 + self.queue[0].arrival_s) - time.perf_counter()
            if wait > 0:
                if active:
                    break
                time.sleep(wait)
            r = self.queue[0]
            try:
                pool.alloc(r.rid, len(r.prompt) + r.max_new_tokens)
            except RuntimeError:
                if not active:         # can never fit: configuration error
                    raise
                break                  # wait for a retirement to free pages
            self.queue.popleft()
            now = time.perf_counter()
            r.admitted = now
            r.due = max(r.submitted, t0 + r.arrival_s)
            r.queue_delay_s = now - r.due
            gen = (make_generator(self.device,
                                  request_seed(self.seed, r.rid))
                   if self.temperature > 0 else None)
            active.append(_Slot(r, gen, next_tok=int(r.prompt[0])))

    def _retire(self, s: _Slot, active: List[_Slot], pool: KVPagePool):
        pool.free(s.req.rid)
        active.remove(s)
        self.finished.append(s.req)
        if self.on_retire is not None:
            self.on_retire(s.req)

    def _sample_rows(self, lg, active: List[_Slot]):
        """The step's sampled token of every row that is past its prompt
        (others get -1), and the rows' f32 logits when any row records
        them — each brought to the host once for the whole batch.  Spans:
        ``server.sample``, and ``server.sample.sync`` over the readbacks."""
        sp = spans.span("server.sample")
        rows = lg[:, -1]
        sampling = [b for b, s in enumerate(active)
                    if s.pos + 1 >= len(s.req.prompt)]
        if self.temperature <= 0:
            toks = sample_tokens(rows)
        else:
            toks = torch.full((len(active),), -1, dtype=torch.long,
                              device=rows.device)
            for b in sampling:       # one draw from the row's own stream
                toks[b] = sample_tokens(rows[b:b + 1], active[b].gen,
                                        self.temperature)[0]
        logits = None
        sync = spans.span("server.sample.sync")
        if any(active[b].req.record_logits for b in sampling):
            logits = rows.float().cpu().numpy()
        toks = toks.cpu().numpy()
        sync.close()
        sp.close()
        return toks, logits

    def _run_continuous(self) -> List[Request]:
        """The serving loop.  Spans (``core/spans``): ``server.step`` per
        step (a new step id; the rows' request ids), with ``server.admit``,
        ``kv.gather``, ``kv.commit``, ``server.sample`` and
        ``server.retire`` inside it; the step's model call
        (``zs.decode_rows``) nests between the gather and the commit."""
        pool = self.pool = self._make_pool()
        active: List[_Slot] = []
        t0 = time.perf_counter()
        while self.queue or active:
            with spans.step_span("server.step") as st:
                self._step(active, pool, t0, st)
        return self.finished

    def _step(self, active: List[_Slot], pool: KVPagePool, t0: float, st):
        """One step of the serving loop (see ``_run_continuous``); `st`
        is its ``server.step`` span."""
        with spans.span("server.admit"):
            self._admit(active, pool, t0)
        rids = [s.req.rid for s in active]
        st.tag(rids)
        tokens = torch.as_tensor([[s.next_tok] for s in active],
                                 dtype=torch.long, device=self.device)
        positions = np.asarray([s.pos for s in active], np.int64)
        with spans.span("kv.gather"):
            views = pool.gather(rids)  # gen-checked: KV pages, not slab slots
        try:
            lg, views = self.zip.decode_rows(tokens, views, positions,
                                             owners=rids)
        except StepFault as f:
            # retire ONLY the rows whose experts could not be fetched,
            # then run the step again with the survivors.  Nothing was
            # committed (the fault fires before commit) and sampling
            # is keyed per request, so the survivors' trajectories are
            # those of a fault-free run.
            bad = {active[b].req.rid for b in f.rows if b < len(active)}
            if not bad:          # always retire someone, or a
                bad = set(rids)  # persistent fault would spin forever
            now = time.perf_counter()
            for s in [s for s in active if s.req.rid in bad]:
                s.req.error = str(f)
                s.req.done = now
                self._retire(s, active, pool)
            return
        with spans.span("kv.commit"):
            pool.commit(views, rids, positions)
        toks, logits = self._sample_rows(lg, active)
        now = time.perf_counter()
        retired: List[_Slot] = []
        for b, s in enumerate(active):
            r = s.req
            s.pos += 1
            if s.pos < len(r.prompt):          # prefill-as-decode
                s.next_tok = int(r.prompt[s.pos])
                continue
            tok = int(toks[b])
            if r.ttft is None:
                r.ttft = now - r.due
            r.output.append(tok)
            r.token_s.append(now)
            if r.record_logits:
                r.logits.append(logits[b])
            s.next_tok = tok
            if (len(r.output) >= r.max_new_tokens
                    or (r.eos_token is not None and tok == r.eos_token)):
                r.done = now
                retired.append(s)
        with spans.span("server.retire"):
            for s in retired:                  # free pages, backfill next
                self._retire(s, active, pool)
            if not active:
                # nothing left to hide the speculative tails under: finish
                # the in-flight prediction jobs so the cache byte
                # accounting is stable (nothing leaks across an idle gap)
                self.zip.drain_pending()

    # -- epoch batching (resident path / static-batch baseline) ----------
    def _take_batch(self) -> List[Request]:
        # bucket by prompt length for a single prefill shape
        first_len = len(self.queue[0].prompt)
        batch = []
        rest = collections.deque()
        while self.queue and len(batch) < self.max_batch:
            r = self.queue.popleft()
            if len(r.prompt) == first_len:
                batch.append(r)
            else:
                rest.append(r)
        self.queue.extendleft(reversed(rest))
        return batch

    def _prefill(self, prompts: torch.Tensor, max_new: int):
        """Returns (last-position logits [B, V], decode cache, decode fn)."""
        B, S = prompts.shape
        if self.zip is not None:
            # compressed-store path: the prompt streams through the ZipMoE
            # decode step (engine prefetch overlaps reconstruction with it)
            cache = self.zip.init_cache(B, S + max_new)
            logits = None
            for i in range(S):
                logits, cache = self.zip.decode_step(prompts[:, i:i + 1],
                                                     cache, i)

            def dec(tok, cache, pos):
                return self.zip.decode_step(tok, cache, pos)
        else:
            logits, cache = self.pf(self.params, prompts)
            cache = grow_cache(self.cfg, cache, B, S + max_new)

            def dec(tok, cache, pos):
                return self.dec(self.params, tok, cache, pos)
        return logits[:, -1], cache, dec

    def _serve_batch(self, batch: List[Request]):
        S = len(batch[0].prompt)
        prompts = torch.from_numpy(np.stack([r.prompt for r in batch]).astype(
            np.int64)).to(self.device)
        max_new = max(r.max_new_tokens for r in batch)
        gen = (make_generator(self.device, self.seed)
               if self.temperature > 0 else None)
        logits, cache, dec = self._prefill(prompts, max_new)
        tok = sample_tokens(logits, gen, self.temperature)
        host = tok.cpu().numpy()
        now = time.perf_counter()
        alive = set()
        for b, r in enumerate(batch):
            r.ttft = now - r.submitted
            r.output.append(int(host[b]))
            r.token_s.append(now)
            if len(r.output) >= r.max_new_tokens:
                r.done = now
            else:
                alive.add(b)
        for i in range(max_new - 1):
            if not alive:
                break
            lg, cache = dec(tok[:, None], cache, S + i)
            tok = sample_tokens(lg[:, -1], gen, self.temperature)
            host = tok.cpu().numpy()
            now = time.perf_counter()
            for b in list(alive):
                r = batch[b]
                r.output.append(int(host[b]))
                r.token_s.append(now)
                if len(r.output) >= r.max_new_tokens:
                    r.done = now
                    alive.discard(b)
        now = time.perf_counter()
        for r in batch:
            if r.done is None:
                r.done = now
        self.finished.extend(batch)

    # -- metrics ---------------------------------------------------------
    def metrics(self) -> Dict[str, float]:
        """Latency and throughput of the finished requests: TTFT from the
        time a request was due, TPOT per request, and ``itl_p95_s``, the
        95th percentile of the gaps between consecutive tokens of one
        request, every request's gaps pooled."""
        if not self.finished:
            return {}
        ttfts = [r.ttft for r in self.finished if r.ttft is not None]
        tpots = [r.tpot_s for r in self.finished if r.tpot_s is not None]
        gaps = [b - a for r in self.finished
                for a, b in zip(r.token_s, r.token_s[1:])]
        qdels = [r.queue_delay_s for r in self.finished
                 if r.queue_delay_s is not None]
        total_toks = sum(len(r.output) for r in self.finished)
        span = (max(r.done for r in self.finished) -
                min(r.submitted for r in self.finished))
        m = {"n_requests": len(self.finished),
             "n_failed": sum(1 for r in self.finished if r.error),
             "mean_ttft_s": float(np.mean(ttfts)) if ttfts else 0.0,
             "ttft_p50_s": _pct(ttfts, 50) if ttfts else 0.0,
             "ttft_p95_s": _pct(ttfts, 95) if ttfts else 0.0,
             "throughput_tok_s": total_toks / max(span, 1e-9)}
        if tpots:
            m["mean_tpot_s"] = float(np.mean(tpots))
            m["tpot_p50_s"] = _pct(tpots, 50)
            m["tpot_p95_s"] = _pct(tpots, 95)
        if gaps:
            m["itl_p95_s"] = _pct(gaps, 95)
        if qdels:
            m["queue_delay_p50_s"] = _pct(qdels, 50)
            m["queue_delay_p95_s"] = _pct(qdels, 95)
        if self.zip is not None:
            m.update({f"overlap_{k}": v
                      for k, v in self.zip.overlap_summary().items()})
            cs = self.zip.cache_summary()
            m.update({"cache_mode": cs["mode"],
                      "cache_hit_rate": cs["hit_rate"],
                      "cache_accesses": cs["accesses"],
                      "cache_misses": cs["misses"],
                      "cache_evictions": cs["evictions"]})
        return m

    def request_summary(self) -> Dict[int, Dict[str, object]]:
        """Per-request accounting: latency (TTFT / TPOT / queue delay)
        joined with the ZipServer's per-request cache stats (accesses,
        hits at step start, hit rate) — the multi-tenant complement to the
        shared-pool :meth:`cache_summary`."""
        per_cache = self.zip.request_summary() if self.zip is not None \
            else {}
        out: Dict[int, Dict[str, object]] = {}
        for r in self.finished:
            d: Dict[str, object] = {
                "ttft_s": r.ttft, "tpot_s": r.tpot_s,
                "queue_delay_s": r.queue_delay_s,
                "n_tokens": len(r.output), "error": r.error}
            d.update({f"cache_{k}": v
                      for k, v in per_cache.get(r.rid, {}).items()})
            out[r.rid] = d
        return out

    def cache_summary(self, per_layer: bool = False):
        """The underlying ZipServer's §3.4 cache telemetry (per-pool hit
        counts, residency transitions); ``{}`` on the resident path."""
        if self.zip is None:
            return {}
        return self.zip.cache_summary(per_layer=per_layer)
