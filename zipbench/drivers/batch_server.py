"""Closed-loop clients through the port's continuous-batching front end:
``BatchServer.run`` over ``ZipServer.decode_rows``.

Set-up draws the seeded weights on the card, builds the compressed store
(zlib at the configuration's level) in the run's temporary directory, drops
the routed experts from the card and starts ``ZipServer`` with the cell's
``server`` settings.  ``clients`` requests are in flight at every moment:
``BatchServer.on_retire`` submits the next one.  The window opens after
``warmup_steps`` decode steps; when it closes, no request is submitted and
every request in flight (or queued) is cut to the token it is on, so the
run drains within the longest prompt.

Everything here is the harness's own: hooks on its own ``BatchServer`` and
``ZipServer`` objects stamp each step's tokens when they reach the host
and time the step's call into the server; the port is not changed.
"""
from __future__ import annotations

import gc
import shutil
import tempfile
import time
import types

import torch

from zipbench import modelcfg, weights
from zipbench.reference import compare
from zipbench.window import Step


class Driver:
    def __init__(self, run):
        self.run = run
        self.spec = run.spec
        self.cfg = run.cfg
        self.store_dir = None
        self.zs = self.srv = None
        self.done = []
        self.step_i = 0

    # ---- set-up --------------------------------------------------------
    def _weights(self):
        """The seeded weights on the run's device (the same every call)."""
        run = self.run
        return weights.make_weights(
            self.cfg, run.seed, run.device, modelcfg.alpha(run.config_file),
            leaf_rule=getattr(run.family, "leaf_rule", None))

    def _server_kwargs(self) -> dict:
        kw = dict(self.spec["server"])
        if kw.get("pool_sizes") == "all":
            kw["pool_sizes"] = {"F": self.cfg.n_experts, "C": 0, "S": 0,
                                "E": 0}
        return kw

    def _serve_from_store(self, params):
        """Build the compressed store from `params`, drop the routed experts
        from the card and start ``ZipServer`` with the cell's settings."""
        from repro_torch.core.codec import ZlibCodec
        from repro_torch.core.store import build_store
        from repro_torch.serving.zipserve import ZipServer
        run, cfg, dev = self.run, self.cfg, self.run.device
        self.store_dir = tempfile.mkdtemp(prefix="zipbench_store_")
        build_store(params, cfg, self.store_dir, device=dev,
                    codec=ZlibCodec(modelcfg.zlib_level(run.config_file))
                    ).close()
        run.note("store")
        weights.drop_routed(params)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        self.zs = ZipServer(params, cfg, self.store_dir, device=dev,
                            **self._server_kwargs())
        if self.spec.get("warm_all_experts"):
            for layer in range(cfg.n_layers):
                if cfg.moe_layer(layer):
                    self.zs.engine.fetch_experts(
                        layer, list(range(cfg.n_experts)))
        run.note("server")

    def _build(self):
        from repro_torch.serving.server import BatchServer
        run = self.run
        params = self._weights()
        run.note("weights")
        self._serve_from_store(params)
        tr = run.traffic
        self.srv = BatchServer(
            params, self.cfg, max_batch=run.mix["clients"],
            max_concurrency=run.mix["clients"],
            max_len=tr.max_prompt + tr.max_output, zip_server=self.zs,
            seed=run.seed)

    # ---- hooks ---------------------------------------------------------
    def _submit(self):
        i = self.next_req
        self.next_req += 1
        prompt, n_out = self.run.traffic.request(i)
        rid = self.srv.submit(prompt, n_out)
        self.run.window.issue(rid, time.perf_counter())

    def _on_retire(self, req):
        self.done.append(req)
        if req.error is not None:
            self.run.window.fail(req.rid, req.error)
        if not self.run.window.closed:
            self._submit()

    def _hook(self):
        run, srv, zs = self.run, self.srv, self.zs
        tracer = run.tracer
        decode_rows, sample = zs.decode_rows, srv._sample_rows
        acquire = zs._acquire_experts
        self.t_prev, self.call_s = None, 0.0

        def timed_decode(*a, **k):
            t0 = time.perf_counter()
            with tracer.span("zb.decode_rows"):
                out = decode_rows(*a, **k)
            self.call_s = time.perf_counter() - t0
            return out

        def timed_acquire(*a, **k):
            with tracer.span("zb.acquire_experts"):
                return acquire(*a, **k)

        def stamped(lg, active):
            with tracer.span("zb.sample"):
                toks, logits = sample(lg, active)
            now = time.perf_counter()
            for s in active:
                if s.pos + 1 >= len(s.req.prompt):
                    run.window.token(s.req.rid, now)
            wall = now - self.t_prev if self.t_prev is not None else 0.0
            run.window.steps.append(Step(now, [s.pos + 1 for s in active],
                                         max(0.0, wall - self.call_s)))
            self.t_prev = now
            self.step_i += 1
            if run.window.t_open is None and \
                    self.step_i >= self.spec["warmup_steps"]:
                run.note("warm-up")
                run.open_window(now)
                self.counters["open"] = len(zs.stats)
            if run.tick(now, mark=lambda: len(zs.stats)):
                self.counters["close"] = len(zs.stats)
                for s in active:
                    s.req.max_new_tokens = 1
                for r in srv.queue:
                    r.max_new_tokens = 1
            return toks, logits

        zs.decode_rows = timed_decode
        zs._acquire_experts = timed_acquire
        srv._sample_rows = stamped
        srv.on_retire = self._on_retire

    # ---- the run -------------------------------------------------------
    def serve(self):
        self._build()
        self.next_req, self.counters = 0, {}
        self._hook()
        for _ in range(self.run.mix["clients"]):
            self._submit()
        self.srv.run()
        self.zs.drain_pending()

    def layer_view(self, view):
        """What the per-layer metric readers read (see metrics/)."""
        run, zs = self.run, self.zs
        c0, c1 = self.counters["open"], self.counters["close"]
        marks = run.tracer.marks
        return types.SimpleNamespace(
            cfg=self.cfg, window=run.window, steps=run.window.window_steps(),
            out_tokens=run.window.out_tokens(), seconds=run.window.seconds,
            stats=zs.stats[c0:c1],
            prof_stats=(zs.stats[marks["start"]:marks["stop"]]
                        if "stop" in marks else None),
            device=view)

    def free(self):
        """Release the program's state before the reference runs."""
        if self.zs is not None:
            self.zs.close()
        self.zs = self.srv = None
        if self.store_dir:
            shutil.rmtree(self.store_dir, ignore_errors=True)
            self.store_dir = None

    # ---- correctness ---------------------------------------------------
    def sample(self):
        """The requests the comparison takes, of those that served a token
        inside the window: the one with most served tokens, then others
        drawn from the seed, until ``sample_tokens`` served tokens or
        ``sample_requests`` requests."""
        c, win = self.spec["check"], self.run.window
        pool = [r for r in self.done if r.error is None and r.output
                and any(win.inside(t) for t in win.reqs[r.rid].tokens)]
        if not pool:
            return []
        longest = max(pool, key=lambda r: len(r.output))
        rest = [r for r in pool if r is not longest]
        order = self.run.traffic.rng(0).permutation(len(rest))
        out, n = [longest], len(longest.output)
        for j in order:
            if n >= c["sample_tokens"] or len(out) >= c["sample_requests"]:
                break
            out.append(rest[j])
            n += len(rest[j].output)
        return out

    def sequences(self, reqs):
        dev = self.run.device
        seqs = []
        for r in reqs:
            toks = list(r.prompt) + list(r.output[:-1])
            seqs.append({"tokens": torch.tensor(toks, dtype=torch.long,
                                                device=dev),
                         "first": len(r.prompt) - 1,
                         "served": torch.tensor(r.output, dtype=torch.long)})
        return seqs

    def reference_numbers(self, control: bool = False):
        run = self.run
        reqs = self.sample()
        ref = run.family.REFERENCE
        params = self._weights()

        def one(s, prec):
            return ref.logits(params, run.hp, s["tokens"][None], prec)[0]

        out = compare.widest_gap(one, self.sequences(reqs), control)
        del params
        return out

    def check(self):
        """``gap_max`` against the cell's limit; a run that served nothing
        to compare reads as failing (1e9)."""
        nums = self.reference_numbers()
        gap = nums["gap_max"] if nums["positions"] > 0 else 1e9
        return [("gap_max", gap, self.spec["check"]["gap_max"])]
