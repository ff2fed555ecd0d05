"""One run of a benchmark cell (``zipbench/``) with the port's span
recorder (``repro_torch.core.spans``) on over the measured window: the
split of the decode step's host time by span.

    python3 tools/span_split.py --workload dsv2lite-b16-resident \\
        --seed 2147483901 --seconds 51 --trace 1 [--spans 0]

The benchmark runs as ``zipbench/run.py`` runs it, and prints its result
line.  With ``--spans 1`` (the default) the cell's serving loop records
spans from the window's opening to its close; after the run this prints
one more line, ``span_split: {...}``:

- ``split``: ms per window step of each span name (``spans.split``), and
  ``zs.decode_rows.self``, the host time of ``zs.decode_rows`` that no
  child span names;
- ``per_step_ms``: the sums the benchmark's per-layer readers would take
  (``route_sync``: ``moe.route.sync``; ``attn_host``: ``zs.attn``;
  ``moe_host``: ``moe.access`` + ``moe.csr`` + ``moe.gemm`` +
  ``moe.combine``; ``engine_collect``: ``engine.collect`` on the decode
  thread; ``kv_pages``: ``kv.gather`` + ``kv.commit``;
  ``decode_untraced``: ``zs.decode_rows.self``), over the window's steps;
- ``covered``: the share of ``zs.decode_rows`` its children cover;
- ``records_per_step``: spans recorded a window step, all threads;
- with ``--trace 1``: the decode thread's spans inside the profiled
  sub-window join the benchmark's own spans, so the ``idle_gaps`` of its
  breakdown name program spans; ``clock`` (``clock_check``): whether the
  sub-window's ``moe.route.sync`` spans, once placed on the trace's
  clock, contain the ``cudaMemcpyAsync`` of their readback;
  ``idle_gaps``: the sub-window's longest idle gaps, named so;
  ``idle_gaps_end``: named with the program's spans placed by the
  closing synchronize (the clock check's ``end_shift_us``);
- ``engine``: over the window, the engine's round-trip counters of
  ``transfer_summary()`` (those the program has: ``readmit_skips``,
  ``collect_keys``, ``collect_fast_keys`` and ``reconcile_skips`` are
  left out where it lacks them) and ``admits``, the calls of
  ``HierarchicalCache.admit``; ``engine_per_step``: the same per window
  step;
- ``attn``: ``zs.attn``'s ms per window step beside the window's kernel
  launches (``kernels._build.LAUNCHES``, those that moved) per step, and
  the MLA decode kernels' launches per attention layer and step (1 each
  when every MLA layer-step went through them; absent where the program
  has no such kernel).

``--spans 0`` runs the same code with the recorder left off: alternate the
two to measure what recording costs.  Needs the card(s) the cell names.
``--site-cost N`` prints instead what one span site costs this host, in
ns, the recorder off and on (N sites each, three passes).
"""
from __future__ import annotations

import argparse
import bisect
import json
import itertools
import statistics
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MOE_HOST = ("moe.access", "moe.csr", "moe.gemm", "moe.combine")


def program_spans(records, tid: int, a: float, b: float):
    """(name, start_s, end_s) of thread `tid`'s records that lie inside
    [a, b] (``perf_counter`` seconds): what joins the benchmark's spans.
    A worker's span never does, so it never names an idle gap."""
    return [(r.name, r.start / 1e9, r.end / 1e9) for r in records
            if r.tid == tid and a <= r.start / 1e9 and r.end / 1e9 <= b]


def per_step(records, steps: int, main_tid: int):
    """The per-step sums of ``per_step_ms`` (ms), and the share of
    ``zs.decode_rows`` its children cover."""
    def ms(names, thread=None):
        return sum(r.dur_ns for r in records if r.name in names
                   and (thread is None or r.tid == thread)) / steps / 1e6

    from repro_torch.core import spans
    kids = spans.children(records)
    rows = [r for r in records if r.name == "zs.decode_rows"]
    dur = sum(r.dur_ns for r in rows)
    untraced = sum(spans.self_ns(r, kids) for r in rows)
    return ({"route_sync": ms(("moe.route.sync",)),
             "attn_host": ms(("zs.attn",)),
             "moe_host": ms(MOE_HOST),
             "engine_collect": ms(("engine.collect",), main_tid),
             "kv_pages": ms(("kv.gather", "kv.commit")),
             "decode_untraced": untraced / steps / 1e6,
             "decode_rows": dur / steps / 1e6},
            1.0 - untraced / dur if dur else None)


MLA_KERNELS = ("mla_rope_write", "mla_absorbed_attend")


def attn_launches(delta, steps: int, cfg, attn_ms=None):
    """``zs.attn``'s ms per step beside the window's kernel launches
    `delta` (name -> launches) per step, and the MLA decode kernels'
    launches per attention layer and step of an MLA `cfg`."""
    out = {"zs.attn_ms_per_step": attn_ms,
           "launches_per_step": {k: n / steps for k, n in delta.items()}}
    if cfg.attn == "mla":
        layers = sum(1 for i in range(cfg.n_layers) if cfg.attn_layer(i))
        out["mla_layers"] = layers
        out["launches_per_layer_step"] = {
            k: delta[k] / (steps * layers) for k in MLA_KERNELS
            if k in delta}
    return out


def clock_check(records, events, a: float, b: float, t0_us: float):
    """The ``moe.route.sync`` spans inside the profiled sub-window [a, b]
    (``perf_counter`` seconds) against the trace's ``cudaMemcpyAsync``
    runtime events (the router readback's copies).

    As placed (`a` at `t0_us`, the opening ``cudaDeviceSynchronize``'s
    start, as the benchmark places its spans): ``share``, the share of
    spans that contain a copy, and ``median_offset_us`` from span start to
    its first copy.  ``end_shift_us``: how far the closing synchronize's
    end lies from ``t0_us + (b - a)`` (`b` is read right after it
    returns); ``end_share`` / ``end_median_offset_us``: the same with the
    spans moved by it.  ``fit_us``: the range of shifts that makes the
    most spans contain a copy, ``fit_share`` that share."""
    copies = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events if e.get("ph") == "X"
                    and e.get("name") == "cudaMemcpyAsync")
    starts = [c[0] for c in copies]
    placed = [(t0_us + (r.start / 1e9 - a) * 1e6,
               t0_us + (r.end / 1e9 - a) * 1e6) for r in records
              if r.name == "moe.route.sync"
              and a <= r.start / 1e9 and r.end / 1e9 <= b]
    n = len(placed)

    def offsets(shift):
        """Per span that contains a copy when moved by `shift`: the
        offset of its first copy from its start."""
        out = []
        for s, e in placed:
            i = bisect.bisect_left(starts, s + shift)
            if i < len(copies) and copies[i][1] <= e + shift:
                out.append(copies[i][0] - s - shift)
        return out

    def share(shift):
        return len(offsets(shift)) / n if n else None

    def median(xs):
        return statistics.median(xs) if xs else None

    out = {"spans": n, "share": share(0.0),
           "median_offset_us": median(offsets(0.0))}
    if n:
        coarse = {d: len(offsets(d)) for d in range(-20000, 20001, 10)}
        top = max(coarse.values())
        best = [d for d, h in coarse.items() if h == top]
        fine = {lo: len(offsets(lo)) for lo in
                (x / 2 for x in range(2 * best[0] - 20, 2 * best[-1] + 21))}
        top = max(fine.values())
        best = [d for d, h in fine.items() if h == top]
        out["fit_us"] = [best[0], best[-1]]
        out["fit_share"] = top / n
    syncs = sorted((float(e["ts"]), float(e["dur"])) for e in events
                   if e.get("ph") == "X"
                   and e.get("name") == "cudaDeviceSynchronize")
    if syncs:
        d = sum(syncs[-1]) - (t0_us + (b - a) * 1e6)
        out["sync"] = [[syncs[0][0] - t0_us, syncs[0][1]],
                       [syncs[-1][0] - t0_us, syncs[-1][1]]]
        out["end_shift_us"] = d
        out["end_share"] = share(d)
        out["end_median_offset_us"] = median(offsets(d))
    return out


def site_cost(n: int):
    """ns per ``with spans.span(...)`` site, [off, on], over `n` sites,
    less the loop's own cost."""
    from repro_torch.core import spans

    def sites():
        for _ in itertools.repeat(None, n):
            with spans.span("zs.moe", 1):
                pass

    def empty():
        for _ in itertools.repeat(None, n):
            pass

    out = []
    for on in (False, True):
        if on:
            spans.enable(cap=n)
        t0 = time.perf_counter()
        sites()
        dt = time.perf_counter() - t0
        spans.disable()
        spans.take()
        t0 = time.perf_counter()
        empty()
        out.append((dt - (time.perf_counter() - t0)) / n * 1e9)
    return out


def main(argv=None, *, root: Path = ROOT, device=None) -> int:
    """`root`: the benchmark's root; `device`: as ``harness.main`` takes
    it (None: the card)."""
    ap = argparse.ArgumentParser(prog="tools/span_split.py")
    ap.add_argument("--site-cost", type=int, default=0)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    if args.site_cost:
        for _ in range(3):
            off, on = site_cost(args.site_cost)
            print(f"site_cost: off {off:.1f} ns, on {on:.1f} ns")
        return 0
    if None in (args.workload, args.seed, args.seconds):
        ap.error("--workload, --seed and --seconds are required")
    from zipbench import run as zrun
    zrun._env()
    from repro_torch.core import spans
    from repro_torch.core.cache import HierarchicalCache
    from repro_torch.kernels import _build
    from zipbench import harness, trace
    from zipbench.drivers import batch_server

    main_tid = threading.get_ident()
    out = {}
    admits = {"open": False, "n": 0}
    admit = HierarchicalCache.admit

    def counted_admit(cache, *a, **k):
        if admits["open"]:
            admits["n"] += 1
        return admit(cache, *a, **k)

    base = batch_server.Driver

    class SpanDriver(base):
        def _hook(self):
            super()._hook()
            run = self.run
            open_window, tick = run.open_window, run.tick

            engine = self.zs.engine

            def opened(now):
                open_window(now)
                self.tr0 = engine.transfer_summary()
                self.launches0 = dict(_build.LAUNCHES)
                admits["open"] = True
                if args.spans:
                    spans.enable()

            def ticked(now, mark=None):
                closed = tick(now, mark)
                if closed:
                    spans.disable()
                    admits["open"] = False
                    tr = engine.transfer_summary()
                    out["engine"] = {
                        k: tr[k] - self.tr0[k] for k in (
                            "jobs_submitted", "jobs_pure_hit",
                            "subset_waits", "subset_wait_timeouts",
                            "readmit_skips", "collect_keys",
                            "collect_fast_keys", "reconcile_skips")
                        if k in tr}
                    out["engine"]["admits"] = admits["n"]
                    out["launches"] = {
                        k: n - self.launches0.get(k, 0)
                        for k, n in _build.LAUNCHES.items()
                        if n != self.launches0.get(k, 0)}
                return closed

            run.open_window, run.tick = opened, ticked

        def serve(self):
            super().serve()
            spans.disable()
            self.records = spans.take()
            out["dropped"] = spans.dropped()
            tr = self.run.tracer
            self.events, self.joined = [], []
            if tr._done is None:
                return
            self.joined = program_spans(self.records, main_tid,
                                        tr.started_at, tr.stopped_at)
            tr.spans += self.joined
            export = tr._done.export_chrome_trace

            def keep(path):
                export(path)
                with open(path) as f:
                    self.events = json.load(f).get("traceEvents", [])

            tr._done.export_chrome_trace = keep

        def layer_view(self, view):
            v = super().layer_view(view)
            win = self.run.window
            recs = [r for r in self.records
                    if win.t_open <= r.end / 1e9 <= win.t_close]
            steps = len(v.steps)
            out["steps"] = steps
            out["split"] = spans.split(recs)
            out["records_per_step"] = len(recs) / steps if steps else None
            if steps and "engine" in out:
                out["engine_per_step"] = {k: n / steps for k, n in
                                          out["engine"].items()}
            if steps and recs:
                out["per_step_ms"], out["covered"] = per_step(
                    recs, steps, main_tid)
            if steps and "launches" in out:
                out["attn"] = attn_launches(
                    out["launches"], steps, self.cfg,
                    out.get("per_step_ms", {}).get("attn_host"))
            if view is not None:
                tr = self.run.tracer
                out["clock"] = clock_check(self.records, self.events,
                                           tr.started_at, tr.stopped_at,
                                           view["t0"])
                out["idle_gaps"] = trace.idle_gaps(view)
                # the same gaps with the program's spans placed by the
                # closing synchronize instead of the opening one
                n = len(self.joined)
                d = out["clock"].get("end_shift_us", 0.0)
                own = view["spans"][:len(view["spans"]) - n]
                moved = [(nm, s + d, e + d)
                         for nm, s, e in view["spans"][len(own):]]
                out["idle_gaps_end"] = trace.idle_gaps(
                    dict(view, spans=own + moved))
            return v

    batch_server.Driver = SpanDriver
    HierarchicalCache.admit = counted_admit
    try:
        rc = harness.main(["--workload", args.workload, "--seed",
                           str(args.seed), "--seconds", str(args.seconds),
                           "--trace", str(args.trace)], root=root,
                          device=device)
    finally:
        batch_server.Driver = base
        HierarchicalCache.admit = admit
    print("span_split: " + json.dumps(out))
    return rc


if __name__ == "__main__":
    sys.exit(main())
