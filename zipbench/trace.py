"""Harness spans and the profiled sub-window.

With tracing on, ``torch.profiler`` records the card's activity (kernels,
copies, memsets: CUDA activity only, so the host loop is not slowed by
recording every operator) over one steady sub-window of the measured window
(the cell's ``profile`` setting, counted from the window's start).  The
sub-window starts and ends at step boundaries behind a
``torch.cuda.synchronize()``, so every operation recorded ran inside it;
once the window has closed, its trace is written to the run's temporary
directory, read back and deleted.  Harness spans ``(name, start, end)`` on
the host's ``perf_counter`` clock are kept in memory while the profiler
runs, and are placed on the trace's clock by the synchronize that opens
the sub-window (its ``cudaDeviceSynchronize`` runtime event).
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC = "cudaDeviceSynchronize"


class Tracer:
    def __init__(self, trace: bool, profile: Dict[str, float]):
        self.trace = trace
        self.start_s = float(profile.get("start_s", 0.0))
        self.length_s = float(profile.get("seconds", 0.0))
        self.spans: List[Tuple[str, float, float]] = []
        self._prof = None
        self.started_at: Optional[float] = None
        self.stopped_at: Optional[float] = None
        self.marks: Dict[str, int] = {}
        self._done = None          # the stopped profiler, read after the run

    @contextlib.contextmanager
    def span(self, name: str):
        if self._prof is None:
            yield
            return
        t0 = time.perf_counter()
        yield
        self.spans.append((name, t0, time.perf_counter()))

    def tick(self, now: float, t_open: Optional[float], mark=None):
        """Called at every step boundary: starts the profiler at the
        sub-window's start, stops it at its end.  `mark` (a callable)
        returns a position to remember at each of the two."""
        if not self.trace or t_open is None or self.stopped_at is not None:
            return
        if self._prof is None and now >= t_open + self.start_s:
            cuda = torch.cuda.is_available()
            if cuda:
                torch.cuda.synchronize()
            acts = [torch.profiler.ProfilerActivity.CUDA if cuda
                    else torch.profiler.ProfilerActivity.CPU]
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self.started_at = time.perf_counter()
            if cuda:
                torch.cuda.synchronize()
            if mark is not None:
                self.marks["start"] = mark()
        elif self._prof is not None and \
                now >= self.started_at + self.length_s:
            self.stop(mark)

    def stop(self, mark=None):
        """End the profiled sub-window (if open)."""
        if self._prof is None or self.stopped_at is not None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.stopped_at = time.perf_counter()
        if mark is not None:
            self.marks["stop"] = mark()
        self._done, self._prof = self._prof, None
        self._done.stop()

    def view(self) -> Optional[dict]:
        """The profiled sub-window on the trace's clock (us): [t0, t1], the
        device operations in it as (name, start, end, device), and the
        harness spans as (name, start, end).  Reads the trace once the
        window has closed, so writing and parsing it cost the window
        nothing."""
        if self._done is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._done.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        ev = [e for e in events if e.get("ph") == "X" and "dur" in e]
        syncs = [float(e["ts"]) for e in ev if e.get("name") == SYNC]
        t0 = min(syncs) if syncs else min((float(e["ts"]) for e in ev),
                                          default=0.0)
        t1 = t0 + (self.stopped_at - self.started_at) * 1e6
        ops = []
        for e in ev:
            if e.get("cat") in DEVICE_CATS:
                s = max(float(e["ts"]), t0)
                end = min(float(e["ts"]) + float(e["dur"]), t1)
                if end > s:
                    ops.append((e.get("name", "?"), s, end,
                                int(e.get("args", {}).get("device", 0))))
        spans = [(n, t0 + (a - self.started_at) * 1e6,
                  t0 + (b - self.started_at) * 1e6) for n, a, b in self.spans]
        return {"t0": t0, "t1": t1, "ops": ops, "spans": spans}


def busy_intervals(ops, device: Optional[int] = None):
    """Merged [start, end] intervals in which an operation ran."""
    iv = sorted((s, e) for _, s, e, d in ops if device is None or d == device)
    out: List[List[float]] = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_gaps(view: dict, device: int = 0, top: int = 10):
    """The longest idle gaps of `device` in the window, each named by the
    innermost harness span open on the host when it began."""
    busy = busy_intervals(view["ops"], device)
    edges = [view["t0"]] + [x for iv in busy for x in iv] + [view["t1"]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    out = []
    for s, e in gaps:
        open_ = [sp for sp in view["spans"] if sp[1] <= s < sp[2]]
        name = max(open_, key=lambda sp: sp[1])[0] if open_ else "host.other"
        out.append((name, (e - s) * 1e-6))
    out.sort(key=lambda x: -x[1])
    return [[n, s] for n, s in out[:top]]


def short(name: str, n: int = 96) -> str:
    """A device operation's name cut to `n` characters, without ``void``
    and anonymous namespaces."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name if len(name) <= n else name[:n - 3] + "..."


def top_ops(view: dict, top: int = 10):
    tot: Dict[str, float] = {}
    for name, s, e, _ in view["ops"]:
        tot[short(name)] = tot.get(short(name), 0.0) + (e - s) * 1e-6
    return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:top]]
