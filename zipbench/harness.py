"""One run of one cell: load its files by name, set up, measure, check,
print the result line.

    BENCHMARK.json            the cells, configurations and metrics
    zipbench/configs/*.json   a configuration (``file`` of its entry)
    zipbench/families/<model_type>.py   its mapping onto the port's
                              config, its reference, its weight rules
    zipbench/workloads/<cell>.json   the cell: driver, server settings,
                              warm-up, profiled sub-window, the limits of
                              its correctness numbers
    zipbench/traffic/<mix>.json      the traffic mix (``traffic.py``)
    zipbench/drivers/<driver>.py     how the cell drives the port
    zipbench/metrics/<metric>.py     one per-layer metric's reader
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time
import types
from dataclasses import asdict
from pathlib import Path
from typing import List, Optional

import torch

from zipbench import modelcfg, traffic as traffic_lib
from zipbench.trace import Tracer, busy_intervals, idle_gaps, top_ops
from zipbench.window import Window, end_to_end

BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def process_age(t_fallback: float) -> float:
    """Seconds since this process started (Linux: from /proc), else since
    `t_fallback` on the perf_counter clock."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - t_fallback


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m, v in list(sys.modules.items())
                   if v is not None and m.split(".")[0] in BANNED})


class Run:
    """What a driver needs: the cell's files, the seed, the device, the
    window, the tracer."""

    def __init__(self, root: Path, bench: dict, cell: str, seed: int,
                 seconds: float, trace: bool, device: torch.device,
                 t_start: float):
        self.root, self.bench, self.name = root, bench, cell
        self.entry = next(w for w in bench["workloads"] if w["name"] == cell)
        conf = next(c for c in bench["configs"]
                    if c["name"] == self.entry["config"])
        self.config_file = modelcfg.load(root / conf["file"])
        self.family = modelcfg.family(self.config_file)
        self.cfg = modelcfg.model_config(self.config_file)
        self.hp = types.SimpleNamespace(
            **asdict(self.cfg),
            rope_scaling=self.config_file.get("rope_scaling"),
            published=dict(self.config_file))
        self.spec = json.loads((root / "zipbench" / "workloads"
                                / f"{cell}.json").read_text())
        self.mix = traffic_lib.load(root, self.entry["traffic"])
        self.seed, self.trace, self.device = int(seed), bool(trace), device
        self.traffic = traffic_lib.Traffic(self.mix, self.seed,
                                           self.cfg.vocab_size)
        self.window = Window(seconds)
        self.tracer = Tracer(self.trace, self.spec.get("profile", {}))
        self.t_start = t_start
        self.setup_s: Optional[float] = None
        self.devices = [device]
        self.phases: List[tuple] = []
        self._t_note = time.perf_counter()

    def note(self, phase: str):
        """Record the seconds since the last note as set-up phase
        `phase`."""
        now = time.perf_counter()
        self.phases.append((phase, now - self._t_note))
        self._t_note = now

    def open_window(self, now: float):
        self.setup_s = process_age(self.t_start)
        self.window.open(now)
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.reset_peak_memory_stats(d)

    def tick(self, now: float, mark=None) -> bool:
        """A step ended at `now`; returns True once, when the window
        closes."""
        w = self.window
        self.tracer.tick(now, w.t_open, mark)
        if w.t_open is not None and not w.closed and now >= w.t_close:
            w.closed = True
            self.tracer.stop(mark)
            return True
        return False


def _import(kind: str, name: str):
    return importlib.import_module(f"zipbench.{kind}.{name}")


def per_layer_names(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    with no list whose moved metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_metrics(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in e2e)]


def end_to_end_metrics(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def device_block(run: Run) -> dict:
    """Where the run ran; the peak allocated bytes of the fullest card since
    the window opened."""
    cuda = [d for d in run.devices if d.type == "cuda"]
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(cuda[0]) if cuda else "cpu",
            "count": len({(d.type, d.index) for d in run.devices}),
            "memory_peak_bytes": max((torch.cuda.max_memory_allocated(d)
                                      for d in cuda), default=0)}


def main(argv=None, *, root: Optional[Path] = None, device=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(prog="zipbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(root or Path.cwd())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if args.workload not in {w["name"] for w in bench["workloads"]}:
        print(f"zipbench: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    entry = next(w for w in bench["workloads"] if w["name"] == args.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < entry["chips"]:
            print(f"zipbench: {args.workload} needs {entry['chips']} CUDA "
                  f"card(s); torch.cuda.is_available()="
                  f"{torch.cuda.is_available()}, device_count="
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    run = Run(root, bench, args.workload, args.seed, args.seconds,
              bool(args.trace), torch.device(device), t_start)
    driver = _import("drivers", run.spec["driver"]).Driver(run)
    driver.serve()                       # set-up, warm-up, window, drain
    win = run.window
    if win.t_open is None or not win.closed:
        print("zipbench: the window never opened or closed", file=sys.stderr)
        return 4
    dev = device_block(run)
    view = run.tracer.view()
    layer_ctx = driver.layer_view(view)
    driver.free()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    failed = win.failed()
    checks = driver.check() + [("failed", failed, 0)]   # (name, value, limit)
    bad = banned_modules()
    if bad:
        print(f"zipbench: the run loaded {bad}", file=sys.stderr)
        return 5
    correct = all(v <= lim for _, v, lim in checks)
    if args.trace:
        metrics = {}
        for m in per_layer_names(bench, args.workload):
            val = _import("metrics", m["name"]).read(layer_ctx)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        if view is not None:
            busy = sum(e - s for d in run.devices if d.type == "cuda"
                       for s, e in busy_intervals(view["ops"], d.index or 0))
            n = max(1, len([d for d in run.devices if d.type == "cuda"]))
            dev["busy_s"] = busy * 1e-6 / n
            dev["window_s"] = (view["t1"] - view["t0"]) * 1e-6
    else:
        e2e = end_to_end(win, run.setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in end_to_end_metrics(bench, args.workload)
                   if m["name"] in e2e}
    result = {"correct": bool(correct), "attempted": win.attempted(),
              "failed": failed, "metrics": metrics, "device": dev}
    if args.trace and view is not None:
        result["breakdown"] = {"device_ops": top_ops(view),
                               "idle_gaps": idle_gaps(view)}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    print("zipbench: set-up " + ", ".join(f"{p} {s:.2f} s"
                                          for p, s in run.phases)
          + f"; setup_s {run.setup_s:.2f} s", file=sys.stderr)
    print(f"zipbench: window {win.trend()}", file=sys.stderr)
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0

