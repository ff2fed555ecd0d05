"""The readings a cell's correctness limit is set from.

    python3 zipbench/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds 10

For each seed, in one process: the cell's own set-up, a short window at its
own load, the drain; then, on the same sampled positions, the program's
number (the widest gap of a served token below the float32 reference's
best) and the control's (the widest gap of the token the float8 reference
puts first).  The limit lies between the program's largest reading and the
control's smallest.  Prints one JSON line per seed.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(argv=None, *, root=None, device=None):
    import argparse

    import torch

    from zipbench.harness import Run, _import
    ap = argparse.ArgumentParser(prog="zipbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    root = Path(root or ROOT)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    dev = torch.device(device or "cuda:0")
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = Run(root, bench, args.workload, seed, args.seconds, False, dev,
                  t0)
        driver = _import("drivers", run.spec["driver"]).Driver(run)
        driver.serve()
        driver.free()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        nums = driver.reference_numbers(control=True)
        line = {"workload": args.workload, "seed": seed, **nums,
                "out_tokens": run.window.out_tokens(),
                "serve_s": t1 - t0, "reference_s": time.perf_counter() - t1}
        print(json.dumps(line), flush=True)
        out.append(line)
        del driver, run
    return out


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from zipbench.run import _env
    _env()
    readings()
