"""Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 zipbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints one JSON line last on standard output (see ``harness.py``).  Build
and kernel caches stay inside the checkout (``build/``); the compressed
store is written under ``TMPDIR`` and deleted.  Needs the port
(``src/repro_torch``) and as many CUDA cards as the cell asks for.
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _env():
    cache = ROOT / "build" / "zipbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


if __name__ == "__main__":
    _env()
    from zipbench.harness import main
    sys.exit(main(root=ROOT))
