"""Each one-card cell as the driver runs it, for a short window on the card
(``gpu``: skipped without one): exit 0, the contract's line, correct."""
import json
import subprocess
import sys

import pytest
import torch

from zipbench.tests.tiny import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json")
                                       .read_text())["workloads"]
         if w["chips"] == 1]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "zipbench/run.py", "--workload",
                        cell, "--seed", "2147483700", "--seconds", "12",
                        "--trace", str(trace)], cwd=REPO, text=True,
                       capture_output=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["correct"], last
    assert last["device"]["platform"] == "gpu"
    if trace:
        assert last["device"]["busy_s"] > 0
        assert "expert_gemm_roofline" in last["metrics"]
