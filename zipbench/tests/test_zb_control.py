"""The control: the float8 reference in the program's place has to come out
not correct.  On the CPU at the tiny size (a vocabulary of 512, where float8
noise flips few tokens) its widest gap is never below the program's and
above it on some seed; on the card, at each cell's own size, above the
cell's limit (``gpu``: skipped without a card)."""
import json

import pytest
import torch

from zipbench.tests.tiny import REPO


def readings(root, cell, seeds, seconds, device):
    from zipbench.control import readings as run
    return run(["--workload", cell, "--seeds", ",".join(map(str, seeds)),
                "--seconds", str(seconds)], root=root, device=device)


def test_control_reads_wider_than_the_program(tiny_root):
    torch.set_num_threads(2)
    rs = readings(tiny_root, "tiny-dsv2-resident", [11, 12, 13], 1.0, "cpu")
    assert all(r["positions"] > 0 for r in rs)
    assert all(r["control_gap_max"] >= r["gap_max"] for r in rs), rs
    assert any(r["control_gap_max"] > r["gap_max"] for r in rs), rs


CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json")
                                       .read_text())["workloads"]
         if w["chips"] == 1]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cells_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limit = json.loads((REPO / "zipbench/workloads" / f"{cell}.json")
                       .read_text())["check"]["gap_max"]
    for r in readings(REPO, cell, [901], 8.0, None):
        assert r["gap_max"] <= limit < r["control_gap_max"], r
