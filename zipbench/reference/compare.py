"""The comparison that decides ``correct`` for a served model.

Each sampled sequence is fed to the reference once, teacher-forced on its
prompt and its served tokens.  At every position where the program served
a token, the gap is the reference's best logit minus the reference's logit
of the served token (0 when they agree); the run's number is the widest
gap.  The control reads, at the same positions, the gap of the token the
float8 reference puts first.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from .common import no_tf32


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """ref [N, V] float32 logits, chosen [N] token ids -> [N] gaps."""
    return ref.max(-1).values - ref.gather(-1, chosen[:, None])[:, 0]


def widest_gap(run: Callable, seqs: List[Dict], control: bool = False
               ) -> Dict[str, float]:
    """`run(seq, prec)` -> float32 logits [S, V] of one sequence; each seq
    has ``tokens`` [S] (what the reference is fed), ``first`` (the position
    whose logits chose the first served token) and ``served`` [N] (the
    served tokens, so positions first .. first + N - 1)."""
    worst, n, worst_ctl = 0.0, 0, 0.0
    with no_tf32(), torch.no_grad():
        for s in seqs:
            k, N = s["first"], len(s["served"])
            ref = run(s, "f32")[k:k + N]
            served = s["served"].to(ref.device)
            worst = max(worst, float(gaps(ref, served).max()))
            n += N
            if control:
                ctl = run(s, "fp8")[k:k + N]
                worst_ctl = max(worst_ctl,
                                float(gaps(ref, ctl.argmax(-1)).max()))
    out = {"gap_max": worst, "positions": float(n)}
    if control:
        out["control_gap_max"] = worst_ctl
    return out
