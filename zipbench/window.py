"""The measured window and the end-to-end metrics read from it.

Times are the harness's ``perf_counter`` stamps: a token is stamped when it
reaches the host, a request when the harness issues it.  The window is
``[t_open, t_open + seconds]``; a token counts when its stamp falls inside.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Req:
    issued: float
    in_window: bool
    tokens: List[float] = field(default_factory=list)
    error: Optional[str] = None


@dataclass
class Step:
    end: float
    kv_lens: List[int]
    server_s: float = 0.0        # host time outside the program's step call


class Window:
    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.t_open: Optional[float] = None
        self.closed = False
        self.reqs: Dict[object, Req] = {}
        self.steps: List[Step] = []

    @property
    def t_close(self) -> float:
        return self.t_open + self.seconds

    def open(self, now: float):
        self.t_open = now

    def inside(self, t: float) -> bool:
        return self.t_open is not None and self.t_open < t <= self.t_close

    def issue(self, rid, now: float):
        self.reqs[rid] = Req(now, self.t_open is not None and not self.closed
                             and now >= self.t_open)

    def token(self, rid, now: float):
        self.reqs[rid].tokens.append(now)

    def fail(self, rid, why: str):
        self.reqs[rid].error = why

    def window_steps(self) -> List[Step]:
        return [s for s in self.steps if self.inside(s.end)]

    def trend(self, parts: int = 4) -> str:
        """Steps and output tokens in each of `parts` equal slices of the
        window: a slice that differs from the others shows warm-up or drift
        inside the window."""
        edges = [self.t_open + self.seconds * i / parts
                 for i in range(parts + 1)]
        out = []
        for a, b in zip(edges, edges[1:]):
            n = sum(1 for s in self.steps if a < s.end <= b)
            toks = sum(1 for r in self.reqs.values() for t in r.tokens
                       if a < t <= b)
            out.append(f"{n} steps/{toks} tok")
        return f"{len(self.window_steps())} steps; slices: " + ", ".join(out)


    # ---- end-to-end metrics ------------------------------------------
    def out_tokens(self) -> int:
        return sum(1 for r in self.reqs.values() for t in r.tokens
                   if self.inside(t))

    def out_tok_s(self) -> float:
        return self.out_tokens() / self.seconds

    def itl_ms(self) -> List[float]:
        """Every gap between two consecutive tokens of one request, both
        inside the window."""
        out = []
        for r in self.reqs.values():
            ts = [t for t in r.tokens if self.inside(t)]
            out += [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]
        return out

    def ttft_ms(self) -> List[Optional[float]]:
        """Issue to first token of every request issued inside the window
        (None: it never got one)."""
        return [(r.tokens[0] - r.issued) * 1e3 if r.tokens else None
                for r in self.reqs.values() if r.in_window]

    def attempted(self) -> int:
        return sum(1 for r in self.reqs.values() if r.in_window)

    def failed(self) -> int:
        return sum(1 for r in self.reqs.values() if r.in_window
                   and (r.error is not None or not r.tokens))


def p95(xs) -> float:
    """95th percentile (inclusive quantiles of the sample, as Python's
    ``statistics.quantiles(method="inclusive")`` gives them)."""
    xs = sorted(xs)
    if len(xs) == 1:
        return float(xs[0])
    return float(statistics.quantiles(xs, n=20, method="inclusive")[18])


def end_to_end(win: Window, setup_s: float) -> Dict[str, float]:
    """Every end-to-end metric the window can give (the cell keeps its
    own).  A request that got no token has no TTFT: it is counted in
    ``failed``, and a run with a failed request is not correct."""
    out = {"setup_s": setup_s, "out_tok_s": win.out_tok_s()}
    itl = win.itl_ms()
    if itl:
        out["itl_p95_ms"] = p95(itl)
    ttft = [t for t in win.ttft_ms() if t is not None]
    if ttft:
        out["ttft_p95_ms"] = p95(ttft)
    return out

