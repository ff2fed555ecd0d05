"""Share of the profiled sub-window's wall time in which no operation
(kernel, copy or memset) ran on the compute card, from the profiler's
trace, %."""
from zipbench.trace import busy_intervals


def read(v):
    view = v.device
    if view is None or not view["ops"]:
        return None
    busy = sum(e - s for s, e in busy_intervals(view["ops"], 0))
    return 100.0 * (1.0 - busy / (view["t1"] - view["t0"]))
