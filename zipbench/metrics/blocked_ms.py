"""Host time a decode step spent blocked on expert reconstruction: the sum
of ``ZipServer.stats[*]["blocked_s"]`` over the window's layer-steps, per
window step, ms."""


def read(v):
    if not v.steps or not v.stats:
        return None
    return sum(s["blocked_s"] for s in v.stats) / len(v.steps) * 1e3
