"""Host time a decode step spent routing: the sum of
``ZipServer.stats[*]["route_s"]`` (from ``moe.route``'s start to
``moe.route.sync``'s end: the router product, the top-k and their
readback to the host) over the window's layer-steps, per window step, ms.
None where the program keeps no such counter."""


def read(v):
    if not v.steps or not v.stats or "route_s" not in v.stats[0]:
        return None
    return sum(s["route_s"] for s in v.stats) / len(v.steps) * 1e3
