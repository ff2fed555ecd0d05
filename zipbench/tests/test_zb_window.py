"""The window arithmetic: an injected stall moves every end-to-end metric
the way a user would feel it."""
from zipbench.window import Window, end_to_end, p95


def serve(stall_at=None, stall_s=0.0):
    """Synthetic closed loop: 2 clients, steps of 10 ms, requests of 20
    tokens; a stall of `stall_s` before step `stall_at`."""
    w = Window(2.0)
    t, rid, active = 0.0, 0, {}
    w.open(0.0)
    for c in range(2):
        active[c] = rid
        w.issue(rid, t)
        rid += 1
    step = 0
    while t < 2.5:
        if step == stall_at:
            t += stall_s
        t += 0.01
        step += 1
        for c, r in list(active.items()):
            w.token(r, t)
            if len(w.reqs[r].tokens) == 20:
                active[c] = rid
                w.issue(rid, t)
                rid += 1
    w.closed = True
    return end_to_end(w, 1.0)


def test_stall_moves_every_metric():
    base, stalled = serve(), serve(stall_at=60, stall_s=0.5)
    assert base["out_tok_s"] > stalled["out_tok_s"]
    assert stalled["itl_p95_ms"] >= base["itl_p95_ms"]
    assert stalled["ttft_p95_ms"] > base["ttft_p95_ms"]
    assert abs(base["out_tok_s"] - 200) <= 2     # 2 rows x 100 steps/s


def test_many_short_stalls_lift_the_tail():
    base = serve()
    w = Window(2.0)
    w.open(0.0)
    w.issue(0, 0.0)
    t = 0.0
    for i in range(300):
        t += 0.01 + (0.05 if i % 10 == 0 else 0.0)
        w.token(0, t)
    w.closed = True
    m = end_to_end(w, 1.0)
    assert m["itl_p95_ms"] > base["itl_p95_ms"] * 2


def test_tokens_outside_the_window_do_not_count():
    w = Window(1.0)
    w.issue("early", 0.0)
    w.token("early", 0.5)
    w.open(1.0)
    w.issue("a", 1.0)
    for t in (1.2, 1.4, 2.0, 2.3):
        w.token("a", t)
    w.closed = True
    assert w.out_tokens() == 3
    assert [round(x, 6) for x in w.itl_ms()] == [200.0, 600.0]
    assert w.attempted() == 1 and w.failed() == 0
    assert [round(x, 6) for x in w.ttft_ms()] == [200.0]


def test_p95_inclusive():
    assert p95(range(1, 101)) == 95.05
    assert p95([7.0]) == 7.0
