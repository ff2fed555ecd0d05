"""The readers of ``tools/span_split.py`` on hand-made span records: the
per-step sums and the self time of ``zs.decode_rows`` where children
overlap and where they leave gaps; the benchmark's ``idle_gaps`` naming a
gap by a program span nested in its own ``zb.decode_rows``, never by a
worker thread's span; the clock check of ``moe.route.sync`` against the
trace's ``cudaMemcpyAsync`` events; the window's kernel launches beside
``zs.attn``, per step and per MLA layer-step."""
import pytest

from repro_torch.core import spans
from repro_torch.configs import get_smoke_config
from tools.span_split import (attn_launches, clock_check, per_step,
                              program_spans)
from zipbench.trace import idle_gaps

MAIN, WORKER = 1, 2
MS = 1_000_000                      # ns


def _rec(name, start, end, sid, parent=0, tid=MAIN):
    r = spans.Span.__new__(spans.Span)
    r.name, r.start, r.end, r.id, r.parent = name, start, end, sid, parent
    r.tid, r.step, r.attr, r.rids = tid, 1, -1, ()
    return r


def _step(base, sid, kids):
    """One step at `base` ms: ``zs.decode_rows`` over [base, base + 20] ms
    with `kids` (name, start, end) in ms relative to it."""
    recs = [_rec("zs.decode_rows", base * MS, (base + 20) * MS, sid)]
    for i, (n, s, e) in enumerate(kids):
        recs.append(_rec(n, (base + s) * MS, (base + e) * MS, sid + 1 + i,
                         parent=sid))
    return recs


@pytest.mark.parametrize("kids,untraced", [
    # children leave gaps: 20 - (4 + 5 + 6) ms untraced
    ([("zs.attn", 0, 4), ("zs.moe", 6, 11), ("zs.head", 13, 19)], 5.0),
    # overlapping children count once: union [1, 12] and [14, 20]
    ([("zs.attn", 1, 8), ("zs.moe", 5, 12), ("zs.head", 14, 20)], 3.0),
    # a child past its parent's end is clipped to it
    ([("zs.attn", 0, 10), ("zs.moe", 10, 25)], 0.0),
])
def test_per_step_self_time(kids, untraced):
    recs = _step(0, 1, kids) + _step(100, 20, kids)
    got, covered = per_step(recs, 2, MAIN)
    assert got["decode_rows"] == pytest.approx(20.0)
    assert got["decode_untraced"] == pytest.approx(untraced)
    assert covered == pytest.approx(1.0 - untraced / 20.0)


def test_per_step_sums():
    recs = _step(0, 1, [("zs.attn", 0, 3), ("zs.moe", 3, 19)])
    recs += [_rec("moe.route.sync", 3 * MS, 4 * MS, 10, parent=3),
             _rec("moe.csr", 4 * MS, 5 * MS, 11, parent=3),
             _rec("moe.gemm", 5 * MS, 7 * MS, 12, parent=3),
             _rec("moe.combine", 7 * MS, 8 * MS, 13, parent=3),
             _rec("moe.access", 8 * MS, 9 * MS, 14, parent=3),
             _rec("engine.collect", 10 * MS, 12 * MS, 15, parent=3),
             # a worker's collect is not the decode thread's
             _rec("engine.collect", 10 * MS, 13 * MS, 16, parent=3,
                  tid=WORKER),
             _rec("kv.gather", 0, MS // 2, 17),
             _rec("kv.commit", 21 * MS, 22 * MS, 18)]
    got, _ = per_step(recs, 2, MAIN)
    assert got["route_sync"] == pytest.approx(0.5)
    assert got["attn_host"] == pytest.approx(1.5)
    assert got["moe_host"] == pytest.approx(2.5)
    assert got["engine_collect"] == pytest.approx(1.0)
    assert got["kv_pages"] == pytest.approx(0.75)


@pytest.mark.parametrize("arch,layers", [("deepseekv2-lite", 3),
                                         ("jamba-v0.1-52b", 1)])
def test_attn_launches(arch, layers):
    """Launches per window step, and for an MLA config the MLA decode
    kernels' per attention layer and step: 1 each when every MLA
    layer-step ran them; a GQA config (jamba: one attention layer of 8)
    gets no MLA split."""
    cfg = get_smoke_config(arch, n_layers=3 if layers == 3 else 8)
    steps = 10
    delta = {"slab_gemm": 60, "mla_rope_write": steps * layers,
             "mla_absorbed_attend": steps * layers}
    got = attn_launches(delta, steps, cfg, attn_ms=1.25)
    assert got["zs.attn_ms_per_step"] == 1.25
    assert got["launches_per_step"] == {"slab_gemm": 6.0,
                                        "mla_rope_write": layers,
                                        "mla_absorbed_attend": layers}
    if cfg.attn == "mla":
        assert got["mla_layers"] == layers
        assert got["launches_per_layer_step"] == {
            "mla_rope_write": 1.0, "mla_absorbed_attend": 1.0}
    else:
        assert "launches_per_layer_step" not in got
    # a program without the kernels (a parent checkout): no split to read
    parent = attn_launches({"slab_gemm": 60}, steps, cfg)
    assert parent.get("launches_per_layer_step", {}) == {}


def _view(spans_):
    """A profiled sub-window [0, 1000] us, busy except [100, 400] and
    [600, 650]."""
    return {"t0": 0.0, "t1": 1000.0,
            "ops": [("k", 0.0, 100.0, 0), ("k", 400.0, 600.0, 0),
                    ("k", 650.0, 1000.0, 0)],
            "spans": spans_}


def test_idle_gap_named_by_nested_program_span():
    """Before: the harness's span names every gap.  With the program's
    spans joined, a gap takes the innermost one, never a worker's."""
    own = [("zb.decode_rows", 50.0, 900.0)]
    assert {n for n, _ in idle_gaps(_view(own))} == {"zb.decode_rows"}
    # on the perf_counter clock: the sub-window starts at a = 10 s
    a = 10.0
    recs = [_rec("zs.moe", int((a + 90e-6) * 1e9), int((a + 500e-6) * 1e9),
                 1),
            _rec("acquire.wait", int((a + 95e-6) * 1e9),
                 int((a + 450e-6) * 1e9), 2, parent=1),
            _rec("moe.csr", int((a + 590e-6) * 1e9),
                 int((a + 700e-6) * 1e9), 3),
            # a worker's span opens last, inside both gaps
            _rec("engine.decompress", int((a + 99e-6) * 1e9),
                 int((a + 640e-6) * 1e9), 4, tid=WORKER),
            # outside the sub-window: left out
            _rec("zs.attn", int((a - 1.0) * 1e9), int((a + 1e-6) * 1e9), 5)]
    joined = program_spans(recs, MAIN, a, a + 1e-3)
    assert [n for n, _, _ in joined] == ["zs.moe", "acquire.wait",
                                         "moe.csr"]
    placed = [(n, (s - a) * 1e6, (e - a) * 1e6) for n, s, e in joined]
    gaps = idle_gaps(_view(own + placed))
    assert [n for n, _ in gaps] == ["acquire.wait", "moe.csr"]
    assert gaps[0][1] == pytest.approx(300e-6)


def test_clock_check():
    a, b, t0 = 5.0, 5.01, 1_000.0        # s, s, us

    def sync(sid, s_us, e_us):
        return _rec("moe.route.sync", int((a + s_us * 1e-6) * 1e9),
                    int((a + e_us * 1e-6) * 1e9), sid)

    recs = [sync(1, 100, 200), sync(2, 300, 400), sync(3, 500, 510),
            sync(4, 20_000, 20_100)]      # after the sub-window: left out
    events = [{"ph": "X", "name": "cudaMemcpyAsync", "ts": t0 + 110,
               "dur": 20},
              {"ph": "X", "name": "cudaMemcpyAsync", "ts": t0 + 330,
               "dur": 30},
              # starts inside span 3 but ends after it: not contained
              {"ph": "X", "name": "cudaMemcpyAsync", "ts": t0 + 505,
               "dur": 20},
              {"ph": "X", "name": "cudaLaunchKernel", "ts": t0 + 501,
               "dur": 2}]
    got = clock_check(recs, events, a, b, t0)
    assert got["spans"] == 3
    assert got["share"] == pytest.approx(2 / 3)
    assert got["median_offset_us"] == pytest.approx(20.0)


def test_clock_fit_and_end_anchor():
    """Spans placed 330-410 us early against their copies: none contains
    one as placed; the fit's range is the shifts that make all do.  The
    closing synchronize ends 350 us after where the opening one puts it:
    moved by that, every span contains its copy."""
    a, t0 = 5.0, 0.0
    recs = [_rec("moe.route.sync", int((a + s * 1e-6) * 1e9),
                 int((a + (s + 100) * 1e-6) * 1e9), i)
            for i, s in enumerate((100, 1100, 2100))]
    events = [{"ph": "X", "name": "cudaMemcpyAsync", "ts": s + 410,
               "dur": 20} for s in (100, 1100, 2100)]
    events += [{"ph": "X", "name": "cudaDeviceSynchronize", "ts": 0.0,
                "dur": 5.0},
               {"ph": "X", "name": "cudaDeviceSynchronize",
                "ts": 1e6 + 340.0, "dur": 10.0}]
    got = clock_check(recs, events, a, a + 1.0, t0)
    assert got["share"] == 0.0
    lo, hi = got["fit_us"]
    assert lo == pytest.approx(330, abs=1) and hi == pytest.approx(410, abs=1)
    assert got["fit_share"] == 1.0
    assert got["end_shift_us"] == pytest.approx(350.0)
    assert got["end_share"] == 1.0
    assert got["end_median_offset_us"] == pytest.approx(60.0, abs=1e-3)
