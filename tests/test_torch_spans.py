"""Spans and counters of the port's decode step (``core/spans``), on the
CPU at the smoke size ``tests/test_torch_batching.py`` serves
(qwen2-moe-a2.7b, 2 layers, d_model 128, 8 experts top-2).

* Off, a step records nothing, every site returns the one shared no-op
  context, reads no clock of the recorder's and allocates nothing.
* On, the served tokens and logits are bit-identical to a run with the
  recorder off, and one continuous-batching step yields the named tree:
  each MoE layer's router readback, acquire, wait, CSR build, GEMM and
  combine, each child inside its parent on its thread, ``server.step``
  listing its rows' request ids.
* ``acquire.wait`` and ``blocked_s`` share their clock readings.
* Under a budget that forces reconstruction, the workers' spans name the
  ``engine.submit`` span of their job as parent.
* The cap counts drops; ``subset_wait_timeouts`` reads 0.
* ``split`` (the ``spans:`` line of the CLI) and self time on hand-made
  records.
* ``BatchServer``: TTFT from the due time, per-token stamps, the pooled
  inter-token-gap tail.
"""
import itertools
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import spans
from repro_torch.core.store import build_store
from repro_torch.models import init_params
from repro_torch.serving.server import BatchServer
from repro_torch.serving.zipserve import ZipServer

MODES = {
    # every expert held in the slab and warmed: every job an F hit
    "resident": dict(device_cache=True,
                     pool_sizes={"F": 8, "C": 0, "S": 0, "E": 0}),
    # one slot a pool: experts are read, decompressed and uploaded
    "budget": dict(device_cache=True,
                   pool_sizes={"F": 1, "C": 1, "S": 1, "E": 1}),
    "budget-host": dict(pool_sizes={"F": 1, "C": 1, "S": 1, "E": 1}),
}
ROUND_TRIPS = ("jobs_submitted", "jobs_pure_hit", "subset_waits",
               "subset_wait_timeouts", "readmit_skips")
MOE_CHILDREN = ("moe.route", "moe.route.sync", "moe.access", "moe.acquire",
                "moe.csr", "moe.gemm", "moe.combine", "moe.shared")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = get_smoke_config("qwen2-moe-a2.7b", n_layers=2)
    params = init_params(cfg, seed=0, device="cpu")
    d = str(tmp_path_factory.mktemp("store_spans"))
    build_store(params, cfg, d, device="cpu")
    return cfg, params, d


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


def _server(setup, mode):
    cfg, params, d = setup
    zs = ZipServer(params, cfg, d, L=2, device="cpu", **MODES[mode])
    if mode == "resident":
        for layer in zs._moe_layers:
            zs.engine.fetch_experts(layer, list(range(cfg.n_experts)))
    return zs


def _serve(setup, mode, on: bool, n_req=3, max_new=3):
    """Requests through ``BatchServer`` with the recorder `on` or off:
    (requests by rid, records, ZipServer stats, the run's round-trip
    counters of ``transfer_summary()``)."""
    cfg, params, _ = setup
    zs = _server(setup, mode)
    try:
        srv = BatchServer(params, cfg, max_batch=n_req, max_len=24,
                          zip_server=zs)
        rng = np.random.default_rng(7)
        for i in range(n_req):
            srv.submit(rng.integers(0, cfg.vocab_size, 2 + i), max_new,
                       record_logits=True)
        tr0 = zs.engine.transfer_summary()
        if on:
            spans.enable()
        try:
            srv.run()
        finally:
            spans.disable()
        tr = zs.engine.transfer_summary()
        return ({r.rid: r for r in srv.finished}, spans.take(),
                list(zs.stats), {k: tr[k] - tr0[k] for k in ROUND_TRIPS})
    finally:
        zs.close()


def _by_id(records):
    return {r.id: r for r in records}


# ---- off --------------------------------------------------------------------
def test_off_records_nothing_and_shares_one_noop(setup):
    zs = _server(setup, "resident")
    try:
        tok = torch.zeros(2, 1, dtype=torch.long)
        zs.decode_rows(tok, zs.init_cache(2, 4), np.asarray([0, 1]),
                       owners=[1, 2])
    finally:
        zs.close()
    assert spans.take() == []
    assert spans.span("moe.csr") is spans.span("zs.attn", 1) \
        is spans.step_span("server.step") is spans.adopt(5, 2, 1, 3) \
        is spans.NOOP
    assert spans.NOOP.id == 0 and spans.NOOP.step == 0


class _NoClock:
    @staticmethod
    def perf_counter_ns():
        raise AssertionError("the recorder read its clock while off")


def test_off_path_reads_no_clock_and_allocates_nothing(setup, monkeypatch):
    """Off, a whole step runs past every site without the recorder's
    clock; and the sites, as the program calls them, allocate nothing."""
    monkeypatch.setattr(spans, "time", _NoClock)
    _serve(setup, "budget", on=False, n_req=2, max_new=2)
    st = [1, 2]

    def sites(n):
        for _ in itertools.repeat(None, n):
            with spans.span("zs.moe", 1):
                pass
            sp = spans.span("acquire.wait", start=7)
            sp.close(9)
            with spans.adopt(3, 4, 1, 5), spans.span("engine.io.read"):
                pass
            with spans.step_span("server.step") as s:
                s.tag(st)

    def peak(n):
        """Bytes allocated at the peak of `n` passes over the sites."""
        sites(n)                              # warm every code path
        tracemalloc.start()
        try:
            before = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            sites(n)
            return tracemalloc.get_traced_memory()[1] - before
        finally:
            tracemalloc.stop()

    # the `with` statements' own bytes do not grow with the passes
    assert peak(10) == peak(5000)


# ---- on -----------------------------------------------------------------------
@pytest.mark.parametrize("mode", sorted(MODES))
def test_on_is_bit_identical_to_off(setup, mode):
    off, rec_off, _, _ = _serve(setup, mode, on=False)
    on, rec_on, _, _ = _serve(setup, mode, on=True)
    assert rec_off == [] and rec_on
    assert off.keys() == on.keys()
    for rid in off:
        assert off[rid].output == on[rid].output, rid
        assert len(off[rid].logits) == len(on[rid].logits) > 0
        for a, b in zip(off[rid].logits, on[rid].logits):
            assert np.array_equal(a, b), rid


@pytest.mark.parametrize("mode", sorted(MODES))
def test_step_tree(setup, mode):
    cfg = setup[0]
    reqs, recs, stats, _ = _serve(setup, mode, on=True)
    by_id = _by_id(recs)
    main = threading.get_ident()
    kids = spans.children(recs)
    steps = [r for r in recs if r.name == "server.step"]
    assert steps and all(r.tid == main for r in steps)
    # every same-thread child lies inside its parent
    for r in recs:
        p = by_id.get(r.parent)
        if p is not None and p.tid == r.tid:
            assert p.start <= r.start <= r.end <= p.end, (p, r)
            assert r.step == p.step
    served = set()
    for st in steps:
        assert st.rids and all(rid in reqs for rid in st.rids)
        served.update(st.rids)
        names = [k.name for k in kids[st.id]]
        assert names[0] == "server.admit" and names[-1] == "server.retire"
        assert {"kv.gather", "kv.commit", "server.sample"} <= set(names)
        sample = next(k for k in kids[st.id] if k.name == "server.sample")
        assert [k.name for k in kids[sample.id]] == ["server.sample.sync"]
    assert served == set(reqs)
    rows = [r for r in recs if r.name == "zs.decode_rows"]
    assert len(rows) == len(steps)
    moe_layers = [i for i in range(cfg.n_layers) if cfg.moe_layer(i)]
    for zr in rows:
        assert by_id[zr.parent].name == "server.step"
        assert zr.step == by_id[zr.parent].step
        names = [(k.name, k.attr) for k in kids[zr.id]]
        want = [("zs.embed", -1)]
        for i in range(cfg.n_layers):
            want.append(("zs.attn", i))
            want.append(("zs.moe" if i in moe_layers else "zs.mlp", i))
        want += [("zs.head", -1), ("zs.tail", -1)]
        assert names == want
        for moe in (k for k in kids[zr.id] if k.name == "zs.moe"):
            sub = {k.name: k for k in kids[moe.id]}
            assert set(MOE_CHILDREN) <= sub.keys(), sorted(sub)
            assert all(k.attr == moe.attr for k in kids[moe.id])
            acq = [k.name for k in kids[sub["moe.acquire"].id]]
            assert {"acquire.issue", "acquire.wait"} <= set(acq)
    assert len(stats) == len(rows) * len(moe_layers)


@pytest.mark.parametrize("mode", ["resident", "budget"])
def test_acquire_wait_is_blocked_s(setup, mode):
    """With prediction jobs pending (``acquire.pin`` present), each
    ``acquire.wait`` lasts exactly the layer-step's ``blocked_s``.  With
    none, ``blocked_s`` is the demand job's wall: it starts at the job's
    ``engine.submit`` span (under ``acquire.issue``) and ends, at the
    latest, when ``acquire.wait`` (its ``result()``) does."""
    _, recs, stats, _ = _serve(setup, mode, on=True)
    by_id, kids = _by_id(recs), spans.children(recs)
    acquires = sorted((r for r in recs if r.name == "moe.acquire"),
                      key=lambda r: r.start)
    assert len(acquires) == len(stats)
    branches = set()
    for acq, st in zip(acquires, stats):
        assert acq.attr == st["layer"]
        sub = {k.name: k for k in kids[acq.id]}
        wait = sub["acquire.wait"]
        if "acquire.pin" in sub:
            branches.add("pending")
            assert (wait.end - wait.start) / 1e9 == st["blocked_s"]
        else:
            branches.add("none")
            issue = sub["acquire.issue"]
            submit = next(k for k in kids[issue.id]
                          if k.name == "engine.submit")
            assert submit.start + st["blocked_s"] * 1e9 <= wait.end + 1e3
            assert st["blocked_s"] >= 0.0
        assert by_id[wait.parent] is acq
    assert branches == {"pending", "none"}


@pytest.mark.parametrize("mode", ["budget", "budget-host"])
def test_worker_spans_name_their_submission(setup, mode):
    cfg = setup[0]
    _, recs, _, _ = _serve(setup, mode, on=True)
    by_id = _by_id(recs)
    main = threading.get_ident()
    work = [r for r in recs if r.tid != main]
    names = {r.name for r in work}
    assert {"engine.io.read", "engine.decompress"} <= names, names
    if mode == "budget":
        assert "engine.upload" in names
    for r in work:
        sub = by_id[r.parent]
        assert sub.name == "engine.submit" and sub.tid == main
        assert r.step == sub.step
        layer, expert = spans.key_of(r.attr)
        assert cfg.moe_layer(layer) and 0 <= expert < cfg.n_experts
    assert all(r.step > 0 for r in work)


def test_cap_counts_drops(setup):
    _, full, _, _ = _serve(setup, "resident", on=True)
    cfg, params, _ = setup
    zs = _server(setup, "resident")
    try:
        srv = BatchServer(params, cfg, max_batch=3, max_len=24,
                          zip_server=zs)
        rng = np.random.default_rng(7)
        for i in range(3):
            srv.submit(rng.integers(0, cfg.vocab_size, 2 + i), 3)
        spans.enable(cap=10)
        srv.run()
        spans.disable()
    finally:
        zs.close()
    kept = spans.take()
    assert len(kept) == 10
    assert spans.dropped() == len(full) - 10 > 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_round_trip_counters(setup, mode):
    _, _, _, tr = _serve(setup, mode, on=False)
    assert tr["subset_wait_timeouts"] == 0
    assert tr["jobs_submitted"] > 0
    if mode == "resident":
        assert tr["jobs_pure_hit"] == tr["jobs_submitted"]
        assert tr["subset_waits"] == 0
        assert tr["readmit_skips"] > 0
    else:
        assert tr["jobs_pure_hit"] < tr["jobs_submitted"]


# ---- reading the records --------------------------------------------------------
def _rec(name, start, end, sid, parent=0, tid=1):
    r = spans.Span.__new__(spans.Span)
    r.name, r.start, r.end, r.id, r.parent = name, start, end, sid, parent
    r.tid, r.step, r.attr, r.rids = tid, 1, -1, ()
    return r


@pytest.mark.parametrize("kids,covered", [
    ([], 0),
    ([(10, 20), (30, 40)], 20),            # gaps between children
    ([(10, 30), (20, 40)], 30),            # overlapping children
    ([(0, 50), (10, 20)], 50),             # nested: counted once
    ([(-5, 10), (90, 120)], 20),           # clipped to the parent
])
def test_covered_and_self_time(kids, covered):
    parent = _rec("zs.decode_rows", 0, 100, 1)
    recs = [parent] + [_rec("zs.attn", s, e, 2 + i, parent=1)
                       for i, (s, e) in enumerate(kids)]
    assert spans.covered_ns(parent, recs[1:]) == covered
    assert spans.self_ns(parent, spans.children(recs)) == 100 - covered


def test_split_per_step():
    recs = [_rec("server.step", 0, 200, 1), _rec("zs.decode_rows", 10, 110,
                                                   2, parent=1),
            _rec("zs.attn", 20, 50, 3, parent=2),
            _rec("zs.moe", 60, 100, 4, parent=2),
            # a worker's span names a decode-thread span: not a child
            _rec("engine.io.read", 0, 100, 5, parent=2, tid=2),
            _rec("server.step", 200, 300, 6)]
    got = spans.split(recs)
    assert got["steps"] == 2
    assert got["zs.decode_rows"] == 100 / 2 / 1e6
    assert got["zs.decode_rows.self"] == (100 - 70) / 2 / 1e6
    assert spans.split([]) == {"steps": 0}


# ---- BatchServer: due-time TTFT, per-token stamps --------------------------------
def test_ttft_counts_from_the_due_time(setup):
    """A request due 0.5 s after the run starts: its TTFT counts from
    then, not from ``submit()``."""
    cfg, params, _ = setup
    zs = _server(setup, "resident")
    try:
        srv = BatchServer(params, cfg, max_batch=2, max_len=24,
                          zip_server=zs)
        rng = np.random.default_rng(3)
        srv.submit(rng.integers(0, cfg.vocab_size, 3), 4, arrival_s=0.5)
        srv.submit(rng.integers(0, cfg.vocab_size, 2), 4, arrival_s=0.5)
        srv.run()
    finally:
        zs.close()
    m = srv.metrics()
    for r in srv.finished:
        assert len(r.token_s) == len(r.output) == 4
        assert r.due >= r.submitted + 0.5 - 1e-3
        assert r.ttft == r.token_s[0] - r.due
        assert r.token_s[0] - r.submitted > r.ttft + 0.45
        assert r.tpot_s == (r.done - r.token_s[0]) / 3
    gaps = [b - a for r in srv.finished
            for a, b in zip(r.token_s, r.token_s[1:])]
    assert m["itl_p95_s"] == float(np.percentile(gaps, 95))
    assert m["ttft_p95_s"] <= max(r.ttft for r in srv.finished)
