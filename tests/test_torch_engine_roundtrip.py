"""The engine's round trip for experts already in F (the full-weight pool):

* a job whose every tensor is in F completes inside ``submit_steps`` with
  no task table, and its collects hand back the F pool's own tensors;
* a collected F resident whose re-admission could not change the cache is
  not re-admitted (``readmit_skips``), and the cache still ends exactly as
  the JAX package's engine leaves it: pool membership and key order,
  transitions, evictions and ``cache_summary()``, after every step of a
  seeded trace of round trips made the way ``ZipServer._acquire_experts``
  makes them, with every expert in F and at a budget of F 2 / C 2 / S 2 /
  E 2 under a drifting popularity, where F residents are re-ranked and
  demoted; and a collected F resident whose rank has fallen below F's is
  demoted as the reference demotes it.
"""
import numpy as np
import pytest
import torch

from repro.core.engine import ZipMoEEngine as RefEngine
from repro.core.store import ExpertStore as RefStore
from repro.core.store import build_store as ref_build_store
from repro_torch.core.engine import ZipMoEEngine
from repro_torch.core.store import ExpertStore
from test_torch_models import both_params

STEPS = 20
BUDGET = {"F": 2, "C": 2, "S": 2, "E": 2}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, jparams, cfg, _ = both_params()
    d = str(tmp_path_factory.mktemp("store_rt"))
    ref_build_store(jparams, jcfg, d, k_shards=4)
    return cfg, d


def _state(eng):
    """Per layer: each pool's keys in order, transitions, evictions."""
    return {l: ({p: list(c.pools[p]) for p in c.order},
                dict(c.transitions), c.evictions)
            for l, c in sorted(eng.caches.items())}


def _trace(n_experts: int, n_layers: int, seed: int = 7):
    """Per step and layer: the selection (1–3 experts, skewed toward a hot
    set that drifts every 5 steps, so F residents fall in rank while a
    prediction still names them) and the next step's prediction (4
    experts)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(STEPS):
        w = 1.0 / (1.0 + (np.arange(n_experts) - 3 * (i // 5))
                   % n_experts) ** 1.2
        w /= w.sum()
        step = []
        for _ in range(n_layers):
            sel = sorted(int(e) for e in rng.choice(
                n_experts, int(rng.integers(1, 4)), replace=False, p=w))
            pred = [int(e) for e in rng.choice(n_experts, 4, replace=False,
                                               p=w)]
            step.append((sel, pred))
        out.append(step)
    return out


def _round_trip(eng, layer, pending, sel, pred):
    """One MoE layer's step as ``_acquire_experts`` makes it: pin, a
    demand job for what the pending prediction misses, ``result_subset``
    of the covered part, the demand job's ``result()``, the drain
    (``spec_result``), unpin, the next prediction's submission.  Returns
    the collects' io bytes and the next pending (handle, covered ids)."""
    io = []
    h, covered = pending.get(layer, (None, frozenset()))
    take = [e for e in sel if e in covered]
    missing = [e for e in sel if e not in covered]
    eng.pin_experts(layer, sel)
    eng.note_access(layer, take)
    h_m = eng.prefetch_experts(layer, missing) if missing else None
    if take:
        io.append(h.result_subset(take, layer=layer)[1].io_bytes)
    if h_m is not None:
        io.append(h_m.result()[1].io_bytes)
    if h is not None:
        io.append(h.spec_result()[1].io_bytes)
    eng.unpin_experts(layer, sel)
    pred = [e for e in pred if e not in sel]
    nxt = eng.submit_steps([(layer, [], pred)])
    pending[layer] = (nxt, frozenset(pred))
    return io


@pytest.mark.parametrize("kw", [
    dict(pool_sizes={"F": 8, "C": 0, "S": 0, "E": 0}, warm=True),
    dict(pool_sizes=BUDGET, warm=False),
    dict(pool_sizes=BUDGET, warm=False, cache_mode="flat", flat_capacity=3),
], ids=["resident", "budget", "flat"])
def test_round_trips_leave_the_reference_cache_state(setup, kw):
    cfg, d = setup
    kw = dict(kw)
    warm = kw.pop("warm")
    args = dict(n_experts=cfg.n_experts, n_layers=cfg.n_layers, L=2,
                device_cache=True, **kw)
    ref = RefEngine(RefStore(d), **args)
    eng = ZipMoEEngine(ExpertStore(d), device="cpu", **args)
    try:
        if warm:
            for l in range(cfg.n_layers):
                for e in (ref, eng):
                    e.fetch_experts(l, list(range(cfg.n_experts)))
        pend_p, pend_r = {}, {}
        t0 = eng.transfer_summary()
        for step in _trace(cfg.n_experts, cfg.n_layers):
            for layer, (sel, pred) in enumerate(step):
                io_p = _round_trip(eng, layer, pend_p, sel, pred)
                io_r = _round_trip(ref, layer, pend_r, sel, pred)
                assert io_p == io_r
                assert _state(eng) == _state(ref)
                assert eng.cache_summary(per_layer=True) == \
                    ref.cache_summary(per_layer=True)
        t = {k: v - t0[k] for k, v in eng.transfer_summary().items()
             if k in ("readmit_skips", "jobs_pure_hit", "jobs_submitted")}
        if kw.get("cache_mode") == "flat":
            assert t["readmit_skips"] == 0
        else:
            assert t["readmit_skips"] > 0
        if warm:
            assert t["jobs_pure_hit"] == t["jobs_submitted"] > 0
    finally:
        eng.shutdown()
        ref.shutdown()


def test_fallen_f_resident_is_demoted_as_the_reference_does(setup):
    """F holds 0 and 1; 2, 3 and 4 are then noted as selected until 0 and 1
    rank below F's threshold.  Collecting a prediction job of 0 and 1
    (a pure F hit) must re-admit them, as the reference does: no skip."""
    cfg, d = setup
    args = dict(n_experts=cfg.n_experts, n_layers=cfg.n_layers, L=2,
                device_cache=True, pool_sizes=BUDGET)
    ref = RefEngine(RefStore(d), **args)
    eng = ZipMoEEngine(ExpertStore(d), device="cpu", **args)
    try:
        for e in (ref, eng):
            e.fetch_experts(0, [0, 1])
            h = e.submit_steps([(0, [], [0, 1])])
            for _ in range(3):
                e.note_access(0, [2, 3, 4])
            e.pin_experts(0, [1])
            h.spec_result()
            e.unpin_experts(0, [1])
        assert eng.caches[0].target_pool(0) != "F"
        assert eng.readmit_skips == 0
        assert _state(eng) == _state(ref)
        assert eng.cache_summary(per_layer=True) == \
            ref.cache_summary(per_layer=True)
        assert 0 not in eng.caches[0].pools["F"]
    finally:
        eng.shutdown()
        ref.shutdown()


def _engine(setup, pools):
    cfg, d = setup
    return ZipMoEEngine(ExpertStore(d), n_experts=cfg.n_experts,
                        n_layers=cfg.n_layers, L=2, pool_sizes=pools,
                        device_cache=True, device="cpu")


def test_all_f_job_is_done_at_submit_without_tasks(setup):
    cfg, _ = setup
    eng = _engine(setup, {"F": 4, "C": 4, "S": 0, "E": 0})
    try:
        eng.fetch_experts(0, [0, 1, 2, 3])     # F holds 0..3
        fpool = eng.caches[0].pools["F"]
        assert set(fpool) == {0, 1, 2, 3}
        names = [t.name for t in eng.store.groups[(0, 0)].tensors]
        t0 = eng.transfer_summary()
        h = eng.submit_steps([(0, [1, 2], [0, 3])])
        job = h._job
        assert h.done() and job.demand_ev.is_set()
        assert job.tasks == [] and job.blocks == [] and job.prio == {}
        assert job.n_done == job.n_total == 4 * len(names)
        assert job.demand_done == job.demand_total == 2 * len(names)
        t1 = eng.transfer_summary()
        assert t1["jobs_submitted"] - t0["jobs_submitted"] == 1
        assert t1["jobs_pure_hit"] - t0["jobs_pure_hit"] == 1

        def own(out, ids):
            return all(out[e][nm] is fpool[e].payload.full[i]
                       for e in ids for i, nm in enumerate(names))

        w, st = h.result_subset([2], layer=0)
        assert st.io_bytes == 0 and own(w, [2])
        w, st = h.result()
        assert st.io_bytes == 0 and own(w, [1, 2])
        w, st = h.spec_result()
        assert st.io_bytes == 0 and own(w, [0, 1, 2, 3])
        assert set(fpool) == {0, 1, 2, 3}
        assert eng.readmit_skips > 0
        assert eng.transfer_summary()["jobs_pure_hit"] == \
            t1["jobs_pure_hit"]

        # one expert outside F: the whole job takes the full path
        h = eng.submit_steps([(0, [1], [5])])
        job = h._job
        assert len(job.tasks) == 2 * len(names) and job.blocks
        assert job.uids.keys() == {(0, 1), (0, 5)}
        h.spec_result()
        t2 = eng.transfer_summary()
        assert t2["jobs_pure_hit"] == t1["jobs_pure_hit"]
        assert t2["jobs_submitted"] == t1["jobs_submitted"] + 1
    finally:
        eng.shutdown()
