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
  demoted as the reference demotes it;
* while a layer cache's epoch stands, a pure hit's collects hand back its
  F payloads' tensors and skip the slab reconcile with no walk
  (``collect_fast_keys``, ``reconcile_skips``); after each change that
  bumps the epoch, a pending pure hit takes the full walk and the cache
  still ends as the reference's.
"""
import numpy as np
import pytest
import torch

from repro.core.engine import ZipMoEEngine as RefEngine
from repro.core.planner import LayerPlan as RefLayerPlan
from repro.core.store import ExpertStore as RefStore
from repro.core.store import build_store as ref_build_store
from repro_torch.core.engine import ZipMoEEngine
from repro_torch.core.planner import LayerPlan
from repro_torch.core.slab import SlotRef
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


def _settled(h):
    """`h` once its job is done: a collect's io bytes then count all of
    the job's reads, however far the workers had got by the call."""
    assert h._job.done_ev.wait(60.0), "fetch job still running"
    return h


def _held_refs(eng, layer, weights):
    """Every SlotRef in `weights` is valid, and where its expert is in F
    it is the F payload's own ref for that tensor."""
    fpool = eng.caches[layer].pools["F"]
    for e, w in weights.items():
        names = [t.name for t in eng.store.groups[(layer, e)].tensors]
        ent = fpool.get(e)
        for tidx, nm in enumerate(names):
            v = w[nm]
            if not isinstance(v, SlotRef):
                continue
            assert v.valid, (layer, e, nm)
            if ent is not None:
                assert ent.payload.full[tidx] == v, (layer, e, nm)


def _round_trip(eng, layer, pending, sel, pred, check=None):
    """One MoE layer's step as ``_acquire_experts`` makes it: pin, a
    demand job for what the pending prediction misses, ``result_subset``
    of the covered part, the demand job's ``result()``, the drain
    (``spec_result``), unpin, the next prediction's submission.  Each
    collect's weights go to `check`.  Returns the collects' io bytes and
    the next pending (handle, covered ids)."""
    io = []
    h, covered = pending.get(layer, (None, frozenset()))
    take = [e for e in sel if e in covered]
    missing = [e for e in sel if e not in covered]
    eng.pin_experts(layer, sel)
    eng.note_access(layer, take)
    h_m = eng.prefetch_experts(layer, missing) if missing else None
    if take:
        w, st = _settled(h).result_subset(take, layer=layer)
        io.append(st.io_bytes)
        if check is not None:
            check(eng, layer, w)
    if h_m is not None:
        w, st = h_m.result()
        io.append(st.io_bytes)
        if check is not None:
            check(eng, layer, w)
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
                io_p = _round_trip(eng, layer, pend_p, sel, pred,
                                   check=_held_refs)
                io_r = _round_trip(ref, layer, pend_r, sel, pred)
                assert io_p == io_r
                assert _state(eng) == _state(ref)
                assert eng.cache_summary(per_layer=True) == \
                    ref.cache_summary(per_layer=True)
        t = {k: v - t0[k] for k, v in eng.transfer_summary().items()
             if k in ("readmit_skips", "jobs_pure_hit", "jobs_submitted",
                      "collect_keys", "collect_fast_keys",
                      "reconcile_skips")}
        if kw.get("cache_mode") == "flat":
            assert t["readmit_skips"] == 0
        else:
            assert t["readmit_skips"] > 0
        if warm:
            assert t["jobs_pure_hit"] == t["jobs_submitted"] > 0
            # nothing moves the epochs: every key and reconcile skips
            assert t["collect_fast_keys"] == t["collect_keys"] > 0
            assert t["reconcile_skips"] > 0
        else:
            assert t["collect_fast_keys"] < t["collect_keys"]
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


def _grow_f(e, plan_cls):
    """``apply_plans`` with F grown to 6 slots: the cache is resized and
    the layer's slab re-sized (residents migrate, the old slab retires)."""
    f = e._bytes_per_state(0)["F"]
    sizes = {"F": 6, "C": 2, "S": 2, "E": 2}
    e.apply_plans({0: plan_cls(layer=0, sizes=sizes,
                               cap_bytes={p: n * f for p, n in sizes.items()},
                               ratios={}, cost=0.0, budget=0.0)})


def _bump(e, case, plan_cls):
    """One change to layer 0 while a pure hit of its F residents 0–3 is
    pending."""
    if case == "evicting_admit":
        for _ in range(2):
            e.note_access(0, [4, 5])
        e.fetch_experts(0, [4, 5])       # hotter than 0–3: displaces two
    elif case == "apply_plans":
        _grow_f(e, plan_cls)
    elif case == "slab_free":
        e._slab(0).free(2)               # expert 2's refs turn stale
    elif case == "cross_layer_drain":
        h = e.submit_steps([(1, [0], []), (0, [], [4, 5])])
        h.result()
        _settled(h).spec_result()        # admits 4 and 5 into layer 0


@pytest.mark.parametrize("case", ["none", "evicting_admit", "apply_plans",
                                  "slab_free", "cross_layer_drain"])
def test_pending_pure_hit_walks_after_an_epoch_bump(setup, case):
    """A pure hit of F's residents is pending while `case` changes layer 0
    (``none``: nothing does).  Its collect hands the F payloads' tensors
    back with no walk only while the layer's epoch stands; after each
    change it takes the full walk, and the cache ends as the
    reference's."""
    cfg, d = setup
    args = dict(n_experts=cfg.n_experts, n_layers=cfg.n_layers, L=2,
                device_cache=True, pool_sizes=BUDGET | {"F": 4})
    ref = RefEngine(RefStore(d), **args)
    eng = ZipMoEEngine(ExpertStore(d), device="cpu", **args)
    try:
        handles = []
        for e, plan_cls in ((eng, LayerPlan), (ref, RefLayerPlan)):
            e.fetch_experts(0, [0, 1, 2, 3])
            h = e.submit_steps([(0, [], [0, 1, 2, 3])])
            assert h.done()
            handles.append(h)
            if e is eng:
                assert h._job.fulls is not None      # seeded lazily
                epoch = eng.caches[0].epoch
                t0 = eng.transfer_summary()
            _bump(e, case, plan_cls)
        assert (eng.caches[0].epoch == epoch) == (case == "none")
        if case == "evicting_admit":
            assert set(eng.caches[0].pools["F"]) != {0, 1, 2, 3}
        for h in handles:
            h.spec_result()
        t = {k: v - t0[k] for k, v in eng.transfer_summary().items()
             if k in ("collect_keys", "collect_fast_keys")}
        if case == "none":
            assert t["collect_fast_keys"] == t["collect_keys"] == 4
        else:
            assert t["collect_keys"] >= 4
            assert t["collect_fast_keys"] == 0
        assert _state(eng) == _state(ref)
        assert eng.cache_summary(per_layer=True) == \
            ref.cache_summary(per_layer=True)
        fpool = eng.caches[0].pools["F"]
        for e in fpool:
            for v in fpool[e].payload.full.values():
                assert not isinstance(v, SlotRef) or v.valid
    finally:
        eng.shutdown()
        ref.shutdown()
