"""The port's live §3.4 planning (``core/planner``, the engine's planner
hooks, ``ZipServer(mem_budget=...)``) against the JAX package's, on the
same numpy inputs.

Tolerances:

* planner parity is exact — both packages run the same numpy code on the
  same arrays, so fitted probabilities, hit distributions and plans are
  compared with ``np.array_equal`` / ``==`` (costs included);
* the resize invariants of the reference's cache tests hold on the port's
  caches, and the same operations leave both packages' pools equal;
* engine parity is exact: with ``plan_consts`` pinned (profiled u/c are
  host timings) and ``profile_per_layer=False``, the same fetch trace gives
  equal plan sizes, ``cap_bytes``, budgets and replan reasons;
* within the port, a ``mem_budget`` server that re-plans mid-decode gives
  logits bit-identical to a static-pool server (the weights are lossless
  whatever the pools hold), and greedy tokens equal to the JAX package's
  ``mem_budget`` server fed the same tokens (``assert_greedy_agrees``).
"""
import numpy as np
import pytest

import repro.core.cache as ref_cache
import repro.core.planner as ref_planner
import repro.core.workload as ref_workload
import repro_torch.core.cache as cache_mod
import repro_torch.core.planner as planner
import repro_torch.core.workload as workload
from repro.core.engine import ZipMoEEngine as RefEngine
from repro.core.store import ExpertStore as RefStore
from repro.core.store import build_store as ref_build_store
from repro.serving.zipserve import ZipServer as RefZipServer
from repro_torch.core import bitfield
from repro_torch.core.engine import ZipMoEEngine
from repro_torch.core.slab import SlotRef
from repro_torch.core.store import ExpertStore
from repro_torch.serving.zipserve import ZipServer
from test_torch_models import assert_greedy_agrees, both_params, serve_greedy

BPS = {"F": 2.0, "C": 1.4, "S": 1.0, "E": 0.4}
CONSTS = dict(u=1.0, v=0.1, c=0.15, L=4, K=4, n_tensors=3)
# the reference drift test's decompression-bound persona (c = u): F pools
# are worth their bytes, so slabs get built
DRIFT_CONSTS = dict(u=1.0, v=0.1, c=1.0, L=4, K=4, n_tensors=3)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, jparams, cfg, params = both_params()
    d = str(tmp_path_factory.mktemp("store_planner"))
    ref_build_store(jparams, jcfg, d, k_shards=4)
    return jcfg, jparams, cfg, params, d


# ---------------------------------------------------------------------------
# planner parity: the same numpy inputs, equal outputs
# ---------------------------------------------------------------------------
def _stats(n, k, seed):
    trace = workload.zipf_trace(n, k, 400, alpha=1.2, seed=seed)
    assert trace == ref_workload.zipf_trace(n, k, 400, alpha=1.2, seed=seed)
    return workload.rank_inclusion_probs(trace, n), workload.effective_k(trace)


def _same_plan(a, b):
    assert a.sizes == b.sizes
    assert a.ratios == b.ratios
    assert a.cost == b.cost
    assert (a.q is None) == (b.q is None)
    if a.q is not None:
        assert np.array_equal(a.q, b.q)


def _same_layer_plans(a, b):
    assert sorted(a) == sorted(b)
    for l in a:
        assert a[l].sizes == b[l].sizes, l
        assert a[l].cap_bytes == b[l].cap_bytes, l
        assert a[l].ratios == b[l].ratios, l
        assert a[l].budget == b[l].budget, l
        assert a[l].cost == b[l].cost, l


@pytest.mark.parametrize("split", ["proportional", "waterfill"])
@pytest.mark.parametrize("n,k", [(8, 2), (8, 4), (60, 2), (60, 4)])
def test_planner_parity_exact(n, k, split):
    f, k_eff = _stats(n, k, seed=3)
    assert k_eff == k
    q = planner.ipf_selection_probs(f, k)
    assert np.array_equal(q, ref_planner.ipf_selection_probs(f, k))
    for lo, hi in ((0, n), (0, n // 2), (n // 4, n)):
        for max_h in (None, k):
            assert np.array_equal(
                planner.poisson_binomial(q[lo:hi], max_h),
                ref_planner.poisson_binomial(q[lo:hi], max_h))
    consts = planner.PlanConsts(**CONSTS)
    rconsts = ref_planner.PlanConsts(**CONSTS)
    for h in ({}, {"F": 1}, {"F": 1, "C": 1, "S": 1},
              {"C": k - 1, "E": 1}, {"S": k}):
        assert planner.estimate_makespan(k, h, consts) == \
            ref_planner.estimate_makespan(k, h, rconsts)
    budget = 0.5 * n * BPS["F"]
    _same_plan(planner.plan_pools(f, k, budget, BPS, consts, step=0.125),
               ref_planner.plan_pools(f, k, budget, BPS, rconsts,
                                      step=0.125))
    # three layers of other skews and activities, planned twice (the
    # second solve warm-starts each layer's fit from the first)
    stats = {l: _stats(n, k, seed=10 + l) for l in range(3)}
    weights = {0: 6.0, 1: 2.0, 2: 0.5}
    lp = planner.LivePlanner(3 * budget, step=0.25, budget_split=split)
    rlp = ref_planner.LivePlanner(3 * budget, step=0.25, budget_split=split)
    for w in (weights, {0: 1.0, 1: 4.0, 2: 0.0}):
        _same_layer_plans(
            lp.plan(stats, {l: BPS for l in stats},
                    {l: consts for l in stats}, weights=w),
            rlp.plan(stats, {l: BPS for l in stats},
                     {l: rconsts for l in stats}, weights=w))
        lp.note_plan(0, "test")
        rlp.note_plan(0, "test")
    assert lp.summary() == rlp.summary()


# ---------------------------------------------------------------------------
# cache resize invariants on the port's caches (tests/test_live_planner.py)
# ---------------------------------------------------------------------------
def _warm_hier(mod, wl, caps, n=16):
    tr = wl.FreqTracker(n)
    cache = mod.HierarchicalCache(dict(caps), tr, delta=1)
    cache.demote_payload = lambda pl, pool: {"expert": pl["expert"],
                                             "pool": pool}
    for e in range(n):
        for _ in range(n - e):
            tr.record([e])
    for e in range(n):
        cache.admit(e, {"expert": e, "pool": None})
    return cache, tr


def _pools(cache):
    return {p: sorted(cache.pools[p]) for p in cache.pools}


def test_hier_resize_shrink_demotes_and_never_evicts_pinned():
    out = {}
    for name, mod, wl in (("port", cache_mod, workload),
                          ("ref", ref_cache, ref_workload)):
        cache, tr = _warm_hier(mod, wl, {"F": 4, "C": 0, "S": 4, "E": 4})
        assert len(cache.pools["F"]) == 4
        pinned = sorted(cache.pools["F"])
        cache.pin(pinned)
        cache.resize({"F": 1, "C": 0, "S": 4, "E": 4})
        assert sorted(cache.pools["F"]) == pinned    # all pinned: deferred
        cache.unpin(pinned)
        cache.resize({"F": 1, "C": 0, "S": 4, "E": 4})
        assert len(cache.pools["F"]) == 1
        keep = min(pinned, key=tr.rank)
        assert keep in cache.pools["F"]
        for e in pinned:
            for p in ("S", "E"):
                if e != keep and e in cache.pools[p]:
                    assert cache.pools[p][e].payload["pool"] == p
        assert sum(v for (a, _), v in cache.transitions.items()
                   if a == "F") >= 3
        out[name] = (_pools(cache), dict(cache.transitions))
    assert out["port"] == out["ref"]


def test_hier_resize_grow_is_churn_free():
    out = {}
    for name, mod, wl in (("port", cache_mod, workload),
                          ("ref", ref_cache, ref_workload)):
        cache, _ = _warm_hier(mod, wl, {"F": 2, "C": 2, "S": 2, "E": 2})
        before = {p: dict(cache.pools[p]) for p in cache.pools}
        ev0 = cache.evictions
        cache.resize({"F": 8, "C": 8, "S": 8, "E": 8})
        for p, entries in before.items():
            assert cache.pools[p].keys() == entries.keys()
            for e, ent in entries.items():
                assert cache.pools[p][e] is ent
        assert cache.evictions == ev0
        out[name] = (_pools(cache), dict(cache.cap))
    assert out["port"] == out["ref"]


def test_flat_resize_respects_pins():
    out = {}
    for name, mod, wl in (("port", cache_mod, workload),
                          ("ref", ref_cache, ref_workload)):
        tr = wl.FreqTracker(16)
        cache = mod.LiveFlatCache(8, tr, policy="lru")
        for e in range(8):
            tr.record([e])
            cache.admit(e, payload=e)
        cache.pin([0, 1])
        cache.resize(2)
        assert cache.capacity == 2 and len(cache.entries) == 2
        assert set(cache.entries) == {0, 1}
        cache.resize(6)
        assert set(cache.entries) == {0, 1}
        assert cache.cap["F"] == 6
        out[name] = (list(cache.entries), dict(cache.cap), cache.evictions)
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# engine parity: the same trace through both packages' planner hooks
# ---------------------------------------------------------------------------
def _drift_trace(n):
    phase1 = workload.zipf_trace(n, 2, 40, alpha=1.4, seed=5)
    phase2 = workload.zipf_trace(n, 2, 40, alpha=1.4, seed=99)
    return phase1, phase2


def _drive_drift(eng, n, watch_slab=False):
    """The reference drift test's trace: the popular set flips at
    mid-trace and layer 1 idles from then on."""
    phase1, phase2 = _drift_trace(n)
    slab1_seen = False
    for i, sel in enumerate(phase1 + phase2):
        eng.fetch_experts(0, sorted(sel))
        if i < len(phase1) and i % 3 == 0:
            eng.fetch_experts(1, sorted(sel))
        if watch_slab:
            slab1_seen = slab1_seen or eng._slabs.get(1) is not None
        eng.note_step()
    return slab1_seen


@pytest.mark.parametrize("cache_mode,device_cache",
                         [("hier", True), ("flat", False)],
                         ids=["hier-device", "flat-host"])
def test_engine_plan_parity_with_reference(setup, cache_mode, device_cache):
    _, _, cfg, _, d = setup
    kw = dict(n_experts=cfg.n_experts, n_layers=2, L=3, freq_decay=0.9,
              cache_mode=cache_mode, device_cache=device_cache)
    ref = RefEngine(RefStore(d), **kw)
    eng = ZipMoEEngine(ExpertStore(d), device="cpu", **kw)
    try:
        ref.plan_consts = lambda layer: ref_planner.PlanConsts(
            **DRIFT_CONSTS)
        eng.plan_consts = lambda layer: planner.PlanConsts(**DRIFT_CONSTS)
        bps = eng._bytes_per_state(0)
        assert bps == ref._bytes_per_state(0)
        for e in (ref, eng):
            e.configure_planner(10 * bps["F"], replan_every=8,
                                plan_step=0.25, drift_margin=0.05,
                                profile_per_layer=False)
        _drive_drift(ref, cfg.n_experts)
        slab1_seen = _drive_drift(eng, cfg.n_experts, watch_slab=True)
        a, b = eng.plan_summary(), ref.plan_summary()
        assert a["layers"] == b["layers"]
        assert [(ev["step"], ev["reason"], ev["sizes"], ev["budgets"])
                for ev in a["replans"]] == \
            [(ev["step"], ev["reason"], ev["sizes"], ev["budgets"])
             for ev in b["replans"]]
        for key in ("bytes_occupancy", "bytes_resident", "n_plans",
                    "n_replans", "mem_budget", "plan_steps"):
            assert a[key] == b[key], key
        assert eng.cache_summary() == ref.cache_summary()
        assert "drift" in [ev["reason"] for ev in a["replans"]]
        if device_cache:
            # the reference test's end state, on the port
            sizes = {l: a["layers"][l]["sizes"] for l in a["layers"]}
            assert sizes[0]["F"] > 0 and sizes[1]["F"] == 0
            assert slab1_seen and eng._slabs.get(1) is None
            assert eng._slab(0) is not None
            assert eng.transfer_summary()["slab_resident"] == \
                ref.transfer_summary()["slab_resident"]
    finally:
        eng.shutdown()
        ref.shutdown()


# ---------------------------------------------------------------------------
# port-internal: lossless across a replan, cold slabs freed, migration
# ---------------------------------------------------------------------------
def _bits(v):
    return bitfield.to_bits(v.read() if isinstance(v, SlotRef) else v)


@pytest.mark.parametrize("cache_mode,device_cache",
                         [("hier", False), ("flat", False), ("hier", True)],
                         ids=["hier", "flat", "hier-device"])
def test_replan_boundary_logits_bitidentical(setup, cache_mode,
                                             device_cache):
    """A mem_budget server that re-plans mid-decode gives logits
    bit-identical to a static-pool server, and the greedy tokens of the JAX
    package's mem_budget server fed the same tokens."""
    jcfg, jparams, cfg, params, d = setup
    pools = {"F": 1, "C": 1, "S": 1, "E": 1}          # eviction-inducing
    kw = dict(L=3, cache_mode=cache_mode, device_cache=device_cache)
    zs_s = ZipServer(params, cfg, d, pool_sizes=pools, device="cpu", **kw)
    budget = 6 * zs_s.engine._bytes_per_state(0)["F"]
    plan_kw = dict(mem_budget=budget, replan_every=2, plan_step=0.25, **kw)
    zs_p = ZipServer(params, cfg, d, device="cpu", **plan_kw)
    zs_r = RefZipServer(jparams, jcfg, d, **plan_kw)
    steps = 6
    try:
        ref_lg, _ = serve_greedy(zs_s, cfg.vocab_size, steps)
        out_lg, out_tok = serve_greedy(zs_p, cfg.vocab_size, steps,
                                       replan_at=3)
        jax_lg, _ = serve_greedy(zs_r, cfg.vocab_size, steps, feed=out_tok,
                                 replan_at=3)
        assert np.array_equal(ref_lg, out_lg)
        assert_greedy_agrees(out_lg, out_tok, jax_lg)
        for zs in (zs_p, zs_r):
            ps = zs.plan_summary()
            assert ps["enabled"]
            assert ps["n_plans"] >= 2 and ps["n_replans"] >= 1
            assert ps["bytes_resident"] <= budget + 1e-6
            assert "forced" in [ev["reason"] for ev in ps["replans"]]
    finally:
        zs_s.close()
        zs_p.close()
        zs_r.close()


def test_engine_replan_frees_cold_layer_slab(setup):
    """Layer 1 goes cold, the re-plan gives it nothing: its slab is freed,
    every SlotRef into it turns stale and trips on read, and a later fetch
    reloads it losslessly."""
    _, _, cfg, _, d = setup
    eng = ZipMoEEngine(ExpertStore(d), n_experts=cfg.n_experts, n_layers=2,
                       L=3, pool_sizes={"F": 2, "C": 1, "S": 1, "E": 1},
                       device_cache=True, freq_decay=0.7, device="cpu")
    try:
        bps = eng._bytes_per_state(0)
        for _ in range(4):
            eng.fetch_experts(1, [0, 1])
            eng.note_step()
        want = {e: {k: _bits(v) for k, v in w.items()}
                for e, w in eng.fetch_experts(1, [0, 1])[0].items()}
        assert eng._slabs.get(1) is not None
        stale = [v for ent in eng.caches[1].pools["F"].values()
                 for v in ent.payload.full.values()
                 if isinstance(v, SlotRef)]
        assert stale and all(r.valid for r in stale)
        eng.configure_planner(4 * bps["F"], replan_every=0, plan_step=0.25,
                              profile_per_layer=True)
        for step in range(12):
            eng.fetch_experts(0, [step % 4, 4 + step % 2])
            eng.note_step()
        eng.replan(reason="test")
        ps = eng.plan_summary()
        assert ps["enabled"] and ps["n_plans"] == 2 and ps["n_replans"] == 1
        sizes = {l: ps["layers"][l]["sizes"] for l in ps["layers"]}
        assert sum(sizes[0].values()) > 0
        assert sum(sizes[1].values()) == 0
        assert eng._slabs[1] is None
        assert all(not r.valid for r in stale)
        with pytest.raises(AssertionError, match="stale SlotRef"):
            stale[0].read()
        assert not eng.caches[1].pools["F"]
        slab0 = eng._slab(0)
        if slab0 is not None:
            assert slab0.capacity == min(
                int(ps["layers"][0]["cap_bytes"]["F"] // bps["F"]),
                cfg.n_experts)
        assert sum(eng.cache_summary()["occupancy_bytes"].values()) \
            <= 4 * bps["F"] + 1e-6
        got, _ = eng.fetch_experts(1, [0, 1])
        for e, w in want.items():
            for k, v in w.items():
                assert np.array_equal(_bits(got[e][k]), v)
    finally:
        eng.shutdown()


def test_slab_migration_carries_residents_bitexact(setup):
    """A replan that re-sizes a populated slab moves its residents slot to
    slot into a new slab: old refs go stale, every F resident is a valid
    SlotRef into the new slab holding the store's bits."""
    _, _, cfg, _, d = setup
    store = ExpertStore(d)
    eng = ZipMoEEngine(ExpertStore(d), n_experts=cfg.n_experts, n_layers=2,
                       L=3, device_cache=True, device="cpu")
    try:
        eng.plan_consts = lambda layer: planner.PlanConsts(**DRIFT_CONSTS)
        bps = eng._bytes_per_state(0)
        eng.configure_planner(6 * bps["F"], replan_every=0, plan_step=0.25,
                              profile_per_layer=False)
        for step in range(6):
            eng.fetch_experts(0, [step % 3, 3 + step % 2])
            eng.note_step()
        old = eng._slabs.get(0)
        assert old is not None and old.slot_of
        old_refs = [v for ent in eng.caches[0].pools["F"].values()
                    for v in ent.payload.full.values()]
        assert old_refs and all(isinstance(v, SlotRef) and v.valid
                                for v in old_refs)
        moved = dict(old.slot_of)
        eng.planner.mem_budget = 12 * bps["F"]       # more bytes, all F-able
        eng.replan(reason="grow")
        new = eng._slabs.get(0)
        assert new is not None and new is not old
        assert new.capacity != old.capacity
        assert all(not v.valid for v in old_refs)
        assert set(moved) <= set(new.slot_of)
        for e, ent in eng.caches[0].pools["F"].items():
            want = store.load_group((0, e))
            names = [t.name for t in store.groups[(0, e)].tensors]
            for tidx, v in ent.payload.full.items():
                assert isinstance(v, SlotRef) and v.slab is new and v.valid
                assert np.array_equal(_bits(v), want[names[tidx]])
    finally:
        eng.shutdown()
        store.close()
