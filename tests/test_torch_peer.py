"""The port's peer-HBM (P) tier on four ``"cpu"`` peer rows, the
counterpart of the JAX package's ``tests/test_peer_tier.py`` (which forces
four XLA host devices in a subprocess) and of its chaos-mesh acceptance
test (``tests/test_faults.py``):

* the slab rows themselves: put / fetch bit-exact, ledger accounting,
  generation-stale refs, logical grants, retire — and a fetch is a COPY,
  never a view a later occupant of the slot could rewrite;
* the engine's submit-time peer serving: link-priced fetches seed demand
  payloads like F hits, bit-exact against the store, with no h2d bytes;
  each row's planned grant is what the reference's per-device solver
  gives that row's shard, and a row admits only up to its grant;
* ``ZipServer`` at ``mesh_devices=4`` against ``mesh_devices=1`` on the
  same trace, with ``device_cache`` off (as the reference test) and on
  (as the main path): logits bit-identical, peer-served experts, and
  ``collective-permute`` bytes = fetches × an expert's bytes; and against
  the reference's one-device ``ZipServer`` on the same store and tokens:
  routes equal, logits within MAX_REL; a one-device server keeps no peer
  context;
* corruption + a killed worker + failed peer links together: outputs
  stay bit-exact and the failures are counted;
* parity with the reference where it runs in-process: ``LinkProfiler``'s
  numbers on one ``record`` sequence, ``plan_peer_shards`` on seeded
  shard statistics, ``PEER_STACK``'s order and costs, and a hierarchical
  cache over ``PEER_STACK`` on a seeded trace.  The reference's own peer
  tier does not run under the installed JAX (its mesh tests fail), so
  the mesh-4 server is held to the reference's one-device server, which
  the peer tier must not change.

Tolerances: exact (bits, counts, bytes, routes), except the port's logits
against the reference's: within MAX_REL (2%) of the largest |logit|, the
tolerance of every cross-package server test (the packages add the expert
GEMMs and the combine in other orders).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import repro.core.cache as ref_cache
import repro.models.moe as ref_moe
import repro.core.tiers as ref_tiers
import repro.core.workload as ref_workload
from repro.core.planner import PlanConsts as RefConsts
from repro.core.planner import plan_peer_shards as ref_plan_peer_shards
from repro.core.profiles import LinkProfiler as RefLinkProfiler
from repro.core.store import build_store as ref_build_store
from repro.serving.zipserve import ZipServer as RefZipServer
from repro_torch.configs import get_smoke_config
from repro_torch.core import bitfield
from repro_torch.core.cache import HierarchicalCache
from repro_torch.core.engine import ZipMoEEngine
from repro_torch.core.faults import FaultPlan, FetchError
from repro_torch.core.planner import PlanConsts, plan_peer_shards
from repro_torch.core.profiles import LinkProfiler
from repro_torch.core.slab import PeerSlabMesh, SlotRef
from repro_torch.core.store import ExpertStore, build_store
from repro_torch.core.tiers import DEFAULT_STACK, PEER_STACK, peer_stack
from repro_torch.core.workload import FreqTracker
from repro_torch.distributed.collectives import CollectiveLedger
from repro_torch.models import init_params
from repro_torch.models.moe import route
from repro_torch.serving.zipserve import ZipServer
from test_torch_models import assert_greedy_agrees, both_params, serve_greedy

ROWS = ["cpu"] * 4
SHAPES = {"w_gate": (8, 16), "w_up": (8, 16), "w_down": (16, 8)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    params = init_params(cfg, seed=0, device="cpu")
    d = str(tmp_path_factory.mktemp("store_peer"))
    build_store(params, cfg, d, k_shards=4, device="cpu")
    return cfg, params, d


def _bits(v):
    return bitfield.to_bits(v.read() if isinstance(v, SlotRef) else v)


def _tensors(seed):
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                ).to(torch.bfloat16)
            for n, s in SHAPES.items()}


def _mesh(capacity=2):
    ledger, link = CollectiveLedger(), LinkProfiler()
    slab = PeerSlabMesh(0, SHAPES, capacity, ROWS, ledger=ledger, link=link)
    return slab, ledger, link


# ---------------------------------------------------------------------------
# the slab rows
# ---------------------------------------------------------------------------
def test_peer_slab_mesh_roundtrip():
    slab, ledger, link = _mesh()
    tensors = _tensors(0)
    # put into device 2's row, fetch back to device 0: bit-exact
    refs = slab.put(5, 2, tensors)
    assert 5 in slab and all(r.valid for r in refs.values())
    got = slab.fetch(5)
    for n in SHAPES:
        assert got[n].device == torch.device("cpu")
        assert torch.equal(got[n].view(torch.int16),
                           tensors[n].view(torch.int16)), n
    s = ledger.summary()
    assert s["collective_ops"] == {"collective-permute": 1}, s
    assert s["collective_bytes"] == {
        "collective-permute": slab.expert_nbytes()}, s
    assert s["peer_put_bytes"] == slab.expert_nbytes(), s
    assert link.n_samples == 1 and link.fetch_wall_s > 0

    # host bf16 bits are accepted as well as tensors
    slab.put(4, 1, {n: bitfield.to_bits(t) for n, t in tensors.items()})
    assert all(torch.equal(slab.fetch(4)[n], tensors[n]) for n in SHAPES)

    # free -> stale refs never serve; the slot is reusable
    slab.free(5)
    assert not any(r.valid for r in refs.values())
    assert slab.fetch(5) is None
    slab.put(6, 2, tensors)
    assert slab.fetch(6) is not None

    # logical dev_caps gate admission below the physical capacity
    slab.set_dev_caps([1, 0, 2, 0])
    assert slab.has_free(0) and not slab.has_free(1)
    slab.put(0, 0, tensors)
    assert not slab.has_free(0)               # logical grant exhausted
    assert slab.resident_bytes(0) == slab.expert_nbytes()

    # retire invalidates everything
    refs6 = slab.refs(6)
    slab.retire()
    assert not any(r.valid for r in refs6.values())
    assert slab.fetch(6) is None and slab.nbytes() == 0


def test_peer_fetch_is_a_copy():
    """A fetched expert keeps its bytes after its slot is freed and taken
    by another expert: the fetch never returns a view of the row."""
    slab, _, _ = _mesh(capacity=1)
    a, b = _tensors(1), _tensors(2)
    refs = slab.put(3, 0, a)
    got = slab.fetch(3)
    slab.free(3)
    refs_b = slab.put(9, 0, b)
    assert refs_b["w_up"].slot == refs["w_up"].slot   # the same slot
    for n in SHAPES:
        assert torch.equal(got[n].view(torch.int16), a[n].view(torch.int16))
        assert torch.equal(slab.fetch(9)[n].view(torch.int16),
                           b[n].view(torch.int16))


def test_peer_slab_faults_count_link_failures():
    slab, ledger, _ = _mesh()
    slab.faults = FaultPlan.parse("peer_link:count=1;seed=0")
    slab.put(1, 3, _tensors(0))
    from repro_torch.core.faults import PeerLinkError
    with pytest.raises(PeerLinkError):
        slab.fetch(1)
    assert slab.link_failures == 1
    assert ledger.summary()["link_failures"] == 1
    assert slab.fetch(1) is not None          # count=1: the next one lands


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("device_cache", [False, True])
def test_engine_peer_serving(setup, device_cache):
    cfg, _, d = setup
    store = ExpertStore(d)
    eng = ZipMoEEngine(store, n_experts=cfg.n_experts, n_layers=cfg.n_layers,
                       L=2, pool_sizes={"F": 2, "P": 8, "C": 0, "S": 0,
                                        "E": 2},
                       device_cache=device_cache, device="cpu",
                       peer_devices=ROWS)
    assert eng.stack.order == ("F", "P", "C", "S", "E")
    try:
        sel = [2, 3, 4, 5]
        eng.fetch_experts(0, sel)             # cold: admit (some land in P)
        h2d_before = eng.transfer_summary()["h2d_bytes"]
        out, _ = eng.fetch_experts(0, sel)    # warm: peer residents serve
        ps = eng.peer_summary()
        assert ps["enabled"] and ps["n_dev"] == 4
        assert ps["served"] > 0, ps           # the link served demand
        assert ps["total_bytes"] > 0, ps
        assert eng.caches[0].hits.get("P", 0) > 0, dict(eng.caches[0].hits)
        # peer-served steps move no host->device staging bytes
        assert eng.transfer_summary()["h2d_bytes"] == h2d_before
        for e in sel:                         # and stay bit-exact
            ref = store.load_group((0, e))
            for name, v in out[e].items():
                assert np.array_equal(_bits(v), ref[name]), (e, name)
        # per-device planning: each row's grant is what the REFERENCE's
        # solver gives that row's shard alone under the row budget the
        # layer was given; the budgets split the per-device budget
        budget = 2e6
        eng.configure_planner(budget, initial_plan=False)
        eng.replan("test")
        caps = eng.peer.dev_caps.get(0)
        row_budget = eng.peer.row_budgets[0]
        full = eng._bytes_per_state(0)["F"]
        consts = RefConsts(**dataclasses.asdict(eng.plan_consts(0)))
        assert caps == ref_plan_peer_shards(eng._peer_shard_stats(0),
                                            row_budget, full, consts)
        assert caps != eng._even_dev_caps(sum(caps)), caps  # shard-aware
        assert all(c * full <= row_budget for c in caps), (caps, row_budget)
        assert sum(eng.peer.row_budgets.values()) <= budget * (1 + 1e-12)
        assert eng.plan_consts(0).peer == eng.peer.link.p_time(
            store.groups[(0, 2)].full_bytes) > 0
        # the slab admits under those grants: a row grows only up to its
        # grant (a shrunk grant gates new admissions, it evicts nothing)
        slab = eng.peer.slabs[0]
        assert slab.dev_caps == [min(slab.capacity, c) for c in caps]

        def rows():
            return [sum(1 for r, _ in slab.slot_of.values() if r == dev)
                    for dev in range(4)]
        before = rows()
        for sel in ([0, 1, 6, 7], [1, 2, 6, 7], [0, 5, 6, 7], [0, 1, 6, 7]):
            eng.fetch_experts(0, sel)
        assert all(a <= max(c, b) for a, b, c in zip(rows(), before, caps)), \
            (rows(), before, caps)
    finally:
        eng.shutdown()


def test_engine_one_device_has_no_peer(setup):
    cfg, _, d = setup
    for rows in (None, ["cpu"]):
        eng = ZipMoEEngine(ExpertStore(d), n_experts=cfg.n_experts,
                           n_layers=cfg.n_layers, L=2, peer_devices=rows)
        try:
            assert eng.peer is None and eng.stack is DEFAULT_STACK
            assert eng.peer_summary() == {"enabled": False}
            assert eng.plan_consts(0).peer == 0.0
            assert "P" not in eng.caches[0].cap
        finally:
            eng.shutdown()


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Both packages' parameters from one seed, and a store the reference
    built, so the reference's one-device server reads the same bytes."""
    jcfg, jparams, cfg, params = both_params()
    d = str(tmp_path_factory.mktemp("store_peer_ref"))
    ref_build_store(jparams, jcfg, d, k_shards=4)
    return jcfg, jparams, cfg, params, d


SERVE_KW = dict(L=2, pool_sizes={"F": 2, "C": 2, "S": 2, "E": 2},
                mem_budget=2e6, replan_every=4)
STEPS = 8


def _record_routes(monkeypatch, cls, route_fn, out):
    """Wrap ``cls._zip_moe_ffn`` to append each step's (layer, sorted
    top-k ids [B, S, k]) to `out`."""
    orig = cls._zip_moe_ffn

    def recording(self, lp, x, layer_idx, owners=None):
        _, ti, _ = route_fn(lp["ffn"]["router"], x, self.cfg)
        out.append((layer_idx, np.sort(np.asarray(ti), -1)))
        return orig(self, lp, x, layer_idx, owners)

    monkeypatch.setattr(cls, "_zip_moe_ffn", recording)


def _serve(zs, vocab, feed=None):
    """Greedy-decode STEPS tokens; the server's logits (f32 bits of its
    bf16 logits), tokens, peer summary, peer fetch sizes, and whether it
    kept the one-device stack."""
    try:
        lg, tok = serve_greedy(zs, vocab, STEPS, feed=feed)
        eng = zs.engine
        ps = zs.peer_summary()
        nbytes = {s.expert_nbytes() for s in eng.peer.slabs.values()
                  if s is not None} if eng.peer is not None else set()
        one_dev = (eng.peer is None, eng.stack is DEFAULT_STACK)
    finally:
        zs.close()
    return lg, tok, ps, nbytes, one_dev


@pytest.mark.parametrize("device_cache", [False, True])
def test_zipserver_mesh_bitexact_and_link_served(both, monkeypatch,
                                                 device_cache):
    """Mesh 4 against mesh 1 within the port (bits), and against the
    reference's one-device server on the same store and token trace: every
    route equal, logits within MAX_REL of the largest |logit| and the same
    greedy tokens wherever the logits decide them."""
    jcfg, jparams, cfg, params, d = both
    kw = dict(SERVE_KW, device_cache=device_cache)
    mine, theirs = [], []
    _record_routes(monkeypatch, ZipServer,
                   lambda w, x, c: [t.numpy() for t in route(w, x, c)], mine)
    _record_routes(monkeypatch, RefZipServer, ref_moe.route, theirs)
    base, _, base_ps, _, one_dev = _serve(
        ZipServer(params, cfg, d, device="cpu", **kw), cfg.vocab_size)
    assert base_ps == {"enabled": False} and one_dev == (True, True)
    n_one = len(mine)
    mesh, tok, ps, nbytes, _ = _serve(
        ZipServer(params, cfg, d, device="cpu", mesh_devices=4,
                  peer_devices=ROWS, **kw), cfg.vocab_size)
    # the peer tier served traffic over the link...
    assert ps["enabled"] and ps["served"] > 0, ps
    n_fetch = ps["collective_ops"]["collective-permute"]
    assert n_fetch > 0 and len(nbytes) == 1, (ps, nbytes)
    assert ps["collective_bytes"] == {
        "collective-permute": n_fetch * nbytes.pop()}, ps
    assert ps["link"]["n_samples"] == n_fetch
    # ...the logits are bit-identical to the one-device run...
    assert np.array_equal(base.view(np.uint32), mesh.view(np.uint32))
    # ...and agree with the reference's one-device server fed the same
    # tokens, every expert routed the same
    ref, _, _, _, _ = _serve(
        RefZipServer(jparams, jcfg, d, mesh_devices=1, **kw),
        cfg.vocab_size, feed=tok)
    ours = mine[n_one:]
    assert len(ours) == len(theirs) == STEPS * cfg.n_layers
    for i, ((la, ia), (lb, ib)) in enumerate(zip(ours, theirs)):
        assert la == lb and np.array_equal(ia, ib), (i, la, ia, ib)
    assert_greedy_agrees(mesh, tok, ref)


def test_zipserver_peer_options(setup):
    cfg, params, d = setup
    with pytest.raises(AssertionError):       # planes can't fill peer rows
        ZipServer(params, cfg, d, device="cpu", mesh_devices=2,
                  peer_devices=["cpu"] * 2, fused_recovery=True)
    with pytest.raises(ValueError):           # one row a device
        ZipServer(params, cfg, d, device="cpu", mesh_devices=4,
                  peer_devices=["cpu"] * 2)
    zs = ZipServer(params, cfg, d, device="cpu", mesh_devices=2,
                   peer_devices=["cpu"] * 2)
    try:
        assert zs.engine.stack is PEER_STACK
        assert zs.engine.caches[0].cap["P"] == cfg.n_experts
    finally:
        zs.close()


# ---------------------------------------------------------------------------
# combined chaos: corruption + a killed worker + failed peer links
# ---------------------------------------------------------------------------
def test_combined_chaos_mesh(setup, tmp_path):
    cfg, params, _ = setup
    d = str(tmp_path)
    build_store(params, cfg, d, k_shards=4, device="cpu")
    ref = ExpertStore(d)
    # persistent on-disk corruption of one expert's first E-chunk
    g = ref.groups[(0, 6)]
    t = g.tensors[0]
    with open(os.path.join(d, g.file), "r+b") as f:
        f.seek(t.e_offsets[0])
        b = f.read(4)
        f.seek(t.e_offsets[0])
        f.write(bytes(x ^ 0xFF for x in b))
    plan = FaultPlan.parse("bitflip:p=0.04;worker_kill:count=1,after=20;"
                           "peer_link:count=2;seed=9")
    store = ExpertStore(d, faults=plan, max_retries=2, retry_backoff_s=0.0)
    eng = ZipMoEEngine(store, n_experts=cfg.n_experts,
                       n_layers=cfg.n_layers, L=2,
                       pool_sizes={"F": 2, "P": 8, "C": 0, "S": 0, "E": 2},
                       peer_devices=ROWS, fetch_deadline_s=60.0,
                       watchdog_interval_s=0.02)

    def exact(out, layer, ids):
        for e in ids:
            want = ref.load_group((layer, e))
            for name, v in out[e].items():
                assert np.array_equal(_bits(v), want[name]), (layer, e, name)
    try:
        sel = [2, 3, 4, 5]
        eng.fetch_experts(0, sel)          # cold: admit (some land in P)
        # warm pass: the first peer fetches hit the injected link failure
        # and fall back to the local store path — still bit-identical
        out, _ = eng.fetch_experts(0, sel)
        exact(out, 0, sel)
        # the corrupt expert fails alone; survivors stay bit-identical
        with pytest.raises(FetchError) as ei:
            eng.fetch_experts(0, [5, 6, 7])
        assert set(ei.value.failures) == {(0, 6)}, ei.value.failures
        out2, _ = eng.fetch_experts(0, [5, 7])
        exact(out2, 0, [5, 7])
        # churn until the injected worker kill lands
        rng = np.random.default_rng(9)
        for i in range(12):
            layer = 1 + (i % (cfg.n_layers - 1))   # corrupt file is layer 0
            s = sorted(int(e) for e in rng.choice(
                cfg.n_experts, size=2, replace=False))
            o, _ = eng.fetch_experts(layer, s)
            exact(o, layer, s)
        fs = eng.fault_summary()
        assert fs["store"]["read_retries"] >= 1, fs
        assert fs["store"]["quarantined"] >= 1, fs
        assert fs["worker_restarts"] >= 1, fs
        assert fs["peer_link_failures"] >= 1, fs
        assert fs["injected"]["total"] >= 3, fs
        assert eng.cache_summary()["pinned"] == 0
        assert eng.peer_summary()["link_failures"] == \
            fs["peer_link_failures"]
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------
def test_link_profiler_matches_reference():
    rng = np.random.default_rng(3)
    ours, theirs = LinkProfiler(), RefLinkProfiler()
    for _ in range(200):
        nbytes = int(rng.integers(0, 1 << 24))
        secs = float(rng.choice([0.0, 1e-7, 3e-6, 1e-4, 2e-3])
                     * rng.uniform(0.5, 2.0))
        ours.record(nbytes, secs)
        theirs.record(nbytes, secs)
        for q in (0, 1, 4096, 1 << 20, 17_301_504):
            assert ours.p_time(q) == theirs.p_time(q)
    assert ours.summary() == theirs.summary()
    assert ours.n_samples > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_peer_shards_matches_reference(seed):
    """The per-device solver on seeded shard statistics (a hot shard, cold
    ones, an empty one) and budgets from none to several experts a row."""
    rng = np.random.default_rng(seed)
    shards = [np.sort(rng.zipf(1.5, 6).astype(np.float64) * w)[::-1]
              for w in rng.permutation([0.0, 0.05, 0.3, 1.0])] \
        + [np.zeros(0)]
    consts = dict(u=float(rng.uniform(1e-4, 1e-3)),
                  v=float(rng.uniform(1e-5, 1e-4)),
                  c=float(rng.uniform(1e-4, 1e-3)), L=4, K=4, n_tensors=3,
                  peer=float(rng.uniform(1e-5, 1e-3)))
    full = 17_301_504.0
    granted = 0
    for n in (0.5, 1, 3, 7):
        ours = plan_peer_shards(shards, n * full, full, PlanConsts(**consts))
        theirs = ref_plan_peer_shards(shards, n * full, full,
                                      RefConsts(**consts))
        assert ours == theirs, (n, ours, theirs)
        granted += sum(ours)
    assert granted > 0


def test_peer_stack_matches_reference():
    assert peer_stack() is PEER_STACK and PEER_STACK.has_peer
    assert not DEFAULT_STACK.has_peer
    ref = ref_tiers.peer_stack()
    assert PEER_STACK.order == ref.order == ("F", "P", "C", "S", "E")
    parts = {"full": 17_301_504.0, "sm": 8_650_752.0, "e": 3_104_211.0}
    assert PEER_STACK.bytes_per_state(parts) == ref.bytes_per_state(parts)
    assert [t.peer for t in PEER_STACK] == [t.peer for t in ref]
    assert [t.state.value for t in PEER_STACK] == \
        [t.state.value for t in ref]


def test_peer_stack_cache_matches_reference():
    """A hierarchical cache over the peer stack: the same seeded trace of
    accesses and admissions gives both packages the same hits, misses,
    evictions, transitions and pools."""
    caps = {"F": 2, "P": 5, "C": 2, "S": 3, "E": 3}
    n, rng = 24, np.random.default_rng(11)
    caches = []
    for mod, wl, stack in ((None, None, PEER_STACK),
                           (ref_cache, ref_workload, ref_tiers.PEER_STACK)):
        tr = (wl.FreqTracker if wl else FreqTracker)(n)
        cls = mod.HierarchicalCache if mod else HierarchicalCache
        c = cls(dict(caps), tr, delta=1, stack=stack)
        c.demote_payload = lambda pl, pool: {"e": pl["e"], "pool": pool}
        caches.append(c)
    pop = rng.zipf(1.3, 4000) % n
    for step in range(300):
        sel = sorted({int(x) for x in pop[step * 4:step * 4 + 4]})
        states = []
        for c in caches:
            states.append({k: v.value
                           for k, v in c.record_access(sel).items()})
            for e in sel:
                if e not in c.pools["F"]:
                    c.admit(e, {"e": e, "pool": None})
        assert states[0] == states[1], step
    ours, theirs = caches
    assert dict(ours.hits) == dict(theirs.hits)
    assert ours.misses == theirs.misses
    assert ours.evictions == theirs.evictions
    assert dict(ours.transitions) == dict(theirs.transitions)
    assert {p: sorted(ours.pools[p]) for p in ours.pools} == \
        {p: sorted(theirs.pools[p]) for p in theirs.pools}
    assert sum(ours.hits.values()) > 0 and ours.hits.get("P", 0) > 0
