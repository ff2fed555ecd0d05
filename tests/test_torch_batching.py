"""Continuous batching of the port (``BatchServer`` over ``ZipServer.
decode_rows`` and the ``KVPagePool``), against the JAX package's and
against itself.

* **Against the reference**: the same requests, arrivals and concurrency
  through both packages' continuous servers over one store: per-request
  logits within ``MAX_REL`` of the largest |logit|, tokens equal wherever
  the logits decide them, and ``request_summary()``'s accesses and hits
  equal to the reference's (every route agrees; checked).
* **Continuous ≡ solo inside the port**, in hier, flat and device-cache
  modes at eviction-inducing pools, with 4-token pages so rows share steps
  at other padded lengths.  What makes a row's bits depend on its batch on
  the CPU was measured (torch's CPU matmuls, rows of [B, d] @ [d, n]
  against the M = 1 product): bf16 products and attention over a padded T
  are batch-invariant at every width probed (up to 2048 × 5632); the f32
  router product (``route``: ``x.float() @ router_w``) is batch-invariant
  at d_model 128 and 256 × 8 experts (the smoke widths: continuous and
  solo logits bit-identical) but not at 256 × 16, nor from 512 × 8 up,
  where a row's router probabilities differ in their last bits from the
  solo run's.  So the test runs d_model 128 and 512 and asserts:

  - bit identity of everything upstream of the first batch-variant op:
    the K/V pages each request committed in layer 0, and every page, token
    and logit of a request whose router probabilities were bit-identical
    to the solo run's at every step;
  - the same routed experts wherever the router's top-k gap exceeds the
    row's measured probability difference;
  - the same tokens wherever the logits decide them (top-2 gap above twice
    the row's difference), and logits within ``MAX_REL`` of the largest
    |logit|: the continuous run differs from the solo one only by last-bit
    router differences, a smaller perturbation than the cross-package one
    (every sum in another order) that ``MAX_REL`` bounds.

  The port's arithmetic is not changed to make it batch-invariant: the
  JAX package has no such mode.
* **The port's serving contracts**, ported from the JAX package's tests
  that pass: admission-order independence, the interleaving fuzz with byte
  accounting at every retirement (``ZIPMOE_CHECK=1``), no duplicate chunk
  reads with ample pools, one-token completions, exact ``max_len`` fits,
  an early EOS that drains pending prefetch, ``submit`` rejecting and
  clamping, and a ``StepFault`` that retires only the faulted rows while
  the survivors' tokens equal a fault-free run's; and sampling at a
  temperature keyed per request, not per batch.
"""
import collections

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.engine import FetchHandle as RefFetchHandle
from repro.core.store import build_store as ref_build_store
from repro.serving.server import BatchServer as RefBatchServer
from repro.serving.zipserve import ZipServer as RefZipServer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import FetchHandle
from repro_torch.models.moe import route
from repro_torch.serving.kv_cache import KVPagePool
from repro_torch.serving.server import BatchServer
from repro_torch.serving.zipserve import ZipServer
from test_torch_models import MAX_REL, numpy_params
from test_torch_options import _corrupt

TINY = {"F": 1, "C": 1, "S": 1, "E": 1}          # eviction-inducing
MODES = {
    "hier-evicting": dict(pool_sizes=TINY),
    "flat-evicting": dict(pool_sizes=TINY, cache_mode="flat",
                          flat_capacity=3),
    "device-cache": dict(pool_sizes={"F": 2, "C": 2, "S": 2, "E": 2},
                         device_cache=True),
}


def _setup(tmp_path_factory, d_model=None):
    kw = {} if d_model is None else {"d_model": d_model}
    jcfg = ref_smoke_config("qwen2-moe-a2.7b", n_layers=2, **kw)
    cfg = get_smoke_config("qwen2-moe-a2.7b", n_layers=2, **kw)
    jparams = numpy_params(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    d = str(tmp_path_factory.mktemp(f"store_cb{d_model or ''}"))
    ref_build_store(jparams, jcfg, d, k_shards=4)
    return jcfg, jparams, cfg, params, d


@pytest.fixture(scope="module")
def moe2(tmp_path_factory):
    return _setup(tmp_path_factory)


@pytest.fixture(scope="module")
def moe2_wide(tmp_path_factory):
    """d_model 512: the router's f32 product is batch-variant here."""
    return _setup(tmp_path_factory, d_model=512)


_ORIG_FFN = ZipServer._zip_moe_ffn
_ORIG_FREE = KVPagePool.free


def settle_predictions(monkeypatch):
    """Make both packages' prediction jobs finish before each drain asks
    whether they are done (``ZipServer._drain``).  A finished job's unused
    tail is admitted to the pools at that drain, an unfinished one's at a
    later one, so without this the experts resident at a step's start,
    and with them ``request_summary()``'s hits, depend on how fast the
    host reconstructs: a host that finishes no prediction in time reads 1
    hit fewer for a request than the reference on a faster one.  With it,
    every prediction lands at the first drain after its step in both
    packages."""
    for cls in (RefFetchHandle, FetchHandle):
        monkeypatch.setattr(cls, "done",
                            lambda self: self._job.done_ev.wait(60.0))


class Recorder:
    """Per request: each step's router probabilities and ids per MoE layer
    (recomputed from the FFN's input, the same call ``_zip_moe_ffn``
    makes), and the K/V pages it committed (read when its pages are
    freed).  A new Recorder replaces the previous one: each records the
    runs made after it until the next."""

    def __init__(self, monkeypatch):
        self.routes = collections.defaultdict(list)  # rid -> [(l, p, i)]
        self.pages = {}                              # rid -> [(k, v)]
        orig_ffn, orig_free = _ORIG_FFN, _ORIG_FREE
        rec = self

        def ffn(self, lp, x, layer_idx, owners=None):
            if owners is not None:
                _, ti, probs = route(lp["ffn"]["router"], x, self.cfg)
                for b, rid in enumerate(owners):
                    rec.routes[rid].append((layer_idx,
                                            probs[b, 0].numpy().copy(),
                                            np.sort(ti[b, 0].numpy())))
            return orig_ffn(self, lp, x, layer_idx, owners)

        def free(self, rid):
            tab = torch.as_tensor(self._tables[rid])
            rec.pages[rid] = [
                tuple(buf[tab].reshape((-1,) + buf.shape[2:]).clone()
                      for buf in (lay["kv"]["k"], lay["kv"]["v"]))
                for lay in self._paged]
            return orig_free(self, rid)

        monkeypatch.setattr(ZipServer, "_zip_moe_ffn", ffn)
        monkeypatch.setattr(KVPagePool, "free", free)


def _serve(cfg, params, d, prompts, *, zs_kw, cc=2, max_new=3, max_len=24,
           arrivals=None, eos=None, max_news=None, on_retire=None,
           page_size=4, continuous=True):
    """Serve `prompts` through one port BatchServer; returns the finished
    Requests in submission order, the server and the (closed) ZipServer."""
    zs = ZipServer(params, cfg, d, L=3, prefetch=True, device="cpu", **zs_kw)
    srv = BatchServer(None, cfg, max_batch=cc, max_len=max_len,
                      zip_server=zs, max_concurrency=cc, page_size=page_size,
                      continuous=continuous)
    if on_retire is not None:
        srv.on_retire = lambda r: on_retire(srv, zs, r)
    try:
        rids = [srv.submit(p, (max_news[i] if max_news else max_new),
                           arrival_s=(arrivals[i] if arrivals else 0.0),
                           eos_token=eos, record_logits=continuous)
                for i, p in enumerate(prompts)]
        by = {r.rid: r for r in srv.run()}
        return [by[r] for r in rids], srv, zs
    finally:
        zs.close()


def _prompts(cfg, seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


def _decided(logits, diff) -> bool:
    top = np.sort(logits)[::-1]
    return top[0] - top[1] > 2 * diff


def assert_same_request(a, b, ra, rb, rec_a=None, rec_b=None):
    """Request `a` (run with recorder `rec_a`, request id `ra`) against
    request `b` served another way: bits where the routers' bits agree,
    else routes where decided, tokens where decided, logits within
    MAX_REL.  Without recorders (two packages) only the last three are
    checked.  Returns (bit-identical logits, tokens compared)."""
    routes_bitequal = rec_a is not None
    if rec_a is not None:
        steps = list(zip(rec_a.routes[ra], rec_b.routes[rb]))
        for (la, pa, ia), (lb, pb, ib) in steps:
            assert la == lb
            if np.array_equal(pa, pb):
                continue
            routes_bitequal = False
            top = np.sort(pb)[::-1]
            k = len(ib)
            if top[k - 1] - top[k] > np.abs(pa - pb).max():
                assert np.array_equal(ia, ib), (ra, la, ia, ib)
        pages_a, pages_b = rec_a.pages[ra], rec_b.pages[rb]
        n = len(a.prompt) + len(a.output) - 1          # positions committed
        for layer, (kva, kvb) in enumerate(zip(pages_a, pages_b)):
            if layer == 0 or routes_bitequal:
                for x, y in zip(kva, kvb):
                    assert torch.equal(x[:n].view(torch.int16),
                                       y[:n].view(torch.int16)), (ra, layer)
    compared = 0
    for t, (x, y) in enumerate(zip(a.logits, b.logits)):
        if routes_bitequal:
            assert np.array_equal(x, y), (ra, t)
        diff = np.abs(x - y).max()
        assert diff <= MAX_REL * np.abs(y).max(), (ra, t, diff)
        compared += 1
        if a.output[t] != b.output[t]:
            assert not _decided(y, diff), (ra, t)
            break                       # the streams part at a near-tie
    return routes_bitequal, compared


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
def _serve_ref(jcfg, jparams, d, prompts, *, zs_kw, cc, arrivals, max_new=3,
               max_len=24):
    zs = RefZipServer(jparams, jcfg, d, L=3, prefetch=True, **zs_kw)
    srv = RefBatchServer(None, jcfg, max_batch=cc, max_len=max_len,
                         zip_server=zs, max_concurrency=cc, page_size=4)
    try:
        rids = [srv.submit(p, max_new, arrival_s=arrivals[i],
                           record_logits=True)
                for i, p in enumerate(prompts)]
        by = {r.rid: r for r in srv.run()}
        return [by[r] for r in rids], srv, zs
    finally:
        zs.close()


@pytest.mark.parametrize("mode", ["hier-evicting", "device-cache"])
def test_continuous_matches_reference(moe2, monkeypatch, mode):
    jcfg, jparams, cfg, params, d = moe2
    prompts = _prompts(cfg, 1, (4, 7, 5))
    # all at once behind max_concurrency=2: the third request joins when
    # the first retires, at the same step in both packages whatever the
    # host's speed (an arrival time would race the steps' wall time)
    arrivals = [0.0, 0.0, 0.0]
    seen = []
    ref_ffn = RefZipServer._zip_moe_ffn

    def recording(self, lp, x, layer_idx, owners=None):
        from repro.models.moe import route as ref_route
        _, ti, _ = ref_route(lp["ffn"]["router"], x, self.cfg)
        seen.append((layer_idx, list(owners),
                     np.sort(np.asarray(ti)[:, 0], -1)))
        return ref_ffn(self, lp, x, layer_idx, owners)

    monkeypatch.setattr(RefZipServer, "_zip_moe_ffn", recording)
    settle_predictions(monkeypatch)
    want, ref_srv, _ = _serve_ref(jcfg, jparams, d, prompts,
                                  zs_kw=MODES[mode], cc=2, arrivals=arrivals)
    got, srv, zs = _serve(cfg, params, d, prompts, zs_kw=MODES[mode], cc=2,
                          arrivals=arrivals)
    for a, b in zip(got, want):
        assert a.rid == b.rid and len(a.logits) == len(b.logits) == 3
        _, n = assert_same_request(a, b, a.rid, b.rid)
        assert n >= 1
    # the same batches in the same order, every route the same: the
    # per-request cache accounting is then the reference's exactly
    mine = [(s["layer"], s["owners"], np.sort(s["routes"], -1))
            for s in zs.stats]
    assert len(mine) == len(seen)
    for (la, oa, ia), (lb, ob, ib) in zip(mine, seen):
        assert (la, oa) == (lb, ob) and np.array_equal(ia, ib)
    got_rs, want_rs = srv.request_summary(), ref_srv.request_summary()
    assert got_rs.keys() == want_rs.keys()
    for rid in got_rs:
        for key in ("cache_accesses", "cache_hits", "cache_steps",
                    "n_tokens"):
            assert got_rs[rid][key] == want_rs[rid][key], (rid, key)


# ---------------------------------------------------------------------------
# continuous ≡ solo inside the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("width", ["d128", "d512"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_continuous_matches_solo(request, monkeypatch, width, mode):
    jcfg, jparams, cfg, params, d = request.getfixturevalue(
        "moe2" if width == "d128" else "moe2_wide")
    prompts = _prompts(cfg, 1, (4, 7, 5))
    rec = Recorder(monkeypatch)
    batched, _, _ = _serve(cfg, params, d, prompts, zs_kw=MODES[mode],
                           cc=2, arrivals=[0.0, 0.0, 0.02])
    for r, p in zip(batched, prompts):
        solo_rec = Recorder(monkeypatch)
        solo, _, _ = _serve(cfg, params, d, [p], zs_kw=MODES[mode], cc=1)
        assert len(solo[0].logits) == len(r.logits) == 3
        _, n = assert_same_request(r, solo[0], r.rid, solo[0].rid, rec,
                                   solo_rec)
        assert n >= 1


def test_continuous_matches_any_admission_order(moe2, monkeypatch):
    """Reversing the arrival order (so admission order and row positions
    flip) changes no request's result."""
    jcfg, jparams, cfg, params, d = moe2
    prompts = _prompts(cfg, 2, (5, 3, 6))
    rec_f = Recorder(monkeypatch)
    fwd, _, _ = _serve(cfg, params, d, prompts, zs_kw=dict(pool_sizes=TINY),
                       cc=2, arrivals=[0.0, 0.01, 0.02])
    rec_r = Recorder(monkeypatch)
    rev, _, _ = _serve(cfg, params, d, list(reversed(prompts)),
                       zs_kw=dict(pool_sizes=TINY), cc=2,
                       arrivals=[0.0, 0.01, 0.02])
    for a, b in zip(fwd, reversed(rev)):
        assert a.output == b.output
        assert_same_request(a, b, a.rid, b.rid, rec_f, rec_r)


def test_static_batch_agrees_with_continuous(moe2):
    """The epoch discipline over the same ZipServer modes (prompts of one
    length in one bucket, one of another) emits the continuous run's
    tokens wherever the logits decide them."""
    jcfg, jparams, cfg, params, d = moe2
    prompts = _prompts(cfg, 3, (5, 5, 4))
    cont, _, _ = _serve(cfg, params, d, prompts, zs_kw=dict(pool_sizes=TINY),
                        cc=2)
    static, srv, _ = _serve(cfg, params, d, prompts,
                            zs_kw=dict(pool_sizes=TINY), cc=2,
                            continuous=False)
    assert not srv.continuous and not hasattr(srv, "pool")
    for a, b in zip(static, cont):
        assert len(a.output) == 3 and a.ttft is not None and a.done
        for t, (x, y) in enumerate(zip(a.output, b.output)):
            if x != y:
                assert not _decided(b.logits[t], MAX_REL
                                    * np.abs(b.logits[t]).max())
                break
    assert srv.metrics()["n_requests"] == 3


def test_sampling_keyed_per_request(moe2):
    """At a temperature each request draws from its own generator, seeded
    from (seed, rid): served two at a time or one after the other, a
    request whose logits are bit-identical in both runs emits the same
    tokens, and the draws are not the greedy tokens."""
    jcfg, jparams, cfg, params, d = moe2
    prompts = _prompts(cfg, 9, (4, 6))
    runs = []
    for cc in (2, 1):
        zs = ZipServer(params, cfg, d, L=3, pool_sizes=TINY, device="cpu")
        srv = BatchServer(None, cfg, max_batch=cc, max_len=16, zip_server=zs,
                          max_concurrency=cc, temperature=1.0, seed=5)
        try:
            for p in prompts:
                srv.submit(p, 6, record_logits=True)
            runs.append(sorted(srv.run(), key=lambda r: r.rid))
        finally:
            zs.close()
    greedy_differs = False
    for a, b in zip(*runs):
        assert len(a.output) == len(b.output) == 6
        greedy_differs |= any(t != int(np.argmax(x))
                              for t, x in zip(a.output, a.logits))
        if all(np.array_equal(x, y) for x, y in zip(a.logits, b.logits)):
            assert a.output == b.output, a.rid
    assert greedy_differs


# ---------------------------------------------------------------------------
# the port's serving contracts
# ---------------------------------------------------------------------------
def test_interleaving_fuzz_accounting(moe2, monkeypatch):
    """Randomized lengths, budgets and arrivals under ZIPMOE_CHECK=1: after
    every retirement the shared pools' byte accounting is consistent, and
    at the end every pin is released, every prefetch drained, every page
    freed."""
    monkeypatch.setenv("ZIPMOE_CHECK", "1")
    jcfg, jparams, cfg, params, d = moe2
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(3, 9, 6)]
    max_news = [int(x) for x in rng.integers(1, 5, 6)]
    arrivals = sorted(float(x) for x in rng.uniform(0.0, 0.08, 6))
    retired = []

    def check(srv, zs, r):
        retired.append(r.rid)
        cs = zs.cache_summary()
        for p, occ in cs["occupancy_bytes"].items():
            assert occ <= cs["capacity_bytes"][p] + 1e-9, (r.rid, p)
        s = srv.pool.summary()
        assert r.rid not in srv.pool._tables          # pages really freed
        assert s["n_requests"] == len(srv.pool._tables)
        assert s["used_bytes"] == (
            s["used_pages"] * srv.pool.page_nbytes()
            + s["used_slots"] * srv.pool.slot_nbytes())

    done, srv, zs = _serve(cfg, params, d, prompts,
                           zs_kw=dict(pool_sizes={"F": 1, "C": 1,
                                                  "S": 2, "E": 2}),
                           cc=3, max_news=max_news, arrivals=arrivals,
                           max_len=16, on_retire=check)
    assert sorted(retired) == sorted(r.rid for r in done)
    assert len(done) == len(prompts)
    for r, mn, p in zip(done, max_news, prompts):
        assert len(r.output) == min(mn, 16 - len(p))
    for cache in zs.engine.caches.values():
        assert not cache.pinned, dict(cache.pinned)
    assert all(not v for v in zs._pending.values())
    assert srv.pool.used_bytes() == 0
    assert srv.pool.summary()["n_requests"] == 0


def test_no_duplicate_chunk_reads_when_pool_ample(moe2):
    """With pools that hold every expert, a multi-request serve reads each
    compressed chunk at most once: the union block list and the residency
    check dedup across tenants."""
    jcfg, jparams, cfg, params, d = moe2
    prompts = _prompts(cfg, 3, (4, 6, 5))
    ample = {p: cfg.n_experts for p in "FCSE"}
    zs = ZipServer(params, cfg, d, L=3, prefetch=True, pool_sizes=ample,
                   device="cpu")
    try:
        store = zs.engine.store
        reads = collections.Counter()
        orig = store._read

        def counted(fname, offset, size):
            reads[(fname, offset, size)] += 1
            return orig(fname, offset, size)

        store._read = counted                  # instance attr shadows method
        srv = BatchServer(None, cfg, max_batch=3, max_len=24, zip_server=zs,
                          max_concurrency=3)
        for p in prompts:
            srv.submit(p, 4)
        assert len(srv.run()) == len(prompts)
        assert reads, "the serve must read the store"
        dups = {k: v for k, v in reads.items() if v > 1}
        assert not dups, f"duplicate chunk reads: {dups}"
    finally:
        zs.close()


def test_one_token_completion_metrics(moe2):
    """max_new_tokens=1 requests retire after their first sampled token:
    tpot_s is undefined, and metrics() aggregates without it."""
    jcfg, jparams, cfg, params, d = moe2
    prompts = _prompts(cfg, 4, (4, 4, 4))
    done, srv, _ = _serve(cfg, params, d, prompts,
                          zs_kw=dict(pool_sizes=TINY), cc=2, max_new=1)
    for r in done:
        assert len(r.output) == 1
        assert r.ttft is not None and r.done is not None
        assert r.tpot_s is None
    m = srv.metrics()
    assert m["n_requests"] == 3 and m["mean_ttft_s"] > 0
    assert "mean_tpot_s" not in m
    rs = srv.request_summary()
    assert set(rs) == {r.rid for r in done}
    for d_ in rs.values():
        assert d_["n_tokens"] == 1 and d_["tpot_s"] is None
        assert d_["cache_accesses"] > 0
        assert d_["cache_steps"] == 4                 # 4 prompt tokens


def test_exact_max_len_fit_mid_batch(moe2):
    """A request whose S + max_new == max_len exactly completes while
    sharing steps with a shorter one: the last commit lands on the final
    allocated position, never past it."""
    jcfg, jparams, cfg, params, d = moe2
    prompts = _prompts(cfg, 5, (8, 3))
    done, srv, _ = _serve(cfg, params, d, prompts,
                          zs_kw=dict(pool_sizes=TINY), cc=2, max_len=12,
                          max_news=[100, 2])
    assert len(done[0].output) == 4                    # clamped to 12 - 8
    assert len(done[1].output) == 2
    assert srv.pool.used_bytes() == 0


def test_eos_retire_drains_pending_prefetch(moe2):
    """An EOS retires the request early; the prefetch jobs issued for steps
    that never run are drained — nothing stays in _pending or pinned."""
    jcfg, jparams, cfg, params, d = moe2
    prompt = _prompts(cfg, 6, (5,))[0]
    probe, _, _ = _serve(cfg, params, d, [prompt],
                         zs_kw=dict(pool_sizes=TINY), cc=1, max_new=4)
    first = probe[0].output[0]
    done, srv, zs = _serve(cfg, params, d, [prompt],
                           zs_kw=dict(pool_sizes=TINY), cc=1, max_new=4,
                           eos=first)
    assert done[0].output == [first]
    assert all(not v for v in zs._pending.values())
    for cache in zs.engine.caches.values():
        assert not cache.pinned
    assert srv.pool.used_bytes() == 0


def test_submit_rejects_and_clamps():
    cfg = get_smoke_config("qwen2-moe-a2.7b", n_layers=2)
    srv = BatchServer(None, cfg, max_len=16, zip_server=object())
    with pytest.raises(ValueError):
        srv.submit(np.zeros(16, np.int32))      # no room for one new token
    with pytest.raises(ValueError):
        srv.submit(np.zeros(0, np.int32))       # empty prompt
    srv.submit(np.zeros(10, np.int32), max_new_tokens=100)
    assert srv.queue[-1].max_new_tokens == 6    # clamped to max_len - S
    srv.submit(np.zeros(10, np.int32), max_new_tokens=0)
    assert srv.queue[-1].max_new_tokens == 1    # at least one token


def test_step_fault_retires_only_faulted_rows(moe2, tmp_path, monkeypatch):
    """A persistently corrupt expert retires ONLY the requests that route
    to it, with the error naming it; the survivors' tokens equal a
    fault-free run's (their logits within the solo bound), and no KV page
    or cache pin leaks."""
    monkeypatch.setenv("ZIPMOE_CHECK", "1")
    jcfg, jparams, cfg, params, d0 = moe2
    prompts = _prompts(cfg, 0, (4, 4, 4, 4))
    kw = dict(zs_kw=dict(pool_sizes={"F": 2, "C": 2, "S": 2, "E": 2}), cc=2,
              max_new=4)
    rec = Recorder(monkeypatch)
    clean, _, _ = _serve(cfg, params, d0, prompts, **kw)
    # corrupt an expert that some requests route to, but not all (and not
    # the first group, which the engine reads to calibrate at start-up)
    users = collections.defaultdict(set)
    for rid, steps in rec.routes.items():
        for layer, _, ids in steps:
            for e in ids:
                users[(layer, int(e))].add(rid)
    bad = next(k for k, v in sorted(users.items())
               if 0 < len(v) < len(prompts) and k != (0, 0))
    d = str(tmp_path / "store")
    ref_build_store(jparams, jcfg, d, k_shards=4)
    _corrupt(d, bad)
    chaos, srv, zs = _serve(cfg, params, d, prompts, **kw)
    m = srv.metrics()
    assert m["n_requests"] == 4 and 1 <= m["n_failed"] < 4
    fs = zs.fault_summary()
    assert fs["store"]["quarantined"] >= 1 and fs["failed_experts"] >= 1
    tag = f"L{bad[0]}E{bad[1]}"
    for r, c in zip(chaos, clean):
        if r.error is not None:
            assert tag in r.error and r.done is not None
            continue
        assert r.output == c.output, r.rid
        for x, y in zip(r.logits, c.logits):
            assert np.abs(x - y).max() <= MAX_REL * np.abs(y).max()
    assert len(srv.pool._free_pages) == srv.pool.n_pages
    assert zs.cache_summary()["pinned"] == 0
