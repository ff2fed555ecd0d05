"""Serving options of the port held against the JAX package's, on one store
built by the JAX package and the same numpy-seeded parameters:

* ``cross_layer_depth`` 1, 2 and ``"auto"`` only move fetch work in time:
  logits bit-identical to depth 0 inside the port, and the greedy tokens of
  the JAX package's server at the same depth fed the same tokens
  (``assert_greedy_agrees``: logits within 2% of the largest |logit|,
  equal argmax wherever the logits decide it);
* ``cache_window`` with ``freq_decay < 1`` gives the reference's windowed
  ``cache_summary(windows=True)``, and every ``flat_policy`` gives its
  ``cache_summary()`` in flat mode — exactly, on the same token stream;
* one engine-level ``FaultPlan`` (a seeded bitflip rate, a worker kill and
  a read delay beyond ``fetch_deadline_s``) over a store with one corrupt
  expert gives the reference's failed keys and error types step by step,
  and the same bits for every expert fetched.
"""
import os
import shutil

import numpy as np
import pytest

import repro.core.faults as ref_faults
from repro.core.engine import ZipMoEEngine as RefEngine
from repro.core.store import ExpertStore as RefStore
from repro.core.store import build_store as ref_build_store
from repro.serving.zipserve import ZipServer as RefZipServer
import repro_torch.core.faults as faults
from repro_torch.core import bitfield
from repro_torch.core.engine import ZipMoEEngine
from repro_torch.core.store import ExpertStore
from repro_torch.serving.zipserve import ZipServer
from test_torch_models import assert_greedy_agrees, both_params, serve_greedy

POOLS = {"F": 1, "C": 1, "S": 2, "E": 2}
STEPS = 8
# "auto" re-tunes once per window of steps; a 2-step window lets it tune
# three times within STEPS (the class default, 8, would not tune before
# the last step).  Both packages run the same window.
AUTO_WINDOW = 2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    # three MoE layers, so depth 2 reaches past depth 1
    jcfg, jparams, cfg, params = both_params(n_layers=3)
    d = str(tmp_path_factory.mktemp("store_options"))
    ref_build_store(jparams, jcfg, d, k_shards=4)
    return jcfg, jparams, cfg, params, d


def _pair(setup, **kw):
    jcfg, jparams, cfg, params, d = setup
    return (ZipServer(params, cfg, d, L=2, device="cpu", **kw),
            RefZipServer(jparams, jcfg, d, L=2, **kw))


@pytest.fixture(scope="module")
def sync_run(setup):
    _, _, cfg, params, d = setup
    zs = ZipServer(params, cfg, d, L=2, pool_sizes=POOLS, prefetch=False,
                   device="cpu")
    try:
        return serve_greedy(zs, cfg.vocab_size, STEPS)
    finally:
        zs.close()


@pytest.mark.parametrize("depth", [1, 2, "auto"])
def test_cross_layer_depth_bitidentical_and_reference_tokens(setup, sync_run,
                                                             depth):
    cfg = setup[2]
    zs, ref = _pair(setup, pool_sizes=POOLS, prefetch=True,
                    cross_layer_depth=depth)
    if depth == "auto":
        zs._DEPTH_WINDOW = ref._DEPTH_WINDOW = AUTO_WINDOW
    try:
        lg, tok = serve_greedy(zs, cfg.vocab_size, STEPS)
        assert np.array_equal(lg, sync_run[0])
        ref_lg, _ = serve_greedy(ref, cfg.vocab_size, STEPS, feed=tok)
        assert_greedy_agrees(lg, tok, ref_lg)
        ov = zs.overlap_summary()
        assert ov["pred_hits"] + ov["pred_misses"] > 0
        if depth == "auto":
            assert zs._auto_depth
            assert 0 <= ov["cross_layer_depth"] <= len(zs._moe_layers)
            for ev in ov["depth_events"]:
                assert ev["from"] != ev["to"]
                assert 0.0 <= ev["hidden_frac"] <= 1.0
        else:
            assert ov["cross_layer_depth"] == depth
    finally:
        zs.close()
        ref.close()


def _feed(cfg, steps=STEPS, B=2):
    """A token stream both packages are fed (teacher forcing), so the
    caches see the same routed experts in the same order."""
    return np.random.default_rng(7).integers(0, cfg.vocab_size, (B, steps))


def test_cache_windows_match_reference(setup):
    cfg = setup[2]
    zs, ref = _pair(setup, pool_sizes=POOLS, prefetch=False, cache_window=2,
                    freq_decay=0.8)
    try:
        for s in (zs, ref):
            serve_greedy(s, cfg.vocab_size, STEPS, feed=_feed(cfg))
        got = zs.cache_summary(windows=True)
        assert got["window_steps"] == 2
        assert len(got["windows"]) == STEPS // 2
        assert got == ref.cache_summary(windows=True)
        assert zs.cache_summary(per_layer=True) == \
            ref.cache_summary(per_layer=True)
    finally:
        zs.close()
        ref.close()


@pytest.mark.parametrize("policy", ["fifo", "lru", "marking", "lfu"])
def test_flat_policy_matches_reference(setup, policy):
    cfg = setup[2]
    zs, ref = _pair(setup, cache_mode="flat", flat_policy=policy,
                    flat_capacity=3, prefetch=False)
    try:
        for s in (zs, ref):
            serve_greedy(s, cfg.vocab_size, STEPS, feed=_feed(cfg))
        got = zs.cache_summary()
        assert got["mode"] == f"flat-{policy}" and got["evictions"] > 0
        assert got == ref.cache_summary()
    finally:
        zs.close()
        ref.close()


# ---------------------------------------------------------------------------
# faults: one seeded plan through both packages' engines
# ---------------------------------------------------------------------------
DEADLINE_S = 1.0
FAULT_PLAN = ("bitflip:p=0.05;worker_kill:count=1,after=6;"
              f"delay:op=read,delay_s={3 * DEADLINE_S},count=1,after=160;"
              "seed=13")
BAD = (1, 2)
TRACE = [(0, [0, 1]), (1, [3, 4]), (0, [2, 5]), (1, [1, 2, 3]),
         (0, [6, 7]), (1, [5, 6]), (0, [0, 3, 4]), (1, [3, 7])]


def _corrupt(d, key):
    """Persistently corrupt the first E-chunk of `key`'s group file."""
    st = ExpertStore(d)
    g = st.groups[key]
    off = g.tensors[0].e_offsets[0]
    st.close()
    with open(os.path.join(d, g.file), "r+b") as f:
        f.seek(off)
        b = f.read(4)
        f.seek(off)
        f.write(bytes(x ^ 0xFF for x in b))


def _fault_run(engine_cls, store_cls, mod, d, cfg):
    """Each step's outcome: ("ok", {expert: {name: uint16 bits}}) or
    (error type, failed keys)."""
    store = store_cls(d, faults=mod.FaultPlan.parse(FAULT_PLAN),
                      max_retries=2, retry_backoff_s=0.0)
    eng = engine_cls(store, n_experts=cfg.n_experts, n_layers=cfg.n_layers,
                     L=2, pool_sizes={"F": 2, "C": 2, "S": 2, "E": 2},
                     fetch_deadline_s=DEADLINE_S, watchdog_interval_s=0.01)
    out = []
    try:
        for layer, ids in TRACE:
            h = eng.prefetch_experts(layer, ids)
            try:
                w, _ = h.result()
            except mod.FetchTimeout:
                out.append(("FetchTimeout", []))
                # let the delayed job finish before the next step is timed
                h.spec_result(deadline_s=30.0)
                continue
            except mod.FetchError as exc:
                out.append(("FetchError", sorted(exc.failures)))
                continue
            out.append(("ok", {e: {k: np.asarray(v).view(np.uint16)
                                   if not hasattr(v, "numpy")
                                   else bitfield.to_bits(v)
                                   for k, v in t.items()}
                               for e, t in w.items()}))
        fs = eng.fault_summary()
    finally:
        eng.shutdown()
    return out, fs


def test_fault_plan_matches_reference(setup, tmp_path):
    cfg, d0 = setup[2], setup[4]
    d = str(tmp_path / "store")
    shutil.copytree(d0, d)
    _corrupt(d, BAD)
    got, fs = _fault_run(ZipMoEEngine, ExpertStore, faults, d, cfg)
    want, rfs = _fault_run(RefEngine, RefStore, ref_faults, d, cfg)
    kinds = [o[0] for o in got]
    assert kinds == [o[0] for o in want]
    assert "FetchTimeout" in kinds and "FetchError" in kinds
    clean = ExpertStore(d0)
    try:
        for (kind, a), (_, b), (layer, ids) in zip(got, want, TRACE):
            if kind != "ok":
                assert a == b
                if kind == "FetchError":
                    assert a == [BAD]
                continue
            assert sorted(a) == sorted(b) == sorted(ids)
            for e in ids:
                ref_w = clean.load_group((layer, e))
                for name, bits in a[e].items():
                    assert np.array_equal(bits, b[e][name])
                    assert np.array_equal(bits, ref_w[name])
    finally:
        clean.close()
    for s in (fs, rfs):
        assert s["worker_restarts"] >= 1
        assert s["deadline_hits"] >= 1
        assert s["failed_experts"] >= 1
    for key in ("failed_experts", "deadline_hits", "fallback_loads"):
        assert fs[key] == rfs[key], key
    assert fs["injected"] == rfs["injected"]
    assert fs["store"] == rfs["store"]
