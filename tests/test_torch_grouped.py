"""The port's grouped, per-token-loop and fused-recovery FFNs of ZipServer,
and its measured p-times, against the JAX package's, on one store built by
the JAX package and the same parameters (``params_from_jax``):

* greedy tokens identical over 4 decode steps and logits within 2% of the
  largest |logit| (the tolerance of test_torch_zipserve: the two packages
  add the expert GEMMs and the combine in other orders) for
  ``ffn_impl="grouped"`` (device cache on and off), ``"loop"``,
  ``fused_recovery=True`` (batched and per expert), ``device_recovery``
  (the JAX package's ``use_pallas_recovery``) and ``profile_p_times``;
* within the port, bit for bit: grouped ≡ ragged in hier, flat and device
  modes, zip batched ≡ zip loop, and profiling changes no output;
* a cache-hit grouped step moves no h2d bytes but pays the gather copy
  (``w_copy_bytes`` > 0) that the ragged path avoids;
* a fused-mode F→S demotion keeps the SM plane of the host bit-planes.
"""
import numpy as np
import pytest
import torch

from repro.core.store import build_store as ref_build_store
from repro.serving.zipserve import ZipServer as RefZipServer
from repro_torch.core.engine import ZipMoEEngine
from repro_torch.core.store import ExpertStore
from repro_torch.serving.zipserve import BitPlanes, ZipServer, _planes_recover
from test_torch_models import both_params
from test_torch_zipserve import POOLS, _decode_port, _decode_ref

MAX_REL = 0.02


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, jparams, cfg, params = both_params()
    d = str(tmp_path_factory.mktemp("store_grouped"))
    ref_build_store(jparams, jcfg, d, k_shards=4)
    return jcfg, jparams, cfg, params, d


def _serve_port(params, cfg, d, **kw):
    zs = ZipServer(params, cfg, d, device="cpu", **kw)
    try:
        return _decode_port(zs, cfg), zs.overlap_summary(), \
            zs.p_time_summary()
    finally:
        zs.close()


MODES = {
    "grouped-host": dict(ffn_impl="grouped"),
    "grouped-device": dict(ffn_impl="grouped", device_cache=True),
    "loop": dict(ffn_impl="loop"),
    "fused-batched": dict(ffn_impl="grouped", fused_recovery=True),
    "fused-loop": dict(ffn_impl="loop", fused_recovery=True),
    "device-recovery-grouped": dict(ffn_impl="grouped",
                                    device_recovery=True),
    "device-recovery-loop": dict(ffn_impl="loop", device_recovery=True),
    "profile": dict(profile_p_times=True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_zipserver_path_matches_reference(setup, mode):
    jcfg, jparams, cfg, params, d = setup
    kw = dict(L=3, pool_sizes=POOLS, prefetch=True, **MODES[mode])
    ref_kw = dict(kw)
    if "device_recovery" in ref_kw:
        ref_kw["use_pallas_recovery"] = ref_kw.pop("device_recovery")
    zs_r = RefZipServer(jparams, jcfg, d, **ref_kw)
    try:
        ref_lg, ref_tok = _decode_ref(zs_r, jcfg)
        ref_pt = zs_r.p_time_summary()
    finally:
        zs_r.close()
    (out_lg, out_tok), ov, pt = _serve_port(params, cfg, d, **kw)
    assert np.array_equal(out_tok, ref_tok)
    diff = np.abs(out_lg - ref_lg)
    assert diff.max() <= MAX_REL * np.abs(ref_lg).max(), diff.max()
    if kw.get("fused_recovery"):
        assert ov["h2d_bytes"] > 0 and ov["splice_ops"] == 0, ov
    if kw.get("profile_p_times"):
        # the same routing asks for the same (layer, experts, cols) buckets
        assert pt["n_measurements"] > 0
        assert set(pt["buckets"]) == set(ref_pt["buckets"])


@pytest.mark.parametrize("mode_kw", [dict(cache_mode="hier"),
                                     dict(cache_mode="flat"),
                                     dict(cache_mode="hier",
                                          device_cache=True)],
                         ids=["hier", "flat", "device"])
def test_grouped_vs_ragged_bitidentical(setup, mode_kw):
    _, _, cfg, params, d = setup
    kw = dict(L=3, pool_sizes=POOLS, prefetch=True, **mode_kw)
    (g_lg, g_tok), ov_g, _ = _serve_port(params, cfg, d, ffn_impl="grouped",
                                         **kw)
    (r_lg, r_tok), ov_r, _ = _serve_port(params, cfg, d, ffn_impl="ragged",
                                         **kw)
    assert np.array_equal(g_lg, r_lg)
    assert np.array_equal(g_tok, r_tok)
    assert ov_g["tokens_real"] == ov_r["tokens_real"] > 0
    assert ov_g["gemm_compiles"] > 0


def test_zip_batched_vs_loop_bitidentical(setup):
    _, _, cfg, params, d = setup
    kw = dict(L=3, pool_sizes=POOLS, prefetch=True, fused_recovery=True)
    (b_lg, b_tok), ov_b, _ = _serve_port(params, cfg, d, ffn_impl="ragged",
                                         **kw)
    (l_lg, l_tok), ov_l, _ = _serve_port(params, cfg, d, ffn_impl="loop",
                                         **kw)
    assert np.array_equal(b_lg, l_lg)
    assert np.array_equal(b_tok, l_tok)
    # both upload the active experts' planes every step, 2 B per element
    assert ov_b["h2d_bytes"] == ov_l["h2d_bytes"] > 0


def test_profile_p_times_changes_no_output(setup):
    """Measured p-times reorder reconstruction work only: the outputs stay
    bit-identical to constant-p scheduling."""
    _, _, cfg, params, d = setup
    kw = dict(L=3, pool_sizes=POOLS, prefetch=True, ffn_impl="grouped")
    (p_lg, p_tok), _, pt = _serve_port(params, cfg, d, profile_p_times=True,
                                       **kw)
    (c_lg, c_tok), _, ct = _serve_port(params, cfg, d, **kw)
    assert np.array_equal(p_lg, c_lg) and np.array_equal(p_tok, c_tok)
    assert ct["n_buckets"] == 0
    assert pt["n_measurements"] > 0
    assert all(b["p_us"] > 0 and "measured" in b["source"]
               for b in pt["buckets"].values())


def test_cache_hit_grouped_step_copies_no_h2d(setup):
    """Every expert slab-resident: a grouped decode step moves zero h2d
    bytes but stages the gather copy of the active experts; the ragged
    step stages none.  Both give the same bits."""
    _, _, cfg, params, d = setup
    ample = {"F": cfg.n_experts, "C": 0, "S": 0, "E": 0}
    deltas, logits = {}, {}
    for impl in ("grouped", "ragged"):
        zs = ZipServer(params, cfg, d, L=3, pool_sizes=ample, prefetch=True,
                       device_cache=True, ffn_impl=impl, device="cpu")
        try:
            for l in zs._moe_layers:       # warm every expert into the slab
                zs.engine.fetch_experts(l, list(range(cfg.n_experts)))
            caches = zs.init_cache(2, 18)
            lg, caches = zs.decode_step(torch.zeros(2, 1, dtype=torch.long),
                                        caches, 11)
            h2d0, w0 = zs.engine.h2d_bytes, zs.engine.w_copy_bytes
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            out = []
            for i in range(3):
                lg, caches = zs.decode_step(tok, caches, 12 + i)
                tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
                out.append(lg.float().numpy())
            deltas[impl] = (zs.engine.h2d_bytes - h2d0,
                            zs.engine.w_copy_bytes - w0)
            logits[impl] = np.stack(out)
            if impl == "grouped":
                assert all(s["h2d_bytes"] == 0 and s["w_copy_bytes"] > 0
                           for s in zs.stats[-3 * len(zs._moe_layers):])
        finally:
            zs.close()
    assert deltas["grouped"][0] == 0 and deltas["grouped"][1] > 0, deltas
    assert deltas["ragged"] == (0, 0), deltas
    assert np.array_equal(logits["grouped"], logits["ragged"])


def test_fused_demotion_keeps_sm_plane(setup):
    """Fused mode keeps host BitPlanes in F; demoting such an expert to S
    must re-derive its SM plane from them (the store's exact bytes), not
    drop the entry."""
    _, _, cfg, _, d = setup
    store = ExpertStore(d)
    eng = ZipMoEEngine(ExpertStore(d), n_experts=cfg.n_experts,
                       n_layers=cfg.n_layers, L=2, delta=0,
                       pool_sizes={"F": 1, "C": 0, "S": 1, "E": 0},
                       recover_fn=_planes_recover)
    try:
        w, _ = eng.fetch_experts(0, [0])
        assert all(isinstance(v, BitPlanes) for v in w[0].values())
        pl = eng.caches[0].pools["F"][0].payload
        assert pl.full and not pl.sm       # F keeps the planes only
        eng.fetch_experts(0, [1])
        eng.fetch_experts(0, [1])          # hotter: 1 takes F, 0 goes to S
        assert 1 in eng.caches[0].pools["F"]
        ent = eng.caches[0].pools["S"].get(0)
        assert ent is not None and ent.payload is not None
        g = store.groups[(0, 0)]
        assert set(ent.payload.sm) == set(range(len(g.tensors)))
        for tidx in range(len(g.tensors)):
            assert bytes(ent.payload.sm[tidx]) == \
                bytes(store.read_sm((0, 0), tidx))
        assert eng._sm_plane_of(w[0]["w_up"]) == \
            bytes(store.read_sm((0, 0), [t.name for t in g.tensors]
                                .index("w_up")))
    finally:
        eng.shutdown()
        store.close()
