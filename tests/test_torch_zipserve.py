"""The port's ZipServer against the JAX package's, on one store built by
the JAX package and the same parameters (``params_from_jax``):

* greedy tokens identical over 4 decode steps, logits within the bf16
  tolerance of test_torch_models (2% of the largest |logit| at worst) —
  the two packages add the expert GEMMs and the combine in other orders;
* the engine in device mode fetches the same bits and charges the same
  h2d / splice counters as the JAX package's;
* within the port, ``device_cache`` on ≡ off and ``prefetch`` on ≡ off,
  bit for bit;
* a fully cache-hit device-mode step stages zero weight-copy bytes and
  zero h2d bytes (the JAX package's acceptance regression).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import ZipMoEEngine as RefEngine
from repro.core.store import ExpertStore as RefStore
from repro.core.store import build_store as ref_build_store
from repro.serving.zipserve import ZipServer as RefZipServer
from repro_torch.core import bitfield
from repro_torch.core.engine import ZipMoEEngine
from repro_torch.core.slab import SlotRef
from repro_torch.core.store import ExpertStore
from repro_torch.serving.zipserve import ZipServer
from test_torch_models import both_params

POOLS = {"F": 2, "C": 2, "S": 2, "E": 2}
MAX_REL = 0.02
B, S, STEPS = 2, 12, 4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, jparams, cfg, params = both_params()
    d = str(tmp_path_factory.mktemp("store_zs"))
    ref_build_store(jparams, jcfg, d, k_shards=4)
    return jcfg, jparams, cfg, params, d


def _tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (B, 1))


def _decode_port(zs, cfg, steps=STEPS):
    caches = zs.init_cache(B, S + steps)
    tok = torch.from_numpy(_tokens(cfg))
    logits, toks = [], []
    for i in range(steps):
        lg, caches = zs.decode_step(tok, caches, S - 1 + i)
        tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        logits.append(lg.float().numpy())
        toks.append(tok.numpy())
    return np.stack(logits), np.concatenate(toks, 1)


def _decode_ref(zs, cfg, steps=STEPS):
    caches = zs.init_cache(B, S + steps)
    tok = jnp.asarray(_tokens(cfg), jnp.int32)
    logits, toks = [], []
    for i in range(steps):
        lg, caches = zs.decode_step(tok, caches, S - 1 + i)
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        logits.append(np.asarray(lg, np.float32))
        toks.append(np.asarray(tok))
    return np.stack(logits), np.concatenate(toks, 1)


def test_zipserver_matches_reference(setup):
    jcfg, jparams, cfg, params, d = setup
    kw = dict(L=3, pool_sizes=POOLS, prefetch=True, device_cache=True)
    zs_r = RefZipServer(jparams, jcfg, d, **kw)
    zs_p = ZipServer(params, cfg, d, device="cpu", **kw)
    try:
        ref_lg, ref_tok = _decode_ref(zs_r, jcfg)
        out_lg, out_tok = _decode_port(zs_p, cfg)
        assert np.array_equal(out_tok, ref_tok)
        diff = np.abs(out_lg - ref_lg)
        assert diff.max() <= MAX_REL * np.abs(ref_lg).max(), diff.max()
        # same routing -> same union selections and token counts per layer
        assert zs_p._last_ids == zs_r._last_ids
        for k in ("tokens_real", "tokens_padded"):
            assert zs_p.overlap_stats[k] == zs_r.overlap_stats[k], k
    finally:
        zs_r.close()
        zs_p.close()


def test_engine_device_fetch_matches_reference(setup):
    """Same store, same fetch trace, device mode: bit-identical weights and
    identical h2d / splice / slab-write counters."""
    jcfg, _, cfg, _, d = setup
    kw = dict(n_experts=cfg.n_experts, n_layers=cfg.n_layers, L=2,
              pool_sizes=POOLS, device_cache=True)
    ref = RefEngine(RefStore(d), **kw)
    eng = ZipMoEEngine(ExpertStore(d), device="cpu", **kw)
    trace = [(0, [0, 1]), (1, [2, 5]), (0, [1, 3, 4]), (0, [0, 1]),
             (1, [6, 7, 2])]
    try:
        for layer, ids in trace:
            got, _ = eng.fetch_experts(layer, ids)
            want, _ = ref.fetch_experts(layer, ids)
            for e in ids:
                for name, v in got[e].items():
                    w = want[e][name]
                    w = w.read() if hasattr(w, "read") else w
                    v = v.read() if isinstance(v, SlotRef) else v
                    assert np.array_equal(bitfield.to_bits(v),
                                          np.asarray(w).view(np.uint16))
        a, b = eng.transfer_summary(), ref.transfer_summary()
        for k in ("h2d_bytes", "splice_ops", "slab_writes", "slab_resident",
                  "w_copy_bytes"):
            assert a[k] == b[k], (k, a[k], b[k])
    finally:
        eng.shutdown()
        ref.shutdown()


@pytest.mark.parametrize("flip", [dict(device_cache=(True, False)),
                                  dict(prefetch=(True, False))],
                         ids=["device_cache", "prefetch"])
def test_port_modes_bitidentical(setup, flip):
    _, _, cfg, params, d = setup
    (name, (a, b)), = flip.items()
    base = dict(L=3, pool_sizes=POOLS, prefetch=True, device_cache=True)
    outs = []
    for v in (a, b):
        zs = ZipServer(params, cfg, d, device="cpu", **{**base, name: v})
        try:
            outs.append(_decode_port(zs, cfg))
        finally:
            zs.close()
    assert np.array_equal(outs[0][0], outs[1][0])
    assert np.array_equal(outs[0][1], outs[1][1])


def test_cache_hit_step_zero_w_copy_and_h2d(setup):
    """With every expert slab-resident, decode steps stage ZERO
    weight-copy bytes and move ZERO h2d bytes; host mode keeps paying the
    per-step upload and stack."""
    _, _, cfg, params, d = setup
    ample = {"F": cfg.n_experts, "C": 0, "S": 0, "E": 0}
    deltas = {}
    for mode, dc in (("host", False), ("device", True)):
        zs = ZipServer(params, cfg, d, L=3, pool_sizes=ample, prefetch=True,
                       device_cache=dc, device="cpu")
        try:
            for l in zs._moe_layers:       # warm every expert into F
                zs.engine.fetch_experts(l, list(range(cfg.n_experts)))
            caches = zs.init_cache(B, 18)
            lg, caches = zs.decode_step(torch.zeros(B, 1, dtype=torch.long),
                                        caches, 11)
            h2d0, w0 = zs.engine.h2d_bytes, zs.engine.w_copy_bytes
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            for i in range(3):
                lg, caches = zs.decode_step(tok, caches, 12 + i)
                tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            deltas[mode] = (zs.engine.h2d_bytes - h2d0,
                            zs.engine.w_copy_bytes - w0)
            if dc:
                assert all(s["h2d_bytes"] == 0 and s["w_copy_bytes"] == 0
                           for s in zs.stats[-3 * len(zs._moe_layers):])
        finally:
            zs.close()
    assert deltas["device"] == (0, 0), deltas
    assert deltas["host"][0] > 0 and deltas["host"][1] > 0, deltas


def test_stale_slotref_trips_ragged_weight_source(setup):
    """A freed slot's SlotRef reaching the slot-indexed weight resolution
    crashes instead of being read as the slot's new occupant."""
    from repro_torch.core.slab import DeviceSlabCache
    _, _, cfg, params, d = setup
    zs = ZipServer(params, cfg, d, L=2, pool_sizes=POOLS, prefetch=False,
                   device_cache=True, device="cpu")
    try:
        slab = DeviceSlabCache(9, {"w_up": (4, 8)}, capacity=1, device="cpu")
        refs = slab.put(0, {"w_up": torch.ones(4, 8, dtype=torch.bfloat16)})
        slab.free(0)
        with pytest.raises(AssertionError):
            zs._slab_sources("w_up", {0: {"w_up": refs["w_up"]}}, [0])
    finally:
        zs.close()
