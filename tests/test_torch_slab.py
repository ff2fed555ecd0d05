"""Device-resident expert slab invariants in the port (the torch twin of
tests/test_device_slab.py), run on CPU tensors:

* DeviceSlabCache — slot alloc/free, generation counters invalidating
  stale refs, slot reuse, ``retire``, writes in place (the buffer's
  ``data_ptr`` never changes), fused splice-admit of bit-planes,
  ``read_np`` returning a copy (a ``read()`` view aliases the slab);
* engine device_cache mode — slab slots track F-pool residency, stale
  SlotRefs are never re-admitted, pinned residents keep their slot, and
  fetched weights are bit-exact against the store.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import bitfield
from repro_torch.core.engine import ExpertPayload, ZipMoEEngine
from repro_torch.core.slab import DevicePlanes, DeviceSlabCache, SlotRef
from repro_torch.core.states import CState
from repro_torch.core.store import ExpertStore, build_store
from repro_torch.models import init_params

CPU = torch.device("cpu")
POOLS = {"F": 2, "C": 2, "S": 2, "E": 2}


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(torch.bfloat16)


def _same(a, b) -> bool:
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


# ---------------------------------------------------------------------------
# DeviceSlabCache unit invariants
# ---------------------------------------------------------------------------
def test_slab_put_gather_roundtrip():
    slab = DeviceSlabCache(0, {"w": (4, 8)}, capacity=3, device=CPU)
    rng = np.random.default_rng(0)
    vals = {e: _bf16(rng, (4, 8)) for e in (5, 9)}
    refs5 = slab.put(5, {"w": vals[5]})
    refs9 = slab.put(9, {"w": vals[9]})
    assert refs5["w"].valid and refs9["w"].valid
    assert slab.slot_of.keys() == {5, 9}
    got = slab.gather("w", [slab.slot_of[9], slab.slot_of[5]])
    assert _same(got[0], vals[9]) and _same(got[1], vals[5])
    assert _same(refs5["w"].read(), vals[5])


def test_slab_free_bumps_generation_and_reuses_slot():
    slab = DeviceSlabCache(0, {"w": (2, 4)}, capacity=1, device=CPU)
    ref_a = slab.put(7, {"w": torch.ones(2, 4, dtype=torch.bfloat16)})["w"]
    slot_a = slab.slot_of[7]
    slab.free(7)
    assert not ref_a.valid and 7 not in slab
    ref_b = slab.put(3, {"w": torch.zeros(2, 4, dtype=torch.bfloat16)})["w"]
    assert slab.slot_of[3] == slot_a and ref_b.valid and not ref_a.valid
    with pytest.raises(AssertionError):
        ref_a.read()                       # stale refs refuse to read


def test_slab_write_is_in_place():
    """Slot writes (plain and fused) go into the preallocated buffer: its
    storage never moves and the untouched slot keeps its bytes."""
    slab = DeviceSlabCache(0, {"w": (4, 8)}, capacity=2, device=CPU)
    buf = slab.bufs["w"]
    ptr = buf.data_ptr()
    rng = np.random.default_rng(1)
    a = _bf16(rng, (4, 8))
    slab.put(0, {"w": a})
    b = _bf16(rng, (4, 8))
    exp, sm = bitfield.decompose(b)
    slab.put(1, {"w": DevicePlanes(exp=exp, sm=sm, shape=(4, 8))})
    assert slab.bufs["w"] is buf and buf.data_ptr() == ptr
    assert slab.splice_writes == 1 and slab.writes == 2
    assert _same(buf[slab.slot_of[0]], a) and _same(buf[slab.slot_of[1]], b)


def test_read_is_a_view_read_np_a_copy():
    """The port's aliasing hazard made explicit: ``read()`` aliases the
    slab (a later occupant shows through it), ``read_np()`` does not."""
    slab = DeviceSlabCache(0, {"w": (2, 4)}, capacity=1, device=CPU)
    ref = slab.put(1, {"w": torch.ones(2, 4, dtype=torch.bfloat16)})["w"]
    view = ref.read()
    host = ref.read_np()
    assert host.dtype == np.uint16 and slab.d2h_bytes == host.nbytes
    slab.free(1)
    slab.put(2, {"w": torch.full((2, 4), 3.0, dtype=torch.bfloat16)})
    assert torch.all(view == 3.0)          # the view sees the new occupant
    assert np.array_equal(host, bitfield.to_bits(
        torch.ones(2, 4, dtype=torch.bfloat16)))


def test_slab_retire_stales_every_ref():
    slab = DeviceSlabCache(0, {"w": (1, 2)}, capacity=2, device=CPU)
    r0 = slab.put(0, {"w": torch.zeros(1, 2, dtype=torch.bfloat16)})["w"]
    r1 = slab.put(1, {"w": torch.ones(1, 2, dtype=torch.bfloat16)})["w"]
    slab.retire()
    assert not r0.valid and not r1.valid and not slab.slot_of
    assert slab.bufs == {} and slab.nbytes() == 0
    with pytest.raises(AssertionError):
        r1.read()


def test_slab_capacity_overflow_asserts():
    slab = DeviceSlabCache(0, {"w": (1, 1)}, capacity=1, device=CPU)
    slab.put(0, {"w": torch.zeros(1, 1, dtype=torch.bfloat16)})
    with pytest.raises(AssertionError):
        slab.put(1, {"w": torch.zeros(1, 1, dtype=torch.bfloat16)})


# ---------------------------------------------------------------------------
# engine device_cache mode: slot lifecycle against F-pool residency
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    cfg = get_smoke_config("qwen2-moe-a2.7b", n_layers=2)
    params = init_params(cfg, seed=0, device="cpu")
    d = str(tmp_path_factory.mktemp("port_slab_store"))
    build_store(params, cfg, d, k_shards=4, device="cpu")
    return cfg, d


def _engine(cfg, d, pools, **kw):
    return ZipMoEEngine(ExpertStore(d), n_experts=cfg.n_experts,
                        n_layers=cfg.n_layers, pool_sizes=pools,
                        device_cache=True, device="cpu", **kw)


def _weight(v) -> np.ndarray:
    return bitfield.to_bits(v.read() if isinstance(v, SlotRef) else v)


def test_engine_device_fetch_bitexact_and_slab_resident(store_dir):
    cfg, d = store_dir
    store = ExpertStore(d)
    eng = _engine(cfg, d, POOLS, L=3)
    try:
        out, _ = eng.fetch_experts(0, [0, 1])
        for e in (0, 1):
            ref = store.load_group((0, e))
            for name, arr in out[e].items():
                assert np.array_equal(_weight(arr), ref[name])
        slab = eng._slab(0)
        assert slab is not None and set(slab.slot_of) == {0, 1}
        for e, ent in eng.caches[0].pools["F"].items():
            assert all(isinstance(v, SlotRef) and v.valid
                       for v in ent.payload.full.values())
        h2d0, w0 = eng.h2d_bytes, slab.writes
        out2, _ = eng.fetch_experts(0, [0, 1])   # pure F hit from the slab
        assert eng.h2d_bytes == h2d0 and slab.writes == w0
        assert all(isinstance(v, SlotRef)
                   for w in out2.values() for v in w.values())
    finally:
        eng.shutdown()


def test_slot_freed_and_reused_after_eviction(store_dir):
    cfg, d = store_dir
    eng = _engine(cfg, d, {"F": 1, "C": 0, "S": 0, "E": 0}, L=2, delta=0)
    try:
        eng.fetch_experts(0, [0])
        slab = eng._slab(0)
        slot0 = slab.slot_of[0]
        ref0 = slab.refs(0)["w_up"]
        eng.fetch_experts(0, [1])
        eng.fetch_experts(0, [1])              # hotter: evicts expert 0
        assert eng.caches[0].residency(0) is CState.M
        assert set(slab.slot_of) == {1} and slab.slot_of[1] == slot0
        assert not ref0.valid
        w1 = ExpertStore(d).load_group((0, 1))["w_up"]
        assert np.array_equal(_weight(slab.refs(1)["w_up"]), w1)
    finally:
        eng.shutdown()


def test_stale_slotref_payload_never_readmitted(store_dir):
    cfg, d = store_dir
    eng = _engine(cfg, d, {"F": 1, "C": 0, "S": 0, "E": 0}, L=2, delta=0)
    try:
        eng.fetch_experts(0, [0])
        slab = eng._slab(0)
        stale = dict(eng.caches[0].pools["F"][0].payload.full)
        eng.fetch_experts(0, [1])
        eng.fetch_experts(0, [1])              # evicts 0, frees its slot
        assert all(not v.valid for v in stale.values())
        eng.trackers[0].record([0, 0, 0])      # make 0 rank-eligible again
        placed = eng.caches[0].admit(0, ExpertPayload(full=stale))
        assert placed is None                  # demote hook refused it
        assert eng.caches[0].residency(0) is CState.M
        assert set(slab.slot_of) == {1}
    finally:
        eng.shutdown()


def test_pinned_resident_keeps_slab_slot(store_dir):
    cfg, d = store_dir
    eng = _engine(cfg, d, {"F": 1, "C": 0, "S": 0, "E": 0}, L=2, delta=0)
    try:
        eng.fetch_experts(0, [0])
        slab = eng._slab(0)
        ref0 = slab.refs(0)["w_up"]
        eng.pin_experts(0, [0])
        eng.fetch_experts(0, [1])
        eng.fetch_experts(0, [1])              # hotter, but 0 is pinned
        assert 0 in eng.caches[0].pools["F"]
        assert set(slab.slot_of) == {0} and ref0.valid
        eng.unpin_experts(0, [0])
        eng.fetch_experts(0, [1])              # unpinned: eviction resumes
        assert set(slab.slot_of) == {1} and not ref0.valid
    finally:
        eng.shutdown()


def test_device_hooks_bitexact(store_dir):
    """The engine's device hooks on CPU tensors: full recovery, plane
    upload + standalone splice, and the stale-ref refetch all rebuild the
    store's exact bits and charge the transfer counters."""
    cfg, d = store_dir
    store = ExpertStore(d)
    eng = _engine(cfg, d, POOLS, L=2)
    try:
        tm = store.groups[(0, 3)].tensors[1]
        want = store.load_tensor((0, 3), 1)
        exp = np.concatenate([store.decompress_e((0, 3), 1, k,
                                                 store.read_e((0, 3), 1, k))
                              for k in range(len(tm.e_sizes))])
        sm = store.read_sm((0, 3), 1)
        h0 = eng.h2d_bytes
        full = eng._recover_device(exp, sm, tm.shape)
        assert np.array_equal(bitfield.to_bits(full), want)
        dp = eng._recover_device_planes(exp, sm, tm.shape)
        assert isinstance(dp, DevicePlanes)
        assert np.array_equal(bitfield.to_bits(eng._splice_planes(dp)), want)
        assert eng.h2d_bytes - h0 == 4 * tm.n_elems
        assert eng._sm_plane_of(dp) == sm
        assert np.array_equal(bitfield.to_bits(eng._refetch_tensor(0, 3, 1)),
                              want)
        assert eng.splice_ops == 2
    finally:
        eng.shutdown()
