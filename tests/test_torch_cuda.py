"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips without
a CUDA device (the build also needs ``nvcc``).  Run on a machine with an
H100 with ``python -m pytest -q tests/test_torch_cuda.py``.  This file
imports nothing of JAX, so it runs where JAX is not installed.

Tolerances: the splices are bit-exact; the GEMMs sum in f32 in another
order than the plain ``bmm``, and both round once to bf16, so outputs
agree to 2^-7 of the largest |output| (one or two bf16 ulps).  Between the
kernels themselves the tests are bitwise: every GEMM kernel adds the
slices of ``moe_gemm.split_plan(K)`` in order through the same MMA
sequence, whatever its weight source and however its launch spreads the
slices, so grouped ≡ ragged, batched fused ≡ per-expert fused, and a
launch repeated gives the same bits.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitfield
from repro_torch.kernels import _build, moe_gemm, ops, recovery, ref

pytestmark = pytest.mark.gpu
GEMM_REL_TOL = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int16),
                       b.contiguous().view(torch.int16))


def test_splice_all_patterns(cuda):
    u = torch.arange(65536, dtype=torch.int32).to(torch.int16)
    e, s = bitfield.decompose(u.view(torch.bfloat16))
    got = recovery.recover_bf16(e.to(cuda), s.to(cuda)).cpu()
    assert _same(got, u.view(torch.bfloat16))


# (n, offset of exp, offset of sm, offset of out): any flat length, each
# pointer at any alignment on its own (exp and sm in bytes, out in bf16
# elements through a view into a larger buffer).  The body's vector steps
# take 8 elements, a block 4096 (splice.cuh: kSpliceTile steps of 8);
# lengths sit on and around both
SPLICE_CASES = (
    [(2048 * 1408, 0, 0, 0), (1000003, 0, 0, 0), (4097, 1, 1, 0),
     (15, 0, 0, 0), (2048 * 1408, 8, 8, 8), (2048 * 1408 + 5, 0, 0, 1),
     (100003, 15, 9, 13)]
    + [(n, 0, 0, 0) for n in (1, 7, 8, 9, 16, 17, 4095, 4096, 4097, 8193)]
    + [(100003, k, 0, 0) for k in range(1, 16)]
    + [(100003, 0, k, 0) for k in range(1, 16)]
    + [(100003, 0, 0, k) for k in range(1, 16)])


@pytest.mark.parametrize("n,oe,osm,oo", SPLICE_CASES)
def test_splice_any_length_and_alignment(cuda, n, oe, osm, oo):
    g = torch.Generator().manual_seed(n)
    e = torch.randint(0, 256, (n + oe,), dtype=torch.uint8, generator=g)
    s = torch.randint(0, 256, (n + osm,), dtype=torch.uint8, generator=g)
    want = ref.recover_bf16_ref(e[oe:], s[osm:])
    ed, sd = e.to(cuda)[oe:], s.to(cuda)[osm:]
    assert _same(recovery.recover_bf16(ed, sd).cpu(), want)
    # into a view at element offset oo; the rest of the buffer keeps its
    # bytes
    buf = torch.full((n + oo + 8,), 0x5A5A, dtype=torch.int16, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    assert _build.library().zipmoe_splice(ed.data_ptr(), sd.data_ptr(),
                                          buf[oo:].data_ptr(), n, stream) == 0
    got = buf.cpu()
    assert _same(got[oo:oo + n], want)
    assert bool((got[:oo] == 0x5A5A).all())
    assert bool((got[oo + n:] == 0x5A5A).all())


def test_splice_repeat_launch_bit_equal(cuda):
    """Repeated launches on the same planes give the same bits, standalone
    and into a slab slot, vector steps and tail alike."""
    g = torch.Generator().manual_seed(1)
    n = 2048 * 1408 + 5
    e = torch.randint(0, 256, (n,), dtype=torch.uint8, generator=g)
    s = torch.randint(0, 256, (n,), dtype=torch.uint8, generator=g)
    want = ref.recover_bf16_ref(e, s)
    ed, sd = e.to(cuda), s.to(cuda)
    outs = [recovery.recover_bf16(ed, sd) for _ in range(10)]
    assert all(_same(o.cpu(), want) for o in outs)
    buf = torch.zeros((3, n), dtype=torch.bfloat16, device=cuda)
    for _ in range(10):
        moe_gemm.slab_splice_admit(buf, ed, sd, 1)
        assert _same(buf[1].cpu(), want)
    assert bool((buf[0] == 0).all()) and bool((buf[2] == 0).all())


# (d, f, slot): an even slot size, and odd d * f, where every slot but
# slot 0 starts off a 16-byte boundary (slot cap - 1 = 3 at 10 bytes past
# one)
@pytest.mark.parametrize("d,f,slot", [(64, 72, 2), (33, 31, 0), (33, 31, 3),
                                      (129, 127, 0), (129, 127, 3)])
def test_splice_admit_in_place(cuda, d, f, slot):
    g = torch.Generator().manual_seed(d * f + slot)
    cap = 4
    base = torch.randn((cap, d, f), generator=g).to(torch.bfloat16)
    w = torch.randn((d, f), generator=g).to(torch.bfloat16)
    e, s = bitfield.decompose(w)
    buf = base.to(cuda)
    ptr = buf.data_ptr()
    out = ops.slab_splice_set(buf, slot, e.to(cuda), s.to(cuda))
    assert out is buf and buf.data_ptr() == ptr
    assert _same(buf.cpu(), ref.splice_admit_ref(base, e, s, slot))
    with pytest.raises(ValueError):
        moe_gemm.slab_splice_admit(buf, e.to(cuda), s.to(cuda), cap)


@pytest.mark.parametrize("d,f,ts", [
    (2048, 1408, [2, 0, 0, 3, 1, 7, 5, 5]),     # main path, vector loads
    (1408, 2048, [1, 2, 3, 4]),
    (24, 40, [2, 0, 1]),                        # d, f under one block
    (64, 72, [1, 0]),                           # ragged f edge
    (600, 136, [1, 0, 2]),                      # K off the slice grid
    (2048, 1408, [4, 1]),                       # two tiles: slices spread
])
def test_slab_gemm_vs_plain(cuda, d, f, ts):
    g = torch.Generator().manual_seed(d + f)
    cap = max(ts) + 1
    ts = np.asarray(ts, np.int32)
    x = torch.randn((ts.size * 8, d), generator=g).to(torch.bfloat16)
    x[8:16] = 0                                 # a singleton group
    x[9] = torch.randn((d,), generator=g).to(torch.bfloat16)
    buf = (torch.randn((cap, d, f), generator=g) * 0.05).to(torch.bfloat16)
    got = ops.slab_gemm(x.to(cuda), buf.to(cuda), ts).float().cpu()
    want = ref.slab_gemm_ref(x, buf, ts).float()
    err = (got - want).abs().max().item()
    assert err <= GEMM_REL_TOL * want.abs().max().item()
    assert torch.all(got[10:16] == 0)           # zero pad rows stay zero


def test_slab_gemm_rejects_bad_slots(cuda):
    x = torch.zeros((8, 16), dtype=torch.bfloat16, device=cuda)
    buf = torch.zeros((2, 16, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        moe_gemm.slab_ragged_gemm(x, buf, np.asarray([2], np.int32))
    with pytest.raises(ValueError):
        moe_gemm.slab_ragged_gemm(x, buf, np.asarray([0, 1], np.int32))


def test_slab_gemm_rejects_unaligned_weights(cuda):
    """The kernel reads weights in 16-byte loads only: f % 8 != 0 or a
    misaligned buffer raises before launch."""
    x = torch.zeros((8, 16), dtype=torch.bfloat16, device=cuda)
    ts = np.zeros(1, np.int32)
    _build.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        moe_gemm.slab_ragged_gemm(
            x, torch.zeros((1, 16, 36), dtype=torch.bfloat16, device=cuda), ts)
    flat = torch.zeros(16 * 16 + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        moe_gemm.slab_ragged_gemm(x, flat[1:].view(1, 16, 16), ts)
    assert _build.LAUNCHES["slab_gemm"] == 0


def test_zipserver_on_card_launches_kernels(cuda, tmp_path):
    """Smoke-size ZipServer on the card, device slabs and the ragged FFN:
    the path's three kernels (splice, splice-admit, ragged GEMM) launch,
    and the logits match the resident model on the card within 2% of the
    largest |logit| (bf16 sums in other orders), the tolerance of the CPU
    parity tests."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.store import build_store
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.serving.zipserve import ZipServer
    cfg = get_smoke_config("qwen2-moe-a2.7b", n_layers=2)
    params = init_params(cfg, seed=0, device=cuda)
    build_store(params, cfg, str(tmp_path), device=cuda)
    zs = ZipServer(params, cfg, str(tmp_path), L=2, device_cache=True,
                   pool_sizes={"F": 2, "C": 2, "S": 2, "E": 2}, device=cuda)
    try:
        B = 2
        caches, rcache = zs.init_cache(B, 4), init_cache(cfg, B, 4, cuda)
        tok = torch.zeros((B, 1), dtype=torch.long, device=cuda)
        _build.reset_launches()
        for i in range(4):
            lg, caches = zs.decode_step(tok, caches, i)
            rl, rcache = decode_step(params, cfg, tok, rcache, i)
            err = (lg.float() - rl.float()).abs().max().item()
            assert err <= 0.02 * rl.float().abs().max().item(), (i, err)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        assert all(_build.LAUNCHES[k] > 0 for k in
                   ("splice", "splice_admit", "slab_gemm")), _build.LAUNCHES
    finally:
        zs.close()


def test_continuous_batching_on_card_launches_kernels(cuda, tmp_path):
    """Smoke-size continuous batching on the card (KV pages on the card,
    ``decode_rows`` over device slabs): every request completes, the page
    pool returns to 0 bytes, the ragged path's three kernels launch, and a
    closed server's slabs are gone."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.store import build_store
    from repro_torch.models import init_params
    from repro_torch.serving.server import BatchServer
    from repro_torch.serving.zipserve import ZipServer
    cfg = get_smoke_config("qwen2-moe-a2.7b", n_layers=2)
    params = init_params(cfg, seed=0, device=cuda)
    build_store(params, cfg, str(tmp_path), device=cuda)
    zs = ZipServer(params, cfg, str(tmp_path), L=2, device_cache=True,
                   pool_sizes={"F": 2, "C": 2, "S": 2, "E": 2}, device=cuda)
    try:
        srv = BatchServer(None, cfg, max_batch=3, max_len=16, zip_server=zs,
                          max_concurrency=3, page_size=4)
        rng = np.random.default_rng(0)
        for n in (3, 6, 4, 5):
            srv.submit(rng.integers(0, cfg.vocab_size, n), 4)
        _build.reset_launches()
        done = srv.run()
        torch.cuda.synchronize()
        assert [len(r.output) for r in done] and all(
            len(r.output) == 4 and r.error is None for r in done)
        assert srv.pool.used_bytes() == 0
        assert srv.pool._paged[0]["kv"]["k"].is_cuda
        assert all(_build.LAUNCHES[k] > 0 for k in
                   ("splice", "splice_admit", "slab_gemm")), _build.LAUNCHES
    finally:
        zs.close()
    assert all(not s.bufs for s in zs.engine._slabs.values() if s)


# (E, C, d, f): odd expert counts, 8/16/136-row groups, served widths;
# K under one slice and off the slice grid, E = 1 at full width (zip_gemm's
# launch, slices spread over CTAs), 16 experts x C = 16 (the profiler's
# buckets; CTAs walk their slices), ragged f edges
GROUPED = [(3, 8, 2048, 1408), (5, 16, 1408, 2048), (7, 136, 96, 64),
           (1, 8, 24, 64), (3, 16, 2048, 64), (5, 8, 64, 1408),
           (1, 8, 2048, 1408), (1, 8, 1408, 2048), (16, 16, 2048, 1408),
           (3, 8, 600, 136), (2, 8, 40, 72)]


def _grouped_inputs(E, C, d, f):
    g = torch.Generator().manual_seed(E * 1000 + C + d + f)
    x = torch.randn((E, C, d), generator=g).to(torch.bfloat16)
    x[:, C // 2:] = 0                           # padded rows
    w = (torch.randn((E, d, f), generator=g) * 0.05).to(torch.bfloat16)
    exp, sm = bitfield.decompose(w)
    return x, w, exp.view(E, d, f), sm.view(E, d, f)


def _close(got, want):
    err = (got.float().cpu() - want.float()).abs().max().item()
    assert err <= GEMM_REL_TOL * want.float().abs().max().item(), err


@pytest.mark.parametrize("E,C,d,f", GROUPED)
def test_grouped_gemm_vs_plain_and_ragged(cuda, E, C, d, f):
    x, w, _, _ = _grouped_inputs(E, C, d, f)
    xd, wd = x.to(cuda), w.to(cuda)
    _build.reset_launches()
    got = ops.grouped_expert_gemm(xd, wd)
    assert _build.LAUNCHES["grouped_gemm"] == 1
    _close(got, ref.moe_gemm_ref(x, w))
    assert torch.all(got[:, C // 2:] == 0)
    # the same rows through the slab kernel, one slot per expert's tiles
    ts = np.repeat(np.arange(E, dtype=np.int32), C // 8)
    rag = moe_gemm.slab_ragged_gemm(xd.view(E * C, d), wd, ts)
    assert _same(got.view(E * C, f), rag)


@pytest.mark.parametrize("E,C,d,f", GROUPED)
def test_zip_gemms_vs_plain_and_each_other(cuda, E, C, d, f):
    x, w, exp, sm = _grouped_inputs(E, C, d, f)
    xd, ed, sd = x.to(cuda), exp.to(cuda), sm.to(cuda)
    _build.reset_launches()
    got = ops.zip_gemm_batch(xd, ed, sd)
    _close(got, ref.zip_gemm_grouped_ref(x, exp, sm))
    # fused splice == splice then GEMM, bit for bit
    assert _same(got, moe_gemm.grouped_gemm(xd, w.to(cuda)))
    for e in range(E):
        assert _same(ops.fused_zip_gemm(xd[e], ed[e], sd[e]), got[e])
    assert _build.LAUNCHES["zip_gemm_grouped"] == 1
    assert _build.LAUNCHES["zip_gemm"] == E


def test_grouped_and_zip_reject_what_the_kernel_cannot_take(cuda):
    """C % 8, f % 8, misaligned operands and mismatched shapes raise before
    launch; nothing is counted."""
    bf, u8 = torch.bfloat16, torch.uint8
    x = torch.zeros((2, 8, 16), dtype=bf, device=cuda)
    w = torch.zeros((2, 16, 16), dtype=bf, device=cuda)
    p = torch.zeros((2, 16, 16), dtype=u8, device=cuda)
    _build.reset_launches()
    x12 = torch.zeros((2, 12, 16), dtype=bf, device=cuda)
    for bad in (lambda: moe_gemm.grouped_gemm(x12, w),
                lambda: moe_gemm.zip_gemm_grouped(x12, p, p),
                lambda: moe_gemm.zip_gemm(x12[0], p[0], p[0])):
        with pytest.raises(ValueError, match="8-row"):
            bad()
    w12 = torch.zeros((2, 16, 12), dtype=bf, device=cuda)
    p12 = torch.zeros((2, 16, 12), dtype=u8, device=cuda)
    for bad in (lambda: moe_gemm.grouped_gemm(x, w12),
                lambda: moe_gemm.zip_gemm_grouped(x, p12, p12),
                lambda: moe_gemm.zip_gemm(x[0], p12[0], p12[0])):
        with pytest.raises(ValueError, match="multiple of 8"):
            bad()
    wflat = torch.zeros(2 * 16 * 16 + 1, dtype=bf, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        moe_gemm.grouped_gemm(x, wflat[1:].view(2, 16, 16))
    pflat = torch.zeros(2 * 16 * 16 + 1, dtype=u8, device=cuda)
    pm = pflat[1:].view(2, 16, 16)
    with pytest.raises(ValueError, match="8-byte"):
        moe_gemm.zip_gemm_grouped(x, pm, p)
    with pytest.raises(ValueError, match="8-byte"):
        moe_gemm.zip_gemm(x[0], p[0], pm[0])
    with pytest.raises(ValueError, match="match"):
        moe_gemm.grouped_gemm(x, torch.zeros((3, 16, 16), dtype=bf,
                                             device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        moe_gemm.grouped_gemm(x, w.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        moe_gemm.zip_gemm_grouped(x, p.cpu(), p)
    assert all(n == 0 for n in _build.LAUNCHES.values()), _build.LAUNCHES


def _lib_gemms(xd, wd, ed, sd, spread):
    """The three GEMM sources through their C entry points with the
    contraction's slices spread over CTAs or walked by one CTA each."""
    lib = _build.library()
    E, C, d = xd.shape
    f = wd.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    sa = moe_gemm.split_args(E * C // 8, d, f, xd.device, spread=spread)
    outs = [torch.empty((E, C, f), dtype=torch.bfloat16, device=xd.device)
            for _ in range(3)]
    ts = torch.from_numpy(np.repeat(np.arange(E, dtype=np.int32),
                                    C // 8)).to(xd.device)
    rcs = [lib.zipmoe_grouped_gemm(xd.data_ptr(), wd.data_ptr(),
                                   outs[0].data_ptr(), E, C, d, f, *sa.args,
                                   stream),
           lib.zipmoe_zip_gemm_grouped(xd.data_ptr(), ed.data_ptr(),
                                       sd.data_ptr(), outs[1].data_ptr(), E,
                                       C, d, f, *sa.args, stream),
           lib.zipmoe_slab_gemm(xd.data_ptr(), wd.data_ptr(), ts.data_ptr(),
                                outs[2].data_ptr(), E * C // 8, d, f, d * f,
                                *sa.args, stream)]
    assert rcs == [0, 0, 0], rcs
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("E,C,d,f", [(3, 8, 2048, 1408), (2, 16, 600, 136),
                                     (16, 8, 1408, 2048)])
def test_slice_distributions_bit_equal(cuda, E, C, d, f):
    """Walking the slices in one CTA and spreading them over CTAs (f32
    partials added by the last CTA) give the same bits, for every weight
    source."""
    x, w, exp, sm = _grouped_inputs(E, C, d, f)
    ops_in = (x.to(cuda), w.to(cuda), exp.to(cuda), sm.to(cuda))
    walked = _lib_gemms(*ops_in, spread=False)
    spread = _lib_gemms(*ops_in, spread=True)
    for a, b in zip(walked + spread, walked[:1] * 6):
        assert _same(a, b)
    _close(walked[0], ref.moe_gemm_ref(x, w))


def test_repeat_launch_bit_equal(cuda):
    """A launch repeated on the same inputs gives the same bits, whatever
    order its CTAs arrive in; the spread launch also leaves its counters
    zeroed for the next one."""
    x, w, exp, sm = _grouped_inputs(16, 8, 2048, 1408)
    xd, wd, ed, sd = x.to(cuda), w.to(cuda), exp.to(cuda), sm.to(cuda)
    one = [moe_gemm.zip_gemm(xd[3], ed[3], sd[3]) for _ in range(20)]
    many = [moe_gemm.grouped_gemm(xd, wd) for _ in range(5)]
    assert moe_gemm.split_args(1, 2048, 1408, cuda).spread
    assert not moe_gemm.split_args(16, 2048, 1408, cuda).spread
    assert all(_same(o, one[0]) for o in one)
    assert all(_same(o, many[0]) for o in many)
    assert _same(one[0], many[0][3])


def test_gemms_reject_unaligned_x(cuda):
    """The kernel copies x in 16-byte pieces: d % 8 != 0 or a misaligned x
    raises before launch."""
    bf, u8 = torch.bfloat16, torch.uint8
    x12 = torch.zeros((2, 8, 12), dtype=bf, device=cuda)
    w12 = torch.zeros((2, 12, 16), dtype=bf, device=cuda)
    p12 = torch.zeros((2, 12, 16), dtype=u8, device=cuda)
    flat = torch.zeros(2 * 8 * 16 + 1, dtype=bf, device=cuda)
    xm = flat[1:].view(2, 8, 16)
    w = torch.zeros((2, 16, 16), dtype=bf, device=cuda)
    _build.reset_launches()
    for bad in (lambda: moe_gemm.grouped_gemm(x12, w12),
                lambda: moe_gemm.zip_gemm_grouped(x12, p12, p12),
                lambda: moe_gemm.zip_gemm(x12[0], p12[0], p12[0]),
                lambda: moe_gemm.grouped_gemm(xm, w),
                lambda: moe_gemm.slab_ragged_gemm(
                    xm.view(16, 16), w, np.zeros(2, np.int32))):
        with pytest.raises(ValueError, match="16-byte"):
            bad()
    assert all(n == 0 for n in _build.LAUNCHES.values()), _build.LAUNCHES


@pytest.mark.parametrize("mode,kernel", [
    (dict(ffn_impl="grouped"), "grouped_gemm"),
    (dict(ffn_impl="grouped", device_cache=True), "grouped_gemm"),
    (dict(ffn_impl="grouped", fused_recovery=True), "zip_gemm_grouped"),
    (dict(ffn_impl="loop", fused_recovery=True), "zip_gemm"),
    (dict(profile_p_times=True), "grouped_gemm"),
    (dict(ffn_impl="grouped", device_recovery=True), "splice"),
    (dict(ffn_impl="ragged", device_cache=True, mem_budget=6,
          replan_every=2, pool_sizes=None), "slab_gemm"),
], ids=["grouped-host", "grouped-device", "fused-batched", "fused-loop",
        "profile", "device-recovery", "mem-budget"])
def test_zipserver_new_paths_launch_kernels(cuda, tmp_path, mode, kernel):
    """Smoke-size ZipServer on the card through each FFN path and serving
    mode ported since the first slice: its kernel launches, and the logits
    match the resident model on the card within 2% of the largest |logit|.
    ``device_recovery`` splices on the engine's worker threads: every
    splice it counts is one launch.  ``mem_budget`` (in F-expert bytes)
    re-plans before step 2; whenever the plan gives F bytes, admissions
    land in the planned slab through the splice-admit kernel."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.store import ExpertStore, build_store
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.serving.zipserve import ZipServer
    cfg = get_smoke_config("qwen2-moe-a2.7b", n_layers=2)
    params = init_params(cfg, seed=0, device=cuda)
    build_store(params, cfg, str(tmp_path), device=cuda)
    kw = {"pool_sizes": {"F": 2, "C": 2, "S": 2, "E": 2}, **mode}
    if "mem_budget" in kw:
        st = ExpertStore(str(tmp_path))
        kw["mem_budget"] *= st.groups[(0, 0)].full_bytes
        st.close()
    zs = ZipServer(params, cfg, str(tmp_path), L=2, device=cuda, **kw)
    try:
        B = 2
        caches, rcache = zs.init_cache(B, 4), init_cache(cfg, B, 4, cuda)
        tok = torch.zeros((B, 1), dtype=torch.long, device=cuda)
        _build.reset_launches()
        ops0 = zs.engine.splice_ops
        for i in range(4):
            if i == 2 and "mem_budget" in kw:
                zs.engine.replan(reason="forced")
            lg, caches = zs.decode_step(tok, caches, i)
            rl, rcache = decode_step(params, cfg, tok, rcache, i)
            err = (lg.float() - rl.float()).abs().max().item()
            assert err <= 0.02 * rl.float().abs().max().item(), (i, err)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        zs.drain_pending()
        torch.cuda.synchronize()
        assert _build.LAUNCHES[kernel] > 0, _build.LAUNCHES
        if mode.get("profile_p_times"):
            assert zs.p_time_summary()["n_measurements"] > 0
        if mode.get("device_recovery"):
            assert _build.LAUNCHES["splice"] == zs.engine.splice_ops - ops0
            assert _build.LAUNCHES["grouped_gemm"] > 0
        if "mem_budget" in kw:
            ps = zs.plan_summary()
            assert ps["n_plans"] >= 2 and ps["n_replans"] >= 1
            assert ps["bytes_resident"] <= kw["mem_budget"] + 1e-6
            if any(lp["sizes"]["F"] > 0 for lp in ps["layers"].values()):
                assert _build.LAUNCHES["splice_admit"] > 0, _build.LAUNCHES
    finally:
        zs.close()


# MLA widths at which head_dim (32), qk_nope + qk_rope (24 + 8) and
# v_head_dim (40) all differ
MLA = dict(qk_nope_dim=24, qk_rope_dim=8, v_head_dim=40, kv_lora_rank=48)


@pytest.mark.parametrize("arch", ["deepseekv2-lite", "deepseek-v2-236b"])
def test_mla_layer_on_card(cuda, arch):
    """One MLA attention layer on the card against the same layer on the
    CPU (``mla_forward`` with its latent cache, ``mla_decode`` and
    ``mla_decode_rows`` absorbed and plain): both sum in f32 in other
    orders and round to bf16 once before the bf16 output product, so they
    agree to 2^-7 of the largest |output|; absorbed and plain agree on the
    card to the same bound.  No TF32."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import attention as attn_lib
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_smoke_config(arch, n_layers=1, **MLA)
    g = torch.Generator().manual_seed(0)
    p = attn_lib.init_attn(g, cfg, "cpu")
    pc = {k: v.to(cuda) for k, v in p.items()}
    B, T = 4, 16
    x = torch.randn((B, 1, cfg.d_model), generator=g).to(torch.bfloat16)
    xs = torch.randn((2, T, cfg.d_model), generator=g).to(torch.bfloat16)
    cache = {"ckv": torch.randn((B, T, cfg.kv_lora_rank),
                                generator=g).to(torch.bfloat16),
             "k_rope": torch.randn((B, T, cfg.qk_rope_dim),
                                   generator=g).to(torch.bfloat16)}

    def close(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        assert a.shape == b.shape
        assert (a - b).abs().max() <= GEMM_REL_TOL * b.abs().max()

    pos = torch.arange(T)[None].expand(2, T)
    y, c = attn_lib.mla_forward(p, xs, cfg, pos, return_cache=True)
    yc, cc = attn_lib.mla_forward(pc, xs.to(cuda), cfg, pos.to(cuda),
                                  return_cache=True)
    close(yc, y)
    for name in c:
        close(cc[name], c[name])
    positions = torch.tensor([3, 9, 0, 15])
    outs = {}
    for absorb in (True, False):
        for rows in (False, True):
            host = {k: v.clone() for k, v in cache.items()}
            card = {k: v.to(cuda, copy=True) for k, v in cache.items()}
            if rows:
                want, _ = attn_lib.mla_decode_rows(p, x, cfg, host, positions,
                                                   absorb=absorb)
                got, _ = attn_lib.mla_decode_rows(pc, x.to(cuda), cfg, card,
                                                  positions.to(cuda),
                                                  absorb=absorb)
            else:
                want, _ = attn_lib.mla_decode(p, x, cfg, host, 7,
                                              absorb=absorb)
                got, _ = attn_lib.mla_decode(pc, x.to(cuda), cfg, card, 7,
                                             absorb=absorb)
            close(got, want)
            for name in host:
                close(card[name], host[name])
            outs[absorb, rows] = got
    for rows in (False, True):
        close(outs[True, rows], outs[False, rows])


def test_mla_device_slab_step_on_card(cuda, tmp_path):
    """deepseekv2-lite at smoke size on the card (a dense first layer, two
    MoE layers, latent KV): ``decode_step`` over device slabs and the
    ragged FFN, then ``decode_rows`` under continuous batching; the
    ragged path's three kernels launch in each, the logits match the
    resident model on the card within 2% of the largest |logit|, and the
    latent page pool returns to 0 bytes."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.store import build_store
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.serving.server import BatchServer
    from repro_torch.serving.zipserve import ZipServer
    cfg = get_smoke_config("deepseekv2-lite", n_layers=3, **MLA)
    params = init_params(cfg, seed=0, device=cuda)
    build_store(params, cfg, str(tmp_path), device=cuda)
    pools = {"F": 2, "C": 2, "S": 2, "E": 2}
    zs = ZipServer(params, cfg, str(tmp_path), L=2, device_cache=True,
                   pool_sizes=pools, device=cuda)
    try:
        B = 2
        caches, rcache = zs.init_cache(B, 4), init_cache(cfg, B, 4, cuda)
        assert caches[0]["kv"]["ckv"].shape == (B, 4, cfg.kv_lora_rank)
        tok = torch.zeros((B, 1), dtype=torch.long, device=cuda)
        _build.reset_launches()
        for i in range(4):
            lg, caches = zs.decode_step(tok, caches, i)
            rl, rcache = decode_step(params, cfg, tok, rcache, i)
            err = (lg.float() - rl.float()).abs().max().item()
            assert err <= 0.02 * rl.float().abs().max().item(), (i, err)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        assert all(_build.LAUNCHES[k] > 0 for k in
                   ("splice", "splice_admit", "slab_gemm")), _build.LAUNCHES
    finally:
        zs.close()
    zs = ZipServer(params, cfg, str(tmp_path), L=2, device_cache=True,
                   pool_sizes=pools, device=cuda)
    try:
        srv = BatchServer(None, cfg, max_batch=3, max_len=16, zip_server=zs,
                          max_concurrency=3, page_size=4)
        rng = np.random.default_rng(0)
        for n in (3, 6, 4, 5):
            srv.submit(rng.integers(0, cfg.vocab_size, n), 4)
        _build.reset_launches()
        done = srv.run()
        torch.cuda.synchronize()
        assert len(done) == 4 and all(
            len(r.output) == 4 and r.error is None for r in done)
        assert srv.pool.used_bytes() == 0
        assert srv.pool._paged[0]["kv"]["ckv"].is_cuda
        assert srv.pool.page_nbytes() == cfg.n_layers * (
            cfg.kv_lora_rank + cfg.qk_rope_dim) * 2 * 4
        assert all(_build.LAUNCHES[k] > 0 for k in
                   ("splice", "splice_admit", "slab_gemm")), _build.LAUNCHES
    finally:
        zs.close()


# ---------------------------------------------------------------------------
# the SSM and hybrid families
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_on_card_matches_cpu(cuda, arch, dtype):
    """One Mamba2 layer at the config's published widths: ``mamba_forward``
    over two 256-token chunks and a ``mamba_decode`` step from its cache,
    on the card against the same call on the CPU.  f32: within 1e-4 of
    the largest magnitude (sums in other orders); bf16: within 2%, the
    cross-package tolerance (the products round to bf16 in other orders)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import mamba as mamba_lib
    cfg = dataclasses.replace(get_config(arch), n_layers=1, dtype=dtype)
    g = torch.Generator().manual_seed(0)
    p = mamba_lib.init_mamba(g, cfg, "cpu")
    dt = getattr(torch, dtype)
    x = torch.randn((1, 2 * cfg.ssm_chunk, cfg.d_model), generator=g).to(dt)
    x1 = torch.randn((1, 1, cfg.d_model), generator=g).to(dt)
    tol = 1e-4 if dtype == "float32" else 0.02
    outs = {}
    for dev in ("cpu", cuda):
        pd = {k: v.to(dev) for k, v in p.items()}
        y, cache = mamba_lib.mamba_forward(pd, x.to(dev), cfg,
                                           return_cache=True)
        y1, cache = mamba_lib.mamba_decode(pd, x1.to(dev), cfg, cache)
        outs[str(dev)] = [t.float().cpu() for t in
                          (y, y1, cache["state"], cache["conv"])]
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        assert (got - want).abs().max() <= tol * want.abs().max()


def test_jamba_device_slab_step_on_card(cuda, tmp_path):
    """jamba at smoke size on the card (Mamba2 mixers, one attention
    layer, MoE on odd layers): ``decode_step`` over device slabs and the
    ragged FFN launches the splice, the splice-admit and the ragged GEMM,
    the logits match the resident model on the card within 2% of the
    largest |logit|; then continuous batching over ``decode_rows`` with
    its SSM slots on the card, the pool back to 0 bytes."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.store import build_store
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.serving.server import BatchServer
    from repro_torch.serving.zipserve import ZipServer
    cfg = get_smoke_config("jamba-v0.1-52b")
    params = init_params(cfg, seed=0, device=cuda)
    build_store(params, cfg, str(tmp_path), device=cuda)
    pools = {"F": 2, "C": 2, "S": 2, "E": 2}
    zs = ZipServer(params, cfg, str(tmp_path), L=2, device_cache=True,
                   pool_sizes=pools, device=cuda)
    try:
        B = 2
        caches, rcache = zs.init_cache(B, 4), init_cache(cfg, B, 4, cuda)
        assert caches[0]["ssm"]["state"].is_cuda
        tok = torch.zeros((B, 1), dtype=torch.long, device=cuda)
        _build.reset_launches()
        for i in range(4):
            lg, caches = zs.decode_step(tok, caches, i)
            rl, rcache = decode_step(params, cfg, tok, rcache, i)
            err = (lg.float() - rl.float()).abs().max().item()
            assert err <= 0.02 * rl.float().abs().max().item(), (i, err)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        assert all(_build.LAUNCHES[k] > 0 for k in
                   ("splice", "splice_admit", "slab_gemm")), _build.LAUNCHES
    finally:
        zs.close()
    zs = ZipServer(params, cfg, str(tmp_path), L=2, device_cache=True,
                   pool_sizes=pools, device=cuda)
    try:
        srv = BatchServer(None, cfg, max_batch=2, max_len=16, zip_server=zs,
                          max_concurrency=2, page_size=4)
        rng = np.random.default_rng(0)
        for n in (3, 6, 4, 5):
            srv.submit(rng.integers(0, cfg.vocab_size, n), 4)
        done = srv.run()
        torch.cuda.synchronize()
        assert len(done) == 4 and all(
            len(r.output) == 4 and r.error is None for r in done)
        assert srv.pool.used_bytes() == 0
        assert srv.pool._slot[0]["ssm"]["state"].is_cuda
    finally:
        zs.close()


# ---------------------------------------------------------------------------
# training on the card (plain PyTorch: no kernel of the port runs)
# ---------------------------------------------------------------------------
def _train_batch(cfg, dev, seed=0):
    g = np.random.default_rng(seed)
    toks = g.integers(0, cfg.vocab_size, (2, 33), dtype=np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
            "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}


def test_train_step_on_card_matches_cpu(cuda):
    """One make_train_step (int8 error feedback on) of the qwen2-moe-a2.7b
    smoke config (2 layers) on the card against the same step on the CPU
    from the same seeded parameters: loss within 1e-3 relative (bf16
    matmuls add in other orders on the two); every parameter within
    2.5e-4 + 2^-7 relative of the CPU's: a first AdamW step moves a weight
    by lr (1e-4) times |u| <= 1 plus the decay, so two devices that
    quantise a gradient entry to other int8 levels part by at most 2 lr,
    plus a bf16 rounding."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    cfg = get_smoke_config("qwen2-moe-a2.7b", n_layers=2)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        params = tree_map(lambda t: t.to(dev),
                          init_params(cfg, seed=0, device="cpu"))
        st = init_train_state(params, grad_compress=True)
        step = make_train_step(cfg, lr=1e-4, warmup=0, total_steps=10,
                               grad_compress=True)
        st, m = step(st, _train_batch(cfg, dev))
        out[dev.type] = (float(m["loss"]), st)
    (lc, sc), (lg, sg) = out["cpu"], out["cuda"]
    assert sg.params["layers"][0]["ffn"]["w_up"].is_cuda
    assert abs(lc - lg) <= 1e-3 * abs(lc), (lc, lg)
    for a, b in zip(tree_leaves(sc.params), tree_leaves(sg.params)):
        torch.testing.assert_close(a.float(), b.cpu().float(),
                                   rtol=2.0 ** -7, atol=2.5e-4)


def test_checkpoint_roundtrip_cuda_cpu_cuda(cuda, tmp_path):
    """A TrainState on the card, saved, restored onto the CPU, saved
    again and restored onto the card: every leaf bit-exact, bf16 kept."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_step import init_train_state
    cfg = get_smoke_config("qwen2-moe-a2.7b", n_layers=2)
    st = init_train_state(init_params(cfg, seed=1, device=cuda),
                          grad_compress=True)
    tree = st._asdict()
    a = CheckpointManager(str(tmp_path / "a"), async_write=True)
    a.save(1, tree)
    a.wait()
    host, _, _ = a.restore(tree, device="cpu")
    b = CheckpointManager(str(tmp_path / "b"))
    b.save(1, host)
    back, step, _ = b.restore(tree, device=cuda)
    assert step == 1
    for x, h, y in zip(tree_leaves(tree), tree_leaves(host),
                       tree_leaves(back)):
        assert h.device.type == "cpu" and y.device.type == "cuda"
        assert x.dtype == h.dtype == y.dtype and x.shape == y.shape
        assert _same(x.cpu(), h) if x.dtype == torch.bfloat16 else \
            torch.equal(x.cpu(), h)
        assert torch.equal(x, y) if x.dtype != torch.bfloat16 else _same(x, y)
