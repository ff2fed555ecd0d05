"""The port on the card: its CUDA kernels against their plain PyTorch
versions, and every path that serves or trains at smoke size against the
resident model, another path or the CPU.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips without
a CUDA device (the build also needs ``nvcc``).  Run on a machine with an
H100 with ``python -m pytest -q -m gpu tests/``.  This file imports
nothing of JAX, so it runs where JAX is not installed.

Tolerances: the splices are bit-exact; the GEMMs sum in f32 in another
order than the plain ``bmm``, and both round once to bf16, so outputs
agree to 2^-7 of the largest |output| (one or two bf16 ulps).  Between the
kernels themselves the tests are bitwise: every GEMM kernel adds the
slices of ``moe_gemm.split_plan(K)`` in order through the same MMA
sequence, whatever its weight source and however its launch spreads the
slices, so grouped ≡ ragged, batched fused ≡ per-expert fused, and a
launch repeated gives the same bits.  Served logits agree with the
resident model's to 2% of the largest |logit| (``LOGIT_REL_TOL``): bf16
activations through layers whose expert sums run in other orders (slab
kernel vs bmm) and whose gates round at other places; the CPU parity
tests hold the port to the same bound.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import bitfield
from repro_torch.kernels import _build, moe_gemm, ops, recovery, ref

pytestmark = pytest.mark.gpu
GEMM_REL_TOL = 2.0 ** -7
LOGIT_REL_TOL = 0.02
POOLS = {"F": 2, "C": 2, "S": 2, "E": 2}
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int16),
                       b.contiguous().view(torch.int16))


def _stored(arch, tmp_path, dev, **overrides):
    """`arch`'s smoke config, seeded parameters on `dev` and their store
    built in `tmp_path`."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.store import build_store
    from repro_torch.models import init_params
    cfg = get_smoke_config(arch, **overrides)
    params = init_params(cfg, seed=0, device=dev)
    build_store(params, cfg, str(tmp_path), device=dev).close()
    return cfg, params


def _moe_layers(cfg):
    return [i for i in range(cfg.n_layers) if cfg.moe_layer(i)]


def _greedy(zs, dev, B, steps, replan_at=None):
    """`steps` greedy ``decode_step``s of `B` rows from token 0 over a
    fresh cache (a forced re-plan before step `replan_at`), launch counts
    reset first and prefetch jobs drained last: every step's logits and
    the server's overlap summary."""
    caches = zs.init_cache(B, steps)
    tok = torch.zeros((B, 1), dtype=torch.long, device=dev)
    _build.reset_launches()
    logits = []
    for i in range(steps):
        if i == replan_at:
            zs.engine.replan(reason="forced")
        lg, caches = zs.decode_step(tok, caches, i)
        logits.append(lg)
        tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
    zs.drain_pending()
    torch.cuda.synchronize()
    return logits, zs.overlap_summary()


def _served_routes(zs):
    """Per request: per MoE layer, the expert set routed at each of its
    positions, from the server's per-step stats (rows mapped by owner)."""
    out = {}
    for st in zs.stats:
        for b, rid in enumerate(st["owners"]):
            out.setdefault(rid, {}).setdefault(st["layer"], []).append(
                set(int(e) for e in st["routes"][b]))
    return out


def _hold_to_resident(params, cfg, dev, done, routes, prefill_as_decode):
    """Each served request's recorded logits against the resident model on
    `dev` fed its prompt and outputs (teacher forcing): ``prefill`` then
    ``decode_step``, or with `prefill_as_decode` one ``decode_step`` per
    prompt token as the server reads it.  A position whose routed experts
    differ in the two models (a router near-tie flipped by bf16 noise),
    or whose (token, slot) the resident prefill drops past its group
    capacity, takes another FFN: in the last layer that changes only its
    own output, which is left out; in an earlier layer the request is
    compared only before it.  Every compared output is within
    LOGIT_REL_TOL of the largest |logit|.  Returns (outputs compared,
    outputs)."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models.moe import _positions, group_capacity
    from repro_torch.serving.kv_cache import grow_cache
    moe = _moe_layers(cfg)
    last = cfg.n_layers - 1
    compared = total = 0
    for r in done:
        S, N = len(r.prompt), len(r.output)
        total += N
        resident = {l: [] for l in moe}
        first_bad, skip = S + N, set()
        if prefill_as_decode:
            caches = init_cache(cfg, 1, S + N, device=dev)
            logits = []
            for s, tok_id in enumerate(list(r.prompt) + list(r.output[:-1])):
                ids = []
                tok = torch.tensor([[int(tok_id)]], device=dev)
                lg, caches = decode_step(params, cfg, tok, caches, s,
                                         router_ids=ids)
                if s >= S - 1:
                    logits.append(lg[0, -1])
                for l, ti in zip(moe, ids):
                    resident[l].append(set(ti[0, 0].tolist()))
        else:
            ids = []
            prompt = torch.as_tensor(r.prompt, dtype=torch.long,
                                     device=dev)[None]
            lg, caches = prefill(params, cfg, prompt, router_ids=ids)
            cap = group_capacity(S, cfg)
            for l, ti in zip(moe, ids):
                resident[l] = [set(ti[0, s].tolist()) for s in range(S)]
                kept = (_positions(ti, cfg.n_experts) < cap)[0].all(-1)
                if not bool(kept.all()):
                    first_bad = min(first_bad, int((~kept).nonzero()[0, 0]))
            caches = grow_cache(cfg, caches, 1, S + N)
            logits = [lg[0, -1]]
            for t in range(N - 1):
                ids = []
                tok = torch.tensor([[int(r.output[t])]], device=dev)
                lg, caches = decode_step(params, cfg, tok, caches, S + t,
                                         router_ids=ids)
                logits.append(lg[0, -1])
                for l, ti in zip(moe, ids):
                    resident[l].append(set(ti[0, 0].tolist()))
        for l in moe:
            mine = routes[r.rid][l]
            assert len(mine) == S + N - 1, (r.rid, l, len(mine))
            for s, (a, b) in enumerate(zip(mine, resident[l])):
                if a == b or s >= first_bad:
                    continue
                if l == last:
                    skip.add(s)
                    continue
                first_bad = s
                break
        for t in range(N):
            want = logits[t].float()
            got = torch.from_numpy(r.logits[t]).to(dev)
            assert bool(torch.isfinite(got).all()), (r.rid, t)
            if S - 1 + t >= first_bad:
                break
            if S - 1 + t in skip:
                continue
            err = (got - want).abs().max().item()
            assert err <= LOGIT_REL_TOL * want.abs().max().item(), \
                (r.rid, t, err)
            compared += 1
    return compared, total


def _tokens_agree_where_decided(a, b):
    """Two runs of one request: their tokens are equal up to the first
    that differs, and that one differs only where the logits leave it
    within twice their difference (a near-tie)."""
    for t, (x, y) in enumerate(zip(a.logits, b.logits)):
        if a.output[t] != b.output[t]:
            top = np.sort(x)[::-1]
            assert top[0] - top[1] <= 2 * float(np.abs(x - y).max()), \
                (b.rid, t)
            break


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


def _continuous(params, cfg, store_dir, dev, prompts, concurrency=3):
    """`prompts` (4 greedy tokens each, logits recorded) through continuous
    batching over a fresh ``ZipServer(device_cache=True)`` on `dev`, KV
    pages of 4 tokens: the finished requests in rid order, the server's
    routes per request, the launches and the page pool."""
    from repro_torch.serving.server import BatchServer
    from repro_torch.serving.zipserve import ZipServer
    zs = ZipServer(params, cfg, store_dir, L=2, device_cache=True,
                   pool_sizes=POOLS, device=dev)
    try:
        srv = BatchServer(None, cfg, max_batch=concurrency, max_len=16,
                          zip_server=zs, max_concurrency=concurrency,
                          page_size=4)
        for p in prompts:
            srv.submit(p, 4, record_logits=True)
        _build.reset_launches()
        done = sorted(srv.run(), key=lambda r: r.rid)
        zs.drain_pending()
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    finally:
        zs.close()
    assert len(done) == len(prompts) and all(
        len(r.output) == 4 == len(r.logits) and r.error is None
        for r in done)
    assert srv.pool.used_bytes() == 0
    assert all(not s.bufs for s in zs.engine._slabs.values() if s)
    return done, _served_routes(zs), launches, srv.pool


def _prompts(cfg, lens=(3, 6, 4, 5)):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, n) for n in lens]


def test_continuous_batching_on_card_launches_kernels(cuda, tmp_path):
    """Smoke-size continuous batching on the card (KV pages on the card,
    ``decode_rows`` over device slabs): every request completes, the page
    pool returns to 0 bytes, the ragged path's three kernels launch, a
    closed server's slabs are gone, and each request's logits match the
    resident model's ``prefill`` + ``decode_step`` on the card on
    identically routed positions (at least half of them).  The first and
    the last request served alone on a fresh server give the same tokens
    wherever their logits decide them."""
    cfg, params = _stored("qwen2-moe-a2.7b", tmp_path, cuda, n_layers=2)
    prompts = _prompts(cfg)
    done, routes, launches, pool = _continuous(params, cfg, str(tmp_path),
                                               cuda, prompts)
    assert pool._paged[0]["kv"]["k"].is_cuda
    assert all(launches[k] > 0 for k in
               ("splice", "splice_admit", "slab_gemm")), launches
    compared, total = _hold_to_resident(params, cfg, cuda, done, routes,
                                        prefill_as_decode=False)
    assert 2 * compared >= total, (compared, total)
    for i in (0, len(prompts) - 1):
        (alone,), _, _, _ = _continuous(params, cfg, str(tmp_path), cuda,
                                        [prompts[i]])
        _tokens_agree_where_decided(alone, done[i])


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
    land in the planned slab through the splice-admit kernel, and
    otherwise the standalone splice runs."""
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
            else:
                assert _build.LAUNCHES["splice"] > 0, _build.LAUNCHES
    finally:
        zs.close()


RAGGED = dict(device_cache=True, ffn_impl="ragged")
# two ZipServer modes that compute one function, and must give the same
# bits on the card: fused recovery batched and one expert at a time;
# splices on the engine's worker threads, and a planned cache (6 F-expert
# bytes, a forced re-plan before step 4), each against the ragged path
SAME_BITS = {
    "fused-loop": (dict(fused_recovery=True, ffn_impl="grouped"),
                   dict(fused_recovery=True, ffn_impl="loop")),
    "device-recovery": (RAGGED, dict(device_recovery=True,
                                     ffn_impl="grouped")),
    "planned": (RAGGED, dict(RAGGED, mem_budget=6, replan_every=4,
                             pool_sizes=None)),
}


@pytest.mark.parametrize("path", list(SAME_BITS))
def test_zipserver_paths_bit_identical_on_card(cuda, tmp_path, path):
    """Smoke-size ZipServer on the card, 6 greedy steps of 2 rows through
    two modes of one function: the logits bit-identical at every step;
    the fused paths upload the same plane bytes and splice nothing on
    their own."""
    from repro_torch.core.store import ExpertStore
    from repro_torch.serving.zipserve import ZipServer
    cfg, params = _stored("qwen2-moe-a2.7b", tmp_path, cuda, n_layers=2)
    runs = []
    for mode in SAME_BITS[path]:
        kw = {"pool_sizes": POOLS, **mode}
        if "mem_budget" in kw:
            st = ExpertStore(str(tmp_path))
            kw["mem_budget"] *= st.groups[(0, 0)].full_bytes
            st.close()
        zs = ZipServer(params, cfg, str(tmp_path), L=2, device=cuda, **kw)
        try:
            runs.append(_greedy(zs, cuda, 2, 6, replan_at=4
                                if "mem_budget" in kw else None))
        finally:
            zs.close()
    (a, ov_a), (b, ov_b) = runs
    assert all(_same(x, y) for x, y in zip(a, b))
    if path == "fused-loop":
        assert ov_a["splice_ops"] == ov_b["splice_ops"] == 0, (ov_a, ov_b)
        assert ov_a["h2d_bytes"] == ov_b["h2d_bytes"] > 0


def test_cache_hit_steps_on_card(cuda, tmp_path):
    """Every expert slab-resident on the card: after a first step, 3 steps
    move no host-to-device byte; the ragged FFN copies no weight and the
    grouped one gathers its experts; each launches its GEMM once a
    projection, MoE layer and step; both give the same bits."""
    from repro_torch.serving.zipserve import ZipServer
    cfg, params = _stored("qwen2-moe-a2.7b", tmp_path, cuda, n_layers=2)
    ample = {"F": cfg.n_experts, "C": 0, "S": 0, "E": 0}
    out = {}
    for impl, kernel in (("ragged", "slab_gemm"), ("grouped", "grouped_gemm")):
        zs = ZipServer(params, cfg, str(tmp_path), L=2, device=cuda,
                       pool_sizes=ample, device_cache=True, ffn_impl=impl)
        try:
            for l in zs._moe_layers:
                zs.engine.fetch_experts(l, list(range(cfg.n_experts)))
            caches = zs.init_cache(2, 4)
            tok = torch.zeros((2, 1), dtype=torch.long, device=cuda)
            logits = []
            for i in range(4):
                if i == 1:
                    torch.cuda.synchronize()
                    _build.reset_launches()
                    h2d, w_copy = zs.engine.h2d_bytes, zs.engine.w_copy_bytes
                lg, caches = zs.decode_step(tok, caches, i)
                logits.append(lg)
                tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            torch.cuda.synchronize()
            out[impl] = (logits, zs.engine.h2d_bytes - h2d,
                         zs.engine.w_copy_bytes - w_copy,
                         _build.LAUNCHES[kernel])
        finally:
            zs.close()
    (lr, h2d_r, copy_r, n_r), (lg_, h2d_g, copy_g, n_g) = out.values()
    assert h2d_r == copy_r == 0 and h2d_g == 0 and copy_g > 0
    assert n_r == n_g == 3 * 3 * len(_moe_layers(cfg)), (n_r, n_g)
    assert all(_same(x, y) for x, y in zip(lr, lg_))


def test_every_kernel_launches_on_a_served_path(cuda, tmp_path):
    """Every kernel the library counts launches on a path that serves
    tokens at smoke size on the card: the ragged device-slab path, the
    grouped host path, fused recovery batched and one expert at a time,
    and deepseekv2-lite's MLA decode."""
    from repro_torch.serving.zipserve import ZipServer
    paths = (("qwen2-moe-a2.7b", dict(n_layers=2),
              (RAGGED, dict(ffn_impl="grouped"),
               SAME_BITS["fused-loop"][0], SAME_BITS["fused-loop"][1])),
             ("deepseekv2-lite", dict(n_layers=3, **MLA), (RAGGED,)))
    served = set()
    for arch, over, modes in paths:
        d = tmp_path / arch
        cfg, params = _stored(arch, d, cuda, **over)
        for mode in modes:
            zs = ZipServer(params, cfg, str(d), L=2, device=cuda,
                           pool_sizes=POOLS, **mode)
            try:
                _greedy(zs, cuda, 2, 3)
            finally:
                zs.close()
            served |= {k for k, n in _build.LAUNCHES.items() if n}
    assert served == set(_build.LAUNCHES), set(_build.LAUNCHES) - served


def test_slab_migration_on_card(cuda, tmp_path):
    """The JAX package's drift trace (two 40-step zipf phases, seeds 5 and
    99, top-2; layer 1 idles from mid-trace) on a smoke-size engine with
    device slabs on the card, planning constants pinned to a
    decompression-bound persona so F pools get bytes, a budget of 10
    experts' bytes and a probe every 8 steps, every re-plan watched from
    outside: a drift re-plan happens; a re-plan carries residents from an
    old slab into a new one; after every re-plan each of layer 0's F
    residents is a valid SlotRef or tensor holding the store's bits; layer
    1's slab exists during the trace and is freed by its end, and every
    SlotRef into it taken before a re-plan is stale; admissions into the
    slabs launch the splice-admit."""
    from repro_torch.core.engine import ZipMoEEngine
    from repro_torch.core.planner import PlanConsts
    from repro_torch.core.slab import SlotRef
    from repro_torch.core.store import ExpertStore
    from repro_torch.core.workload import zipf_trace
    cfg, _ = _stored("qwen2-moe-a2.7b", tmp_path, cuda, n_layers=2)
    truth = ExpertStore(str(tmp_path))
    group = truth.groups[(0, 0)]
    eng = ZipMoEEngine(ExpertStore(str(tmp_path)), n_experts=cfg.n_experts,
                       n_layers=cfg.n_layers, L=2, freq_decay=0.9,
                       device_cache=True, device=cuda)
    reasons, migrations, l1_refs, checked = [], [], [], []
    plain_replan = eng.replan

    def replan(reason="manual", hit_rate=None):
        before = {l: eng._slabs.get(l) for l in (0, 1)}
        slots = {l: set(s.slot_of) if s is not None else set()
                 for l, s in before.items()}
        if before[1] is not None:
            l1_refs.extend(v for ent in eng.caches[1].pools["F"].values()
                           if ent.payload is not None
                           for v in ent.payload.full.values()
                           if isinstance(v, SlotRef) and v.slab is before[1])
        out = plain_replan(reason=reason, hit_rate=hit_rate)
        torch.cuda.synchronize()
        reasons.append(reason)
        for l in (0, 1):
            old, new = before[l], eng._slabs.get(l)
            if old is not None and new is not None and new is not old \
                    and slots[l] & set(new.slot_of):
                migrations.append(l)
        for e, ent in eng.caches[0].pools["F"].items():
            if ent.payload is None:
                continue
            want = truth.load_group((0, e))
            for tidx, v in ent.payload.full.items():
                assert not isinstance(v, SlotRef) or v.valid, (reason, e)
                got = v.read() if isinstance(v, SlotRef) else v
                assert np.array_equal(bitfield.to_bits(got),
                                      want[group.tensors[tidx].name]), \
                    (reason, e, tidx)
                checked.append(e)
        return out

    eng.replan = replan
    eng.plan_consts = lambda layer: PlanConsts(u=1.0, v=0.1, c=1.0, L=4, K=4,
                                               n_tensors=3)
    phase1 = zipf_trace(cfg.n_experts, 2, 40, alpha=1.4, seed=5)
    phase2 = zipf_trace(cfg.n_experts, 2, 40, alpha=1.4, seed=99)
    slab1_seen = False
    _build.reset_launches()
    try:
        eng.configure_planner(10 * group.full_bytes, replan_every=8,
                              plan_step=0.25, drift_margin=0.05,
                              profile_per_layer=False)
        for i, sel in enumerate(phase1 + phase2):
            eng.fetch_experts(0, sorted(sel))
            if i < len(phase1) and i % 3 == 0:
                eng.fetch_experts(1, sorted(sel))
            slab1_seen = slab1_seen or eng._slabs.get(1) is not None
            eng.note_step()
        torch.cuda.synchronize()
        slab1_end = eng._slabs.get(1)
    finally:
        eng.shutdown()
        truth.close()
    assert "drift" in reasons and migrations and checked, (reasons,
                                                           migrations)
    assert slab1_seen and slab1_end is None
    assert l1_refs and not any(r.valid for r in l1_refs)
    assert _build.LAUNCHES["splice_admit"] > 0, _build.LAUNCHES


# the port's CLIs as subprocesses on the card, each at its own smoke size
CLIS = {
    "serve": ("serve", "--mode", "zipmoe-batch", "--device-cache",
              "--requests", "4", "--max-new", "4"),
    "serve-mla": ("serve", "--arch", "deepseekv2-lite", "--mode",
                  "zipmoe-batch", "--device-cache", "--requests", "4",
                  "--max-new", "4"),
    "serve-jamba": ("serve", "--arch", "jamba-v0.1-52b", "--mode",
                    "zipmoe-batch", "--device-cache", "--requests", "4",
                    "--max-new", "4"),
    "train": ("train", "--arch", "granite-8b", "--preset", "tiny",
              "--steps", "20"),
}


@pytest.mark.parametrize("cli", list(CLIS))
def test_cli_on_card(cuda, tmp_path, cli):
    """``python -m repro_torch.launch.serve`` (``zipmoe-batch``, device
    slabs) exits 0 and prints its ``metrics:`` and ``cache:`` lines;
    ``python -m repro_torch.launch.train`` (granite-8b, ``tiny``, 20
    steps, checkpoints) exits 0 with a final loss below its step-0
    loss."""
    entry, *args = CLIS[cli]
    if entry == "train":
        args += ["--ckpt-dir", str(tmp_path)]
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{entry}", *args],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO / "src")},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    if entry == "serve":
        for head in ("metrics:", "cache:"):
            assert any(ln.startswith(head) for ln in lines), head
        return
    steps = [ln for ln in lines if ln.startswith("step")]
    assert steps[0].startswith("step     0") and lines[-1].startswith(
        "done in"), lines[-3:]
    first = float(steps[0].split("loss=")[1].split()[0])
    assert float(lines[-1].rsplit("final loss", 1)[1]) < first


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


MLA_PATH = ("splice", "splice_admit", "slab_gemm", "mla_rope_write",
            "mla_absorbed_attend")


def test_mla_device_slab_step_on_card(cuda, tmp_path):
    """deepseekv2-lite at smoke size on the card (a dense first layer, two
    MoE layers, latent KV): ``decode_step`` over device slabs and the
    ragged FFN, then ``decode_rows`` under continuous batching; the
    ragged path's three kernels and the two MLA decode kernels launch in
    each, the logits match the resident model on the card within 2% of
    the largest |logit| (each request's against the resident model fed
    its prompt one ``decode_step`` per token as the server reads it, on
    at least half its outputs; against ``prefill`` + ``decode_step`` where
    routed identically), and the latent page pool returns to 0 bytes."""
    from repro_torch.models import decode_step, init_cache
    from repro_torch.serving.zipserve import ZipServer
    cfg, params = _stored("deepseekv2-lite", tmp_path, cuda, n_layers=3,
                          **MLA)
    zs = ZipServer(params, cfg, str(tmp_path), L=2, device_cache=True,
                   pool_sizes=POOLS, device=cuda)
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
        assert all(_build.LAUNCHES[k] > 0 for k in MLA_PATH), _build.LAUNCHES
    finally:
        zs.close()
    done, routes, launches, pool = _continuous(params, cfg, str(tmp_path),
                                               cuda, _prompts(cfg))
    assert pool._paged[0]["kv"]["ckv"].is_cuda
    assert pool.page_nbytes() == cfg.n_layers * (
        cfg.kv_lora_rank + cfg.qk_rope_dim) * 2 * 4
    assert all(launches[k] > 0 for k in MLA_PATH), launches
    _hold_to_resident(params, cfg, cuda, done, routes,
                      prefill_as_decode=False)
    compared, total = _hold_to_resident(params, cfg, cuda, done, routes,
                                        prefill_as_decode=True)
    assert 2 * compared >= total, (compared, total)


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
    its SSM slots on the card, at most 2 requests at once: the pool back to
    0 bytes, the same three kernels launched, each request's logits
    against the resident model fed its prompt one ``decode_step`` per
    token as the server reads it (the resident prefill's SSD rounds the
    conv to bf16 per product where decode sums in f32), on at least half
    its outputs."""
    from repro_torch.models import decode_step, init_cache
    from repro_torch.serving.zipserve import ZipServer
    cfg, params = _stored("jamba-v0.1-52b", tmp_path, cuda)
    zs = ZipServer(params, cfg, str(tmp_path), L=2, device_cache=True,
                   pool_sizes=POOLS, device=cuda)
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
    prompts = _prompts(cfg)
    done, routes, launches, pool = _continuous(params, cfg, str(tmp_path),
                                               cuda, prompts, concurrency=2)
    assert pool._slot[0]["ssm"]["state"].is_cuda
    assert all(launches[k] > 0 for k in
               ("splice", "splice_admit", "slab_gemm")), launches
    compared, total = _hold_to_resident(params, cfg, cuda, done, routes,
                                        prefill_as_decode=True)
    assert 2 * compared >= total, (compared, total)
    # the last request ran in a slot an earlier one freed: against itself
    # alone on a fresh server, logits within LOGIT_REL_TOL before the
    # first position routed otherwise (on at least half its outputs) and
    # tokens equal wherever the logits decide them
    r = done[-1]
    assert r.rid > 2
    (alone,), solo_routes, _, _ = _continuous(
        params, cfg, str(tmp_path), cuda, [prompts[-1]], concurrency=2)
    S, N = len(r.prompt), len(r.output)
    first_flip = min([S + N] + [
        next((s for s, (a, b) in enumerate(zip(mine, solo_routes[
            alone.rid][l])) if a != b), S + N)
        for l, mine in routes[r.rid].items()])
    compared = 0
    for t, (x, y) in enumerate(zip(r.logits, alone.logits)):
        if S - 1 + t >= first_flip:
            break
        diff = float(np.abs(x - y).max())
        assert diff <= LOGIT_REL_TOL * float(np.abs(y).max()), (t, diff)
        top = np.sort(y)[::-1]
        assert top[0] - top[1] <= 2 * diff or r.output[t] == alone.output[t]
        compared += 1
    assert 2 * compared >= N, (compared, N)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3),
                                       ("bfloat16", 0.15)])
def test_mamba_prefill_matches_stepwise_decode_on_card(cuda, dtype, tol):
    """mamba2-370m at smoke size on the card: its SSD prefill of two chunks
    against as many single decode steps from the zero state, every layer
    at once.  In f32 the two compute one function in other orders: within
    1e-3 of the largest |logit|.  In bf16 the prefill's conv rounds each
    product to bf16 where decode sums in f32, as the JAX package does:
    within 0.15, a check of the state handed across the chunk boundary,
    not of rounding."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.models import prefill
    cfg = get_smoke_config("mamba2-370m", d_ff=0, dtype=dtype)
    params = init_params(cfg, seed=0, device=cuda)
    n = 2 * cfg.ssm_chunk
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, n))).to(cuda)
    lg, _ = prefill(params, cfg, toks)
    assert bool(torch.isfinite(lg).all())
    caches = init_cache(cfg, 1, n, device=cuda)
    worst = 0.0
    for i in range(n):
        step, caches = decode_step(params, cfg, toks[:, i:i + 1], caches, i)
        worst = max(worst, (step[0, 0].float() - lg[0, i].float()).abs()
                    .max().item())
    assert worst <= tol * lg.float().abs().max().item(), worst


def _encoder_inputs(cfg, B, dev, seed=0):
    """N(0, 0.02²) encoder inputs drawn with numpy, rounded once to bf16."""
    x = np.random.default_rng(seed).standard_normal(
        (B, cfg.enc_seq_len, cfg.d_model)) * 0.02
    return torch.from_numpy(x).to(torch.bfloat16).to(dev)


@pytest.mark.parametrize("arch", ["mamba2-370m", "whisper-small"])
def test_zipserver_without_routed_experts_on_card(cuda, tmp_path, arch):
    """Configs with no routed expert at smoke size on the card (mamba2's
    store holds its SSM projections, whisper's its dense FFNs): from a
    resident prefill of 7 tokens (whisper's over seeded encoder inputs),
    ``ZipServer.decode_step`` launches no kernel and gives the resident
    model's logits bit for bit over 4 greedy steps."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serving.kv_cache import grow_cache
    from repro_torch.serving.zipserve import ZipServer
    over = {"d_ff": 0} if arch == "mamba2-370m" else {}
    cfg, params = _stored(arch, tmp_path, cuda, **over)
    B, S, steps = 2, 7, 4
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).to(cuda)
    enc = {"enc_embeds": _encoder_inputs(cfg, B, cuda)} \
        if cfg.encoder_decoder else {}
    lg, caches = prefill(params, cfg, toks, **enc)
    served, resident = (grow_cache(cfg, caches, B, S + steps)
                        for _ in range(2))
    tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
    zs = ZipServer(params, cfg, str(tmp_path), L=2, device=cuda,
                   pool_sizes=POOLS, **RAGGED)
    try:
        _build.reset_launches()
        for i in range(steps):
            lg, served = zs.decode_step(tok, served, S + i)
            rl, resident = decode_step(params, cfg, tok, resident, S + i)
            assert bool(torch.isfinite(lg).all()) and _same(lg, rl), i
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
    finally:
        zs.close()
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES


def test_switch_zipserver_on_card(cuda, tmp_path):
    """switch-large-128 at smoke size on the card (MoE decoder layers
    between dense ones, cross-attention over encoder K/V): a resident
    prefill of 8 tokens over seeded encoder inputs, then 8 greedy
    ``ZipServer.decode_step``s over device slabs and the ragged FFN from
    its caches, each against the resident ``decode_step`` fed the same
    tokens: logits within 2% of the largest |logit| on the rows routed
    identically so far (at least half the (step, row) pairs); the caches'
    cross-attention K/V come back unchanged; the splice, the splice-admit
    and the ragged GEMM launch."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serving.kv_cache import grow_cache
    from repro_torch.serving.zipserve import ZipServer
    cfg, params = _stored("switch-large-128", tmp_path, cuda)
    moe = _moe_layers(cfg)
    B, S, steps = 4, 8, 8
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).to(cuda)
    lg, caches = prefill(params, cfg, toks,
                         enc_embeds=_encoder_inputs(cfg, B, cuda))
    assert bool(torch.isfinite(lg).all())
    served, resident = (grow_cache(cfg, caches, B, S + steps)
                        for _ in range(2))
    tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
    live, compared = np.ones(B, bool), 0
    zs = ZipServer(params, cfg, str(tmp_path), L=2, device=cuda,
                   pool_sizes=POOLS, **RAGGED)
    try:
        _build.reset_launches()
        for i in range(steps):
            ids = []
            lg, served = zs.decode_step(tok, served, S + i)
            rl, resident = decode_step(params, cfg, tok, resident, S + i,
                                       router_ids=ids)
            for j, r_ids in enumerate(ids):
                mine = zs.stats[i * len(moe) + j]["routes"]
                theirs = r_ids.reshape(B, -1).cpu().numpy()
                live &= [set(mine[b]) == set(theirs[b]) for b in range(B)]
            assert bool(torch.isfinite(lg).all())
            rows = torch.from_numpy(np.flatnonzero(live)).to(cuda)
            a, b = lg.float()[rows], rl.float()[rows]
            if len(rows):
                err = (a - b).abs().max().item()
                assert err <= LOGIT_REL_TOL * b.abs().max().item(), (i, err)
            compared += len(rows)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
    finally:
        zs.close()
    assert 2 * compared >= B * steps, compared
    assert all(_same(c["xkv"][n], p["xkv"][n])
               for c, p in zip(served, caches) for n in ("k", "v"))
    assert all(_build.LAUNCHES[k] > 0 for k in
               ("splice", "splice_admit", "slab_gemm")), _build.LAUNCHES


@pytest.mark.parametrize("arch", ["qwen3-14b", "starcoder2-3b",
                                  "whisper-small", "qwen2-vl-2b"])
def test_prefill_decode_matches_forward_on_card(cuda, arch):
    """Resident at smoke size on the card (qk-norm; LayerNorm + GELU; an
    encoder-decoder over seeded encoder inputs; seeded embeddings at M-RoPE
    positions of a 3 x 4 image grid then text, three channels that
    differ): ``prefill(S-1)`` + ``decode_step`` against ``forward(S)``
    within 2% of the largest |logit|, every logit finite."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode_step, forward, init_params
    from repro_torch.models import prefill
    from repro_torch.serving.kv_cache import grow_cache
    cfg = get_smoke_config(arch)
    params = init_params(cfg, seed=0, device=cuda)
    B, S = 4, 16
    rng = np.random.default_rng(0)
    if cfg.name.startswith("qwen2-vl"):
        # the image: temporal 0, its row, its column; then text from one
        # past the image's largest position, on all three channels
        pos = np.zeros((3, S), np.int32)
        pos[1, :12], pos[2, :12] = np.arange(12) // 4, np.arange(12) % 4
        pos[:, 12:] = 4 + np.arange(S - 12)
        pos3 = torch.from_numpy(pos)[:, None].expand(3, B, S).contiguous(
        ).to(cuda)
        emb = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                               * 0.02).to(torch.bfloat16).to(cuda)

        def inputs(a, b):
            return None, {"embeds": emb[:, a:b],
                          "mrope_positions": pos3[:, :, a:b]}
        last = inputs(S - 1, S)
    else:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                ).to(cuda)
        enc = {"enc_embeds": _encoder_inputs(cfg, B, cuda)} \
            if cfg.encoder_decoder else {}

        def inputs(a, b):
            return toks[:, a:b], enc
        last = (toks[:, S - 1:], {})
    t, kw = inputs(0, S)
    want, _, _ = forward(params, cfg, t, **kw)
    t, kw = inputs(0, S - 1)
    _, caches = prefill(params, cfg, t, **kw)
    t, kw = last
    got, _ = decode_step(params, cfg, t, grow_cache(cfg, caches, B, S),
                         S - 1, **kw)
    a, b = got[:, 0].float(), want[:, -1].float()
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(want).all())
    assert (a - b).abs().max().item() <= LOGIT_REL_TOL * b.abs().max().item()


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


def _named_leaves(tree, path=""):
    """(path, tensor) of every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def test_train_variants_on_card(cuda):
    """The qwen2-moe-a2.7b smoke config (2 layers) trained on the card, no
    kernel of the port launched: 8 steps of ``make_train_step(remat=True,
    moe_impl="einsum")`` on one fixed batch, every loss and gradient norm
    finite, the last loss at least 0.25 nats below the first; then one
    step each way from the trained weights: remat against no remat (loss
    and every gradient bit-identical but the token embedding's, whose
    backward adds with atomics in an order that varies: within 2^-7),
    the scatter dispatch's loss within 1e-3 of the einsum's (the combine
    summed in another order), and the int8 error feedback's residuals
    within half a quantisation step of every gradient, then one
    compressed step, finite."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models.model import train_loss
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_step import (_compress_ef,
                                                 init_train_state,
                                                 loss_and_grads,
                                                 make_train_step)
    cfg = get_smoke_config("qwen2-moe-a2.7b", n_layers=2)
    batch = _train_batch(cfg, cuda)
    _build.reset_launches()
    state = init_train_state(init_params(cfg, seed=0, device=cuda))
    step = make_train_step(cfg, lr=1e-3, warmup=2, total_steps=8, remat=True,
                           moe_impl="einsum")
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1]) and np.isfinite(float(m["gnorm"]))
    assert losses[-1] < losses[0] - 0.25, losses
    params = state.params
    la, _, ga = loss_and_grads(params, cfg, batch, remat=True)
    lb, _, gb = loss_and_grads(params, cfg, batch, remat=False)
    assert torch.equal(la, lb)
    for (path, a), (_, b) in zip(_named_leaves(ga), _named_leaves(gb)):
        if not torch.equal(a, b):
            assert path == "/embed/tok", path
            assert (a.float() - b.float()).abs().max() <= \
                2.0 ** -7 * b.float().abs().max()
    with torch.no_grad():
        le, ls = (float(train_loss(params, cfg, batch, remat=False,
                                   moe_impl=impl)[0])
                  for impl in ("einsum", "scatter"))
    assert abs(ls - le) <= 1e-3 * abs(le), (ls, le)
    for path, g in _named_leaves(ga):
        _, res = _compress_ef(g, torch.zeros(g.shape, dtype=torch.float32,
                                             device=cuda))
        scale = float(g.float().abs().max()) / 127.0
        assert float(res.abs().max()) <= scale * (0.5 + 2.0 ** -16), path
    state = init_train_state(params, grad_compress=True)
    step = make_train_step(cfg, lr=1e-3, warmup=2, total_steps=8, remat=True,
                           grad_compress=True)
    state, m = step(state, batch)
    assert np.isfinite(float(m["loss"])) and all(
        bool(torch.isfinite(e).all()) for e in tree_leaves(state.err))
    torch.cuda.synchronize()
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES


def test_train_resume_on_card_matches_straight(cuda, tmp_path):
    """At the train CLI's ``tiny`` preset on the card: 8 steps straight
    through against 4 steps, a checkpoint, a restore into a fresh state
    (every leaf on the card, of its dtype and bit-equal to the saved one)
    and 4 more steps; the losses agree within 1e-3 (the restored state is
    bit-equal, but the embedding backward's atomics may change the last
    bits of a later step), and the straight run's loss falls."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.train import preset_config
    from repro_torch.models import init_params
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.data import data_iter
    from repro_torch.training.train_step import (TrainState, as_tensors,
                                                 init_train_state,
                                                 make_train_step)
    cfg, B, S = preset_config("qwen2-moe-a2.7b", "tiny")
    it = data_iter(cfg, ShapeConfig("train", S, B, "train"), seed=0)
    batches = [as_tensors(next(it), cfg, cuda) for _ in range(8)]

    def run(state, bs):
        step = make_train_step(cfg, lr=3e-3, warmup=2, total_steps=8)
        out = []
        for b in bs:
            state, m = step(state, b)
            out.append(float(m["loss"]))
        return state, out

    def fresh(seed):
        return init_train_state(init_params(cfg, seed=seed, device=cuda))

    _, straight = run(fresh(0), batches)
    state, first = run(fresh(0), batches[:4])
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(4, state._asdict(), extra={"loss": first[-1]})
    mgr.wait()
    restored, step, extra = mgr.restore(fresh(1)._asdict(), device=cuda)
    assert step == 4 and extra == {"loss": first[-1]}
    saved = dict(_named_leaves(state._asdict()))
    got = dict(_named_leaves(restored))
    assert set(got) == set(saved)
    for path, t in got.items():
        assert t.is_cuda and t.dtype == saved[path].dtype, path
        assert _same(t, saved[path]) if t.dtype == torch.bfloat16 else \
            torch.equal(t, saved[path]), path
    _, second = run(TrainState(**restored), batches[4:])
    assert max(abs(a - b) for a, b in zip(straight, first + second)) <= 1e-3
    assert straight[-1] < straight[0], straight


def test_gloo_ranks_on_card(cuda, tmp_path):
    """Two ranks sharing the card over gloo: a permute of a CUDA tensor
    arrives (staged through pinned host memory) and is charged its
    operand's bytes; a restore re-meshed onto a CUDA mesh puts each rank's
    block on the card."""
    import _torch_ranks
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.launch import spawn_ranks
    from repro_torch.models import init_params
    from repro_torch.training.checkpoint import CheckpointManager
    cfg = get_smoke_config("qwen2-moe-a2.7b", n_layers=2)
    params = init_params(cfg, seed=3, device="cpu")
    CheckpointManager(str(tmp_path / "ckpt")).save(1, params)
    res = spawn_ranks(_torch_ranks.device_rank, 2, timeout_s=300,
                      args=(str(tmp_path / "ckpt"), params, cfg, "cuda"),
                      store_dir=str(tmp_path))
    for rank, (on_card, got, summary, blocks_ok) in enumerate(res):
        assert on_card and blocks_ok
        assert (got == (rank - 1) % 2 + 1).all()
        assert summary["collective_bytes"] == {"collective-permute": 30}
        assert summary["collective_ops"] == {"collective-permute": 1}


def test_seqshard_and_pipeline_ranks_on_card(cuda, tmp_path):
    """Two ranks sharing the card over gloo, against the parent's
    one-process runs on the card from the same seeded inputs:

    * sequence-sharded decode, qwen2-moe-a2.7b (GQA, 2 layers) and
      deepseekv2-lite (MLA, 3 layers) smoke configs in f32, B 4, a seeded
      cache of 64 positions split 32 a rank, three steps writing in both
      shards: each rank's logits within 1e-5 of the largest |logit| of
      the default ``decode_step`` (the reference's seq-sharded test's
      limit); the gathered shards bit-equal to the default path's cache
      but for the positions written in layers past the first, whose
      inputs carry the combine's other summation order (within 1e-5);
      each ledger equal to ``reckon_seqshard_decode``;
    * the GPipe pipeline, qwen2-moe-a2.7b smoke config at 4 layers in
      bf16, 2 stages, 4 micro-batches of [2, 16]: each rank's result
      bit-identical to the sequential pass over the stack, its ledger
      equal to ``reckon_pipeline``;
    * no kernel launches on a rank; the parent's default MLA decode
      launches each MLA decode kernel once a layer and step, and nothing
      else launches."""
    import _torch_ranks
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.launch import spawn_ranks
    from repro_torch.distributed.pipeline import reckon_pipeline
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.models.decode_attention import reckon_seqshard_decode
    from repro_torch.models.model import _superblock
    from repro_torch.serving.kv_cache import map_tree
    B, T, positions, world, rel = 4, 64, (10, 39, 63), 2, 1e-5
    g = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(0)
    jobs = []
    for arch, over in (("qwen2-moe-a2.7b", dict(n_layers=2)),
                       ("deepseekv2-lite", dict(n_layers=3, **MLA))):
        cfg = get_smoke_config(arch, dtype="float32", **over)
        caches = map_tree(lambda t: torch.randn(t.shape, generator=g) * 0.5,
                          init_cache(cfg, B, T, device="cpu"))
        jobs.append((cfg, init_params(cfg, seed=0, device="cpu"), caches,
                     [(p, torch.from_numpy(rng.integers(
                         0, cfg.vocab_size, (B, 1)))) for p in positions]))
    pcfg = get_smoke_config("qwen2-moe-a2.7b", n_layers=4)
    pparams = init_params(pcfg, seed=0, device="cpu")
    x = (torch.randn((4, 2, 16, pcfg.d_model), generator=g) * 0.1).to(
        torch.bfloat16)
    ranks = spawn_ranks(_torch_ranks.card_rank, world, timeout_s=600,
                        args=(jobs, (pcfg, pparams, x), "cuda"),
                        store_dir=str(tmp_path))
    _build.reset_launches()
    written = np.zeros(T, bool)
    written[list(positions)] = True

    def on_card(tree):
        return map_tree(lambda t: t if t is None else t.to(cuda), tree)

    for j, (cfg, params, caches, steps) in enumerate(jobs):
        params, caches = on_card(params), on_card(caches)
        for i, (pos, tok) in enumerate(steps):
            lg, caches = decode_step(params, cfg, tok.to(cuda), caches, pos)
            want = lg.cpu().numpy()
            for r in ranks:
                got = r["decode"][j][0][i]
                assert np.isfinite(got).all()
                assert np.abs(got - want).max() <= rel * np.abs(want).max()
        for layer, c in enumerate(caches):
            for name, t in c["kv"].items():
                want = t.cpu().numpy()
                got = np.concatenate([r["decode"][j][1][layer][name]
                                      for r in ranks], axis=1)
                same = got.view(np.uint32) == want.view(np.uint32)
                assert same[:, ~written].all(), (cfg.name, layer, name)
                assert layer > 0 or same.all(), (cfg.name, name)
                assert np.abs(got - want)[:, written].max() <= \
                    rel * np.abs(want[:, written]).max()
        reckoned = reckon_seqshard_decode(cfg, B, len(steps))
        for r in ranks:
            assert {k: r["decode"][j][2][k] for k in reckoned} == reckoned
    params = on_card(pparams)
    pos = torch.arange(16, dtype=torch.int32, device=cuda)[None].expand(2, 16)
    aux = torch.zeros((), device=cuda)
    seq = torch.stack([_superblock(params["layers"], xm, aux, pcfg, pos, None,
                                   None, "einsum")[0] for xm in x.to(cuda)])
    assert bool(torch.isfinite(seq).all())
    reckoned = reckon_pipeline(pcfg, world, 4, (2, 16))
    for r in ranks:
        bits, summary = r["pipe"]
        assert np.array_equal(bits, seq.view(torch.int16).cpu().numpy())
        assert {k: summary[k] for k in reckoned} == reckoned
        assert not any(r["launches"].values()), r["launches"]
    torch.cuda.synchronize()
    n_mla = jobs[1][0].n_layers * len(positions)
    assert _build.LAUNCHES == {**{k: 0 for k in _build.LAUNCHES},
                               "mla_rope_write": n_mla,
                               "mla_absorbed_attend": n_mla}, _build.LAUNCHES


def test_peer_tier_on_card(cuda, tmp_path):
    """Four peer rows on the card (a card each where there are four): a
    fetch lands on the compute device as a copy that keeps its bytes when
    the slot is reused.  A smoke-size ZipServer at mesh 4 gives the mesh-1
    server's logits bit for bit, link-serves experts, charges its ledger
    an expert's bytes a fetch and launches the splice-admit and the ragged
    GEMM; every PeerRef it holds is valid and names its expert's slot, and
    one expert a row fetched back holds the store's bits.  With every
    expert then resident, 3 more steps from a fresh cache move no
    host-to-device byte, link-serve experts and give mesh 1's logits bit
    for bit.  Planned at mesh 4 (6 experts' bytes, 2 a row on the peers,
    a forced re-plan before step 4) it gives them too."""
    from repro_torch.core.bitfield import to_bits
    from repro_torch.core.slab import PeerRef, PeerSlabMesh
    from repro_torch.core.store import ExpertStore
    from repro_torch.serving.zipserve import ZipServer
    n = torch.cuda.device_count()
    rows = [torch.device("cuda", i) for i in range(4)] if n >= 4 \
        else [torch.device("cuda", torch.cuda.current_device())] * 4
    shapes = {"w_up": (64, 72), "w_down": (72, 64)}
    slab = PeerSlabMesh(0, shapes, 1, rows)
    a = {k: torch.randn(s, device=cuda).to(torch.bfloat16)
         for k, s in shapes.items()}
    slab.put(1, 3, a)
    got = slab.fetch(1)
    slab.free(1)
    slab.put(2, 3, {k: torch.zeros_like(v) for k, v in a.items()})
    for k in shapes:
        assert got[k].device == rows[0] and _same(got[k], a[k])
    cfg, params = _stored("qwen2-moe-a2.7b", tmp_path, cuda, n_layers=2)
    store = ExpertStore(str(tmp_path))
    f_bytes = store.groups[(0, 0)].full_bytes

    def server(**kw):
        return ZipServer(params, cfg, str(tmp_path), L=2, device=cuda,
                         **RAGGED, **kw)

    zs = server(pool_sizes=POOLS)
    try:
        base, _ = _greedy(zs, cuda, 2, 6)
    finally:
        zs.close()
    zs = server(pool_sizes=POOLS, mesh_devices=4, peer_devices=rows)
    try:
        lgs, _ = _greedy(zs, cuda, 2, 6)
        launches, ps = dict(_build.LAUNCHES), zs.peer_summary()
        n_fetch = ps["collective_ops"]["collective-permute"]
        nbytes = {s.expert_nbytes() for s in zs.engine.peer.slabs.values()
                  if s is not None}
        assert ps["collective_bytes"] == {
            "collective-permute": n_fetch * nbytes.pop()} and not nbytes
        n_refs = 0
        for l, pslab in zs.engine.peer.slabs.items():
            if pslab is None:
                continue
            for e, ent in zs.engine.caches[l].pools["P"].items():
                for v in (ent.payload.full.values()
                          if ent.payload is not None else ()):
                    if isinstance(v, PeerRef):
                        assert v.valid and pslab.slot_of.get(e) == (
                            v.dev, v.slot), (l, e)
                        n_refs += 1
            seen = set()
            for e, (row, _) in sorted(pslab.slot_of.items()):
                if row not in seen:
                    seen.add(row)
                    want = store.load_group((l, e))
                    for name, t in pslab.fetch(e).items():
                        assert np.array_equal(to_bits(t), want[name])
        assert n_refs > 0
        for l in zs._moe_layers:
            zs.engine.fetch_experts(l, list(range(cfg.n_experts)))
        served = zs.peer_summary()["served"]
        caches = zs.init_cache(2, 4)
        tok = torch.zeros((2, 1), dtype=torch.long, device=cuda)
        for i in range(4):
            if i == 1:
                torch.cuda.synchronize()
                h2d = zs.engine.h2d_bytes
            lg, caches = zs.decode_step(tok, caches, i)
            assert _same(lg, base[i]), i
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        assert zs.engine.h2d_bytes == h2d
        assert zs.peer_summary()["served"] > served
    finally:
        zs.close()
    assert all(_same(x, y) for x, y in zip(base, lgs))
    assert ps["served"] > 0 and ps["total_bytes"] > 0, ps
    assert launches["splice_admit"] > 0 and launches["slab_gemm"] > 0
    zs = server(mem_budget=6 * f_bytes, peer_budget=2 * f_bytes,
                replan_every=4, mesh_devices=4, peer_devices=rows)
    try:
        planned, _ = _greedy(zs, cuda, 2, 6, replan_at=4)
        assert zs.plan_summary()["n_replans"] >= 1
    finally:
        zs.close()
        store.close()
    assert all(_same(x, y) for x, y in zip(base, planned))
