"""The port's kernels, on the CPU: each plain PyTorch version against the
JAX package's Pallas kernel in interpret mode, the ``kernels/ops.py``
dispatchers on CPU tensors against the JAX package's dispatchers, and the
CUDA wrappers' refusal of anything but CUDA tensors.  (The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.)

Tolerances: splices and slab writes are bit-exact.  The ragged GEMM sums
in f32 in another order than the Pallas kernel (whole-d ``bmm`` vs
``block_d`` partial sums), so f32 outputs agree to f32 round-off
(rtol 1e-5) and bf16 outputs, rounded once from those sums, to one bf16
ulp (rtol 2^-7).  The grouped and fused GEMMs are held bit for bit where
the Pallas kernel takes the whole contraction in one block (as the JAX
package's own zip_gemm_grouped test does), and to one bf16 ulp where it
splits d into blocks.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import moe_gemm as jmoe
from repro.kernels import ops as jops
from repro.kernels import recovery as jrec
from repro.kernels import ref as jref
from repro_torch.core import bitfield
from repro_torch.kernels import moe_gemm, ops, recovery, ref


def _u8(rng, shape, hi=256):
    return rng.integers(0, hi, shape, dtype=np.uint8)


def _exp(rng, shape):
    """Exponent plane without the all-ones exponent: XLA rewrites NaN
    payloads, so bit patterns are compared on finite values against the
    JAX package (the numpy comparison in test_torch_bitfield covers every
    pattern)."""
    return _u8(rng, shape, hi=255)


def _bits(a) -> np.ndarray:
    """Bit pattern of a bf16 array of either package."""
    if isinstance(a, torch.Tensor):
        return bitfield.to_bits(a)
    return np.asarray(a).view(np.uint16)


def test_recover_plain_vs_pallas_interpret():
    rng = np.random.default_rng(0)
    exp, sm = _exp(rng, (16, 256)), _u8(rng, (16, 256))
    want = jrec.recover_bf16_2d(jnp.asarray(exp), jnp.asarray(sm),
                                block_m=8, block_n=128, interpret=True)
    got = ref.recover_bf16_ref(torch.from_numpy(exp), torch.from_numpy(sm))
    assert np.array_equal(_bits(got), _bits(want))


def test_splice_admit_plain_vs_pallas_interpret():
    rng = np.random.default_rng(2)
    cap, d, f, slot = 4, 16, 32, 2
    base = rng.standard_normal((cap, d, f)).astype(np.float32)
    exp, sm = _exp(rng, (d, f)), _u8(rng, (d, f))
    want = jmoe.slab_splice_admit(jnp.asarray(base, jnp.bfloat16),
                                  jnp.asarray(exp), jnp.asarray(sm), slot,
                                  block_d=d, block_f=f, interpret=True)
    buf = torch.from_numpy(base).to(torch.bfloat16)
    got = ref.splice_admit_ref(buf, torch.from_numpy(exp),
                               torch.from_numpy(sm), slot)
    assert np.array_equal(_bits(got), _bits(want))
    # the CPU dispatcher writes the same bytes in place
    ptr = buf.data_ptr()
    out = ops.slab_splice_set(buf, slot, torch.from_numpy(exp.reshape(-1)),
                              torch.from_numpy(sm.reshape(-1)))
    assert out is buf and buf.data_ptr() == ptr
    assert np.array_equal(_bits(buf), _bits(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,f,bd,bf,ts", [
    (16, 32, 16, 32, [2, 0, 0, 3, 1, 0]),     # repeats + "pad" tiles
    (24, 40, 24, 40, [1, 2, 2]),              # non-128 dims
    (32, 64, 16, 32, [3, 1]),                 # blocked contraction
])
def test_slab_gemm_plain_vs_pallas_interpret(dtype, d, f, bd, bf, ts):
    rng = np.random.default_rng(0)
    cap, block_c = 4, 8
    ts = np.asarray(ts, np.int32)
    buf = rng.standard_normal((cap, d, f)).astype(np.float32)
    x = rng.standard_normal((ts.size * block_c, d)).astype(np.float32)
    want = np.asarray(jmoe.slab_ragged_gemm(
        jnp.asarray(x, dtype), jnp.asarray(buf, dtype), ts,
        block_c=block_c, block_d=bd, block_f=bf, interpret=True), np.float32)
    tdt = getattr(torch, dtype)
    got = ref.slab_gemm_ref(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(buf).to(tdt), ts,
                            block_c=block_c)
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=1e-4)


def test_slab_gemm_singleton_and_empty_tiles():
    """A tile holding one real token and an all-padding tile: the real row
    matches the JAX kernel, the pad tile is exactly zero."""
    rng = np.random.default_rng(1)
    cap, d, f, block_c = 3, 16, 24, 8
    buf = rng.standard_normal((cap, d, f)).astype(np.float32)
    x = np.zeros((2 * block_c, d), np.float32)
    x[0] = rng.standard_normal(d)
    ts = np.asarray([1, 0], np.int32)
    want = np.asarray(jmoe.slab_ragged_gemm(
        jnp.asarray(x), jnp.asarray(buf), ts, block_c=block_c, block_d=d,
        block_f=f, interpret=True))
    got = ref.slab_gemm_ref(torch.from_numpy(x), torch.from_numpy(buf), ts)
    np.testing.assert_allclose(got.numpy()[0], want[0], rtol=1e-5, atol=1e-5)
    assert np.all(got.numpy()[1:] == 0.0)


def test_ops_dispatchers_on_cpu_match_jax_dispatchers():
    rng = np.random.default_rng(3)
    d, f = 24, 40
    exp, sm = _exp(rng, d * f), _u8(rng, d * f)
    want = jops.recover_bf16_device(exp, sm, (d, f))
    te, ts_ = torch.from_numpy(exp), torch.from_numpy(sm)
    for got in (ops.recover_bf16(te, ts_, (d, f)),
                ops.splice_planes_device(te, ts_, (d, f)),
                ops.recover_bf16_device(exp, sm.tobytes(), (d, f), "cpu")):
        assert tuple(got.shape) == (d, f)
        assert np.array_equal(_bits(got), _bits(want))
    cap = 3
    buf = rng.standard_normal((cap, d, f)).astype(np.float32)
    x = rng.standard_normal((16, d)).astype(np.float32)
    tsl = np.asarray([2, 2], np.int32)
    want = np.asarray(jops.slab_gemm(jnp.asarray(x, jnp.bfloat16),
                                     jnp.asarray(buf, jnp.bfloat16), tsl),
                      np.float32)
    got = ops.slab_gemm(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(buf).bfloat16(), tsl)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=1e-4)


# (E, C, d, f, block_d): one contraction block, then split contractions
GROUPED_SHAPES = [(3, 8, 16, 32, 16), (3, 8, 64, 48, 64),
                  (2, 8, 128, 128, 128), (4, 16, 256, 128, 128),
                  (1, 8, 512, 256, 128)]


def _check_gemm(got: torch.Tensor, want, d: int, block_d: int):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if block_d == d:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-4)


def _grouped_inputs(seed, E, C, d, f):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((E, C, d)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((E, d, f)) * 0.05, jnp.bfloat16)
    exp, sm = jref.decompose_bf16_ref(w)
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    tw = torch.from_numpy(np.asarray(w, np.float32)).to(torch.bfloat16)
    return (x, w, exp, sm), (tx, tw, torch.from_numpy(np.array(exp)),
                             torch.from_numpy(np.array(sm)))


@pytest.mark.parametrize("E,C,d,f,bd", GROUPED_SHAPES)
def test_grouped_gemm_plain_vs_pallas_interpret(E, C, d, f, bd):
    (x, w, _, _), (tx, tw, _, _) = _grouped_inputs(4, E, C, d, f)
    want = jmoe.grouped_gemm(x, w, block_c=8, block_d=bd,
                             block_f=min(f, 128), interpret=True)
    _check_gemm(ref.moe_gemm_ref(tx, tw), want, d, bd)
    _check_gemm(ops.grouped_expert_gemm(tx, tw), want, d, bd)


@pytest.mark.parametrize("E,C,d,f,bd", GROUPED_SHAPES)
def test_zip_gemm_grouped_plain_vs_pallas_interpret(E, C, d, f, bd):
    (x, _, exp, sm), (tx, _, te, ts) = _grouped_inputs(5, E, C, d, f)
    want = jmoe.zip_gemm_grouped(x, exp, sm, block_c=8, block_d=bd,
                                 block_f=min(f, 128), interpret=True)
    _check_gemm(ref.zip_gemm_grouped_ref(tx, te, ts), want, d, bd)
    _check_gemm(ops.zip_gemm_batch(tx, te, ts), want, d, bd)


@pytest.mark.parametrize("C,d,f,bd", [(8, 16, 32, 16), (8, 256, 128, 128),
                                      (16, 512, 256, 128)])
def test_zip_gemm_plain_vs_pallas_interpret(C, d, f, bd):
    (x, _, exp, sm), (tx, _, te, ts) = _grouped_inputs(6, 1, C, d, f)
    want = jmoe.zip_gemm(x[0], exp[0], sm[0], block_c=8, block_d=bd,
                         block_f=min(f, 128), interpret=True)
    _check_gemm(ops.fused_zip_gemm(tx[0], te[0], ts[0]), want, d, bd)


def test_fused_dispatchers_match_jax_dispatchers():
    """The port's CPU dispatchers against the JAX package's: the batched
    fused GEMM bit for bit, the per-expert one equal to the batch row, the
    host recovery hook returning the same bf16 bits."""
    (x, _, exp, sm), (tx, _, te, ts) = _grouped_inputs(7, 3, 8, 24, 40)
    want = np.asarray(jops.zip_gemm_batch(x, exp, sm), np.float32)
    got = ops.zip_gemm_batch(tx, te, ts)
    assert np.array_equal(got.float().numpy(), want)
    for e in range(3):
        one = ops.fused_zip_gemm(tx[e], te[e], ts[e])
        assert np.array_equal(_bits(one), _bits(got[e]))
    flat_e = np.asarray(exp[1]).reshape(-1)
    flat_s = np.asarray(sm[1]).reshape(-1)
    host = ops.recover_bf16_host(flat_e, flat_s.tobytes(), (24, 40), "cpu")
    assert host.dtype == np.uint16 and host.shape == (24, 40)
    assert np.array_equal(host, _bits(jops.recover_bf16_host(
        flat_e, flat_s.tobytes(), (24, 40))))


def test_bucket_rows_matches_reference():
    for n in list(range(0, 300)) + [1000, 4097]:
        for align in (1, 8):
            assert ops.bucket_rows(n, align) == jops.bucket_rows(n, align)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only: a CPU tensor raises
    instead of silently running a plain path."""
    e = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        recovery.recover_bf16(e, e)
    buf = torch.zeros((2, 8, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        moe_gemm.slab_splice_admit(buf, e, e, 0)
    with pytest.raises(ValueError, match="CUDA"):
        moe_gemm.slab_ragged_gemm(torch.zeros((8, 8), dtype=torch.bfloat16),
                                  buf, np.zeros(1, np.int32))
    with pytest.raises(TypeError):
        recovery.recover_bf16(np.zeros(64, np.uint8), e)


def test_grouped_and_zip_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 8, 16), dtype=torch.bfloat16)
    w = torch.zeros((2, 16, 8), dtype=torch.bfloat16)
    p = torch.zeros((2, 16, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        moe_gemm.grouped_gemm(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        moe_gemm.zip_gemm_grouped(x, p, p)
    with pytest.raises(ValueError, match="CUDA"):
        moe_gemm.zip_gemm(x[0], p[0], p[0])


# the served contraction widths: the smoke config's d_model / d_expert and
# qwen2-moe-a2.7b's
@pytest.mark.parametrize("k", [64, 128, 1408, 2048])
def test_split_plan_served_widths(k):
    b = moe_gemm.split_plan(k)
    assert b[0] == 0 and b[-1] == k
    assert len(b) - 1 == -(-k // 512)
    assert all(x % moe_gemm.CHUNK_ROWS == 0 for x in b[:-1])
    assert moe_gemm.split_args(3, k, 8, torch.device("cpu"),
                               spread=False).bounds.tolist() == list(b)


def test_split_plan_slices_every_k():
    """For every K in 1..4096: ascending non-empty slices on 64-row chunk
    boundaries, covering [0, K) exactly, S = ceil(K / 512), each at most
    512 rows, and the same plan on every call (the GEMM kernels hold their
    bit-equalities only because it depends on K alone)."""
    for k in range(1, 4097):
        b = moe_gemm.split_plan(k)
        assert b[0] == 0 and b[-1] == k
        assert all(x < y <= x + 512 for x, y in zip(b, b[1:]))
        assert all(x % moe_gemm.CHUNK_ROWS == 0 for x in b[:-1])
        assert len(b) - 1 == -(-k // 512)
        assert b == moe_gemm.split_plan(k)


def test_split_plan_limits():
    assert moe_gemm.split_plan(0) == (0, 0)
    longest = moe_gemm.MAX_SLICES * moe_gemm.SLICE_CHUNKS * 64
    assert len(moe_gemm.split_plan(longest)) == moe_gemm.MAX_SLICES + 1
    with pytest.raises(ValueError, match="slices"):
        moe_gemm.split_plan(longest + 1)
    with pytest.raises(ValueError):
        moe_gemm.split_plan(-1)


@pytest.mark.parametrize("n_tiles,f,n_slices,spread", [
    (1, 1408, 4, True),          # zip_gemm's one tile: 22 CTAs on 132 SMs
    (1, 2048, 3, True),
    (16, 1408, 4, False),        # E = 16 x C = 8: 352 CTAs walk their slices
    (16, 2048, 3, False),
    (1, 1408, 1, False),         # one slice: nothing to spread
    (11, 1408, 4, True),         # 242 CTAs: under two per SM
    (12, 1408, 4, False),        # 264 CTAs: two per SM
])
def test_spread_rule(n_tiles, f, n_slices, spread):
    assert moe_gemm.spreads(n_tiles, f, n_slices, 132) is spread


def test_split_args_layout_without_spread():
    sa = moe_gemm.split_args(16, 2048, 1408, torch.device("cpu"),
                             spread=False)
    ptr, n, spread, partial, counters = sa.args
    assert ptr == sa.bounds.ctypes.data and sa.bounds.dtype == np.int32
    assert (n, spread, partial, counters) == (4, 0, None, None)


def test_dispatch_rejects_mixed_devices():
    with pytest.raises(ValueError):
        ops._on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))


def test_decompose_ref_inverts_recover():
    w = torch.randn(8, 16).to(torch.bfloat16)
    exp, sm = ref.decompose_bf16_ref(w)
    want_e, want_s = jref.decompose_bf16_ref(jnp.asarray(
        w.float().numpy(), jnp.bfloat16))
    assert np.array_equal(exp.numpy(), np.asarray(want_e))
    assert np.array_equal(sm.numpy(), np.asarray(want_s))
    assert torch.equal(ref.recover_bf16_ref(exp, sm).view(torch.int16),
                       w.view(torch.int16))


def test_launch_count_loses_no_increment():
    """``_build.count_launch`` is called from the decode thread and, with
    ``device_recovery``, from the engine's I/O and decompression workers at
    once.  The count and its reset go through one lock of their own (not
    the build's): a count waits while that lock is held, and 32 threads
    counting with a short switch interval lose no increment."""
    import sys
    import threading
    from repro_torch.kernels import _build
    _build.reset_launches()
    with _build._count_lock:
        for fn in (lambda: _build.count_launch("splice"),
                   _build.reset_launches):
            t = threading.Thread(target=fn)
            t.start()
            t.join(timeout=0.2)
            assert t.is_alive()               # waits on the count lock
            waiting = t
    waiting.join(timeout=10)
    assert not waiting.is_alive()
    assert _build.LAUNCHES["splice"] == 0     # counted, then reset
    n_threads, per = 32, 1000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = threading.Barrier(n_threads)

        def work():
            start.wait(timeout=30)
            for _ in range(per):
                _build.count_launch("splice")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert _build.LAUNCHES["splice"] == n_threads * per
    finally:
        sys.setswitchinterval(old)
        _build.reset_launches()
