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
ulp (rtol 2^-7).
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
