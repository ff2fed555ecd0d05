"""The port's bit-field split/merge against the JAX package's numpy one,
over all 65,536 bf16 bit patterns (NaN payloads included).

Compared against ``repro.core.bitfield``'s numpy functions, not its jnp
ones: XLA rewrites non-canonical NaN payloads, torch bit views do not.
"""
import numpy as np
import pytest
import torch

from repro.core import bitfield as ref_bf
from repro_torch.core import bitfield as bf

ALL = np.arange(65536, dtype=np.uint16)


def test_decompose_np_all_patterns():
    exp, sm = bf.decompose_np(ALL)
    r_exp, r_sm = ref_bf.decompose_np(ALL.view(ref_bf.BF16))
    assert np.array_equal(exp, r_exp) and np.array_equal(sm, r_sm)


def test_reconstruct_np_all_patterns():
    r_exp, r_sm = ref_bf.decompose_np(ALL.view(ref_bf.BF16))
    got = bf.reconstruct_np(r_exp, r_sm)
    want = ref_bf.reconstruct_np(r_exp, r_sm).view(np.uint16)
    assert got.dtype == np.uint16
    assert np.array_equal(got, want) and np.array_equal(got, ALL)


def test_torch_split_merge_all_patterns():
    t = bf.from_bits(ALL)
    exp, sm = bf.decompose(t)
    r_exp, r_sm = ref_bf.decompose_np(ALL.view(ref_bf.BF16))
    assert np.array_equal(exp.numpy(), r_exp)
    assert np.array_equal(sm.numpy(), r_sm)
    back = bf.reconstruct(torch.from_numpy(r_exp), torch.from_numpy(r_sm))
    assert back.dtype == torch.bfloat16
    assert np.array_equal(bf.to_bits(back), ALL)


def test_bits_bridge_roundtrip():
    """bf16 crosses torch <-> numpy through uint16 views, bit-exact, and a
    float array rounds to the same bf16 as ml_dtypes does."""
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    want = x.astype(ref_bf.BF16).view(np.uint16)
    assert np.array_equal(bf.to_bits(x), want)
    assert np.array_equal(bf.to_bits(bf.from_bits(want, (10, 100))),
                          want.reshape(10, 100))


@pytest.mark.parametrize("n,k", [(10, 4), (4096, 4), (7, 3), (1, 1)])
def test_shard_bounds_match(n, k):
    assert bf.shard_bounds(n, k) == ref_bf.shard_bounds(n, k)


def test_entropy_helpers_match():
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    bits = bf.to_bits(x)
    exp, _ = bf.decompose_np(bits)
    r_exp, _ = ref_bf.decompose_np(x.astype(ref_bf.BF16))
    assert bf.byte_entropy(exp) == ref_bf.byte_entropy(r_exp)
    assert bf.support_fraction(exp) == ref_bf.support_fraction(r_exp)
    assert bf.entropy_bound_ratio(bits) == \
        ref_bf.entropy_bound_ratio(x.astype(ref_bf.BF16))
