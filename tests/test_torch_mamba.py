"""The port's Mamba2 block (``models/mamba.py``) against the JAX package's,
and the port's SSD prefill against its own recurrence.

The widths are the mamba2 smoke config's with two B/C groups:
``ssm_headdim`` 16 (against an attention ``head_dim`` of 32), 16 SSM heads
over 2 groups, so ``_bc_heads`` must give heads 0-7 group 0 and heads
8-15 group 1; a chunk of 32 tokens, so a 64-token prefill crosses a chunk
boundary.  Inputs are drawn with numpy from a seed; the parameters are
``test_torch_models.numpy_params``'s (the JAX init's constants for the 1-D
leaves).

Tolerances:

* **f32** (``dtype="float32"``): both packages run the same arithmetic in
  f32 with sums in other orders: outputs and states within ``F32_REL``
  (1e-5) of their largest magnitude;
* **bf16** (the served dtype): the projections and the prefill's conv
  round to bf16 as the JAX package rounds them, but the matmuls add in
  other orders, so an output may differ by a bf16 ulp or two: within
  ``MAX_REL`` (2%) of the largest |y| at worst and ``MEAN_REL`` (0.5%) on
  average; the f32 state within 2% of its largest magnitude;
* **prefill + decode ≡ forward**, and SSD prefill ≡ step-by-step decode,
  within the port in f32: ``F32_REL`` of the largest logit (the JAX
  package's own test holds itself to 1e-4 there).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba as ref_mamba
from repro.configs import get_smoke_config as ref_smoke_config
from repro_torch.configs import get_smoke_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import decode_step, forward, init_cache, prefill
from repro_torch.models import init_params
from repro_torch.serving.kv_cache import grow_cache
from test_torch_models import MAX_REL, MEAN_REL, numpy_params

F32_REL = 1e-5
WIDTHS = dict(ssm_groups=2, ssm_headdim=16, ssm_chunk=32)


def _layer(dtype: str, seed: int = 0):
    """(JAX config, JAX leaves, port config, port leaves) of one mamba2
    layer at the test widths, the same numbers in both packages."""
    jcfg = ref_smoke_config("mamba2-370m", n_layers=1, dtype=dtype,
                            **WIDTHS)
    cfg = get_smoke_config("mamba2-370m", n_layers=1, dtype=dtype, **WIDTHS)
    assert cfg.ssm_headdim != cfg.head_dim and cfg.ssm_heads == 16
    tree = jax.tree.map(np.asarray, numpy_params(jcfg, seed))
    leaves = tree["decoder"]["stack"]["sub_0"]["mamba"]
    jp = {k: jnp.asarray(v[0]) for k, v in leaves.items()}
    tp = {k: tensor_from_numpy(v[0], "cpu") for k, v in leaves.items()}
    return jcfg, jp, cfg, tp


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch,
                                                                 dtype))


def _close(got, want, dtype, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= F32_REL * scale, (what, diff.max(), scale)
    else:
        assert diff.max() <= MAX_REL * scale, (what, diff.max(), scale)
        assert diff.mean() <= MEAN_REL * scale, (what, diff.mean(), scale)


def test_bc_heads_repeat_order():
    """Head i reads group i // (H / g), as the JAX package's repeat."""
    jcfg, _, cfg, _ = _layer("float32")
    t = np.random.default_rng(0).standard_normal(
        (3, cfg.ssm_groups * cfg.ssm_state)).astype(np.float32)
    got = mamba_lib._bc_heads(torch.from_numpy(t), cfg).numpy()
    want = np.asarray(ref_mamba._bc_heads(jnp.asarray(t), jcfg))
    assert got.shape == (3, cfg.ssm_heads, cfg.ssm_state)
    assert np.array_equal(got, want)
    per = cfg.ssm_heads // cfg.ssm_groups
    assert np.array_equal(got[:, per], t[:, cfg.ssm_state:])


@pytest.mark.parametrize("L", [8, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_forward_matches_reference(dtype, L):
    """One chunk (8 tokens) and two chunks (64 = 2 x 32): the output, the
    final SSD state and the conv ring."""
    jcfg, jp, cfg, tp = _layer(dtype)
    jx, tx = _x((2, L, cfg.d_model), dtype)
    want, wc = ref_mamba.mamba_forward(jp, jx, jcfg, return_cache=True)
    got, gc = mamba_lib.mamba_forward(tp, tx, cfg, return_cache=True)
    _close(got, want, dtype, "y")
    _close(gc["state"], wc["state"], dtype, "state")
    assert gc["state"].dtype == torch.float32
    # the ring is the last w - 1 pre-conv inputs: the same projections
    _close(gc["conv"], wc["conv"], dtype, "conv")
    assert gc["conv"].shape == (2, cfg.ssm_conv - 1,
                                cfg.d_inner + 2 * cfg.ssm_groups
                                * cfg.ssm_state)
    no_cache = mamba_lib.mamba_forward(tp, tx, cfg)
    assert torch.equal(no_cache, got)


def test_mamba_forward_refuses_ragged_chunks():
    """Like the JAX package, a sequence longer than a chunk must be a
    whole number of chunks."""
    _, _, cfg, tp = _layer("float32")
    _, tx = _x((1, 40, cfg.d_model), "float32")
    with pytest.raises(AssertionError, match="not divisible"):
        mamba_lib.mamba_forward(tp, tx, cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_reference_in_place(dtype):
    """One decode step from a random state and conv ring: output and new
    cache as the reference's, written into the given cache tensors."""
    jcfg, jp, cfg, tp = _layer(dtype)
    B = 3
    jx, tx = _x((B, 1, cfg.d_model), dtype)
    cache_t = mamba_lib.init_ssm_cache(cfg, B, "cpu")
    rng = np.random.default_rng(5)
    state = rng.standard_normal(cache_t["state"].shape).astype(np.float32)
    conv = rng.standard_normal(cache_t["conv"].shape).astype(np.float32)
    cache_t["state"].copy_(torch.from_numpy(state))
    cache_t["conv"].copy_(torch.from_numpy(conv))
    jc = {"state": jnp.asarray(state),
          "conv": jnp.asarray(conv, jnp.dtype(dtype))}
    want, wc = ref_mamba.mamba_decode(jp, jx, jcfg, jc)
    ptrs = {k: v.data_ptr() for k, v in cache_t.items()}
    got, gc = mamba_lib.mamba_decode(tp, tx, cfg, cache_t)
    assert gc is cache_t and all(v.data_ptr() == ptrs[k]
                                 for k, v in gc.items())
    _close(got, want, dtype, "y")
    _close(gc["state"], wc["state"], dtype, "state")
    _close(gc["conv"], wc["conv"], dtype, "conv")


def _f32(arch, n_layers):
    """A smoke config in f32 with no MoE capacity drops."""
    return get_smoke_config(arch, n_layers=n_layers, dtype="float32",
                            capacity_factor=8.0)


@pytest.mark.parametrize("arch,n_layers", [("mamba2-370m", 2),
                                           ("jamba-v0.1-52b", 8)])
def test_prefill_then_decode_matches_forward_f32(arch, n_layers):
    """prefill(S - 1) + decode_step(1) == forward(S) in f32, as the JAX
    package's test_decode_matches_full_forward_f32 checks itself: the SSD
    prefill's final state and conv ring continue the sequence."""
    cfg = _f32(arch, n_layers)
    params = init_params(cfg, seed=0, device="cpu")
    B, S = 2, 32
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)))
    full, _, _ = forward(params, cfg, toks)
    _, caches = prefill(params, cfg, toks[:, :S - 1])
    caches = grow_cache(cfg, caches, B, S)
    lg, _ = decode_step(params, cfg, toks[:, S - 1:], caches, S - 1)
    want = full[:, -1:]
    assert (lg - want).abs().max() <= F32_REL * want.abs().max()


@pytest.mark.parametrize("L", [2, 64])
def test_ssd_prefill_matches_stepwise_decode_f32(L):
    """The chunked SSD prefill against the recurrence it summarises, one
    decode step per token from the zero state, over a chunk boundary (64
    tokens, chunk 32) and for a prompt shorter than the conv ring (2 < 3
    tokens, whose ring the port left-pads)."""
    cfg = dataclasses.replace(_f32("mamba2-370m", 2), **WIDTHS)
    params = init_params(cfg, seed=0, device="cpu")
    B = 2
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, L + 1)))
    lg_pf, caches = prefill(params, cfg, toks[:, :L])
    step = init_cache(cfg, B, L + 1, device="cpu")
    outs = []
    for i in range(L + 1):
        lg, step = decode_step(params, cfg, toks[:, i:i + 1], step, i)
        outs.append(lg)
    stepwise = torch.cat(outs, 1)
    scale = stepwise.abs().max()
    assert (lg_pf - stepwise[:, :L]).abs().max() <= F32_REL * scale
    # the prefill's cache continues the sequence: token L decoded from it
    caches = grow_cache(cfg, caches, B, L + 1)
    lg, _ = decode_step(params, cfg, toks[:, L:], caches, L)
    assert (lg - stepwise[:, L:]).abs().max() <= F32_REL * scale
