"""The port's resident model against the JAX package's, on the same
parameters and the same tokens.  The parameters are drawn with numpy from a
seed into the JAX package's tree (:func:`numpy_params`, shared by the other
``test_torch_*`` files) and handed to the port through ``params_from_jax``:

* router top-k ids of every MoE layer and step identical;
* logits within a bf16 tolerance: both run bf16 weights and activations
  with f32 softmax/norms, but the matmuls add in other orders and round at
  slightly other places (e.g. silu), so each logit may differ by a few bf16
  ulps (2^-8 relative) — held to 2% of the largest |logit| at worst and
  0.5% on average.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as ref_moe
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import decode_step as ref_decode_step
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import decode_step, init_cache
from repro_torch.models.moe import route

MAX_REL, MEAN_REL = 0.02, 0.005
# the 1-D leaves, each the constant the JAX init gives it: norm scales
# and Mamba2's D and gate norm ones; LayerNorm's bias, Mamba2's dt bias,
# A_log (A = -1) and conv bias zeros
_CONST = {"scale": 1.0, "q_norm": 1.0, "k_norm": 1.0, "kv_norm": 1.0,
          "D": 1.0, "gate_norm": 1.0,
          "bias": 0.0, "dt_bias": 0.0, "A_log": 0.0, "conv_b": 0.0}
# embed, learned positions and lm head as the JAX init; the router 10x
# the JAX init, so the top-k margins sit far above bf16 noise and a test
# compares arithmetic, not the luck of near-ties (at 0.02 the 8 smoke
# experts' probabilities are all close to 1/8 and the two packages'
# last-ulp differences can swap two of them); Mamba2's depthwise conv as
# the JAX init
_STD = {"tok": 0.02, "pos": 0.02, "w": 0.02, "router": 0.2, "conv_w": 0.2}


def numpy_params(jcfg, seed: int = 0):
    """The JAX package's parameter tree for `jcfg` (its shapes and dtypes,
    from ``jax.eval_shape`` of its ``init_params``), every leaf drawn from
    ``numpy.random.default_rng(seed)`` with the JAX init's scale (a 1-D
    leaf with the JAX init's constant)."""
    shapes = jax.eval_shape(functools.partial(ref_init_params, cfg=jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in _CONST:
            a = np.full(s.shape, _CONST[name], np.float32)
        else:
            std = _STD.get(name, (2.0 / (s.shape[-2] + s.shape[-1])) ** 0.5)
            a = rng.standard_normal(s.shape).astype(np.float32) * std
        return jnp.asarray(a, s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def both_params(n_layers: int = 2, seed: int = 0,
                arch: str = "qwen2-moe-a2.7b", **overrides):
    """(JAX config, JAX params, port config, port params) of `arch`'s smoke
    config (qwen2-moe-a2.7b by default), the same numbers in both packages.
    `overrides` replace smoke widths (e.g. MLA's ``qk_nope_dim``)."""
    jcfg = ref_smoke_config(arch, n_layers=n_layers, **overrides)
    cfg = get_smoke_config(arch, n_layers=n_layers, **overrides)
    jparams = numpy_params(jcfg, seed)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, jparams, cfg, params


def serve_greedy(zs, vocab: int, steps: int, feed=None, replan_at=None,
                 B: int = 2, S: int = 12, seed: int = 0):
    """Decode `steps` tokens through a ZipServer of either package from a
    numpy-seeded prompt.  Step i's input is the previous greedy token, or
    ``feed[:, i - 1]`` when a [B, steps] token array is given (teacher
    forcing); ``replan_at`` forces a planner re-plan before that step.
    Returns (logits [steps, B, 1, V] f32, greedy tokens [B, steps])."""
    is_port = type(zs).__module__.startswith("repro_torch.")
    caches = zs.init_cache(B, S + steps)
    tok = np.random.default_rng(seed).integers(0, vocab, (B, 1))
    logits, toks = [], []
    for i in range(steps):
        if i == replan_at:
            zs.engine.replan(reason="forced")
        if feed is not None and i:
            tok = feed[:, i - 1:i]
        inp = torch.from_numpy(tok) if is_port else jnp.asarray(tok,
                                                                jnp.int32)
        lg, caches = zs.decode_step(inp, caches, S - 1 + i)
        lg = lg.float().numpy() if is_port else np.asarray(lg, np.float32)
        tok = np.argmax(lg[:, -1], -1)[:, None]
        logits.append(lg)
        toks.append(tok)
    return np.stack(logits), np.concatenate(toks, 1)


def assert_greedy_agrees(got, got_tok, want):
    """The port's greedy tokens against the JAX package's on the same
    inputs (teacher forcing): logits within MAX_REL of the largest
    |logit|, and the same argmax wherever the reference's top-2 gap is more
    than twice the two packages' largest difference on that row — a gap
    inside it is a bf16 near-tie the two add orders may break either way
    (see the module docstring).  At least half of the (step, row) pairs
    must be decided."""
    diff = np.abs(got - want)
    assert diff.max() <= MAX_REL * np.abs(want).max(), diff.max()
    decided = 0
    for i in range(want.shape[0]):
        for b in range(want.shape[1]):
            top = np.sort(want[i, b, -1])[::-1]
            if top[0] - top[1] > 2 * diff[i, b].max():
                decided += 1
                assert got_tok[b, i] == np.argmax(want[i, b, -1]), (i, b)
    assert 2 * decided >= want.shape[0] * want.shape[1], decided


@pytest.fixture(scope="module")
def models():
    return both_params()


def test_params_convert_bitexact(models):
    jcfg, jparams, cfg, params = models
    stack = jparams["decoder"]["stack"]["sub_0"]
    for l in range(cfg.n_layers):
        for name in ("w_gate", "w_up", "w_down"):
            want = np.asarray(stack["ffn"][name][l]).view(np.uint16)
            got = params["layers"][l]["ffn"][name].view(torch.int16).numpy()
            assert np.array_equal(got.view(np.uint16), want)
    assert torch.equal(params["embed"]["tok"].float(), torch.from_numpy(
        np.asarray(jparams["embed"]["tok"], np.float32)))


def test_route_matches_reference(models):
    jcfg, jparams, cfg, params = models
    x = np.random.default_rng(0).standard_normal((4, 1, cfg.d_model)
                                                 ).astype(np.float32)
    rw = jparams["decoder"]["stack"]["sub_0"]["ffn"]["router"][0]
    jp, ji, jprobs = ref_moe.route(rw, jnp.asarray(x, jnp.bfloat16), jcfg)
    tp, ti, tprobs = route(params["layers"][0]["ffn"]["router"],
                           torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                               rtol=1e-5, atol=1e-7)


def test_decode_step_matches_reference(models, monkeypatch):
    jcfg, jparams, cfg, params = models
    B, steps = 2, 3
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (steps, B, 1))
    seen = []
    orig = ref_moe.route

    def recording_route(router_w, x, c):
        out = orig(router_w, x, c)
        seen.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(ref_moe, "route", recording_route)
    jcache = ref_init_cache(jcfg, B, steps)
    tcache = init_cache(cfg, B, steps, device="cpu")
    for i in range(steps):
        jl, jcache = ref_decode_step(
            jparams, jcfg, {"tokens": jnp.asarray(toks[i], jnp.int32)},
            jcache, jnp.int32(i), unroll=True)
        ids = []
        tl, tcache = decode_step(params, cfg, torch.from_numpy(toks[i]),
                                 tcache, i, router_ids=ids)
        want = np.asarray(jl, np.float32)
        got = tl.float().numpy()
        assert got.shape == want.shape == (B, 1, cfg.vocab_size)
        diff = np.abs(got - want)
        scale = np.abs(want).max()
        assert diff.max() <= MAX_REL * scale, (i, diff.max(), scale)
        assert diff.mean() <= MEAN_REL * scale, (i, diff.mean(), scale)
        assert len(ids) == len(seen) == cfg.n_layers
        for t_ids, j_ids in zip(ids, seen):
            assert np.array_equal(t_ids.numpy(), j_ids), i
        seen.clear()


def test_numpy_params_draws_1d_leaves():
    """The shared parameter helper draws every 1-D leaf with the JAX
    init's constant: LayerNorm's bias (starcoder2-3b) and the Mamba2
    leaves (jamba's), and Mamba2's conv with the init's 0.2 scale."""
    tree = numpy_params(ref_smoke_config("starcoder2-3b", n_layers=1))
    norm = tree["decoder"]["stack"]["sub_0"]["norm1"]
    assert (np.asarray(norm["bias"]) == 0).all()
    assert (np.asarray(norm["scale"]) == 1).all()
    tree = numpy_params(ref_smoke_config("jamba-v0.1-52b"))
    m = tree["decoder"]["stack"]["sub_0"]["mamba"]
    for name, value in (("dt_bias", 0), ("A_log", 0), ("D", 1),
                        ("gate_norm", 1), ("conv_b", 0)):
        assert m[name].ndim == 2, name            # [m, n]: 1-D per layer
        assert (np.asarray(m[name], np.float32) == value).all(), name
    assert m["A_log"].dtype == jnp.float32
    std = float(np.asarray(m["conv_w"], np.float32).std())
    assert 0.18 < std < 0.22, std
