"""The dense GQA family in the port (granite-8b, deepseek-coder-33b,
starcoder2-3b, qwen3-14b at their smoke widths, 2 layers), against the JAX
package, and the registry's reach (every architecture the JAX package
registers).

Between them the four configs exercise qk-norm (qwen3-14b), LayerNorm with
a bias and the GELU MLP (starcoder2-3b, 2 KV heads) and the SwiGLU MLP at
three RoPE thetas.  Parameters are drawn with numpy from a seed
(``test_torch_models.numpy_params``: norm scales ones, LayerNorm biases
zeros, as the JAX init) and cross into the port through
``params_from_jax``; the tokens are numpy-seeded too.

Tolerance: bf16 weights and activations with f32 norms and softmax in
both packages, the matmuls adding in other orders, so each logit may
differ by a few bf16 ulps: within ``MAX_REL`` (2%) of the largest |logit|
at worst and ``MEAN_REL`` (0.5%) on average, as for the MoE families.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.registry import _ARCH_MODULES as REF_ARCH_MODULES
from repro.models import decode_step as ref_decode_step
from repro.models.model import prefill as ref_prefill
from repro.serving.kv_cache import grow_cache as ref_grow_cache
from repro_torch.configs import ModelConfig, get_config
from repro_torch.configs.registry import _ARCH_MODULES
from repro_torch.models import decode_step, prefill
from repro_torch.models.model import check_supported
from repro_torch.serving.kv_cache import grow_cache
from test_torch_models import MAX_REL, MEAN_REL, both_params

DENSE = ["granite-8b", "deepseek-coder-33b", "starcoder2-3b", "qwen3-14b"]


@pytest.mark.parametrize("arch", DENSE)
def test_dense_matches_reference(arch):
    """``prefill`` of a 6-token prompt, then 3 ``decode_step``s fed the
    port's greedy tokens, in both packages: logits within the tolerance at
    every step."""
    jcfg, jparams, cfg, params = both_params(n_layers=2, arch=arch)
    assert cfg.family == "dense" and not cfg.is_moe
    if arch == "starcoder2-3b":
        assert "bias" in params["layers"][0]["norm1"]
        assert "w_gate" not in params["layers"][0]["ffn"]
    if arch == "qwen3-14b":
        assert "q_norm" in params["layers"][0]["attn"]
    B, S, N = 2, 6, 3
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    lg, caches = prefill(params, cfg, torch.from_numpy(prompt))
    caches = grow_cache(cfg, caches, B, S + N)
    jl, jc = ref_prefill(jparams, jcfg,
                         {"tokens": jnp.asarray(prompt, jnp.int32)},
                         unroll=True)
    jc = ref_grow_cache(jcfg, jc, B, S + N)
    for i in range(N + 1):
        got = lg[:, -1].float().numpy()
        want = np.asarray(jl[:, -1], np.float32)
        diff = np.abs(got - want)
        scale = np.abs(want).max()
        assert np.isfinite(got).all()
        assert diff.max() <= MAX_REL * scale, (i, diff.max(), scale)
        assert diff.mean() <= MEAN_REL * scale, (i, diff.mean(), scale)
        if i == N:
            break
        tok = np.argmax(got, -1)[:, None]
        lg, caches = decode_step(params, cfg, torch.from_numpy(tok), caches,
                                 S + i)
        jl, jc = ref_decode_step(jparams, jcfg,
                                 {"tokens": jnp.asarray(tok, jnp.int32)}, jc,
                                 jnp.int32(S + i), unroll=True)


def _port_config(arch):
    """The JAX package's config of `arch` as the port's dataclass."""
    return ModelConfig(**dataclasses.asdict(ref_get_config(arch)))


@pytest.mark.parametrize("arch", sorted(set(_ARCH_MODULES)
                                       & set(REF_ARCH_MODULES)))
def test_registry_config_served(arch):
    """Every architecture both packages register, at its published widths,
    passes ``check_supported``, with the JAX package's fields (the port's
    own, kanana-2-30b-a3b, is held to its published file in
    test_torch_sigmoid_router.py)."""
    cfg = get_config(arch)
    check_supported(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(_port_config(arch))

