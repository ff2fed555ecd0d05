"""The GPipe pipeline (``distributed/pipeline.py``) on ``gloo`` ranks on
the CPU, against the JAX package's ``apply_stack`` and the port's own
sequential pass.

granite-8b and qwen2-moe-a2.7b smoke configs (4 stacked super-blocks) in
f32, numpy-seeded parameters, M = 4 micro-batches of [2, 32]; 2 stages
(ranks 0-1 of 4) and 4 stages:

* every rank's result within 1e-5 of the largest |activation| of the
  reference's ``apply_stack`` run on each micro-batch (the reference
  test's limit);
* bit-identical to the port's sequential pass over the whole stack on
  each micro-batch (``models.model._superblock``): each stage runs the
  same ops on the same shapes, and the result crosses the final
  all-reduce unchanged;
* each rank's ledger: M + P − 1 collective permutes of one micro-batch's
  activation and one all-reduce of the result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.transformer import apply_stack as ref_apply_stack
from repro_torch.distributed.launch import spawn_ranks
from repro_torch.models.model import _superblock, stack_layout

import _torch_ranks
from test_torch_models import both_params

ARCHS = ["granite-8b", "qwen2-moe-a2.7b"]
WORLD = 4
M, B_MB, S = 4, 2, 32
REL = 1e-5


def case(arch):
    n = ref_smoke_config(arch).n_layers
    jcfg, jparams, cfg, params = both_params(n_layers=n, arch=arch,
                                             dtype="float32")
    x = (np.random.default_rng(0).standard_normal((M, B_MB, S, cfg.d_model))
         * 0.1).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B_MB, S))
    ref = np.stack([np.asarray(ref_apply_stack(
        jparams["decoder"], jnp.asarray(xm), jcfg, mode="full",
        positions=pos)[0]) for xm in x])
    xt = torch.from_numpy(x)
    positions = torch.arange(S, dtype=torch.int32)[None].expand(B_MB, S)
    aux = torch.zeros(())
    seq = torch.stack([_superblock(params["layers"], xm, aux, cfg, positions,
                                   None, None, "einsum")[0] for xm in xt])
    return cfg, params, xt, ref, seq


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = [case(arch) for arch in ARCHS]
    outs = spawn_ranks(_torch_ranks.pipeline_rank, WORLD, timeout_s=300,
                       args=([(cfg, params, x)
                              for cfg, params, x, _, _ in cases],),
                       store_dir=str(tmp_path_factory.mktemp("store")))
    return cases, outs


@pytest.mark.parametrize("n_st", [2, WORLD])
@pytest.mark.parametrize("a", range(len(ARCHS)), ids=ARCHS)
def test_pipeline_matches_reference_and_sequential(runs, a, n_st):
    cases, outs = runs
    cfg, _, x, ref, seq = cases[a]
    _, _, m = stack_layout(cfg)
    assert cfg.first_dense == 0 and m % n_st == 0
    seq_bits = seq.view(torch.int32).numpy()
    act = B_MB * S * cfg.d_model * 4
    for r in range(WORLD):
        res = outs[r][a][n_st]
        if r >= n_st:
            assert res is None
            continue
        bits, summary = res
        got = bits.view(np.float32)
        assert got.shape == ref.shape
        assert float(np.abs(got - ref).max() / np.abs(ref).max()) <= REL
        assert np.array_equal(bits, seq_bits), (ARCHS[a], n_st, r)
        assert summary["collective_ops"] == {"collective-permute":
                                             M + n_st - 1, "all-reduce": 1}
        assert summary["collective_bytes"] == {
            "collective-permute": (M + n_st - 1) * act,
            "all-reduce": M * act}


def test_pipeline_refuses_uneven_stages():
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.pipeline import stage_layers
    cfg = get_smoke_config("granite-8b", n_layers=3)
    with pytest.raises(ValueError, match="not divisible"):
        stage_layers([{}] * 3, cfg, 0, 2)
