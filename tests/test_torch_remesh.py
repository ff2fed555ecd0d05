"""Re-mesh on restore: ``CheckpointManager.restore(shardings=)``, the JAX
package's ``restore(shardings=)``.  A checkpoint written from one process
with no mesh is restored onto a 2-rank ("data", "model") = (1, 2) mesh and
a (1, 1) mesh of ``gloo`` ranks on the CPU, with ``param_shardings``'
specs (qwen2-moe-a2.7b's smoke config: experts split over E, the shared
expert's and the attention's Megatron splits, the vocab split, replicated
norms).  On every rank, for every leaf: a ``DTensor`` whose local block is
bit-equal to ``distribute_tensor``'s block of the saved leaf, and whose
``full_tensor()`` is bit-equal to the saved leaf."""
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.launch import spawn_ranks
from repro_torch.models import init_params
from repro_torch.training.checkpoint import CheckpointManager

import _torch_ranks


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = get_smoke_config("qwen2-moe-a2.7b", n_layers=2)
    params = init_params(cfg, seed=3, device="cpu")
    d = str(tmp_path_factory.mktemp("ckpt"))
    CheckpointManager(d).save(5, params)
    return cfg, params, d


@pytest.mark.parametrize("mesh_shape", [(1, 2), (1, 1)])
def test_restore_remeshes(ckpt, mesh_shape, tmp_path):
    cfg, params, d = ckpt
    world = mesh_shape[0] * mesh_shape[1]
    reports = spawn_ranks(_torch_ranks.remesh_rank, world, timeout_s=180,
                          args=(d, params, cfg, mesh_shape),
                          store_dir=str(tmp_path))
    for rank, report in enumerate(reports):
        assert report, rank
        for path, (spec, shape, block_ok, full_ok) in report.items():
            assert block_ok and full_ok, (rank, path, spec)
    split = {p: (s, sh) for p, (s, sh, _, _) in reports[0].items()
             if any(e is not None for e in s)}
    if world == 1:
        return
    # the model axis splits what the rules say, into halves
    assert split["/embed/tok"] == (("model", None), (cfg.vocab_size // 2,
                                                     cfg.d_model))
    assert split["/layers/0/ffn/w_up"][0] == ("model", None, None)
    assert split["/layers/1/ffn/shared/w_down"][0] == ("model", None)
    assert "/layers/0/norm1/scale" not in split
