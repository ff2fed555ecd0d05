"""Rank bodies of the port's multi-process tests, run by
``repro_torch.distributed.launch.spawn_ranks`` as ``fn(rank, world,
*args)``.  A separate module that imports torch and the port only, so the
spawned ranks never import JAX; each returns numpy arrays and plain
values."""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as col


def ledger_rank(rank, world):
    """Each ledger wrapper once on known shapes: the results, and this
    rank's ledger summary."""
    ledger = col.CollectiveLedger()
    out = {}
    t = torch.full((4, 8), float(rank + 1))                     # f32
    out["all-reduce"] = col.all_reduce(t, group=None, ledger=ledger).numpy()
    t = torch.full((3, 5), rank, dtype=torch.bfloat16)
    g = torch.empty((3 * world, 5), dtype=torch.bfloat16)
    col.all_gather_into_tensor(g, t, ledger=ledger)
    out["all-gather"] = g.float().numpy()
    t = torch.arange(2 * world * 3, dtype=torch.float64).reshape(2 * world, 3)
    r = torch.empty((2, 3), dtype=torch.float64)
    out["reduce-scatter"] = col.reduce_scatter_tensor(
        r, t, ledger=ledger).numpy()
    t = torch.full((world, 6), rank, dtype=torch.int32)
    a = torch.empty_like(t)
    out["all-to-all"] = col.all_to_all_single(a, t, ledger=ledger).numpy()
    t = torch.full((7,), rank, dtype=torch.int64)
    out["collective-permute"] = col.permute(
        t, torch.empty_like(t), (rank + 1) % world, (rank - 1) % world,
        ledger=ledger).numpy()
    ledger.charge_put(10)
    ledger.charge_failure()
    return out, ledger.summary()


def _bits(t):
    return {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.float16: torch.int16}.get(t.dtype, t.dtype)


def seqshard_rank(rank, world, jobs, mesh_shape, batch_axes):
    """Sequence-sharded decode of each job on a ("data", "model") mesh.
    jobs: [(cfg, params, full caches, [(pos, tokens [B, 1]), ...])].
    Returns per job: the logits of this rank's rows at each step, this
    rank's caches after the steps and its ledger summary."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.decode_attention import seqshard_caches
    from repro_torch.models.model import decode_step
    from repro_torch.serving.kv_cache import map_tree
    mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
    outs = []
    for cfg, params, caches, steps in jobs:
        ledger = col.CollectiveLedger()
        local = seqshard_caches(caches, mesh, batch_axes=batch_axes)
        logits = []
        for pos, tokens in steps:
            lg, local = decode_step(params, cfg, tokens, local, pos,
                                    attn_impl="seqshard", mesh=mesh,
                                    batch_axes=batch_axes, ledger=ledger)
            logits.append(lg.numpy())
        outs.append((logits, map_tree(lambda t: t.numpy(), local),
                     ledger.summary()))
    return outs


def pipeline_rank(rank, world, jobs):
    """Each job (cfg, params, x_micro [M, B, S, d]) through the pipeline
    on 2 stages (ranks 0-1) and on `world` stages: per job and stage
    count, the result's bits and this rank's ledger summary (None on a
    rank outside the 2-stage group)."""
    from repro_torch.distributed.pipeline import (pipeline_forward,
                                                  stage_layers)
    two = dist.new_group([0, 1])
    outs = []
    for cfg, params, x in jobs:
        res = {}
        for n_st, group in ((2, two), (world, None)):
            if rank >= n_st:
                res[n_st] = None
                continue
            ledger = col.CollectiveLedger()
            layers = stage_layers(params["layers"], cfg, rank, n_st)
            y = pipeline_forward(layers, x, cfg, group, ledger=ledger)
            res[n_st] = (y.view(_bits(y)).numpy(), ledger.summary())
        outs.append(res)
    return outs


def _leaf_triples(a, b, s, path=""):
    """(path, whole leaf, restored leaf, sharding) over three trees of the
    same structure (a sharding is a NamedTuple: a leaf here)."""
    if isinstance(a, dict):
        for k in a:
            yield from _leaf_triples(a[k], b[k], s[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y, z) in enumerate(zip(a, b, s)):
            yield from _leaf_triples(x, y, z, f"{path}/{i}")
    else:
        yield path, a, b, s


def remesh_rank(rank, world, ckpt_dir, template, cfg, mesh_shape):
    """Restore the checkpoint in `ckpt_dir` onto a ("data", "model") mesh
    of `mesh_shape`: per leaf path, whether the local block's bits equal
    ``distribute_tensor``'s and whether ``full_tensor()``'s equal the
    whole restored leaf's."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.checkpoint import CheckpointManager
    mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
    mgr = CheckpointManager(ckpt_dir)
    whole, _, _ = mgr.restore(template)
    shardings = param_shardings(template, cfg, mesh)
    tree, _, _ = mgr.restore(template, shardings=shardings)
    report = {}
    for path, a, b, s in _leaf_triples(whole, tree, shardings):
        assert isinstance(b, DTensor), path
        want = distribute_tensor(a, mesh, s.placements).to_local()
        got = b.to_local()
        report[path] = (
            tuple(s.spec), tuple(got.shape),
            torch.equal(got.view(_bits(got)), want.view(_bits(want))),
            torch.equal(b.full_tensor().view(_bits(a)), a.view(_bits(a))))
    return report


def faulty_rank(rank, world, how):
    """Rank 1 fails as `how` says; the others wait at a barrier."""
    import os
    import time
    if rank == 1:
        if how == "raise":
            raise ValueError("rank 1 raised")
        if how == "exit":
            os._exit(3)
        if how == "hang":
            time.sleep(3600)
    dist.barrier()
    return rank


def device_rank(rank, world, ckpt_dir, template, cfg, dev_type):
    """On `dev_type` over gloo (the card: every rank shares it): a permute
    of a bf16 tensor (a CUDA one staged through the host) with its
    ledger, and a restore re-meshed onto a ("model",) mesh of that device
    type (local blocks only: ``full_tensor()`` over gloo crashed on CUDA
    tensors)."""
    from repro_torch.distributed.sharding import param_shardings, shard_local
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.checkpoint import CheckpointManager
    mesh = make_mesh((world,), ("model",), dev_type)
    ledger = col.CollectiveLedger()
    t = torch.full((3, 5), rank + 1, dtype=torch.bfloat16,
                   device=mesh.device_type)
    got = col.permute(t, torch.empty_like(t), (rank + 1) % world,
                      (rank - 1) % world, ledger=ledger)
    mgr = CheckpointManager(ckpt_dir)
    whole, _, _ = mgr.restore(template)
    shardings = param_shardings(template, cfg, mesh)
    tree, _, _ = mgr.restore(template, shardings=shardings)
    blocks_ok = all(
        d.to_local().device.type == dev_type and torch.equal(
            d.to_local().cpu().view(_bits(w)),
            shard_local(w, s.spec, mesh).view(_bits(w)))
        for _, w, d, s in _leaf_triples(whole, tree, shardings))
    return (got.device.type == dev_type, got.float().cpu().numpy(),
            ledger.summary(), blocks_ok)


def card_rank(rank, world, jobs, pipe, dev_type):
    """On `dev_type` over gloo (the card: every rank shares it): each
    seq-sharded decode job on a ("model",) mesh of `world` ranks, then the
    pipeline job on `world` stages.  jobs: [(cfg, params, full caches,
    [(pos, tokens [B, 1]), ...])] and pipe: (cfg, params, x_micro
    [M, B, S, d]), all on the CPU.  Returns per job the logits at each
    step, this rank's ``kv`` cache shards and its ledger summary; the
    pipeline's result bits and ledger summary; and the kernel launches."""
    from repro_torch.distributed.pipeline import (pipeline_forward,
                                                  stage_layers)
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.decode_attention import seqshard_caches
    from repro_torch.models.model import decode_step
    from repro_torch.serving.kv_cache import map_tree
    mesh = make_mesh((world,), ("model",), dev_type)
    dev = torch.device(mesh.device_type)

    def to_dev(tree):
        return map_tree(lambda t: t if t is None else t.to(dev), tree)

    _build.reset_launches()
    out = {"decode": []}
    for cfg, params, caches, steps in jobs:
        params = to_dev(params)
        local = seqshard_caches(to_dev(caches), mesh)
        ledger = col.CollectiveLedger()
        logits = []
        for pos, tokens in steps:
            lg, local = decode_step(params, cfg, tokens.to(dev), local, pos,
                                    attn_impl="seqshard", mesh=mesh,
                                    ledger=ledger)
            logits.append(lg.cpu().numpy())
        out["decode"].append((logits, map_tree(lambda t: t.cpu().numpy(),
                                               [c["kv"] for c in local]),
                              ledger.summary()))
    cfg, params, x = pipe
    ledger = col.CollectiveLedger()
    layers = stage_layers(to_dev(params)["layers"], cfg, rank, world)
    y = pipeline_forward(layers, x.to(dev), cfg, None, ledger=ledger)
    out["pipe"] = (y.view(_bits(y)).cpu().numpy(), ledger.summary())
    dist.barrier()
    out["launches"] = dict(_build.LAUNCHES)
    return out
