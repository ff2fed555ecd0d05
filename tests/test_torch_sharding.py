"""The port's sharding rules and collective ledger against the JAX
package's (``repro.distributed.{sharding,collectives}``).

* Parameter specs at every registered architecture's full widths (the
  port's tree built on the meta device, the reference's from
  ``jax.eval_shape``), model axis 1/2/4/16, FSDP on and off: the port's
  spec of a layer's leaf is the reference's with the stacked leading dim
  dropped — except where the reference shards that layer dim itself (a
  stacked shared expert, see ``test_reference_shards_shared_expert_layer_
  axis``); there the port gives the reference's rule at the per-layer
  shape.
* Batch and cache specs on (data, model) and (pod, data, model) meshes,
  with and without ``seq_shard``; ``needs_fsdp``; ``ep_owner`` and
  ``ep_partition``.
* The ledger's kinds, bytes and op counts over a 2-rank ``gloo`` group,
  and its summary against the reference ledger given the same charges.
"""
import dataclasses
import functools
from types import SimpleNamespace
from typing import Any, NamedTuple

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.distributed.sharding as ref_sh
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.registry import _ARCH_MODULES
from repro.distributed.collectives import CollectiveLedger as RefLedger
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models.inputs import batch_spec as ref_batch_spec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.launch import spawn_ranks
from repro_torch.models.inputs import batch_spec
from repro_torch.models.model import (build_params, init_layer_cache,
                                      stack_layout)

import _torch_ranks

# every registered architecture once (qwen1.5-moe-a2.7b is qwen2-moe's
# alias)
ARCHS = sorted(a for a in _ARCH_MODULES if a != "qwen1.5-moe-a2.7b")
META = torch.device("meta")


def norm(spec, ndim):
    """A spec (the reference's PartitionSpec or the port's Spec) as a tuple
    of `ndim` entries: None, an axis name, or a tuple of names."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple):
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    return tuple(out + [None] * (ndim - len(out)))


@functools.lru_cache(maxsize=None)
def ref_shapes(arch):
    cfg = ref_get_config(arch)
    return cfg, jax.eval_shape(functools.partial(ref_init_params, cfg=cfg),
                               jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def port_shapes(arch):
    cfg = get_config(arch)
    return cfg, build_params(torch.Generator(), cfg, META)


def ref_layers(tree, cfg):
    """The reference's stacked decoder tree as a per-layer list of
    (subtree, stacked?) — the port's layer order."""
    prefix, period, m = stack_layout(cfg)
    out = [(p, False) for p in tree["prefix"]]
    for _ in range(m):
        out += [(tree["stack"][f"sub_{j}"], True) for j in range(period)]
    return out


def compare(ref_spec, ref_shape, port_spec, path, stacked, rule):
    """Hold one leaf's port spec to the reference's; returns whether the
    reference sharded the stacked layer dim."""
    if ref_spec is None:
        assert port_spec is None, path
        return False
    ndim = len(ref_shape) - stacked
    got = norm(port_spec, ndim)
    want = norm(ref_spec, len(ref_shape))
    if stacked and want[0] is not None:
        # the reference split the LAYER axis: a stacked shared expert only
        assert path[-2:-1] == ("shared",), (path, want)
        assert path[-1] in ("w_gate", "w_up", "w_down"), path
        assert got == norm(rule(path[-1], ref_shape[1:]), ndim), (path, got)
        return True
    assert got == want[stacked:], (path, got, want)
    return False


class Leaf(NamedTuple):
    spec: Any
    shape: tuple


def zipped(spec_tree, shape_tree):
    """The reference's spec and shape trees as one tree of :class:`Leaf`."""
    if isinstance(spec_tree, dict):
        return {k: zipped(spec_tree[k], shape_tree[k]) for k in spec_tree}
    if isinstance(spec_tree, list):
        return [zipped(a, b) for a, b in zip(spec_tree, shape_tree)]
    return Leaf(spec_tree, tuple(shape_tree.shape))


def walk_pair(ref, port, path, stacked, rule, hits):
    if isinstance(ref, dict):
        assert set(ref) == set(port), (path, set(ref) ^ set(port))
        for k in ref:
            walk_pair(ref[k], port[k], path + (k,), stacked, rule, hits)
    else:
        hits.append(compare(ref.spec, ref.shape, port, path, stacked, rule))


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("model_size", [1, 2, 4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, model_size, fsdp):
    jcfg, jtree = ref_shapes(arch)
    cfg, tree = port_shapes(arch)
    kw = dict(model_size=model_size, fsdp=fsdp, data_size=16 if fsdp else 1)
    rspec = ref_sh.param_pspecs(jtree, jcfg, **kw)
    pspec = sh.param_pspecs(tree, cfg, **kw)
    ep = (jcfg.moe_mode != "tp") and jcfg.is_moe \
        and jcfg.n_experts % model_size == 0

    def rule(name, shape):        # the reference's rule, per-layer shape
        return ref_sh._leaf_spec(name, shape, in_moe=True, ep_ok=ep,
                                 model="model", size=model_size, cfg=jcfg,
                                 fsdp=fsdp, dsize=kw["data_size"])

    hits = []
    for key in ("embed", "final_norm", "lm_head", "enc_norm"):
        assert (key in jtree) == (key in tree), key
        if key in jtree:
            walk_pair(zipped(rspec[key], jtree[key]), pspec[key], (key,),
                      False, rule, hits)
    for stack, ours, c in (("decoder", "layers", jcfg),
                           ("encoder", "encoder", jcfg)):
        if stack not in jtree:
            assert ours not in tree
            continue
        if stack == "encoder":
            c = dataclasses.replace(
                jcfg, n_layers=jcfg.n_enc_layers, first_dense=0,
                n_experts=0, top_k=0, n_shared_experts=0)
        layers = ref_layers(zipped(rspec[stack], jtree[stack]), c)
        assert len(layers) == len(pspec[ours])
        for i, ((rl, stacked), pl) in enumerate(zip(layers, pspec[ours])):
            walk_pair(rl, pl, (ours, i), stacked, rule, hits)
    assert hits and len(hits) == sum(1 for _ in _leaves(pspec))
    # the layer-axis split happens exactly where the stack depth and the
    # expert count both divide the model axis and EP is on
    _, _, m = stack_layout(jcfg)
    expect = ep and jcfg.n_shared_experts > 0 and m % model_size == 0
    assert any(hits) == expect, (arch, model_size)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_reference_shards_shared_expert_layer_axis():
    """The reference's MoE rule takes any rank->=3 w_gate/w_up/w_down in a
    MoE FFN for an expert stack: qwen2-moe's smoke config (4 stacked
    layers, 8 experts) at model axis 2 shards its shared expert's LAYER
    axis.  The port's shared expert is [d, f] and takes the Megatron split
    (f over model; w_down's input dim)."""
    jcfg = ref_smoke_config("qwen2-moe-a2.7b")
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    assert jcfg.n_layers == 4 and jcfg.n_experts == 8
    jtree = jax.eval_shape(functools.partial(ref_init_params, cfg=jcfg),
                           jax.random.PRNGKey(0))
    rspec = ref_sh.param_pspecs(jtree, jcfg, model_size=2)
    shared = rspec["decoder"]["stack"]["sub_0"]["ffn"]["shared"]
    for name in ("w_gate", "w_up", "w_down"):
        assert norm(shared[name], 3) == ("model", None, None), shared[name]
    pspec = sh.param_pspecs(build_params(torch.Generator(), cfg, META), cfg,
                            model_size=2)
    for layer in pspec["layers"]:
        ps = layer["ffn"]["shared"]
        assert ps["w_gate"] == ps["w_up"] == sh.Spec(None, "model")
        assert ps["w_down"] == sh.Spec("model", None)
        # the routed experts stay split over E
        assert layer["ffn"]["w_up"] == sh.Spec("model", None, None)


MESHES = {"dm": ((2, 4), ("data", "model")),
          "pdm": ((2, 2, 2), ("pod", "data", "model")),
          "m": ((4,), ("model",))}


def meshes(key):
    shape, axes = MESHES[key]
    return (AbstractMesh(shape, axes),
            SimpleNamespace(mesh_dim_names=axes, shape=shape))


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(arch, mesh_key):
    jmesh, mesh = meshes(mesh_key)
    jcfg, cfg = ref_get_config(arch), get_config(arch)
    for shape in SHAPES + (ShapeConfig("odd", 64, 3, "decode"),):
        for kind in ("train", "prefill", "decode"):
            rb = ref_sh.batch_pspecs(ref_batch_spec(jcfg, shape, kind),
                                     jmesh)
            pb = sh.batch_pspecs(batch_spec(cfg, shape, kind), mesh)
            assert set(rb) == set(pb)
            for k in rb:
                n = len(batch_spec(cfg, shape, kind)[k][0])
                assert norm(pb[k], n) == norm(rb[k], n), (kind, k)
    B, T = 4, 64
    jc = jax.eval_shape(lambda: ref_init_cache(jcfg, B, T))
    caches = [init_layer_cache(cfg, i, B, T, META)
              for i in range(cfg.n_layers)]
    for seq in (False, True):
        rs = ref_sh.cache_pspecs(jc, jmesh, jcfg, seq_shard=seq)
        ps = sh.cache_pspecs(caches, mesh, cfg, seq_shard=seq)
        rl = [(layer, False) for layer in rs["prefix"]]
        sl = [(layer, False) for layer in jc["prefix"]]
        if rs["stack"] is not None:
            _, period, m = stack_layout(jcfg)
            for _ in range(m):
                rl += [(rs["stack"][f"sub_{j}"], True)
                       for j in range(period)]
                sl += [(jc["stack"][f"sub_{j}"], True)
                       for j in range(period)]
        assert len(rl) == len(ps)
        for i, ((r, stacked), (shapes, _), p) in enumerate(zip(rl, sl, ps)):
            _cmp_cache(r, shapes, p, stacked, (i, seq))


def _cmp_cache(r, shapes, p, stacked, where):
    if isinstance(r, dict):
        assert set(r) == set(p), where
        for k in r:
            _cmp_cache(r[k], shapes[k], p[k], stacked, where + (k,))
        return
    n = len(shapes.shape)
    want = norm(r.spec, n)
    if stacked:
        assert want[0] is None, where
        want = want[1:]
    assert norm(p, n - stacked) == want, (where, p, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_needs_fsdp_matches_reference(arch):
    jcfg, cfg = ref_get_config(arch), get_config(arch)
    for size in (1, 2, 4, 16, 256):
        for train in (False, True):
            for budget in (1e9, 12e9, 80e9):
                assert sh.needs_fsdp(cfg, size, train=train,
                                     hbm_budget=budget) == \
                    ref_sh.needs_fsdp(jcfg, size, train=train,
                                      hbm_budget=budget)


@pytest.mark.parametrize("n_experts", [8, 16, 60, 64, 128, 160])
def test_ep_owner_and_partition_match_reference(n_experts):
    for n in (1, 2, 4, 8):
        assert sh.ep_ok(n_experts, n) == ref_sh.ep_ok(n_experts, n)
        if not ref_sh.ep_ok(n_experts, n):
            with pytest.raises(AssertionError):
                ref_sh.ep_partition(n_experts, n)
            with pytest.raises(ValueError):
                sh.ep_partition(n_experts, n)
            with pytest.raises(ValueError):
                sh.ep_owner(0, n_experts, n)
            continue
        assert sh.ep_partition(n_experts, n) == \
            ref_sh.ep_partition(n_experts, n)
        owners = [sh.ep_owner(e, n_experts, n) for e in range(n_experts)]
        assert owners == [ref_sh.ep_owner(e, n_experts, n)
                          for e in range(n_experts)]
        for d, rng in enumerate(sh.ep_partition(n_experts, n)):
            assert all(owners[e] == d for e in rng)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                           shape=(2, 2, 2))
    assert sh.placements(sh.Spec(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert sh.placements(sh.Spec(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sh.placements(sh.Spec(("data", "pod")), mesh)
    import pickle
    spec = sh.Spec(None, ("pod", "data"), "model")
    assert pickle.loads(pickle.dumps(spec)) == spec


def test_ledger_over_two_ranks(tmp_path):
    """Each wrapper once on each of 2 gloo ranks: the results, and each
    rank's ledger — one op per call, the operand's bytes under the
    reference's kind names, and the reference ledger's summary given the
    same charges."""
    world = 2
    res = spawn_ranks(_torch_ranks.ledger_rank, world, timeout_s=120,
                      store_dir=str(tmp_path))
    nbytes = {"all-reduce": 4 * 8 * 4, "all-gather": 3 * 5 * 2,
              "reduce-scatter": 2 * world * 3 * 8, "all-to-all": world * 6 * 4,
              "collective-permute": 7 * 8}
    for rank, (out, summary) in enumerate(res):
        np.testing.assert_array_equal(out["all-reduce"], np.full((4, 8), 3.0))
        np.testing.assert_array_equal(
            out["all-gather"], np.repeat(np.arange(world), 3)[:, None]
            * np.ones((1, 5)))
        full = np.arange(2 * world * 3, dtype=np.float64).reshape(
            2 * world, 3) * world
        np.testing.assert_array_equal(out["reduce-scatter"],
                                      full[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(
            out["all-to-all"], np.arange(world)[:, None] * np.ones((1, 6)))
        np.testing.assert_array_equal(out["collective-permute"],
                                      np.full(7, (rank - 1) % world))
        ref = RefLedger()
        for kind, b in nbytes.items():
            ref.charge({kind: b, "total": b})
        ref.charge_put(10)
        ref.charge_failure()
        assert summary == ref.summary()
        assert summary["collective_bytes"] == nbytes
        assert summary["collective_ops"] == {k: 1 for k in nbytes}
