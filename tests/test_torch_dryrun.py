"""The port's dry run (``repro_torch.launch.dryrun``): a shape pass on the
meta device, held to the JAX package where the two reckon the same thing.

* A small cell on a (1, 1) abstract mesh (the counterpart of
  ``tests/test_sharding.py::test_small_mesh_lowering``): FLOPs > 0, and
  the argument bytes are the whole tree's bytes.
* The 1- and 2-super-block probe, ``cost(1) + (m − 1)·Δ``, equals a direct
  count of a depth-m model, for train, prefill and decode.
* ``ASSIGNED``, ``shape_applicable`` and ``model_flops`` equal the
  reference's for every cell (its ``model_flops`` from its own
  ``ModelConfig.param_counts()``: importing its dry run would set a
  512-device ``XLA_FLAGS`` in this process).
* Per-device param bytes on the (16, 16) mesh equal what the reference's
  own specs give for its own parameter tree, for two full configs.
* ``param_counts()["total"]`` equals the matrix entries of the port's
  own parameter tree for the dense and MoE transformer configs.
* The CLI: ``--all --mesh both`` writes a record per cell with no error,
  the ``seqkv`` variant reckons the seq-sharded decode's all-reduces, and
  ``--pp-demo`` the pipeline's collectives.
* Each ``--variant`` changes its cell's record against baseline's, is
  recorded ``skip`` (with the reason) on a cell it cannot change, and the
  JAX package's presets that change nothing the port reckons are refused.

Tolerances: exact (integer FLOP and byte counts; the same float formula).
"""
import dataclasses
import functools
import json

import jax
import pytest
import torch

import repro.distributed.sharding as ref_sh
from repro.configs import ASSIGNED as REF_ASSIGNED
from repro.configs import get_config as ref_get_config
from repro.configs import shape_applicable as ref_applicable
from repro.models import init_params as ref_init_params
from repro_torch.configs import (ASSIGNED, SHAPE_BY_NAME, SHAPES, all_cells,
                                 get_config, get_smoke_config,
                                 shape_applicable)
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models.decode_attention import reckon_seqshard_decode
from repro_torch.models.inputs import make_batch_structs
from repro_torch.serving.kv_cache import tree_leaves


def _bytes(tree, dtype=None):
    return sum(t.numel() * torch.empty((), dtype=dtype or t.dtype
                                       ).element_size()
               for t in tree_leaves(tree))


def test_small_mesh_flops_and_bytes():
    cfg = get_smoke_config("granite-8b")
    shape = ShapeConfig("t", 64, 2, "train")
    mesh = dryrun.AbstractMesh(("data", "model"), (1, 1))
    args = dryrun.argument_bytes(cfg, shape, mesh, "train")
    params = dryrun.meta_params(cfg)
    assert args["params"] == _bytes(params) > 0
    assert args["opt_moments"] == 2 * _bytes(params, torch.float32)
    assert args["batch"] == _bytes(make_batch_structs(cfg, shape, "train"))
    assert args["total"] == args["params"] + args["opt_moments"] \
        + args["batch"]
    probe = dryrun.probe_flops(cfg, shape, "train")
    assert probe["flops"] > probe["flops_1"] > 0 and probe["n_blocks"] > 1
    assert dryrun.flop_split(shape, mesh) == 1


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["granite-8b", "qwen2-moe-a2.7b",
                                  "deepseek-v2-236b", "jamba-v0.1-52b",
                                  "whisper-small"])
def test_probe_equals_direct_count(arch, kind):
    base = get_smoke_config(arch)
    prefix, period, _ = dryrun.stack_layout(base)
    cfg = dataclasses.replace(base, n_layers=len(prefix) + 3 * period)
    if cfg.encoder_decoder:
        cfg = dataclasses.replace(cfg, n_enc_layers=cfg.n_layers)
    shape = ShapeConfig("t", 32, 2, kind)
    probe = dryrun.probe_flops(cfg, shape, kind)
    assert probe["n_blocks"] == 3
    assert probe["flops"] == dryrun.count_flops(cfg, shape, kind) > 0


def test_registry_and_model_flops_match_reference():
    assert ASSIGNED == REF_ASSIGNED
    assert len(all_cells()) == len(ASSIGNED) * len(SHAPES)
    for arch, shape_name in all_cells():
        cfg, jcfg = get_config(arch), ref_get_config(arch)
        assert shape_applicable(cfg, shape_name) == \
            ref_applicable(jcfg, shape_name)
        shape = SHAPE_BY_NAME[shape_name]
        toks = shape.global_batch * (shape.seq_len
                                     if shape.kind != "decode" else 1)
        want = float(6 if shape.kind == "train" else 2) * \
            jcfg.param_counts()["active"] * toks
        assert dryrun.model_flops(cfg, shape, shape.kind) == want


def _ref_local_bytes(spec_tree, shape_tree, sizes):
    if isinstance(spec_tree, dict):
        return sum(_ref_local_bytes(spec_tree[k], shape_tree[k], sizes)
                   for k in spec_tree)
    if isinstance(spec_tree, list):
        return sum(_ref_local_bytes(a, b, sizes)
                   for a, b in zip(spec_tree, shape_tree))
    return dryrun.local_numel(shape_tree.shape, tuple(spec_tree), sizes) \
        * shape_tree.dtype.itemsize


@pytest.mark.parametrize("arch", ["granite-8b", "deepseek-v2-236b"])
def test_param_bytes_match_reference_specs(arch):
    mesh = dryrun.production_mesh()
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    cfg, jcfg = get_config(arch), ref_get_config(arch)
    shape = SHAPE_BY_NAME["decode_32k"]
    args = dryrun.argument_bytes(cfg, shape, mesh, "decode")
    jtree = jax.eval_shape(functools.partial(ref_init_params, cfg=jcfg),
                           jax.random.PRNGKey(0))
    rspec = ref_sh.param_pspecs(jtree, jcfg, model_size=16,
                                fsdp=args["fsdp"], data_size=16)
    assert args["params"] == _ref_local_bytes(rspec, jtree, sizes) > 0


@pytest.mark.parametrize("arch", ["granite-8b", "deepseek-coder-33b",
                                  "starcoder2-3b", "qwen3-14b",
                                  "qwen2-moe-a2.7b", "deepseek-v2-236b",
                                  "deepseekv2-lite"])
def test_param_counts_are_the_trees_matrices(arch):
    """``param_counts()["total"]`` (which the sharding rules size FSDP
    by, and the train CLI prints) is the number of entries in the
    parameter tree's matrices at every published width, built on the
    meta device; the norm scales come on top."""
    from repro_torch.models.model import build_params
    cfg = get_config(arch)
    tree = build_params(torch.Generator(), cfg, torch.device("meta"))
    assert sum(p.numel() for p in tree_leaves(tree) if p.ndim >= 2) == \
        cfg.param_counts()["total"]


def test_cli_all_cells(tmp_path, capsys):
    with pytest.raises(SystemExit) as ei:
        dryrun.main(["--all", "--mesh", "both", "--out-dir", str(tmp_path)])
    assert ei.value.code == 0
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == 2 * len(all_cells())
    for r in recs:
        ok, _ = shape_applicable(get_config(r["arch"]), r["shape"])
        assert r["status"] == ("ok" if ok else "skip"), r
        if ok:
            assert r["flops_per_device"] > 0 and r["useful_flop_ratio"] > 0
            assert r["collective_bytes_per_device"] is None
            assert r["collective_note"] and r["roofline"]["dominant"]
    assert "dry-run: 64 ok, 16 skip, 0 error" in capsys.readouterr().out


def test_cli_seqkv_and_pp_demo(tmp_path):
    with pytest.raises(SystemExit) as ei:
        dryrun.main(["--arch", "qwen2-moe-a2.7b", "--shape", "decode_32k",
                     "--variant", "seqkv", "--out-dir", str(tmp_path)])
    assert ei.value.code == 0
    rec = json.loads((tmp_path / "qwen2-moe-a2.7b__decode_32k__single__"
                      "seqkv.json").read_text())
    want = reckon_seqshard_decode(get_config("qwen2-moe-a2.7b"), 128 // 16)
    assert rec["collectives"] == want
    assert rec["collective_bytes_per_device"] == \
        want["collective_bytes"]["all-reduce"]
    assert rec["roofline"]["collective_s"] > 0
    with pytest.raises(SystemExit) as ei:
        dryrun.main(["--pp-demo", "--out-dir", str(tmp_path)])
    assert ei.value.code == 0
    rec = json.loads((tmp_path / "granite-8b__pp_microbatch__multi__pp2"
                      ".json").read_text())
    assert rec["status"] == "ok" and rec["stages"] == 2
    assert rec["collectives"]["collective_ops"] == {
        "collective-permute": dryrun.PP_MICRO + 1, "all-reduce": 1}


ARCH = "qwen2-moe-a2.7b"


@pytest.mark.parametrize("variant,shape", [
    ("moegroup2k", "train_4k"), ("moegroup1k", "prefill_32k"),
    ("scatter", "train_4k"), ("seqkv", "decode_32k"),
    ("noremat", "train_4k")])
def test_variant_changes_its_record(tmp_path, variant, shape):
    base = dryrun.run_cell(ARCH, shape, "single", out_dir=tmp_path)
    rec = dryrun.run_cell(ARCH, shape, "single", variant=variant,
                          out_dir=tmp_path)
    assert base["status"] == rec["status"] == "ok", rec
    keys = ("flops_global", "argument_bytes_per_device",
            "collective_bytes_per_device")
    assert any(rec[k] != base[k] for k in keys), (variant, shape)
    assert (tmp_path / f"{ARCH}__{shape}__single__{variant}.json").exists()


@pytest.mark.parametrize("arch,variant,shape", [
    (ARCH, "moegroup2k", "decode_32k"), (ARCH, "seqkv", "train_4k"),
    (ARCH, "noremat", "prefill_32k"), ("granite-8b", "scatter", "train_4k"),
    ("granite-8b", "moegroup1k", "train_4k")])
def test_variant_skips_a_cell_it_cannot_change(tmp_path, arch, variant,
                                               shape):
    rec = dryrun.run_cell(arch, shape, "single", variant=variant,
                          out_dir=tmp_path)
    assert rec["status"] == "skip" and rec["reason"].startswith(variant), rec
    assert "flops_global" not in rec


@pytest.mark.parametrize("variant", ["epconstraint", "eppad64", "seqkv+ep",
                                     "moegroup2k+ep", "bf16scores",
                                     "bf16scores+moegroup1k"])
def test_cli_refuses_variants_the_port_cannot_tell_apart(tmp_path, variant):
    with pytest.raises(SystemExit) as ei:
        dryrun.main(["--arch", ARCH, "--shape", "train_4k", "--variant",
                     variant, "--out-dir", str(tmp_path)])
    assert ei.value.code == 2
    assert not list(tmp_path.glob("*.json"))
