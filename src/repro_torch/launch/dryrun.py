"""Dry run: a shape pass of every (arch × shape × mesh) cell on the meta
device, the counterpart of the JAX package's ``launch/dryrun.py``.

The JAX package lowers and compiles each cell with production shardings
onto 512 placeholder host devices and reads XLA's memory and cost
analyses.  The port has no compiler pass to ask, so it runs the cell's
step function on ``meta`` tensors (shapes and dtypes, no storage) and
reckons the rest from the sharding specs.  It touches no card, starts no
process group, and needs no ``XLA_FLAGS``: the mesh is an abstract one,
axis names and sizes only (``(16, 16)`` ("data", "model") single-pod,
``(2, 16, 16)`` ("pod", "data", "model") multi-pod).  For each cell it
records

* the status: ``skip`` with the reason where
  ``configs.registry.shape_applicable`` refuses the cell or the
  ``--variant`` changes nothing in it (``variant_applicable``), else
  ``ok``, or ``error`` with the traceback;
* ``model_bytes``: the whole model's parameter bytes, unsharded;
* per-device argument bytes: params (bf16; AdamW's two f32 moments beside
  them for train), the KV/SSM cache for decode, and the batch, each leaf
  cut by its spec (``distributed.sharding.param_pspecs`` with the FSDP
  rule of ``needs_fsdp``, ``batch_pspecs``, ``cache_pspecs``);
* the matmul and attention FLOPs that ``torch.utils.flop_counter`` counts
  over ``train_loss`` + its backward, ``prefill`` or ``decode_step``.  The
  model is run at 1 and 2 super-blocks of its stack (``stack_layout``),
  and ``total = cost(1) + (m − 1)·Δ``, the JAX package's probe.  Per
  device is the total over the devices that split it: all of them when
  the batch splits over the data axes, else the ``model`` axis only (the
  batch replicated, as XLA would run it);
* ``model_flops`` (6·N_active·D for train, 2·N_active·D otherwise) and
  the useful-FLOP ratio against the counted FLOPs;
* the roofline terms at one H100 SXM's rates (``launch/mesh.py``):
  compute = FLOPs / 989 TFLOP/s, memory = argument bytes / 3.35 TB/s (each
  argument read once: a lower bound where XLA reported bytes accessed),
  collective = collective bytes / 900 GB/s NVLink.

What it does not reckon: the collectives XLA's partitioner inserts into
the JAX package's train and prefill cells have no counterpart in the
port, so ``collective_bytes_per_device`` is null there, with the reason.
The ``seqkv`` decode variant reckons its all-reduces as the seq-sharded
decode charges them (``models.decode_attention.reckon_seqshard_decode``),
and ``--pp-demo`` its permutes and all-reduce as the pipeline does
(``distributed.pipeline.reckon_pipeline``).  Of the JAX package's
``--variant`` presets the port keeps those that change what it reckons
(``VARIANTS``).

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]

Each cell writes ``<out-dir>/<arch>__<shape>__<mesh>[__<variant>].json``
(``build/dryrun/`` of the checkout by default).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (SHAPE_BY_NAME, all_cells, get_config,
                                 shape_applicable)
from repro_torch.distributed.pipeline import reckon_pipeline
from repro_torch.distributed.sharding import (axis_sizes, batch_pspecs,
                                              cache_pspecs, data_axes,
                                              needs_fsdp, param_pspecs)
from repro_torch.launch.mesh import (CHIPS, HBM_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16)
from repro_torch.models.decode_attention import reckon_seqshard_decode
from repro_torch.models.inputs import (batch_spec, cache_structs,
                                       make_batch_structs)
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import (_superblock, build_params, decode_step,
                                      prefill, stack_layout, train_loss)
from repro_torch.serving.kv_cache import tree_leaves

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
META = torch.device("meta")
NO_COLLECTIVES = ("the port runs this cell's step on one device: the "
                  "collectives XLA's partitioner inserts for its "
                  "shardings have no counterpart to reckon")

# the perf-variant presets of the JAX package's dry run that change what
# the port reckons.  Its EP-constraint and EP-padding presets set config
# fields nothing in the port reads, and its bf16-score presets change only
# operand dtypes, which neither the FLOP count nor the argument bytes see:
# the port has none of them, so --variant refuses those names.
VARIANTS = {
    "baseline": {},
    "moegroup2k": {"cfg": {"moe_group_size": 2048}},
    "moegroup1k": {"cfg": {"moe_group_size": 1024}},
    "scatter": {"moe_impl": "scatter"},
    "seqkv": {"seq_shard": True, "attn_impl": "seqshard"},
    "noremat": {"remat": False},
}


def variant_applicable(cfg, shape, variant: str,
                       moe_impl: str) -> Tuple[bool, str]:
    """(True, "") when `variant` changes what the port reckons for the
    cell, else (False, why): a record under a variant's name is one the
    variant changed."""
    opts = VARIANTS[variant]
    g = opts.get("cfg", {}).get("moe_group_size")
    if g is not None:
        if not cfg.is_moe or moe_impl != "einsum":
            return False, f"{variant}: groups only the einsum MoE dispatch"
        if shape.kind == "decode" or not (shape.seq_len > g
                                          and shape.seq_len % g == 0):
            return False, (f"{variant}: {shape.seq_len}-token sequences "
                           f"do not split into {g}-token groups")
    if "moe_impl" in opts and not cfg.is_moe:
        return False, f"{variant}: {cfg.name} has no MoE layer"
    if opts.get("seq_shard") and shape.kind != "decode":
        return False, f"{variant}: shards the decode KV cache only"
    if "remat" in opts and shape.kind != "train":
        return False, f"{variant}: remat runs in training only"
    return True, ""


class AbstractMesh(NamedTuple):
    """Axis names and sizes: all the sharding rules read of a mesh."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def production_mesh(multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


# ----------------------------------------------------------------------------
# per-device bytes from the specs
# ----------------------------------------------------------------------------
def _paired(tree, specs):
    """(leaf, spec) pairs of a tree and its spec tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paired(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs):
            yield from _paired(v, s)
    elif tree is not None:
        yield tree, specs


def local_numel(shape, spec, sizes) -> int:
    """Elements of one device's block of a `shape` tensor cut by `spec`
    (an uneven split rounds up, as a padded shard would)."""
    n = 1
    for dim, size in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        n *= -(-int(size) // math.prod(sizes[a] for a in axes))
    return n


def tree_local_bytes(tree, specs, mesh, dtype=None) -> int:
    """Per-device bytes of `tree` under `specs` (each leaf in its own
    dtype, or in `dtype`)."""
    sizes = axis_sizes(mesh)
    total = 0
    for leaf, spec in _paired(tree, specs):
        item = torch.empty((), dtype=dtype or leaf.dtype).element_size()
        total += local_numel(leaf.shape, spec, sizes) * item
    return total


def meta_params(cfg):
    return build_params(torch.Generator(), cfg, META)


def model_bytes(cfg) -> int:
    """The whole model's parameter bytes, each leaf in its own dtype."""
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(meta_params(cfg)))


def argument_bytes(cfg, shape, mesh, kind, seq_shard=False) -> dict:
    """Per-device argument bytes of one cell, by part."""
    sizes = axis_sizes(mesh)
    train = kind == "train"
    params = meta_params(cfg)
    fsdp = needs_fsdp(cfg, sizes.get("model", 1), train=train)
    specs = param_pspecs(params, cfg, model_size=sizes.get("model", 1),
                         fsdp=fsdp, data_size=sizes.get("data", 1))
    out = {"params": tree_local_bytes(params, specs, mesh), "fsdp": fsdp}
    if train:
        # AdamW's mu and nu: f32, sharded as the params
        out["opt_moments"] = 2 * tree_local_bytes(params, specs, mesh,
                                                  torch.float32)
    b_spec = batch_spec(cfg, shape, kind)
    b_structs = make_batch_structs(cfg, shape, kind)
    out["batch"] = tree_local_bytes(b_structs, batch_pspecs(b_spec, mesh),
                                    mesh)
    if kind == "decode":
        caches = cache_structs(cfg, shape.global_batch, shape.seq_len)
        out["cache"] = tree_local_bytes(
            caches, cache_pspecs(caches, mesh, cfg, seq_shard=seq_shard),
            mesh)
    out["total"] = sum(v for k, v in out.items() if k != "fsdp")
    return out


# ----------------------------------------------------------------------------
# FLOPs: the 1- and 2-super-block probe
# ----------------------------------------------------------------------------
def depth_reduced(cfg, n_blocks: int):
    """`cfg` cut to its prefix and `n_blocks` super-blocks (an
    encoder-decoder's encoder in proportion)."""
    prefix, period, _ = stack_layout(cfg)
    kw = dict(n_layers=len(prefix) + period * n_blocks)
    if cfg.encoder_decoder:
        kw["n_enc_layers"] = n_blocks * (cfg.n_enc_layers // cfg.n_layers)
    return dataclasses.replace(cfg, **kw)


def count_flops(cfg, shape, kind, *, moe_impl="einsum", remat=True) -> int:
    """Matmul and attention FLOPs of one step of `kind` on the whole batch
    (train: the loss and its backward), counted on meta tensors."""
    p = meta_params(cfg)
    batch = make_batch_structs(cfg, shape, kind)
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            for t in tree_leaves(p):
                t.requires_grad_(True)
            loss, _ = train_loss(p, cfg, batch, remat=remat,
                                 moe_impl=moe_impl)
            loss.backward()
        elif kind == "prefill":
            with torch.no_grad():
                prefill(p, cfg, batch.get("tokens"), moe_impl=moe_impl,
                        **{k: v for k, v in batch.items() if k != "tokens"})
        else:
            caches = cache_structs(cfg, shape.global_batch, shape.seq_len)
            with torch.no_grad():
                decode_step(p, cfg, batch.get("tokens"), caches,
                            shape.seq_len - 1, embeds=batch.get("embeds"),
                            mrope_positions=batch.get("mrope_positions"))
    return int(fc.get_total_flops())


def probe_flops(cfg, shape, kind, *, moe_impl="einsum", remat=True) -> dict:
    """``total = cost(1) + (m − 1)·Δ`` over the stack's m super-blocks."""
    _, _, m = stack_layout(cfg)
    costs = {nb: count_flops(depth_reduced(cfg, nb), shape, kind,
                             moe_impl=moe_impl, remat=remat)
             for nb in (1, 2)}
    delta = costs[2] - costs[1]
    return {"flops": costs[1] + (m - 1) * delta, "flops_1": costs[1],
            "flops_2": costs[2], "flops_per_block": delta, "n_blocks": m}


def flop_split(shape, mesh) -> int:
    """Devices one step's FLOPs divide over: every device when the batch
    splits over the data axes, else the ``model`` axis alone."""
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in data_axes(mesh))
    model = sizes.get("model", 1)
    return dp * model if shape.global_batch % dp == 0 else model


def roofline_terms(flops_dev: float, bytes_dev: float,
                   coll_dev: Optional[float]) -> dict:
    """Seconds per term at one H100 SXM's rates; the dominant term."""
    terms = {"compute_s": flops_dev / PEAK_FLOPS_BF16,
             "memory_s": bytes_dev / HBM_BW,
             "collective_s": None if coll_dev is None
             else coll_dev / NVLINK_BW}
    known = {k: v for k, v in terms.items() if v is not None}
    terms["dominant"] = max(known, key=known.get)
    return terms


def model_flops(cfg, shape, kind) -> float:
    """MODEL_FLOPS: 6·N_active·D for train, 2·N_active·D for inference."""
    n = cfg.param_counts()["active"]
    toks = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    return float(6 if kind == "train" else 2) * n * toks


# ----------------------------------------------------------------------------
# cells
# ----------------------------------------------------------------------------
_PROBES: dict = {}


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             moe_impl="einsum", remat=True, variant="baseline",
             out_dir=None) -> dict:
    cfg = get_config(arch)
    shape = SHAPE_BY_NAME[shape_name]
    opts = VARIANTS[variant]
    if opts.get("cfg"):
        cfg = dataclasses.replace(cfg, **opts["cfg"])
    moe_impl = opts.get("moe_impl", moe_impl)
    remat = opts.get("remat", remat)
    seqkv = opts.get("attn_impl") == "seqshard" and shape.kind == "decode"
    ok, reason = shape_applicable(cfg, shape_name)
    if ok:
        ok, reason = variant_applicable(cfg, shape, variant, moe_impl)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "variant": variant, "kind": shape.kind, "moe_impl": moe_impl}
    if not ok:
        rec.update(status="skip", reason=reason)
        _write(rec, out_dir)
        return rec
    mesh = production_mesh(multi_pod=(mesh_kind == "multi"))
    chips = CHIPS[mesh_kind]
    t0 = time.time()
    try:
        args = argument_bytes(cfg, shape, mesh, shape.kind,
                              seq_shard=bool(opts.get("seq_shard")))
        # the FLOPs of a step do not depend on the mesh: probe once
        key = (arch, shape_name, variant, moe_impl, remat)
        if key not in _PROBES:
            _PROBES[key] = probe_flops(cfg, shape, shape.kind,
                                       moe_impl=moe_impl, remat=remat)
        probe = _PROBES[key]
        split = flop_split(shape, mesh)
        flops_dev = probe["flops"] / split
        coll = coll_reason = None
        if seqkv:
            sizes = axis_sizes(mesh)
            dp = math.prod(sizes[a] for a in data_axes(mesh))
            b_loc = shape.global_batch // dp \
                if shape.global_batch % dp == 0 else shape.global_batch
            coll = reckon_seqshard_decode(cfg, b_loc)
        else:
            coll_reason = NO_COLLECTIVES
        coll_dev = None if coll is None else \
            float(sum(coll["collective_bytes"].values()))
        mf = model_flops(cfg, shape, shape.kind)
        terms = roofline_terms(flops_dev, args["total"], coll_dev)
        rec.update(
            status="ok", wall_s=round(time.time() - t0, 2),
            model_bytes=model_bytes(cfg), argument_bytes_per_device=args,
            flops_global=probe["flops"], flops_split=split,
            flops_per_device=flops_dev,
            collective_bytes_per_device=coll_dev,
            collectives=coll, collective_note=coll_reason,
            probe=probe, roofline=terms,
            model_flops_global=mf, model_flops_per_device=mf / chips,
            useful_flop_ratio=(mf / chips / flops_dev) if flops_dev
            else None,
            chips=chips)
        print(f"[{arch} × {shape_name} × {mesh_kind}] OK "
              f"model={rec['model_bytes']:.3e} B "
              f"flops/dev={flops_dev:.3e} "
              f"args/dev={args['total']:.3e} B "
              f"coll/dev={coll_dev if coll_dev is None else f'{coll_dev:.3e}'} "
              f"dominant={terms['dominant']} "
              f"useful={rec['useful_flop_ratio'] and round(rec['useful_flop_ratio'], 3)}",
              flush=True)
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[{arch} × {shape_name} × {mesh_kind}] FAIL: {e}",
              file=sys.stderr, flush=True)
    _write(rec, out_dir)
    return rec


def _write(rec, out_dir=None):
    d = Path(out_dir or OUT_DIR).resolve()
    d.mkdir(parents=True, exist_ok=True)
    name = (f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
            + (f"__{rec['variant']}" if rec.get("variant", "baseline")
               != "baseline" else "") + ".json")
    with open(d / name, "w") as f:
        json.dump(rec, f, indent=1)


PP_MICRO, PP_MB = 8, (8, 2048)


def run_pp_demo(arch: str = "granite-8b", out_dir=None) -> dict:
    """The GPipe pipeline with the multi-pod mesh's ``pod`` axis as its
    stages: each stage's share of the stack (its per-device bytes), its
    FLOPs for PP_MICRO micro-batches of PP_MB, and its collectives as
    ``distributed.pipeline.pipeline_forward`` charges them."""
    cfg = get_config(arch)
    mesh = production_mesh(multi_pod=True)
    n_st = axis_sizes(mesh)["pod"]
    prefix, period, m = stack_layout(cfg)
    rec = {"arch": arch, "shape": "pp_microbatch", "mesh": "multi",
           "variant": "pp2", "kind": "pipeline"}
    t0 = time.time()
    try:
        if m % n_st:
            raise ValueError(f"{arch}: {m} super-blocks do not split over "
                             f"{n_st} stages")
        cfg1 = depth_reduced(cfg, 1)
        p = meta_params(cfg1)
        layers = p["layers"][len(prefix):]
        B, S = PP_MB
        x = torch.empty((B, S, cfg.d_model), dtype=dtype_of(cfg),
                        device=META)
        positions = torch.empty((B, S), dtype=torch.int32, device=META)
        aux = torch.zeros((), dtype=torch.float32, device=META)
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            _superblock(layers, x, aux, cfg1, positions, None, None,
                        "einsum")
        per_block = int(fc.get_total_flops())
        blocks = m // n_st
        block_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(layers))
        coll = reckon_pipeline(cfg, n_st, PP_MICRO, PP_MB)
        rec.update(status="ok", wall_s=round(time.time() - t0, 2),
                   stages=n_st, micro_batches=PP_MICRO,
                   micro_batch=list(PP_MB), blocks_per_stage=blocks,
                   stage_param_bytes=blocks * block_bytes,
                   stage_flops=PP_MICRO * blocks * per_block,
                   collectives=coll)
        print(f"[pp2 {arch}] OK stage_flops={rec['stage_flops']:.3e} "
              f"collectives={coll['collective_ops']}", flush=True)
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[pp2 {arch}] FAIL: {e}", file=sys.stderr, flush=True)
    _write(rec, out_dir)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--moe-impl", default="einsum",
                    choices=["einsum", "scatter"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--pp-demo", action="store_true",
                    help="reckon the GPipe pipeline over the pod axis")
    args = ap.parse_args(argv)

    if args.pp_demo:
        rec = run_pp_demo(args.arch or "granite-8b", out_dir=args.out_dir)
        sys.exit(0 if rec["status"] == "ok" else 1)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    n_ok = n_skip = n_err = 0
    for arch, shape in cells:
        for mk in meshes:
            rec = run_cell(arch, shape, mk, moe_impl=args.moe_impl,
                           remat=not args.no_remat, variant=args.variant,
                           out_dir=args.out_dir)
            n_ok += rec["status"] == "ok"
            n_skip += rec["status"] == "skip"
            n_err += rec["status"] == "error"
    print(f"dry-run: {n_ok} ok, {n_skip} skip, {n_err} error")
    sys.exit(1 if n_err else 0)


if __name__ == "__main__":
    main()
