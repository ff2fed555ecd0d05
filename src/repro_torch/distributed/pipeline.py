"""GPipe pipeline parallelism, the JAX package's ``distributed/pipeline.py``
for the ranks of a process group.

Each rank of the group is one stage and holds a contiguous ``m/P`` of the
decoder stack's ``m`` super-blocks (:func:`stage_layers`; ``m % P == 0``).
The schedule runs ``M + P − 1`` ticks over ``M`` micro-batches: at tick
``t`` stage ``s`` works on micro-batch ``t − s`` when that lies in
``[0, M)`` — stage 0 takes it from the inputs, the others from the
boundary activation the stage before sent at tick ``t − 1`` — and every
tick each stage sends its activation one hop forward, the last stage to
stage 0 (the JAX package's cyclic ``ppermute``; stage 0 never reads it).
A stage skips the ticks where it holds no micro-batch, whose results the
JAX package computes and drops.  Each micro-batch runs the same ops on the
same shapes as a sequential pass over the stack, so the results are the
same numbers.

The last stage's results reach every rank by an all-reduce SUM of the
result buffer, which the other ranks fill with -0.0: ``x + (-0.0)`` is
``x`` for every x, ±0 included, so the sum moves the bits unchanged.

Forward only (inference, loss evaluation), over the stack after the
``first_dense`` prefix, as the JAX package's.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import all_reduce, permute
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import _superblock, stack_layout


def stage_layers(layers, cfg, stage: int, n_stages: int):
    """Stage `stage`'s contiguous share of the per-layer list `layers`: its
    ``m / n_stages`` super-blocks of the stack after the prefix."""
    prefix, period, m = stack_layout(cfg)
    if m % n_stages:
        raise ValueError(f"stack depth {m} not divisible by {n_stages} "
                         f"stages")
    per = m // n_stages * period
    base = len(prefix) + stage * per
    return layers[base:base + per]


def pipeline_forward(stage_layers, x_micro, cfg, group=None, *,
                     positions=None, moe_impl="einsum", ledger=None):
    """Run the decoder stack as a pipeline over `group`'s ranks.

    stage_layers : this rank's layers (:func:`stage_layers` at its group
                   rank).
    x_micro      : [M, B_mb, S, d] micro-batches, the same on every rank.
    positions    : [B_mb, S] int, the sequence index when None.
    Returns [M, B_mb, S, d] on every rank.  Charges ``M + P − 1``
    collective permutes of one micro-batch's activation and one
    all-reduce of the result to `ledger` when given."""
    n_st = dist.get_world_size(group)
    s = dist.get_rank(group)
    _, period, m = stack_layout(cfg)
    if m % n_st:
        raise ValueError(f"stack depth {m} not divisible by {n_st} stages")
    if len(stage_layers) != m // n_st * period:
        raise ValueError(f"a stage holds {m // n_st * period} layers, got "
                         f"{len(stage_layers)}")
    M, B, S = x_micro.shape[:3]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x_micro.device)[None].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x_micro.device)
    acc = torch.full_like(x_micro, -0.0)
    buf = torch.zeros_like(x_micro[0])
    for t in range(M + n_st - 1):
        x_in = x_micro[t] if s == 0 and t < M else buf
        if 0 <= t - s < M:
            y, _ = _superblock(stage_layers, x_in, aux, cfg, positions,
                               None, None, moe_impl)
            if s == n_st - 1:
                acc[t - s] = y
        else:
            y = x_in
        buf = permute(y.contiguous(), torch.empty_like(y), (s + 1) % n_st,
                      (s - 1) % n_st, group, ledger) if n_st > 1 else y
    return all_reduce(acc, dist.ReduceOp.SUM, group, ledger)


def reckon_pipeline(cfg, n_stages: int, n_micro: int, mb_shape) -> dict:
    """What :func:`pipeline_forward` charges a stage's ledger for `n_micro`
    micro-batches of `mb_shape` ``(B_mb, S)`` over `n_stages` stages: one
    permute of a micro-batch's activation a tick (``M + P − 1`` ticks)
    and one all-reduce of the whole result."""
    B, S = mb_shape
    act = int(B) * int(S) * cfg.d_model * \
        torch.empty((), dtype=dtype_of(cfg)).element_size()
    ticks = int(n_micro) + int(n_stages) - 1
    return {"collective_ops": {"collective-permute": ticks,
                               "all-reduce": 1},
            "collective_bytes": {"collective-permute": ticks * act,
                                 "all-reduce": int(n_micro) * act}}
