"""AdamW over the port's parameter trees (f32 moments, bf16 params), and
the cosine learning-rate schedule — the JAX package's
``training/optimizer.py`` in plain PyTorch.

Written by hand, not ``torch.optim.AdamW``: that one keeps bf16 moments
for bf16 parameters and applies its bias correction in another order, so
it does not compute the JAX package's function.  Here, as there:

* the global-norm clip is taken over every gradient in f32;
* each update runs in f32 and is cast back to the parameter's dtype;
* weight decay applies to tensors of two or more dims only;
* the step counter is an int32 tensor on the parameters' device, and the
  schedule reads it there (``cosine_lr(0)`` is 0).
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple

import torch


def tree_leaves(tree) -> List[Any]:
    """The leaves of a tree of dicts (in insertion order), lists and
    tuples; None is not a leaf."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over `tree`'s structure
    (dicts, lists, tuples; a NamedTuple keeps its type)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


class AdamWState(NamedTuple):
    step: torch.Tensor            # int32 scalar on the parameters' device
    mu: Any                       # f32, the parameters' structure
    nu: Any


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """One AdamW step, written into the buffers of `params` and `state`
    (as a compiled step with donated buffers would; the old values are
    gone): the step holds one copy of the moments.  Returns (params,
    state, gnorm), gnorm the f32 global norm of `grads` before clipping;
    the numbers are the JAX package's functional update's."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in tree_leaves(grads)))
    scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    b1c = 1 - b1 ** step.float()
    b2c = 1 - b2 ** step.float()

    def upd(g, m, v, p):
        g = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        u = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        if p.ndim >= 2:                       # no decay on scales/biases
            u = u + weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))

    tree_map(upd, grads, state.mu, state.nu, params)
    state.step.copy_(step)
    return params, state, gnorm


def cosine_lr(step, *, peak, warmup=100, total=10000, floor=0.1):
    """Linear warmup to `peak` over `warmup` steps, then a cosine down to
    ``floor * peak`` at `total`.  `step`: an int or an int tensor (the
    optimizer's counter); returns an f32 tensor on its device."""
    step = torch.as_tensor(step)
    warm = peak * step / max(1, warmup)
    frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5
                  * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
