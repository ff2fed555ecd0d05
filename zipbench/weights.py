"""The benchmark's seeded weights: the port's parameter structure, the
benchmark's own values.

The structure (which leaves, their shapes and dtypes) comes from the port's
``models.model.build_params`` run on the ``meta`` device.  The values come
from this file alone, drawn on the target device from ``--seed`` in three
calls (routed experts, the other matrices, the routers), so a change to the
port's ``init_params`` cannot move them, nor the store's compressibility.

* norm scales are ones, biases zeros;
* embeddings, positions and the LM head are N(0, 0.02^2);
* every other matrix is N(0, 2 / (fan_in + fan_out)) with fan_in, fan_out
  its last two dims;
* a router [d, E] is N(0, 0.02^2) with column e scaled by
  ``1 / (1 + alpha * ln(1 + rank_e))``, ``rank`` a permutation of the
  experts drawn from the seed per layer: an expert of lower rank has a wider
  logit spread and enters the top-k more often.  alpha = 0 is uniform;
* a 1-D leaf no rule above covers takes the family's ``leaf_rule``
  (``zipbench/families/``), drawn after the three calls from a generator of
  its own (``seed ^ 0xFA11``), so a family's extra leaves leave the common
  leaves' values as they are.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

EXPERT_NAMES = ("w_gate", "w_up", "w_down")
ONES = ("scale", "q_norm", "k_norm", "kv_norm")
STD_002 = ("tok", "router")


def structure(cfg):
    """The port's parameter tree for `cfg`, as shapes on the meta device."""
    from repro_torch.models.model import build_params
    return build_params(torch.Generator("cpu"), cfg, torch.device("meta"))


def leaves(tree, path=()) -> List[Tuple[tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in leaves(v, path + (i,))]
    return [(path, tree)]


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def is_routed(path, t) -> bool:
    return "ffn" in path and path[-1] in EXPERT_NAMES and t.dim() == 3


def _std(path, t) -> float:
    if path[-1] in STD_002 or path[:2] == ("lm_head", "w"):
        return 0.02
    return math.sqrt(2.0 / (t.shape[-2] + t.shape[-1]))


def skew_scales(n_experts: int, alpha: float, perm: torch.Tensor
                ) -> torch.Tensor:
    """[E] f32 column scales: expert ``perm[r]`` gets
    ``1 / (1 + alpha * ln(1 + r))``."""
    r = torch.arange(n_experts, dtype=torch.float64)
    prof = 1.0 / (1.0 + alpha * torch.log1p(r))
    out = torch.empty(n_experts, dtype=torch.float64)
    out[perm] = prof
    return out.float()


def apply_skew_(router: torch.Tensor, alpha: float, perm: torch.Tensor):
    router.mul_(skew_scales(router.shape[-1], alpha, perm).to(router.device))
    return router


def make_weights(cfg, seed: int, device, alpha: float,
                 leaf_rule: Optional[Callable] = None) -> Dict:
    """The parameter tree of `cfg` on `device`, drawn from `seed`;
    `leaf_rule(path, t, gen)` gives the values of a leaf the common rules
    do not cover (None: it has none)."""
    dev = torch.device(device)
    tree = structure(cfg)
    items = leaves(tree)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    perm_gen = torch.Generator("cpu")
    perm_gen.manual_seed(int(seed) ^ 0x5EED)
    groups = {"routed": [], "dense": [], "router": []}
    family_leaves = []
    for path, t in items:
        if t.dim() == 1:
            if path[-1] in ONES:
                _set(tree, path, torch.ones(t.shape, dtype=t.dtype,
                                            device=dev))
            elif path[-1] == "bias":
                _set(tree, path, torch.zeros(t.shape, dtype=t.dtype,
                                             device=dev))
            elif leaf_rule is None:
                raise NotImplementedError(f"no rule for leaf {path}")
            else:
                family_leaves.append((path, t))
        elif path[-1] == "router":
            groups["router"].append((path, t))
        elif is_routed(path, t):
            groups["routed"].append((path, t))
        else:
            groups["dense"].append((path, t))
    for name, dtype in (("routed", None), ("dense", None),
                        ("router", torch.float32)):
        items = groups[name]
        if not items:
            continue
        dt = dtype or items[0][1].dtype
        assert all(t.dtype == dt for _, t in items), name
        total = sum(t.numel() for _, t in items)
        buf = torch.randn(total, generator=gen, device=dev, dtype=dt)
        off = 0
        for path, t in items:
            v = buf[off:off + t.numel()].view(t.shape)
            off += t.numel()
            v.mul_(_std(path, t))
            if name == "router":
                perm = torch.randperm(t.shape[-1], generator=perm_gen)
                apply_skew_(v, alpha, perm)
            _set(tree, path, v)
    if family_leaves:
        fgen = torch.Generator(device=dev)
        fgen.manual_seed(int(seed) ^ 0xFA11)
        for path, t in family_leaves:
            v = leaf_rule(path, t, fgen)
            if v is None:
                raise NotImplementedError(f"no rule for leaf {path}")
            if v.shape != t.shape or v.dtype != t.dtype:
                raise ValueError(f"leaf_rule for {path} gave {v.dtype} "
                                 f"{tuple(v.shape)}, not {t.dtype} "
                                 f"{tuple(t.shape)}")
            _set(tree, path, v)
    return tree


def drop_routed(tree) -> int:
    """Remove the routed expert stacks from `tree` (they live in the store);
    returns the bytes dropped."""
    n = 0
    for lp in tree["layers"]:
        ffn = lp.get("ffn", {})
        if "router" in ffn:
            for name in EXPERT_NAMES:
                t = ffn.pop(name, None)
                if t is not None:
                    n += t.numel() * t.element_size()
    return n


def top_quarter_share(router: torch.Tensor, k: int, n_tokens: int,
                      seed: int = 0) -> float:
    """Share of top-k selections that go to the most-chosen quarter of the
    experts, for N(0, 1) inputs through `router` [d, E] (f32)."""
    g = torch.Generator("cpu")
    g.manual_seed(seed)
    d, E = router.shape
    x = torch.randn(n_tokens, d, generator=g)
    top = torch.topk(x @ router.float().cpu(), k, dim=-1).indices
    counts = torch.bincount(top.reshape(-1), minlength=E).sort(
        descending=True).values
    return float(counts[:E // 4].sum() / counts.sum())
