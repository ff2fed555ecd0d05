"""Per-layer views of a stacked parameter (or cache) tree.

The JAX package scans its decoder over super-blocks, so its trees carry a
leading ``[m]`` stack dim (``{"prefix": [...], "stack": {"sub_j": ...}}``).
The port keeps one entry per layer; :func:`unstack_layers` turns the first
form into the second.  The paged KV pool of continuous batching is not
ported yet.
"""
from __future__ import annotations

from repro_torch.models.model import stack_layout


def map_tree(fn, tree):
    """`fn` applied to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def unstack_layers(tree, cfg):
    """Stacked decoder tree -> flat per-layer list (leaves are indexed, not
    copied)."""
    prefix, period, m = stack_layout(cfg)
    out = list(tree["prefix"])
    if tree.get("stack") is not None:
        for b in range(m):
            for j in range(period):
                out.append(map_tree(lambda x: x[b],
                                    tree["stack"][f"sub_{j}"]))
    return out
