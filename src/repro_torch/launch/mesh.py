"""Mesh construction over ``torch.distributed``'s ``DeviceMesh``.

Functions, not module-level meshes, so importing this module touches no
process group.  The production shapes are the JAX package's:

  single-pod : (16, 16)    axes ("data", "model")          — 256 devices
  multi-pod  : (2, 16, 16) axes ("pod", "data", "model")   — 512 devices

``pod`` composes with ``data`` for batch DP; ``model`` carries TP/EP.  A
mesh spans the default process group's ranks, which must number the
mesh's size (``repro_torch.distributed.launch.spawn_ranks`` makes such a
group).
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def make_mesh(shape, axes, device_type=None):
    """A ``DeviceMesh`` of `shape` with axis names `axes` over the default
    process group.  `device_type` ``"cuda"`` or ``"cpu"``; None means the
    card, and raises without one (as every entry point of the port)."""
    dev = resolve_device(device_type)
    if dev.type == "cuda":
        # every rank of one host may share the card: pick it before the
        # mesh guesses a device from the rank
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


# NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU data sheet): roofline
# denominators of one card
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                # B/s
NVLINK_BW = 900e9               # B/s, NVLink 4, both directions together
CHIPS = {"single": 256, "multi": 512}
