"""Parameters of the JAX package, as the port's per-layer parameters.

``params_from_jax`` takes the JAX package's parameter tree with numpy
leaves (``{"embed", ["encoder", "enc_norm",] "decoder": {"prefix",
"stack": {"sub_j": …}}, "final_norm", "lm_head"}``, the stack leaves
carrying a leading ``[m]`` dim) and returns the port's structure
(``models/model.py``) with the same numbers, so both packages compute the
same function.  bf16 leaves cross
through their 16-bit patterns: numpy's bf16 comes from ``ml_dtypes``,
which ``torch.from_numpy`` does not take and the port does not import.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import check_supported, enc_config
from repro_torch.serving.kv_cache import map_tree, unstack_layers


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """One numpy leaf -> torch tensor on `device`; bf16 bit-exact."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:         # torch tensors must be writable
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(tree: Dict[str, Any], cfg, device=None) -> Dict[str, Any]:
    """JAX-package parameter tree (numpy leaves) -> port parameters on
    `device` (the card by default).  Every leaf crosses in its own dtype:
    MLA's f32 norm scales (``kv_norm``, ``q_norm``) and Mamba2's f32
    ``dt_bias``, ``A_log``, ``D`` and ``gate_norm`` stay f32, its conv and
    projections bf16.  A hybrid stack (jamba) unstacks with its period of
    lcm(moe_every, attn_every) layers; an encoder-decoder's encoder with
    its own (dense) layout, its decoder layers with ``norm_x`` and
    ``xattn``.  An ``embed`` holds ``tok`` and ``pos`` where the config
    has them."""
    check_supported(cfg)
    dev = resolve_device(device)
    conv = lambda a: tensor_from_numpy(a, dev)          # noqa: E731
    layers = unstack_layers(tree["decoder"], cfg)
    out = {"embed": map_tree(conv, tree["embed"]),
           "layers": [map_tree(conv, lp) for lp in layers],
           "final_norm": map_tree(conv, tree["final_norm"])}
    if cfg.encoder_decoder:
        out["encoder"] = [map_tree(conv, lp) for lp in unstack_layers(
            tree["encoder"], enc_config(cfg))]
        out["enc_norm"] = map_tree(conv, tree["enc_norm"])
    if "lm_head" in tree:
        out["lm_head"] = map_tree(conv, tree["lm_head"])
    return out
