"""Batch construction: seeded random inputs of one shape cell, drawn with
numpy exactly as the JAX package draws them, so both packages can be fed
the same batch; and shape-only stand-ins on the ``meta`` device (the dry
run), from the same spec.

Batch dict conventions (torch tensors on the target device):

* a decoder fed tokens: ``{"tokens": [B, S] int32}``;
* a config fed embeddings (qwen2-vl-2b): ``{"embeds": [B, S, d]}`` and,
  with M-RoPE, ``{"mrope_positions": [3, B, S] int32}``;
* an encoder-decoder adds ``{"enc_embeds": [B, enc_seq_len, d]}`` (the
  stub frontend's output);
* ``kind="train"`` adds ``{"labels": [B, S] int32}``; ``kind="decode"`` is
  one new token (``[B, 1]``, ``[B, 1, d]``, ``[3, B, 1]``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import init_layer_cache

META = torch.device("meta")


def batch_spec(cfg, shape, kind=None) -> Dict[str, Any]:
    """Dict of (shape, dtype) tuples for the given cell.  kind defaults to
    shape.kind; pass "prefill"/"decode"/"train" to override."""
    kind = kind or shape.kind
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    spec: Dict[str, Any] = {}
    if kind in ("train", "prefill"):
        if cfg.embed_inputs:
            spec["tokens"] = ((B, S), torch.int32)
        else:
            spec["embeds"] = ((B, S, d), dtype_of(cfg))
        if cfg.mrope:
            spec["mrope_positions"] = ((3, B, S), torch.int32)
        if cfg.encoder_decoder:
            spec["enc_embeds"] = ((B, cfg.enc_seq_len, d), dtype_of(cfg))
        if kind == "train":
            spec["labels"] = ((B, S), torch.int32)
    else:  # decode: one new token against a cache of length S
        if cfg.embed_inputs:
            spec["tokens"] = ((B, 1), torch.int32)
        else:
            spec["embeds"] = ((B, 1, d), dtype_of(cfg))
        if cfg.mrope:
            spec["mrope_positions"] = ((3, B, 1), torch.int32)
    return spec


def make_batch(cfg, shape, kind=None, seed=0, device=None
               ) -> Dict[str, torch.Tensor]:
    """Concrete random batch on `device` (the card by default): token ids
    uniform over the vocabulary, embeddings N(0, 0.02²) rounded once to
    the model's dtype, M-RoPE positions the sequence index on every
    channel."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shp, dt) in batch_spec(cfg, shape, kind).items():
        if dt == torch.int32:
            if name == "mrope_positions":
                a = np.broadcast_to(np.arange(shp[-1], dtype=np.int32), shp)
            else:
                a = rng.integers(0, cfg.vocab_size, size=shp, dtype=np.int32)
            out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        else:
            out[name] = torch.from_numpy(
                rng.standard_normal(shp) * 0.02).to(dt).to(dev)
    return out


def make_batch_structs(cfg, shape, kind=None) -> Dict[str, torch.Tensor]:
    """``meta``-device stand-ins of :func:`make_batch` (dry run: shapes and
    dtypes, no storage)."""
    return {name: torch.empty(shp, dtype=dt, device=META)
            for name, (shp, dt) in batch_spec(cfg, shape, kind).items()}


def cache_structs(cfg, batch: int, length: int):
    """``meta``-device stand-ins of ``models.model.init_cache``."""
    return [init_layer_cache(cfg, i, batch, length, META)
            for i in range(cfg.n_layers)]
