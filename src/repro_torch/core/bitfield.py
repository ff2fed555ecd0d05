"""BF16 bit-field decomposition (§2.2, §3.1 offline initialization step ❶).

A BF16 value is ``(-1)^sign · 2^(exp-127) · 1.mantissa`` with bit layout
``s eeeeeeee mmmmmmm`` (1+8+7).  ZipMoE splits each element into

* **exponent plane**  — 8 exponent bits, one byte per element (low entropy,
  compressible);
* **sign–mantissa plane** — sign bit + 7 mantissa bits packed into one byte
  (near-random, stored raw).

Both planes are byte-aligned so the split/merge is pure byte arithmetic.

numpy has no bf16 type of its own, so on the host a bf16 tensor travels as
its **bit pattern**: a ``uint16`` ndarray (:func:`to_bits` /
:func:`from_bits` convert to and from torch bf16 tensors without touching a
bit).  The numpy versions run on the host (offline compression pipeline /
CPU workers); the torch versions do the same bit ops in int32 on any device
and are the plain versions of the CUDA splice kernels.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


# ----------------------------------------------------------------------------
# bf16 tensor <-> uint16 bit pattern
# ----------------------------------------------------------------------------
def to_bits(t) -> np.ndarray:
    """bf16 tensor (any device) -> host uint16 ndarray of its bit pattern.
    A uint16 ndarray passes through; other float inputs round to bf16."""
    if isinstance(t, np.ndarray):
        if t.dtype == np.uint16:
            return t
        t = torch.from_numpy(np.ascontiguousarray(t, np.float32))
    if t.dtype != torch.bfloat16:
        t = t.to(torch.bfloat16)
    return t.detach().contiguous().cpu().view(torch.int16).numpy().view(
        np.uint16)


def from_bits(u: np.ndarray, shape=None) -> torch.Tensor:
    """uint16 bit-pattern ndarray -> CPU bf16 tensor sharing its memory."""
    u = np.ascontiguousarray(u, np.uint16)
    t = torch.from_numpy(u.view(np.int16)).view(torch.bfloat16)
    return t.reshape(shape) if shape is not None else t


# ----------------------------------------------------------------------------
# numpy (host side)
# ----------------------------------------------------------------------------
def decompose_np(bits) -> Tuple[np.ndarray, np.ndarray]:
    """BF16 bits (uint16 ndarray, or a bf16 tensor) -> (exp u8, sm u8),
    flattened."""
    u = to_bits(bits).reshape(-1)
    exp = ((u >> 7) & 0xFF).astype(np.uint8)
    sm = (((u >> 8) & 0x80) | (u & 0x7F)).astype(np.uint8)
    return exp, sm


def reconstruct_np(exp: np.ndarray, sm: np.ndarray, shape=None) -> np.ndarray:
    """(exp u8, sm u8) -> BF16 bits as a uint16 ndarray."""
    e = exp.astype(np.uint16)
    s = sm.astype(np.uint16)
    u = ((s & 0x80) << 8) | (e << 7) | (s & 0x7F)
    return u.reshape(shape) if shape is not None else u


# ----------------------------------------------------------------------------
# torch (device side; the plain version of the CUDA splice)
# ----------------------------------------------------------------------------
def decompose(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16 tensor -> (exp u8, sm u8) flat tensors on the same device."""
    u = t.to(torch.bfloat16).contiguous().view(torch.int16).reshape(-1).to(
        torch.int32) & 0xFFFF
    exp = ((u >> 7) & 0xFF).to(torch.uint8)
    sm = (((u >> 8) & 0x80) | (u & 0x7F)).to(torch.uint8)
    return exp, sm


def reconstruct(exp: torch.Tensor, sm: torch.Tensor) -> torch.Tensor:
    """(exp u8, sm u8) -> bf16 tensor of the same shape: int32 bit ops, cut
    to 16 bits (the narrowing cast keeps the low bits) and viewed as bf16."""
    e = exp.to(torch.int32)
    s = sm.to(torch.int32)
    u = ((s & 0x80) << 8) | (e << 7) | (s & 0x7F)
    return u.to(torch.int16).view(torch.bfloat16)


# ----------------------------------------------------------------------------
# K-sharding of the exponent plane (E-chunks)
# ----------------------------------------------------------------------------
def shard_bounds(n: int, k: int) -> List[Tuple[int, int]]:
    """K contiguous shards covering [0, n) (last shard absorbs the remainder)."""
    step = n // k
    return [(i * step, (i + 1) * step if i < k - 1 else n) for i in range(k)]


def shard_plane(plane: np.ndarray, k: int) -> List[np.ndarray]:
    return [plane[a:b] for a, b in shard_bounds(plane.size, k)]


# ----------------------------------------------------------------------------
# entropy measurement (Fig. 2)
# ----------------------------------------------------------------------------
def byte_entropy(plane: np.ndarray) -> float:
    """Shannon entropy (bits/symbol) of a u8 plane."""
    counts = np.bincount(plane.reshape(-1), minlength=256).astype(np.float64)
    p = counts / max(1, counts.sum())
    nz = p[p > 0]
    return float(-(nz * np.log2(nz)).sum())


def support_fraction(plane: np.ndarray) -> float:
    """Fraction of the 256 symbols actually used (Fig. 2 support set)."""
    return float((np.bincount(plane.reshape(-1), minlength=256) > 0).mean())


def entropy_bound_ratio(arr) -> float:
    """Shannon lower bound on compressed size / original size (§2.2):
    sm plane stays 8 bits, exp plane compresses to its entropy."""
    exp, sm = decompose_np(arr)
    h_exp = byte_entropy(exp)
    return (8.0 + h_exp) / 16.0
