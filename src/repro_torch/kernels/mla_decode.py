"""MLA decode's absorbed form as two hand-written CUDA kernels
(``csrc/mla_decode.cu``), between the input projections (``wq`` or the
q-LoRA chain, ``wkv_a``) and the output projection (``wo``):

* :func:`rope_write` — rotates the query's rope part of every head at each
  row's position, norms the new latent with the f32 ``kv_norm``, rotates
  the new rope key, and writes both into the step's latent cache at
  ``(b, positions[b])`` in place.  Bit for bit the plain code's on the card
  (the latent's mean of squares is summed in the order PyTorch's CUDA
  reduction sums it, :func:`torch_reduce_lanes`).
* :func:`absorbed_attend` — per row and head: the query absorbed through
  ``wkv_b``'s key half, f32 scores over the latent and the rope key at the
  row's positions ``t <= positions[b]`` only, an f32 softmax and weighted
  sum over the latent, the value absorbed through ``wkv_b``'s value half,
  rounded once: ``[B, 1, H * Dv]``, ready for ``wo``.  One block a row
  and head; a row's output does not depend on the batch or ``T_pad``.

Neither replaces a TPU kernel (the JAX package leaves MLA decode to XLA);
they replace ~60 eager PyTorch ops a layer and their three host copies.
The wrappers take CUDA tensors only and raise on anything else, checking
dtypes, shapes and widths before the device; call them through
``kernels/ops.py``, which runs the plain versions (``kernels/ref.py``) for
CPU tensors.  Widths are multiples of 8; the latent is at most 512 wide,
the nope part 256, the rope part 128 and the value head 256.  A position
outside ``[0, T)`` stops both kernels with a device-side trap, which the
next synchronising call raises (the plain version's ``index_put_`` fails
too), and leaves the CUDA context unusable.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build, ref

MAX_LATENT = 512         # kMaxC
MAX_NOPE = 256           # 4 * 32 * kMaxKD
MAX_ROPE = 128           # one slice of 4 a lane
MAX_V = 256              # kMaxDv
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
EPS = 1e-6               # ``rms_norm_headwise``'s


def _last_pow2(n: int) -> int:
    return 1 << (max(1, int(n)).bit_length() - 1)


def torch_reduce_lanes(rows: int, n: int) -> Tuple[int, bool]:
    """(threads a row, vectorised) of PyTorch's CUDA reduction of a
    contiguous f32 ``[rows, n]`` tensor over its last dim
    (``ATen/native/cuda/Reduce.cuh``, ``setReduceConfig``): the order in
    which ``x.square().mean(-1)`` adds a row's squares on the card.  Raises
    where PyTorch would also split a row over warps or blocks, which the
    kernel does not reproduce."""
    vec = n >= 128
    dim0 = n // 4 if vec else n
    most = 512
    d0 = _last_pow2(dim0) if dim0 < most else most
    d1 = _last_pow2(rows) if rows < most else most
    width = min(d0, 32)
    height = min(d1, most // width)
    width = min(d0, most // height)
    if -(-n // width) >= min(height * 16, 256):
        raise ValueError(f"a [{rows}, {n}] mean splits each row over warps "
                         f"in PyTorch's reduction; the kernel sums one row "
                         f"on one block of lanes")
    return width, vec


@functools.lru_cache(maxsize=None)
def freq_table(dr: int, theta: float) -> np.ndarray:
    """The f32 rope frequencies ``ref.rope_freqs(dr, theta)``, made once
    per (width, theta) and kept on the host: the launch passes them by
    value among the kernel's arguments, so no copy to the card orders
    against any stream."""
    return np.ascontiguousarray(ref.rope_freqs(dr, theta), np.float32)


def _width(name: str, v: int, cap: int = 0) -> None:
    if v <= 0 or v % 8:
        raise ValueError(f"{name} = {v}: the kernels take widths that are "
                         f"positive multiples of 8")
    if cap and v > cap:
        raise ValueError(f"{name} = {v}: the kernel takes at most {cap}")


def _dtype(name: str, t: torch.Tensor, want) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype not in (want if isinstance(want, tuple) else (want,)):
        raise TypeError(f"{name}: expected {want}, got {t.dtype}")


def _shape(name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _on_card(named, aligned=()) -> torch.device:
    """Every operand contiguous, on one CUDA device; the `aligned` ones at
    16-byte addresses (the kernels' vector loads)."""
    dev = named[0][1].device
    for name, t in named:
        _build.require_cuda(t, t.dtype, name, dev)
    for name, t in named:
        if name in aligned and t.data_ptr() % 16:
            raise ValueError(f"{name}: must start at a 16-byte boundary")
    return dev


def rope_write(q: torch.Tensor, kv: torch.Tensor, kv_norm: torch.Tensor,
               positions: torch.Tensor, ckv: torch.Tensor,
               k_rope: torch.Tensor, *, n_heads: int,
               rope_theta: float) -> torch.Tensor:  # hot-path
    """q [B, 1, H (Dn + Dr)], kv [B, 1, C + Dr] (bf16 or f32), kv_norm [C]
    f32, positions [B] int64, the latent cache ckv [B, T, C] and k_rope
    [B, T, Dr] (q's dtype) -> the rotated q_rope [B, 1, H, Dr]; the new
    latent and rope key written at ``(b, positions[b])`` in place.  One
    launch."""
    _dtype("q", q, (torch.bfloat16, torch.float32))
    for name, t in (("kv", kv), ("ckv", ckv), ("k_rope", k_rope)):
        _dtype(name, t, q.dtype)
    _dtype("kv_norm", kv_norm, torch.float32)
    _dtype("positions", positions, torch.int64)
    if ckv.dim() != 3 or k_rope.dim() != 3:
        raise ValueError(f"ckv {tuple(ckv.shape)} and k_rope "
                         f"{tuple(k_rope.shape)}: expected [B, T, width]")
    B, T, C = ckv.shape
    Dr = k_rope.shape[-1]
    H = int(n_heads)
    _width("the latent width", C)
    _width("the rope width", Dr, MAX_ROPE)
    if H <= 0 or q.dim() != 3 or q.shape[-1] % H:
        raise ValueError(f"q {tuple(q.shape)}: expected [B, 1, {H} x head "
                         f"width]")
    Dn = q.shape[-1] // H - Dr
    _width("the nope width", Dn)
    _shape("q", q, (B, 1, H * (Dn + Dr)))
    _shape("kv", kv, (B, 1, C + Dr))
    _shape("k_rope", k_rope, (B, T, Dr))
    _shape("kv_norm", kv_norm, (C,))
    _shape("positions", positions, (B,))
    lanes, vec = torch_reduce_lanes(B, C)
    dev = _on_card((("q", q), ("kv", kv), ("kv_norm", kv_norm),
                    ("positions", positions), ("ckv", ckv),
                    ("k_rope", k_rope)))
    q_rope = torch.empty((B, 1, H, Dr), dtype=q.dtype, device=dev)
    if B == 0:
        return q_rope
    freqs = freq_table(int(Dr), float(rope_theta))
    factor = float(np.float32(1.0) / np.float32(C))   # PyTorch's MeanOps
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.zipmoe_mla_rope_write(
            q.data_ptr(), kv.data_ptr(), kv_norm.data_ptr(),
            freqs.ctypes.data, positions.data_ptr(), ckv.data_ptr(),
            k_rope.data_ptr(), q_rope.data_ptr(), B, H, Dn, Dr, C, T, lanes,
            int(vec), factor, EPS, _DTYPES[q.dtype], stream)
    _build.check(rc, "zipmoe_mla_rope_write")
    _build.count_launch("mla_rope_write")
    return q_rope


def absorbed_attend(q: torch.Tensor, q_rope: torch.Tensor,
                    wkv_b: torch.Tensor, ckv: torch.Tensor,
                    k_rope: torch.Tensor, positions: torch.Tensor, *,
                    n_heads: int, v_head_dim: int,
                    scale: float) -> torch.Tensor:  # hot-path
    """q [B, 1, H (Dn + Dr)] (its nope part is read), the rotated q_rope
    [B, 1, H, Dr], wkv_b [C, H (Dn + Dv)] (columns [H, Dn + Dv]), the
    latent cache ckv [B, T, C] and k_rope [B, T, Dr], positions [B] int64
    -> [B, 1, H * Dv] in q's dtype: row b attends over ``t <=
    positions[b]``.  One launch."""
    _dtype("q", q, (torch.bfloat16, torch.float32))
    for name, t in (("q_rope", q_rope), ("wkv_b", wkv_b), ("ckv", ckv),
                    ("k_rope", k_rope)):
        _dtype(name, t, q.dtype)
    _dtype("positions", positions, torch.int64)
    if ckv.dim() != 3 or k_rope.dim() != 3:
        raise ValueError(f"ckv {tuple(ckv.shape)} and k_rope "
                         f"{tuple(k_rope.shape)}: expected [B, T, width]")
    B, T, C = ckv.shape
    Dr = k_rope.shape[-1]
    H, Dv = int(n_heads), int(v_head_dim)
    _width("the latent width", C, MAX_LATENT)
    _width("the rope width", Dr, MAX_ROPE)
    _width("the value width", Dv, MAX_V)
    if H <= 0 or q.dim() != 3 or q.shape[-1] % H:
        raise ValueError(f"q {tuple(q.shape)}: expected [B, 1, {H} x head "
                         f"width]")
    Dn = q.shape[-1] // H - Dr
    _width("the nope width", Dn, MAX_NOPE)
    _shape("q", q, (B, 1, H * (Dn + Dr)))
    _shape("q_rope", q_rope, (B, 1, H, Dr))
    _shape("wkv_b", wkv_b, (C, H * (Dn + Dv)))
    _shape("k_rope", k_rope, (B, T, Dr))
    _shape("positions", positions, (B,))
    dev = _on_card((("q", q), ("q_rope", q_rope), ("wkv_b", wkv_b),
                    ("ckv", ckv), ("k_rope", k_rope),
                    ("positions", positions)),
                   aligned=("wkv_b", "ckv", "k_rope"))
    out = torch.empty((B, 1, H * Dv), dtype=q.dtype, device=dev)
    if B == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.zipmoe_mla_absorbed_attend(
            q.data_ptr(), q_rope.data_ptr(), wkv_b.data_ptr(),
            ckv.data_ptr(), k_rope.data_ptr(), positions.data_ptr(),
            out.data_ptr(), B, H, Dn, Dr, Dv, C, T, float(scale),
            _DTYPES[q.dtype], stream)
    _build.check(rc, "zipmoe_mla_absorbed_attend")
    _build.count_launch("mla_absorbed_attend")
    return out
