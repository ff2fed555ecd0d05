"""Expert compute for the H100 as hand-written CUDA kernels
(``csrc/moe_gemm.cu``), one tiled GEMM body with four weight sources plus
the slab splice-admit:

* ``slab_ragged_gemm`` — x [T, d] (tokens CSR-concatenated by expert, each
  group padded to an 8-row tile) against the WHOLE per-layer slab
  ``[capacity, d, f]``; each tile's weights are read in place from its
  expert's slot, named by ``tile_slot`` — no gather copy of the active
  experts.  Replaces the JAX package's Pallas ``slab_ragged_gemm``.
* ``grouped_gemm`` — the padded batch x [E, C, d] @ w [E, d, f].  Replaces
  the Pallas ``grouped_gemm``.
* ``zip_gemm_grouped`` / ``zip_gemm`` — fused recovery + GEMM: the weights
  arrive as the two u8 bit-planes and are spliced to bf16 in registers
  inside the GEMM, for every active expert at once ([E, C, d] against
  planes [E, d, f]) or for one expert ([C, d] against [d, f], the batched
  kernel at E = 1).  Replace the Pallas ``zip_gemm_grouped`` and
  ``zip_gemm``.
* ``slab_splice_admit`` — splice two u8 bit-planes straight into
  ``buf[slot]`` in one launch: a demand miss warms the slab as a side
  effect of its recovery.  The write goes through the slab's own pointer,
  so it is in place (``buf.data_ptr()`` never changes) and every other slot
  keeps its bytes.  Replaces the JAX package's aliased
  ``slab_splice_admit``.

Every GEMM output element is one f32 sum in ascending k, so a row's result
depends on its own inputs only: the ragged and grouped GEMMs agree bit for
bit, and so do the batched and per-expert fused ones.

These wrappers take CUDA tensors only and raise on anything else; call them
through ``kernels/ops.py``, which runs the plain versions
(``kernels/ref.py``) for CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

BLOCK_C = 8      # token rows per tile, fixed by the kernel


def _check_rows(rows: int, f: int, what: str) -> None:
    """Shapes the tiled GEMM takes: whole 8-row tiles and 8-column
    weight vectors."""
    if rows % BLOCK_C:
        raise ValueError(f"{what}: {rows} rows is not a multiple of the "
                         f"{BLOCK_C}-row tile")
    if f % 8:
        raise ValueError(f"{what}: the kernel reads weights 8 columns at a "
                         f"time; f={f} must be a multiple of 8")


def _launch(name: str, fn, *args, device) -> None:
    """Launch one kernel on `device`'s current stream, raise on a refused
    launch, and count it."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"zipmoe_{name}")
    _build.LAUNCHES[name] += 1


def slab_ragged_gemm(x: torch.Tensor, buf: torch.Tensor,
                     tile_slot) -> torch.Tensor:  # hot-path
    """x: [T, d] bf16 CUDA (T a multiple of 8); buf: [capacity, d, f] bf16
    CUDA, f a multiple of 8; tile_slot: host int array [T // 8] of slots in
    [0, capacity).
    Returns x @ buf[slot-of-tile] -> [T, f] bf16 with f32 accumulation."""
    _build.require_cuda(x, torch.bfloat16, "x")
    _build.require_cuda(buf, torch.bfloat16, "buf", x.device)
    if x.dim() != 2 or buf.dim() != 3:
        raise ValueError(f"x must be [T, d] and buf [cap, d, f]; got "
                         f"{tuple(x.shape)}, {tuple(buf.shape)}")
    T, d = x.shape
    cap, d_w, f = buf.shape
    if d_w != d:
        raise ValueError(f"contraction mismatch: x d={d}, buf d={d_w}")
    if T % BLOCK_C:
        raise ValueError(f"T={T} is not a multiple of the {BLOCK_C}-row tile")
    if f % 8 or buf.data_ptr() % 16:
        raise ValueError(f"the kernel reads weights in 16-byte loads: f={f} "
                         f"must be a multiple of 8 and buf 16-byte aligned")
    if isinstance(tile_slot, torch.Tensor):
        if tile_slot.device.type != "cpu":
            raise ValueError("tile_slot must be on the host, so its slots "
                             "can be range-checked before launch")
        tile_slot = tile_slot.numpy()
    # host-sync-ok: host slot vector, validated before upload
    ts = np.ascontiguousarray(tile_slot, dtype=np.int32)
    if ts.shape != (T // BLOCK_C,):
        raise ValueError(f"tile_slot shape {ts.shape}, expected "
                         f"({T // BLOCK_C},)")
    if ts.size and (ts.min() < 0 or ts.max() >= cap):
        raise ValueError(f"tile_slot out of range [0, {cap})")
    out = torch.empty((T, f), dtype=torch.bfloat16, device=x.device)
    if T == 0 or f == 0:            # nothing to launch, nothing to count
        return out
    ts_d = torch.from_numpy(ts).to(x.device)
    _launch("slab_gemm", _build.library().zipmoe_slab_gemm, x.data_ptr(),
            buf.data_ptr(), ts_d.data_ptr(), out.data_ptr(), T // BLOCK_C,
            d, f, d * f, device=x.device)
    return out


def grouped_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:  # hot-path
    """x: [E, C, d] bf16 CUDA (C a multiple of 8); w: [E, d, f] bf16 CUDA,
    f a multiple of 8, 16-byte aligned.
    Returns x @ w -> [E, C, f] bf16 with f32 accumulation."""
    _build.require_cuda(x, torch.bfloat16, "x")
    _build.require_cuda(w, torch.bfloat16, "w", x.device)
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x must be [E, C, d] and w [E, d, f]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    E, C, d = x.shape
    if w.shape[:2] != (E, d):
        raise ValueError(f"w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    f = w.shape[2]
    _check_rows(C, f, "grouped_gemm")
    if w.data_ptr() % 16:
        raise ValueError("grouped_gemm: the kernel reads weights in 16-byte "
                         "loads; w must be 16-byte aligned")
    out = torch.empty((E, C, f), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:            # nothing to launch, nothing to count
        return out
    _launch("grouped_gemm", _build.library().zipmoe_grouped_gemm,
            x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f,
            device=x.device)
    return out


def _check_planes(x: torch.Tensor, exp: torch.Tensor, sm: torch.Tensor,
                  what: str) -> int:
    """Validate the fused kernels' operands; returns f."""
    _build.require_cuda(x, torch.bfloat16, "x")
    _build.require_cuda(exp, torch.uint8, "exp", x.device)
    _build.require_cuda(sm, torch.uint8, "sm", x.device)
    if exp.shape != sm.shape or exp.dim() != x.dim() \
            or exp.shape[:-1] != x.shape[:-2] + x.shape[-1:]:
        raise ValueError(f"{what}: planes {tuple(exp.shape)}/"
                         f"{tuple(sm.shape)} do not match x {tuple(x.shape)}")
    f = exp.shape[-1]
    _check_rows(x.shape[-2], f, what)
    if exp.data_ptr() % 8 or sm.data_ptr() % 8:
        raise ValueError(f"{what}: the kernel reads each plane in 8-byte "
                         f"loads; exp and sm must be 8-byte aligned")
    return f


def zip_gemm_grouped(x: torch.Tensor, exp: torch.Tensor,
                     sm: torch.Tensor) -> torch.Tensor:  # hot-path
    """Fused recovery + grouped GEMM: x [E, C, d] bf16 CUDA (C a multiple
    of 8) against the u8 bit-planes exp, sm [E, d, f] (f a multiple of 8,
    8-byte aligned) -> x @ splice(exp, sm) as [E, C, f] bf16.  No bf16
    weight is written to device memory."""
    if x.dim() != 3:
        raise ValueError(f"x must be [E, C, d], got {tuple(x.shape)}")
    f = _check_planes(x, exp, sm, "zip_gemm_grouped")
    E, C, d = x.shape
    out = torch.empty((E, C, f), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:            # nothing to launch, nothing to count
        return out
    _launch("zip_gemm_grouped", _build.library().zipmoe_zip_gemm_grouped,
            x.data_ptr(), exp.data_ptr(), sm.data_ptr(), out.data_ptr(), E,
            C, d, f, device=x.device)
    return out


def zip_gemm(x: torch.Tensor, exp: torch.Tensor,
             sm: torch.Tensor) -> torch.Tensor:
    """Fused recovery + GEMM for one expert: x [C, d] bf16 CUDA against
    planes exp, sm [d, f] -> [C, f] bf16; bit-equal to
    :func:`zip_gemm_grouped` on the same expert."""
    if x.dim() != 2:
        raise ValueError(f"x must be [C, d], got {tuple(x.shape)}")
    f = _check_planes(x, exp, sm, "zip_gemm")
    C, d = x.shape
    out = torch.empty((C, f), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:            # nothing to launch, nothing to count
        return out
    _launch("zip_gemm", _build.library().zipmoe_zip_gemm, x.data_ptr(),
            exp.data_ptr(), sm.data_ptr(), out.data_ptr(), C, d, f,
            device=x.device)
    return out


def slab_splice_admit(buf: torch.Tensor, exp: torch.Tensor, sm: torch.Tensor,
                      slot: int) -> torch.Tensor:
    """Write splice(exp, sm) into ``buf[slot]`` in place and return `buf`.
    buf: [capacity, *shape] bf16 CUDA; exp, sm: u8 CUDA planes holding one
    slot's elements (any shape)."""
    _build.require_cuda(buf, torch.bfloat16, "buf")
    _build.require_cuda(exp, torch.uint8, "exp", buf.device)
    _build.require_cuda(sm, torch.uint8, "sm", buf.device)
    if buf.dim() < 2:
        raise ValueError(f"buf must be [capacity, ...], got {tuple(buf.shape)}")
    cap = buf.shape[0]
    slot_elems = buf[0].numel()
    if exp.numel() != slot_elems or sm.numel() != slot_elems:
        raise ValueError(f"planes hold {exp.numel()}/{sm.numel()} elements, "
                         f"a slot {slot_elems}")
    slot = int(slot)
    if not 0 <= slot < cap:
        raise ValueError(f"slot {slot} out of range [0, {cap})")
    if slot_elems == 0:             # nothing to launch, nothing to count
        return buf
    _launch("splice_admit", _build.library().zipmoe_splice_admit,
            buf.data_ptr(), slot, slot_elems, exp.data_ptr(), sm.data_ptr(),
            device=buf.device)
    return buf
