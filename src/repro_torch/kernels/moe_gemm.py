"""Expert compute straight out of the device slab (the slot-indexed
megakernel family), as hand-written CUDA kernels for the H100
(``csrc/moe_gemm.cu``):

* ``slab_ragged_gemm`` — x [T, d] (tokens CSR-concatenated by expert, each
  group padded to an 8-row tile) against the WHOLE per-layer slab
  ``[capacity, d, f]``; each tile's weights are read in place from its
  expert's slot, named by ``tile_slot`` — no gather copy of the active
  experts.  Replaces the JAX package's Pallas ``slab_ragged_gemm``.
* ``slab_splice_admit`` — splice two u8 bit-planes straight into
  ``buf[slot]`` in one launch: a demand miss warms the slab as a side
  effect of its recovery.  The write goes through the slab's own pointer,
  so it is in place (``buf.data_ptr()`` never changes) and every other slot
  keeps its bytes.  Replaces the JAX package's aliased
  ``slab_splice_admit``.

These wrappers take CUDA tensors only and raise on anything else; call them
through ``kernels/ops.py``, which runs the plain versions
(``kernels/ref.py``) for CPU tensors.  The grouped GEMM and the fused
splice+GEMM kernels of the JAX package are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

BLOCK_C = 8      # token rows per tile, fixed by the kernel


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
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.zipmoe_slab_gemm(x.data_ptr(), buf.data_ptr(),
                                  ts_d.data_ptr(), out.data_ptr(),
                                  T // BLOCK_C, d, f, d * f, stream)
    _build.check(rc, "zipmoe_slab_gemm")
    _build.LAUNCHES["slab_gemm"] += 1
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
    lib = _build.library()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.zipmoe_splice_admit(buf.data_ptr(), slot, slot_elems,
                                     exp.data_ptr(), sm.data_ptr(), stream)
    _build.check(rc, "zipmoe_splice_admit")
    _build.LAUNCHES["splice_admit"] += 1
    return buf
