"""Public entry points of the port's kernels, dispatched by the tensor's
device.

A CPU tensor takes the plain PyTorch version in ``kernels/ref.py``; a CUDA
tensor takes the hand-written kernel or an exception — there is no silent
plain path on the card and no ``try`` that falls back.  Any other device
raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import moe_gemm, recovery, ref


def _on_cuda(t: torch.Tensor, *others: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU ones; mixed devices raise."""
    for o in others:
        if o.device != t.device:
            raise ValueError(f"operands on {t.device} and {o.device}")
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def bucket_rows(n: int, align: int = 8) -> int:
    """Token-count shape bucket: the next power of two up to 128, then the
    next 128-multiple.  Decode-step token counts drift every step; padding
    each per-expert group (or the padded-path column count) to a fixed rung
    instead of its exact size keeps the set of GEMM shapes to a handful.
    `align` floors the rung."""
    n = max(int(n), align)
    if n <= 128:
        b = align
        while b < n:
            b *= 2
        return b
    return -(-n // 128) * 128


def recover_bf16(exp: torch.Tensor, sm: torch.Tensor, shape) -> torch.Tensor:
    """u8 planes (any shape, same numel) -> bf16 tensor of `shape`."""
    if _on_cuda(exp, sm):
        return recovery.recover_bf16(exp.reshape(-1), sm.reshape(-1)
                                     ).reshape(tuple(shape))
    return ref.recover_bf16_ref(exp.reshape(-1), sm.reshape(-1)
                                ).reshape(tuple(shape))


def splice_planes_device(exp: torch.Tensor, sm: torch.Tensor, shape
                         ) -> torch.Tensor:
    """Standalone splice of ALREADY-uploaded device planes (the fused-admit
    fallback when no slab slot is available): device bf16 out, no h2d."""
    return recover_bf16(exp, sm, shape)


def host_u8(x) -> torch.Tensor:
    """Host plane (bytes or u8 ndarray) -> CPU u8 tensor, copying only a
    read-only buffer (torch tensors must be writable)."""
    arr = np.frombuffer(x, np.uint8) if isinstance(x, (bytes, bytearray)) \
        else np.asarray(x, np.uint8)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr.reshape(-1))


def recover_bf16_device(exp_np, sm_np, shape, device) -> torch.Tensor:
    """Engine hook: host planes in, **device** bf16 out.  Uploads the two u8
    planes once and splices on `device`, leaving the bf16 tensor there for
    the GEMM (or a slab write) to consume — no download."""
    exp = host_u8(exp_np).to(device)
    sm = host_u8(sm_np).to(device)
    return recover_bf16(exp, sm, shape)


def slab_gemm(x: torch.Tensor, buf: torch.Tensor, tile_slot, *,
              block_c: int = 8) -> torch.Tensor:  # hot-path
    """Slot-indexed ragged grouped GEMM against the whole slab buffer.

    x: [T, d] (tokens CSR-grouped by expert, each group padded to a
    ``block_c`` multiple); buf: [capacity, d, f] — the per-layer
    ``DeviceSlabCache`` buffer read IN PLACE (or a stacked weight batch,
    with ``tile_slot`` indexing stack rows); tile_slot: host int32
    [T // block_c]."""
    if _on_cuda(x, buf):
        if block_c != moe_gemm.BLOCK_C:
            raise ValueError(f"the CUDA kernel takes {moe_gemm.BLOCK_C}-row "
                             f"tiles, got block_c={block_c}")
        return moe_gemm.slab_ragged_gemm(x, buf, tile_slot)
    return ref.slab_gemm_ref(x, buf, tile_slot, block_c=block_c)


def slab_splice_set(buf: torch.Tensor, slot: int, exp: torch.Tensor,
                    sm: torch.Tensor) -> torch.Tensor:
    """Fused splice-admit: write splice(exp, sm) into ``buf[slot]`` in place
    (one kernel launch on the card) and return `buf` — a demand miss warms
    the slab as a side effect of its recovery."""
    if _on_cuda(buf, exp, sm):
        return moe_gemm.slab_splice_admit(buf, exp, sm, slot)
    buf[int(slot)] = ref.recover_bf16_ref(exp.reshape(-1), sm.reshape(-1)
                                          ).reshape(buf.shape[1:])
    return buf
