"""Public entry points of the port's kernels, dispatched by the tensor's
device.

A CPU tensor takes the plain PyTorch version in ``kernels/ref.py``; a CUDA
tensor takes the hand-written kernel or an exception — there is no silent
plain path on the card and no ``try`` that falls back.  A tensor on the
meta device (the dry run's shape pass, ``launch/dryrun.py``) takes the
plain version too, which there computes shapes and nothing else.  Any
other device raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitfield
from repro_torch.kernels import mla_decode, moe_gemm, recovery, ref


def _on_cuda(t: torch.Tensor, *others: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU (or meta) ones; mixed devices
    raise."""
    for o in others:
        if o.device != t.device:
            raise ValueError(f"operands on {t.device} and {o.device}")
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
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


def recover_bf16_host(exp_np, sm_np, shape, device) -> np.ndarray:
    """Host planes in, host bf16 BITS (uint16 ndarray) out, spliced on
    `device` (the kernel on the card).  Pays a download; only for consumers
    that need a host array — the grouped GEMM uses
    :func:`recover_bf16_device`."""
    return bitfield.to_bits(recover_bf16_device(exp_np, sm_np, shape,
                                                device))


def grouped_expert_gemm(x: torch.Tensor, w: torch.Tensor
                        ) -> torch.Tensor:  # hot-path
    """Padded grouped expert GEMM: x [E, C, d] @ w [E, d, f] -> [E, C, f],
    f32 accumulation (C a multiple of 8 on the card)."""
    if _on_cuda(x, w):
        return moe_gemm.grouped_gemm(x, w)
    return ref.moe_gemm_ref(x, w)


def zip_gemm_batch(x: torch.Tensor, exp: torch.Tensor, sm: torch.Tensor
                   ) -> torch.Tensor:  # hot-path
    """Batched fused recovery + GEMM over every active expert of a step:
    x [E, C, d] against u8 bit-planes exp/sm [E, d, f] -> [E, C, f].  One
    launch replaces :func:`fused_zip_gemm`'s per-expert loop."""
    if _on_cuda(x, exp, sm):
        return moe_gemm.zip_gemm_grouped(x, exp, sm)
    return ref.zip_gemm_grouped_ref(x, exp, sm)


def fused_zip_gemm(x: torch.Tensor, exp: torch.Tensor, sm: torch.Tensor
                   ) -> torch.Tensor:
    """Fused recovery + GEMM for one expert: x [C, d] against planes
    exp/sm [d, f] -> [C, f]; bit-equal to :func:`zip_gemm_batch` on the
    same expert."""
    if _on_cuda(x, exp, sm):
        return moe_gemm.zip_gemm(x, exp, sm)
    return ref.zip_gemm_grouped_ref(x[None], exp[None], sm[None])[0]


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


def mla_rope_write(q: torch.Tensor, kv: torch.Tensor, kv_norm: torch.Tensor,
                   positions: torch.Tensor, ckv: torch.Tensor,
                   k_rope: torch.Tensor, *, n_heads: int,
                   rope_theta: float) -> torch.Tensor:  # hot-path
    """MLA decode's query and latent side: q [B, 1, H (Dn + Dr)], kv
    [B, 1, C + Dr] -> the rotated q_rope [B, 1, H, Dr]; the new latent
    (normed by ``kv_norm``) and rope key written into ckv [B, T, C] and
    k_rope [B, T, Dr] at ``(b, positions[b])`` in place."""
    if _on_cuda(q, kv, kv_norm, positions, ckv, k_rope):
        return mla_decode.rope_write(q, kv, kv_norm, positions, ckv, k_rope,
                                     n_heads=n_heads, rope_theta=rope_theta)
    return ref.mla_rope_write_ref(q, kv, kv_norm, positions, ckv, k_rope,
                                  n_heads=n_heads, rope_theta=rope_theta)


def mla_absorbed_attend(q: torch.Tensor, q_rope: torch.Tensor,
                        wkv_b: torch.Tensor, ckv: torch.Tensor,
                        k_rope: torch.Tensor, positions: torch.Tensor, *,
                        n_heads: int, v_head_dim: int,
                        scale: float) -> torch.Tensor:  # hot-path
    """MLA decode's absorbed attention over the latent cache, row b over
    ``t <= positions[b]``: [B, 1, H * Dv] in q's dtype, ready for
    ``wo``."""
    if _on_cuda(q, q_rope, wkv_b, ckv, k_rope, positions):
        return mla_decode.absorbed_attend(
            q, q_rope, wkv_b, ckv, k_rope, positions, n_heads=n_heads,
            v_head_dim=v_head_dim, scale=scale)
    return ref.mla_absorbed_attend_ref(
        q, q_rope, wkv_b, ckv, k_rope, positions, n_heads=n_heads,
        v_head_dim=v_head_dim, scale=scale)
