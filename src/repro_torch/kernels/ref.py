"""Plain PyTorch versions of the port's kernels.

``kernels/ops.py`` runs these for CPU tensors; ``chip_smoke.py`` and the
tests hold each CUDA kernel against them on the same inputs.  They repeat
the kernels' arithmetic and are no yardstick of speed.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitfield


def recover_bf16_ref(exp: torch.Tensor, sm: torch.Tensor) -> torch.Tensor:
    """Bit-splice: (exp u8, sm u8) -> bf16, elementwise.

    bf16 layout: s eeeeeeee mmmmmmm.  sm packs the sign in bit 7 and the
    7 mantissa bits in bits 0..6.
    """
    return bitfield.reconstruct(exp, sm)


def decompose_bf16_ref(x: torch.Tensor):
    """Inverse splice (used by tests): bf16 -> (exp u8, sm u8) of x's shape."""
    exp, sm = bitfield.decompose(x)
    return exp.reshape(x.shape), sm.reshape(x.shape)


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped expert GEMM: x [E, C, d] @ w [E, d, f] -> [E, C, f], summed
    in f32 and rounded once to x's dtype.  (On the CPU, f32 ``bmm`` gives
    each row the same bits whether the rows ride as [E, C] or as the ragged
    GEMM's 8-row tiles; tests/test_torch_grouped.py pins grouped ≡ ragged
    end to end.)"""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def zip_gemm_grouped_ref(x: torch.Tensor, exp: torch.Tensor,
                         sm: torch.Tensor) -> torch.Tensor:
    """Batched fused recovery + GEMM: splice the u8 planes [E, d, f], then
    the grouped GEMM."""
    return moe_gemm_ref(x, recover_bf16_ref(exp, sm))


def slab_gemm_ref(x: torch.Tensor, buf: torch.Tensor, tile_slot,
                  block_c: int = 8) -> torch.Tensor:
    """Slot-indexed ragged grouped GEMM: per token tile of ``block_c`` rows,
    multiply against the slab row named by the tile's slot, in f32.
    x: [T, d]; buf: [capacity, d, f]; tile_slot: [T // block_c]."""
    T, d = x.shape
    ts = torch.as_tensor(tile_slot, dtype=torch.long, device=buf.device)
    xt = x.reshape(T // block_c, block_c, d).float()
    wt = buf.index_select(0, ts).float()
    out = torch.bmm(xt, wt)
    return out.to(x.dtype).reshape(T, -1)


def splice_admit_ref(buf: torch.Tensor, exp: torch.Tensor, sm: torch.Tensor,
                     slot: int) -> torch.Tensor:
    """Fused splice + slab write: a copy of ``buf`` with slot `slot`
    replaced by the spliced bf16 tensor, every other slot byte-preserved."""
    out = buf.clone()
    out[int(slot)] = recover_bf16_ref(exp, sm).reshape(buf.shape[1:])
    return out
