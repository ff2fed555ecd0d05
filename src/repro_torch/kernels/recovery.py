"""Memory-coalesced BF16 tensor recovery (§3.3) on the H100.

The paper's CUDA kernel streams SM-chunks and decompressed E-chunks through
registers with vectorized loads/stores so the bit splice runs at DRAM
bandwidth.  ``csrc/recovery.cu`` is that kernel, on the streaming body of
``csrc/splice.cuh`` that the slab splice-admit shares: 8 B of each u8 plane
in and 16 B of bf16 out per step, two steps per thread with every load
issued before any store, so each warp store writes one contiguous 512-byte
run; the planes are read without L1 lines and the output is stored
streaming, each byte touched once; one pass of blocks covers the work, and
an element path takes the tail and misaligned pointers, so any flat length
is taken without tile padding.  It replaces
the JAX package's Pallas ``recover_bf16_2d``; the bit rule lives in
``csrc/splice.cuh``.

``recover_bf16`` launches it for CUDA tensors only; ``kernels/ops.py``
dispatches, with ``kernels/ref.recover_bf16_ref`` as the plain version for
CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def recover_bf16(exp: torch.Tensor, sm: torch.Tensor) -> torch.Tensor:
    """Splice two u8 CUDA planes (any shape, same numel) into a flat bf16
    tensor."""
    _build.require_cuda(exp, torch.uint8, "exp")
    _build.require_cuda(sm, torch.uint8, "sm", exp.device)
    n = exp.numel()
    if sm.numel() != n:
        raise ValueError(f"plane sizes differ: exp {n}, sm {sm.numel()}")
    out = torch.empty(n, dtype=torch.bfloat16, device=exp.device)
    if n == 0:                      # nothing to launch, nothing to count
        return out
    lib = _build.library()
    with torch.cuda.device(exp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.zipmoe_splice(exp.data_ptr(), sm.data_ptr(), out.data_ptr(),
                               n, stream)
    _build.check(rc, "zipmoe_splice")
    _build.count_launch("splice")
    return out
