"""Plain PyTorch versions of the port's kernels.

``kernels/ops.py`` runs these for CPU tensors; ``chip_smoke.py`` and the
tests hold each CUDA kernel against them on the same inputs.  They repeat
the kernels' arithmetic and are no yardstick of speed.  The rotary
embedding, the head-wise RMS norm and the score mask live here, below the
models that use them too, since the plain MLA decode is built from them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitfield

NEG_INF = -1e30


def rope_freqs(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x, positions, theta):
    """x: [..., S, H, D]; positions: [..., S] int."""
    d = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(d, theta).astype(np.float32)).to(
        x.device)                                             # [D/2]
    angles = positions[..., None].float() * freqs             # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                     # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rms_norm_headwise(scale, x, eps=1e-6):
    """qk-norm: RMSNorm over the last (head) dim."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


def where_mask(sc, mask):
    """`sc` where `mask` holds, NEG_INF elsewhere."""
    return torch.where(mask, sc, torch.tensor(NEG_INF, dtype=sc.dtype,
                                              device=sc.device))


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


def mla_rope_write_ref(q: torch.Tensor, kv: torch.Tensor,
                       kv_norm: torch.Tensor, positions: torch.Tensor,
                       ckv: torch.Tensor, k_rope: torch.Tensor, *,
                       n_heads: int, rope_theta: float) -> torch.Tensor:
    """MLA decode's query and latent side: q [B, 1, H (Dn + Dr)] and kv
    [B, 1, C + Dr] (the ``wq`` and ``wkv_a`` products); rotates q's rope
    part at each row's position, norms the new latent with the f32
    ``kv_norm`` and rotates the rope key (``_mla_kv_latent``), writes both
    at ``(b, positions[b])`` of the latent cache ckv [B, T, C] / k_rope
    [B, T, Dr] in place, and returns the rotated q_rope [B, 1, H, Dr]."""
    B = q.shape[0]
    C, Dr = ckv.shape[-1], k_rope.shape[-1]
    posv = positions[:, None]
    q_rope = apply_rope(q.reshape(B, 1, n_heads, -1)[..., -Dr:], posv,
                        rope_theta)
    ckv_new, k_rope_new = kv.split([C, Dr], dim=-1)
    ckv_new = rms_norm_headwise(kv_norm, ckv_new)
    k_rope_new = apply_rope(k_rope_new[:, :, None, :], posv,
                            rope_theta)[:, :, 0, :]
    rows = torch.arange(B, device=q.device)
    ckv[rows, positions] = ckv_new[:, 0]
    k_rope[rows, positions] = k_rope_new[:, 0]
    return q_rope


def mla_absorbed_attend_ref(q: torch.Tensor, q_rope: torch.Tensor,
                            wkv_b: torch.Tensor, ckv: torch.Tensor,
                            k_rope: torch.Tensor, positions: torch.Tensor, *,
                            n_heads: int, v_head_dim: int,
                            scale: float) -> torch.Tensor:
    """MLA decode's absorbed attention: q_nope (q [B, 1, H (Dn + Dr)] less
    its rope part) through the key half of ``wkv_b`` [C, H (Dn + Dv)], f32
    scores over the latent cache ckv [B, T, C] plus the rotated q_rope
    [B, 1, H, Dr] against k_rope [B, T, Dr], times `scale`, row b over
    ``t <= positions[b]``; f32 softmax and weighted sum over the latent,
    then the value half of ``wkv_b``, rounded once to q's dtype ->
    [B, 1, H * Dv]."""
    B, T, C = ckv.shape
    Dr = k_rope.shape[-1]
    q_nope = q.reshape(B, 1, n_heads, -1)[..., :-Dr]
    Dn = q_nope.shape[-1]
    wkv = wkv_b.reshape(C, n_heads, Dn + v_head_dim).float()
    w_k, w_v = wkv[:, :, :Dn], wkv[:, :, Dn:]
    q_c = torch.einsum("bshd,chd->bshc", q_nope.float(), w_k)
    qr, kr, cf = q_rope.float(), k_rope.float(), ckv.float()
    sc = (torch.einsum("bshc,btc->bhst", q_c, cf)
          + torch.einsum("bshd,btd->bhst", qr, kr)) * scale
    mask = (torch.arange(T, device=ckv.device)[None, :]
            <= positions[:, None])[:, None, None]             # [B,1,1,T]
    attn = torch.softmax(where_mask(sc, mask), dim=-1)
    o_c = torch.einsum("bhst,btc->bshc", attn, cf)
    out = torch.einsum("bshc,chd->bshd", o_c, w_v)
    return out.to(q.dtype).reshape(B, 1, n_heads * v_head_dim)
