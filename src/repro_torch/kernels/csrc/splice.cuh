// The ZipMoE bit splice on the GPU: (exp u8, sm u8) -> bf16 bits.
//
// bf16 layout ``s eeeeeeee mmmmmmm``; the sign-mantissa plane packs the sign
// in bit 7 and the 7 mantissa bits in bits 0..6.  This header plays the role
// ``splice_bf16`` (src/repro/kernels/recovery.py:26) plays in the JAX
// package: every kernel that recovers weights (the standalone splice, the
// slab splice-admit, and the fused splice+GEMM kernels) includes it, so the
// bit semantics live in one place.
#pragma once

#include <cstdint>

namespace zipmoe {

__device__ __forceinline__ uint32_t splice_bits(uint32_t e, uint32_t s) {
  return ((s & 0x80u) << 8) | (e << 7) | (s & 0x7Fu);
}

// Four elements packed little-endian in one 32-bit word of each plane ->
// four bf16 values packed in two 32-bit words.
__device__ __forceinline__ void splice4(uint32_t e4, uint32_t s4, uint32_t& lo,
                                        uint32_t& hi) {
  lo = splice_bits(e4 & 0xFFu, s4 & 0xFFu) |
       (splice_bits((e4 >> 8) & 0xFFu, (s4 >> 8) & 0xFFu) << 16);
  hi = splice_bits((e4 >> 16) & 0xFFu, (s4 >> 16) & 0xFFu) |
       (splice_bits(e4 >> 24, s4 >> 24) << 16);
}

// ---------------------------------------------------------------------------
// The one streaming body of the standalone splice (recovery.cu) and the slab
// splice-admit (moe_gemm.cu): out[i] = splice(exp[i], sm[i]) for i in
// [0, n).  Bound: bytes, 2 B read and 2 B written per element.  At the
// served [2048, 1408] (11.53 MB) the bytes alone take 3.44 us at 3.35 TB/s,
// and an empty kernel launched back to back already takes 2.0-2.2 us (NVIDIA
// H100 80GB HBM3 at 700 W, chip_smoke.py phase 2), so what the body
// controls is how soon every byte is requested and how few requests carry
// it:
//
// * Each thread takes kSpliceSteps steps of 8 elements, a block's steps
//   interleaved by thread, and issues every load before any store: per
//   step 8 B of each plane, so one warp load reads a contiguous 256-byte
//   run of a plane, and one 16-byte store of bf16, so one warp store writes
//   a contiguous 512-byte run in full 32-byte sectors.
// * Every byte is touched once: the planes are loaded with
//   ``ld.global.nc.L1::no_allocate`` (read-only, no L1 line), the bf16
//   output is stored with ``st.global.cs`` (streaming: its L2 lines are the
//   first evicted).  A slab slot is cold in the L2, and under the default
//   store policy its writes made the splice-admit as slow as a plain copy
//   into the same slots; on the served path the output's consumer (the
//   stacked weight copy, the ragged GEMM on the slot) reads it only after
//   the rest of the layer's experts have been spliced, hundreds of MB
//   later, so keeping it in the L2 buys nothing there.
// * The grid covers the work once (splice_grid: 704 blocks at the served
//   shape) and needs no SM count; the block loop strides by the grid only
//   past 2^31 - 1 blocks.
// * The vector steps need exp and sm 8-byte aligned and out 16-byte
//   aligned.  Otherwise (a view at any offset, or a slab slot of odd d * f)
//   every element, and always the n % 8 tail, goes element by element, so
//   any flat length and any alignment of each pointer is taken.
constexpr int kSpliceThreads = 256;
constexpr int kSpliceSteps = 2;
constexpr long long kSpliceTile = kSpliceThreads * kSpliceSteps;   // steps

__device__ __forceinline__ uint2 load_once(const uint8_t* p) {
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void store_once(uint16_t* p, const uint4& v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void splice_range(const uint8_t* __restrict__ exp,
                                             const uint8_t* __restrict__ sm,
                                             uint16_t* __restrict__ out,
                                             long long n) {
  const bool vec = ((reinterpret_cast<uintptr_t>(exp) |
                     reinterpret_cast<uintptr_t>(sm)) & 7u) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
  const long long nv = vec ? n / 8 : 0;
  if (nv > 0) {
    const long long tiles = (nv + kSpliceTile - 1) / kSpliceTile;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long first = t * kSpliceTile + threadIdx.x;
      uint2 e[kSpliceSteps], s[kSpliceSteps];
#pragma unroll
      for (int u = 0; u < kSpliceSteps; ++u) {
        const long long i = first + u * kSpliceThreads;
        if (i < nv) {
          e[u] = load_once(exp + 8 * i);
          s[u] = load_once(sm + 8 * i);
        }
      }
#pragma unroll
      for (int u = 0; u < kSpliceSteps; ++u) {
        const long long i = first + u * kSpliceThreads;
        if (i < nv) {
          uint4 o;
          splice4(e[u].x, s[u].x, o.x, o.y);
          splice4(e[u].y, s[u].y, o.z, o.w);
          store_once(out + 8 * i, o);
        }
      }
    }
  }
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = nv * 8 + tid; i < n; i += stride) {
    out[i] = static_cast<uint16_t>(splice_bits(exp[i], sm[i]));
  }
}

// Blocks of kSpliceThreads for splice_range over n elements: one per tile
// of kSpliceTile 8-element steps, so one pass covers the work.
inline int splice_grid(long long n) {
  const long long blocks = (n + 8 * kSpliceTile - 1) / (8 * kSpliceTile);
  return static_cast<int>(blocks < 1 ? 1 : blocks > 0x7FFFFFFF ? 0x7FFFFFFF
                                                               : blocks);
}

}  // namespace zipmoe
