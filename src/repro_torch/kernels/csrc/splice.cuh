// The ZipMoE bit splice on the GPU: (exp u8, sm u8) -> bf16 bits.
//
// bf16 layout ``s eeeeeeee mmmmmmm``; the sign-mantissa plane packs the sign
// in bit 7 and the 7 mantissa bits in bits 0..6.  This header plays the role
// ``splice_bf16`` (src/repro/kernels/recovery.py:26) plays in the JAX
// package: every kernel that recovers weights (the standalone splice, the
// slab splice-admit, and later the fused splice+GEMM kernels) includes it,
// so the bit semantics live in one place.
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

// out[i] = splice(exp[i], sm[i]) for i in [0, n), grid-stride.  When all
// three pointers are 16-byte aligned each thread step loads 16 B of each
// plane and stores 32 B of bf16; whatever the vector loop leaves (the tail,
// or everything for unaligned pointers) goes element by element, so any
// flat length is taken without padding.
__device__ __forceinline__ void splice_range(const uint8_t* __restrict__ exp,
                                             const uint8_t* __restrict__ sm,
                                             uint16_t* __restrict__ out,
                                             long long n) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(exp) |
                     reinterpret_cast<uintptr_t>(sm) |
                     reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  long long done = 0;
  if (vec) {
    const long long nv = n / 16;
    const uint4* e16 = reinterpret_cast<const uint4*>(exp);
    const uint4* s16 = reinterpret_cast<const uint4*>(sm);
    uint4* o16 = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < nv; i += stride) {
      const uint4 e = __ldg(e16 + i);
      const uint4 s = __ldg(s16 + i);
      uint4 a, b;
      splice4(e.x, s.x, a.x, a.y);
      splice4(e.y, s.y, a.z, a.w);
      splice4(e.z, s.z, b.x, b.y);
      splice4(e.w, s.w, b.z, b.w);
      o16[2 * i] = a;
      o16[2 * i + 1] = b;
    }
    done = nv * 16;
  }
  for (long long i = done + tid; i < n; i += stride) {
    out[i] = static_cast<uint16_t>(splice_bits(exp[i], sm[i]));
  }
}

// Grid for a grid-stride pass over n elements, 16 per thread step: enough
// blocks to cover the work once, capped at 16 blocks per SM of an H100.
inline int splice_grid(long long n, int threads) {
  const long long steps = (n + 15) / 16;
  long long blocks = (steps + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return static_cast<int>(blocks);
}

}  // namespace zipmoe
