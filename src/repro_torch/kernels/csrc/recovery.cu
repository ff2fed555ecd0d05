// Standalone bf16 recovery: splice two u8 bit-planes into a bf16 tensor.
//
// Replaces the Pallas kernel ``recover_bf16_2d`` (src/repro/kernels/
// recovery.py:44, body ``_recover_kernel``), which the JAX package runs on
// 256x512 tiles after padding the flat planes (kernels/ops.py:57-66).
//
// Bound on the H100: bytes.  It reads 2 B and writes 2 B per element and
// does three integer ops on them, far below the ~295 operations per byte
// where the card stops being memory-bound.  Design: a grid-stride loop in
// which each thread moves 16 B of each plane in and 32 B of bf16 out per
// step (coalesced 16-byte accesses), over any flat length with an
// element-wise tail, so no tile padding is needed.  The grid is capped so a
// block does several steps and launch overhead stays small.
#include <cuda_runtime.h>

#include "splice.cuh"

__global__ void __launch_bounds__(256)
    zipmoe_splice_kernel(const uint8_t* __restrict__ exp,
                         const uint8_t* __restrict__ sm,
                         uint16_t* __restrict__ out, long long n) {
  zipmoe::splice_range(exp, sm, out, n);
}

extern "C" int zipmoe_splice(const void* exp, const void* sm, void* out,
                             long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  zipmoe_splice_kernel<<<zipmoe::splice_grid(n, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(exp), static_cast<const uint8_t*>(sm),
      static_cast<uint16_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
