// Standalone bf16 recovery: splice two u8 bit-planes into a bf16 tensor.
//
// Replaces the Pallas kernel ``recover_bf16_2d`` (src/repro/kernels/
// recovery.py:44, body ``_recover_kernel``), which the JAX package runs on
// 256x512 tiles after padding the flat planes (kernels/ops.py:57-66).
//
// Bound on the H100: bytes.  It reads 2 B and writes 2 B per element and
// does three integer ops on them, far below the ~295 operations per byte
// where the card stops being memory-bound.  The body is the streaming
// splice of splice.cuh (zipmoe::splice_range), shared with the slab
// splice-admit: 8 B of each plane per load and full 512-byte warp stores,
// two steps per thread with every load before any store, the planes and
// the output each touched once (no L1 line for the planes, streaming stores
// for the output), one pass of blocks over the work, and an element path
// for the tail and for misaligned pointers, so any flat length is taken
// without padding.
#include <cuda_runtime.h>

#include "splice.cuh"

__global__ void __launch_bounds__(zipmoe::kSpliceThreads)
    zipmoe_splice_kernel(const uint8_t* __restrict__ exp,
                         const uint8_t* __restrict__ sm,
                         uint16_t* __restrict__ out, long long n) {
  zipmoe::splice_range(exp, sm, out, n);
}

extern "C" int zipmoe_splice(const void* exp, const void* sm, void* out,
                             long long n, void* stream) {
  if (n <= 0) return 0;
  zipmoe_splice_kernel<<<zipmoe::splice_grid(n), zipmoe::kSpliceThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(exp), static_cast<const uint8_t*>(sm),
      static_cast<uint16_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
