// Expert compute straight out of the device slab: the fused splice-admit and
// the slot-indexed ragged grouped GEMM.
//
// ---------------------------------------------------------------------------
// zipmoe_splice_admit_kernel replaces the Pallas kernel ``slab_splice_admit``
// (src/repro/kernels/moe_gemm.py:172, body ``_splice_admit_kernel`` :165).
// The TPU kernel aliases the donated slab buffer to its output so only the
// target slot is rewritten.  Here the slab is an ordinary device buffer: the
// kernel writes splice(exp, sm) through ``buf + slot * d * f``, with the slot
// a runtime int, so the write is in place by construction and every other
// slot keeps its bytes.  Bound: bytes (2 B in, 2 B out per element), the
// same grid-stride body as the standalone splice (splice.cuh).
//
// ---------------------------------------------------------------------------
// zipmoe_slab_gemm_kernel replaces the Pallas kernel ``slab_ragged_gemm``
// (src/repro/kernels/moe_gemm.py:123, body ``_slab_gemm_kernel`` :104):
// for each 8-row token tile i, out[i] = x[i] @ buf[tile_slot[i]] with f32
// accumulation.  The TPU grid walks (tile, f-block, d-block) in order and
// carries the sum in VMEM scratch, with the tile's slot scalar-prefetched
// into the weight BlockSpec's index map.  On Hopper, blocks run in parallel
// and in no order, so one block owns one (tile, 64-column block of f) pair
// for the whole contraction: it reads its own slot from device memory,
// loops over d in 64-row chunks, stages the x tile (as f32) and the weight
// block (as bf16, 16-byte loads) in shared memory, and keeps the 8 x 64
// partial sums in registers (4 per thread).  The next chunk is loaded into
// registers while the current one is multiplied, so loads stay in flight.
// Columns past f and rows past d are masked, so f need not be a multiple
// of 64 or a power of two; it must be a multiple of 8 and the slab 16-byte
// aligned, so every weight row is read in 16-byte loads (the C entry point
// returns cudaErrorInvalidValue otherwise, and the wrapper raises first).
//
// Bound on the H100: bytes.  Decode puts one to a few tokens on each
// expert, so each projection does 2 x 8 flops per weight element it reads
// (16 per 2 bytes), far below the ~295 operations per byte where the tensor
// cores would become the limit; the time is the active experts' weight
// bytes, about E_active x d x f x 2 B per projection, over the memory rate.
// This first version does the multiply-adds on CUDA cores (no wgmma/TMA)
// and reads an expert's weights once per token tile, not once per group;
// both are for later work.  Each output element is one f32 sum over k in
// ascending order (fmaf), which the grouped GEMM kernel must repeat so the
// ragged and grouped FFN paths stay bit-identical.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "splice.cuh"

namespace {

constexpr int kRows = 8;      // token rows per tile (block_c of the reference)
constexpr int kCols = 64;     // output columns per block
constexpr int kChunk = 64;    // contraction rows staged per iteration
constexpr int kThreads = 128;
constexpr int kRowsPerThread = kRows * kCols / kThreads;   // 4
constexpr int kXPerThread = kRows * kChunk / kThreads;     // 4
constexpr int kVecPerThread = kChunk * kCols / 8 / kThreads;  // 4 x 16 B

static_assert(kRowsPerThread * kThreads == kRows * kCols, "tile split");
static_assert(kCols % 8 == 0, "16-byte weight loads");

struct Stage {
  float x[kXPerThread];
  uint4 w[kVecPerThread];
};

__device__ __forceinline__ void load_stage(
    Stage& st, const __nv_bfloat16* __restrict__ xt,
    const __nv_bfloat16* __restrict__ w, int k0, int col0, int d, int f) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kXPerThread; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / kChunk, k = i % kChunk;
    st.x[j] = (k0 + k < d)
                  ? __bfloat162float(xt[static_cast<long long>(r) * d + k0 + k])
                  : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kVecPerThread; ++j) {
    const int i = tid + j * kThreads;
    const int k = i / (kCols / 8), c = (i % (kCols / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    // f % 8 == 0, so an 8-column group is wholly in or out
    if (k0 + k < d && col0 + c < f) {
      v = __ldg(reinterpret_cast<const uint4*>(
          w + static_cast<long long>(k0 + k) * f + col0 + c));
    }
    st.w[j] = v;
  }
}

__device__ __forceinline__ void store_stage(
    const Stage& st, float (*xs)[kChunk],
    unsigned short (*ws)[kCols]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kXPerThread; ++j) {
    const int i = tid + j * kThreads;
    xs[i / kChunk][i % kChunk] = st.x[j];
  }
#pragma unroll
  for (int j = 0; j < kVecPerThread; ++j) {
    const int i = tid + j * kThreads;
    const int k = i / (kCols / 8), c = (i % (kCols / 8)) * 8;
    *reinterpret_cast<uint4*>(&ws[k][c]) = st.w[j];
  }
}

__global__ void __launch_bounds__(kThreads) zipmoe_slab_gemm_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ buf,
    const int* __restrict__ tile_slot, __nv_bfloat16* __restrict__ out, int d,
    int f, long long slot_stride) {
  __shared__ float xs[kRows][kChunk];
  __shared__ __align__(16) unsigned short ws[kChunk][kCols];
  const int tile = blockIdx.y;
  const int col0 = blockIdx.x * kCols;
  const int tid = threadIdx.x;
  const int c = tid % kCols;
  const int r0 = (tid / kCols) * kRowsPerThread;
  // the slot-indexed read: this tile's weights come from slab row ts[tile]
  const long long slot = tile_slot[tile];
  const __nv_bfloat16* w = buf + slot * slot_stride;
  const __nv_bfloat16* xt = x + static_cast<long long>(tile) * kRows * d;

  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;

  Stage st;
  load_stage(st, xt, w, 0, col0, d, f);
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    store_stage(st, xs, ws);
    __syncthreads();
    if (k0 + kChunk < d) load_stage(st, xt, w, k0 + kChunk, col0, d, f);
    const int kn = min(kChunk, d - k0);
    for (int k = 0; k < kn; ++k) {
      const float wv = __bfloat162float(
          __ushort_as_bfloat16(ws[k][c]));
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        acc[r] = fmaf(xs[r0 + r][k], wv, acc[r]);
      }
    }
    __syncthreads();
  }
  if (col0 + c < f) {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const long long row = static_cast<long long>(tile) * kRows + r0 + r;
      out[row * f + col0 + c] = __float2bfloat16_rn(acc[r]);
    }
  }
}

__global__ void __launch_bounds__(256) zipmoe_splice_admit_kernel(
    uint16_t* __restrict__ buf, int slot, long long slot_elems,
    const uint8_t* __restrict__ exp, const uint8_t* __restrict__ sm) {
  zipmoe::splice_range(exp, sm, buf + static_cast<long long>(slot) * slot_elems,
                       slot_elems);
}

}  // namespace

extern "C" int zipmoe_splice_admit(void* buf, int slot, long long slot_elems,
                                   const void* exp, const void* sm,
                                   void* stream) {
  if (slot_elems <= 0) return 0;
  const int threads = 256;
  zipmoe_splice_admit_kernel<<<zipmoe::splice_grid(slot_elems, threads),
                               threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(buf), slot, slot_elems,
      static_cast<const uint8_t*>(exp), static_cast<const uint8_t*>(sm));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zipmoe_slab_gemm(const void* x, const void* buf,
                                const void* tile_slot, void* out, int n_tiles,
                                int d, int f, long long slot_stride,
                                void* stream) {
  if (n_tiles <= 0 || f <= 0) return 0;
  const dim3 grid((f + kCols - 1) / kCols, n_tiles);
  if (f % 8 != 0 || slot_stride % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(buf) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  zipmoe_slab_gemm_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(buf),
      static_cast<const int*>(tile_slot), static_cast<__nv_bfloat16*>(out), d,
      f, slot_stride);
  return static_cast<int>(cudaGetLastError());
}
