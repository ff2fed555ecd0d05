// Expert compute for the H100: the fused splice-admit, and one tiled GEMM
// body that four kernels share, each with its own source of weights.
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
// zipmoe_tile_gemm_kernel<Source>: for each 8-row token tile i,
// out[i] = x[i] @ W(i) with f32 accumulation, where the weight source
// decides which expert's [d, f] rows W(i) are and how they are read:
//
// * SlabSource  — replaces ``slab_ragged_gemm`` (src/repro/kernels/
//   moe_gemm.py:123): W(i) = buf[tile_slot[i]], the slab slot named by the
//   tile, read in place.
// * StackSource — replaces ``grouped_gemm`` (moe_gemm.py:76): x [E, C, d]
//   against a dense stack w [E, d, f]; tile i belongs to expert i / (C / 8).
// * PlaneSource — replaces ``zip_gemm_grouped`` (moe_gemm.py:268) and, with
//   E = 1, ``zip_gemm`` (moe_gemm.py:227): the weights arrive as the two u8
//   bit-planes of each expert [E, d, f]; every 8 columns are read as 8 B of
//   each plane and spliced to bf16 in registers (splice.cuh) just before
//   they are staged for the multiply, so no bf16 weight is ever written to
//   device memory — the point of the TPU kernel, which splices on VREGs.
//
// The TPU grids walk (tile, f-block, d-block) in order and carry the sum in
// VMEM scratch.  On Hopper, blocks run in parallel and in no order, so one
// block owns one (tile, 64-column block of f) pair for the whole
// contraction: it resolves its own expert, loops over d in 64-row chunks,
// stages the x tile (as f32) and the weight block (as bf16) in shared
// memory, and keeps the 8 x 64 partial sums in registers (4 per thread).
// The next chunk is loaded into registers while the current one is
// multiplied, so loads stay in flight.  Columns past f and rows past d are
// masked, so f need not be a multiple of 64; it must be a multiple of 8, a
// bf16 weight buffer 16-byte aligned and a plane 8-byte aligned, so every
// weight row is read in whole vectors (the C entry points return
// cudaErrorInvalidValue otherwise, and the wrappers raise first).
//
// Every output element is ONE f32 sum over k in ascending order (fmaf),
// whatever the source: a row's result depends on its own x row and its
// expert's weights only.  That is what keeps the ragged and grouped FFN
// paths, and the batched and per-expert fused paths, bit-identical.
//
// Bound on the H100: bytes.  Decode puts one to a few tokens on each
// expert, so each projection does 2 x 8 flops per weight element it reads
// (16 per 2 bytes — the planes are 2 B per element too), far below the
// ~295 operations per byte where the tensor cores would become the limit;
// the time is the active experts' weight bytes over the memory rate.  This
// first version does the multiply-adds on CUDA cores (no wgmma/TMA) and
// reads an expert's weights once per token tile, not once per group; both
// are for later work.
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
constexpr int kVecPerThread = kChunk * kCols / 8 / kThreads;  // 4 x 8 cols

static_assert(kRowsPerThread * kThreads == kRows * kCols, "tile split");
static_assert(kCols % 8 == 0, "8-column weight vectors");

// One expert's [d, f] weight rows, read 8 columns at a time as 8 bf16.
struct Bf16Rows {
  const __nv_bfloat16* w;
  __device__ __forceinline__ uint4 load8(long long off) const {
    return __ldg(reinterpret_cast<const uint4*>(w + off));
  }
};

// The same rows held as two u8 planes: 8 B of each, spliced in registers.
struct PlaneRows {
  const uint8_t* exp;
  const uint8_t* sm;
  __device__ __forceinline__ uint4 load8(long long off) const {
    const uint2 e = __ldg(reinterpret_cast<const uint2*>(exp + off));
    const uint2 s = __ldg(reinterpret_cast<const uint2*>(sm + off));
    uint4 v;
    zipmoe::splice4(e.x, s.x, v.x, v.y);
    zipmoe::splice4(e.y, s.y, v.z, v.w);
    return v;
  }
};

struct SlabSource {       // the tile's slab slot, read in place
  const __nv_bfloat16* buf;
  const int* tile_slot;
  long long stride;
  __device__ __forceinline__ Bf16Rows rows(int tile) const {
    return {buf + static_cast<long long>(tile_slot[tile]) * stride};
  }
};

struct StackSource {      // expert tile / tiles_per_expert of a dense stack
  const __nv_bfloat16* w;
  int tiles_per_expert;
  long long stride;
  __device__ __forceinline__ Bf16Rows rows(int tile) const {
    return {w + static_cast<long long>(tile / tiles_per_expert) * stride};
  }
};

struct PlaneSource {      // the same expert, as bit-planes
  const uint8_t* exp;
  const uint8_t* sm;
  int tiles_per_expert;
  long long stride;
  __device__ __forceinline__ PlaneRows rows(int tile) const {
    const long long o = static_cast<long long>(tile / tiles_per_expert) *
                        stride;
    return {exp + o, sm + o};
  }
};

struct Stage {
  float x[kXPerThread];
  uint4 w[kVecPerThread];
};

template <class Rows>
__device__ __forceinline__ void load_stage(
    Stage& st, const __nv_bfloat16* __restrict__ xt, const Rows& w, int k0,
    int col0, int d, int f) {
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
      v = w.load8(static_cast<long long>(k0 + k) * f + col0 + c);
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

template <class Source>
__global__ void __launch_bounds__(kThreads) zipmoe_tile_gemm_kernel(
    const __nv_bfloat16* __restrict__ x, Source src,
    __nv_bfloat16* __restrict__ out, int d, int f) {
  __shared__ float xs[kRows][kChunk];
  __shared__ __align__(16) unsigned short ws[kChunk][kCols];
  const int tile = blockIdx.y;
  const int col0 = blockIdx.x * kCols;
  const int tid = threadIdx.x;
  const int c = tid % kCols;
  const int r0 = (tid / kCols) * kRowsPerThread;
  const auto w = src.rows(tile);
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

template <class Source>
int launch_tile_gemm(const void* x, const Source& src, void* out, int n_tiles,
                     int d, int f, void* stream) {
  const dim3 grid((f + kCols - 1) / kCols, n_tiles);
  zipmoe_tile_gemm_kernel<Source><<<grid, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), src,
      static_cast<__nv_bfloat16*>(out), d, f);
  return static_cast<int>(cudaGetLastError());
}

bool misaligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1u)) != 0;
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

// x [n_tiles * 8, d] against buf [capacity, d, f] by tile slot.
extern "C" int zipmoe_slab_gemm(const void* x, const void* buf,
                                const void* tile_slot, void* out, int n_tiles,
                                int d, int f, long long slot_stride,
                                void* stream) {
  if (n_tiles <= 0 || f <= 0) return 0;
  if (f % 8 != 0 || slot_stride % 8 != 0 || misaligned(buf, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SlabSource src{static_cast<const __nv_bfloat16*>(buf),
                       static_cast<const int*>(tile_slot), slot_stride};
  return launch_tile_gemm(x, src, out, n_tiles, d, f, stream);
}

// x [E, rows, d] @ w [E, d, f] -> out [E, rows, f]; rows % 8 == 0.
extern "C" int zipmoe_grouped_gemm(const void* x, const void* w, void* out,
                                   int n_experts, int rows, int d, int f,
                                   void* stream) {
  if (n_experts <= 0 || rows <= 0 || f <= 0) return 0;
  if (rows % kRows != 0 || f % 8 != 0 || misaligned(w, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const StackSource src{static_cast<const __nv_bfloat16*>(w), rows / kRows,
                        static_cast<long long>(d) * f};
  return launch_tile_gemm(x, src, out, n_experts * (rows / kRows), d, f,
                          stream);
}

// x [E, rows, d] against splice(exp, sm) of u8 planes [E, d, f].
extern "C" int zipmoe_zip_gemm_grouped(const void* x, const void* exp,
                                       const void* sm, void* out,
                                       int n_experts, int rows, int d, int f,
                                       void* stream) {
  if (n_experts <= 0 || rows <= 0 || f <= 0) return 0;
  if (rows % kRows != 0 || f % 8 != 0 || misaligned(exp, 8) ||
      misaligned(sm, 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PlaneSource src{static_cast<const uint8_t*>(exp),
                        static_cast<const uint8_t*>(sm), rows / kRows,
                        static_cast<long long>(d) * f};
  return launch_tile_gemm(x, src, out, n_experts * (rows / kRows), d, f,
                          stream);
}

// One expert: x [rows, d] against splice(exp, sm) of planes [d, f] — the
// batched kernel at E = 1, so the per-expert path is bit-equal to it.
extern "C" int zipmoe_zip_gemm(const void* x, const void* exp, const void* sm,
                               void* out, int rows, int d, int f,
                               void* stream) {
  return zipmoe_zip_gemm_grouped(x, exp, sm, out, 1, rows, d, f, stream);
}
