// Expert compute for the H100: the fused splice-admit, and one tensor-core
// GEMM body that four kernels share, each with its own source of weights.
//
// ---------------------------------------------------------------------------
// zipmoe_splice_admit_kernel replaces the Pallas kernel ``slab_splice_admit``
// (src/repro/kernels/moe_gemm.py:172, body ``_splice_admit_kernel`` :165).
// The TPU kernel aliases the donated slab buffer to its output so only the
// target slot is rewritten.  Here the slab is an ordinary device buffer: the
// kernel writes splice(exp, sm) through ``buf + slot * d * f``, with the slot
// a runtime int, so the write is in place by construction and every other
// slot keeps its bytes.  Bound: bytes (2 B in, 2 B out per element), the
// same streaming body as the standalone splice (splice.cuh); a slot of odd
// d * f starts off a 16-byte boundary and is spliced element by element.
//
// ---------------------------------------------------------------------------
// zipmoe_gemm_kernel<Source>: for each 8-row token tile i,
// out[i] = x[i] @ W(i) with f32 accumulation, where the weight source
// decides which expert's [K, f] rows W(i) are and how they are read:
//
// * SlabSource  — replaces ``slab_ragged_gemm`` (src/repro/kernels/
//   moe_gemm.py:123): W(i) = buf[tile_slot[i]], the slab slot named by the
//   tile, read in place.
// * StackSource — replaces ``grouped_gemm`` (moe_gemm.py:76): x [E, C, K]
//   against a dense stack w [E, K, f]; tile i belongs to expert i / (C / 8).
// * PlaneSource — replaces ``zip_gemm_grouped`` (moe_gemm.py:268) and, with
//   E = 1, ``zip_gemm`` (moe_gemm.py:227): the weights arrive as the two u8
//   bit-planes of each expert [E, K, f] and are spliced to bf16 in shared
//   memory (splice.cuh) just before the multiply, so no bf16 weight is ever
//   written to device memory — the point of the TPU kernel, which splices
//   on VREGs.
//
// Bound on the H100: bytes.  Decode puts one to a few tokens on each
// expert, so a projection does 2 x 8 flops per weight element it reads (16
// per 2 bytes; the planes are 2 B per element too), far below the ~295
// operations per byte where the tensor cores would become the limit.  The
// time is the weight bytes over the memory rate, so the design keeps many
// weight bytes in flight and spends few instructions per byte:
//
// * Swap AB.  A CTA computes out^T[64 f-columns, 8 tokens] = W^T x^T, so the
//   tile's 8 tokens are the N = 8 of ``mma.sync.m16n8k16`` (bf16 in, f32
//   accumulators) and the weight columns fill M; no token row is padded.
//   Four MMA warps own 16 columns each.  W is [K, f] with f contiguous, so
//   the A operand is MN-major: ``ldmatrix.trans`` turns a 16x16 block of
//   staged weight rows into the A fragment in one instruction; x is K-major
//   and ``ldmatrix`` gives the B fragments of two k16 steps at a time.
//   ``mma.sync`` over ``wgmma``: at N = 8 the MMAs take well under a tenth
//   of the byte bound even at ``mma.sync``'s rate, the fragment layout is
//   plain, and the splice writes the same padded row layout the bf16
//   sources land in (no wgmma swizzle to reproduce by hand).
// * A ring of kStages shared-memory stages of 64 contraction rows (8 KB of
//   weights and 1 KB of x each) fed by one producer warp with ``cp.async``
//   (16-byte copies with an L2 256-byte prefetch hint; plane rows in 8-byte
//   copies where the planes are only 8-byte aligned or f % 16 != 0), each
//   stage's arrival signalled on a ``full`` mbarrier by
//   ``cp.async.mbarrier.arrive.noinc`` and its release by the MMA warps on
//   an ``empty`` one, as soon as their fragments are in registers.
//   Out-of-range rows and columns are zero-filled by the copy itself, so f
//   need not be a multiple of 64.  Staged rows are dense 128-byte lines
//   with their 16-byte chunks XOR-swizzled by row (padding the rows instead
//   split every line over two rows of banks and cost a few percent of the
//   copy rate).  At four CTAs per SM an SM holds up to 128 KB of weights in
//   flight.
// * The plane source stages exp and sm rows the same way; each MMA warp
//   reads its own 16 columns of a stage, releases the stage, and splices
//   them (zipmoe::splice4) into a bf16 tile of the staged bf16 layout, then
//   runs the identical ldmatrix/MMA sequence.
// * A fixed split of the contraction (``moe_gemm.split_plan``): S slices
//   on 64-row chunk boundaries, a function of K alone, passed in as a
//   SlicePlan.  Each slice's MMA chain starts from zero, and an output is
//   p_0 + p_1 + ... + p_{S-1}, added left to right in f32, rounded once to
//   bf16.  Where those adds happen is a launch-time choice that does not
//   change the bits: a CTA either walks all S slices itself and adds in
//   registers (``spread`` = 0, no scratch), or each of S CTAs takes one
//   slice, writes its f32 partial to a scratch the wrapper owns, and the
//   last CTA of the output tile to arrive (a counter it resets itself) adds
//   the S partials in slice order.  The wrapper spreads when one CTA per
//   (tile, 64 columns) would leave the SMs short of work: ``zip_gemm``'s
//   one tile gives 22 or 32 CTAs, spread 88 or 96; at E = 16 the 352 or
//   512 CTAs already fill the card and walk their slices without scratch,
//   so the split costs nothing there.
//
// Order rule: every output element is computed by the same instruction
// sequence whatever the source and whatever the grid — the same staged
// bf16 tile (spliced or copied), the same MMA chain per slice, the same
// left-to-right sum of slices — so a row's result depends on its own x row,
// its expert's weights and K only.  That is what keeps the ragged and
// grouped FFN paths, and the batched and per-expert fused paths,
// bit-identical.
//
// Left for later: pad tiles of the ragged path still read slot 0's
// weights; an expert with two or more tiles (C > 8) reads its weights once
// per tile, not once per group; TMA, wgmma and thread-block clusters are
// not used.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "splice.cuh"

namespace {

constexpr int kRows = 8;      // token rows per tile: the MMA's N
constexpr int kCols = 64;     // output columns per CTA: 4 MMA warps x M = 16
constexpr int kChunk = 64;    // contraction rows per ring stage
constexpr int kStages = 4;
constexpr int kMmaWarps = kCols / 16;
constexpr int kThreads = (kMmaWarps + 1) * 32;   // + one producer warp
constexpr int kMaxSlices = 64;
constexpr int kCtasPerSm = 4;

// Staged rows are dense: a bf16 row of 64 values (x or weights) is one
// 128-byte line, a plane row of 64 bytes half of one, so each copied line
// lands in one row of banks.  Within a row the 16-byte chunks are permuted
// by an XOR with the row (swz128 / swz64), so the 8 row addresses of one
// ldmatrix, or of a quarter-warp's 16-byte plane reads, fall in 8
// distinct bank groups.
constexpr int kXBytes = kRows * 128;
constexpr int kWBytes = kChunk * 128;
constexpr int kPlaneBytes = kChunk * 64;
// a stage: the x chunk, then the weight chunk (bf16, or exp then sm)
constexpr int kStageBytes = kXBytes + kWBytes;
// full[], empty[] and the last-CTA flag, rounded up to 128 bytes
constexpr int kBarBytes = (2 * kStages * 8 + 4 + 127) / 128 * 128;

static_assert(kCols == 64 && kChunk == 64, "128-byte staged rows");
static_assert(2 * kPlaneBytes == kWBytes, "the planes fill a weight chunk");

// byte offset of 16-byte chunk c of row r: bf16 tiles of 128-byte rows
__device__ __forceinline__ int swz128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// the same for plane tiles of 64-byte rows (two rows per 128 bytes)
__device__ __forceinline__ int swz64(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// The contraction split: slice s is rows [bound[s], bound[s + 1]).
struct SlicePlan {
  int n;
  int bound[kMaxSlices + 1];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared.b64 st, [%0];\n\t}" ::"r"(
          smem_u32(b))
      : "memory");
}

// arrive on `b` once every earlier cp.async of this thread has landed
__device__ __forceinline__ void bar_arrive_copies(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" ::"r"(
                   smem_u32(b))
               : "memory");
}

// 16 or 8 bytes global -> shared; when !ok nothing is read and the
// destination is zero-filled.  The 16-byte copy asks the L2 for the whole
// 256-byte line pair: the next column block's CTA reads the other 128
// bytes of a weight row.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 accumulators
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One expert's [K, f] bf16 rows, staged 8 columns per 16-byte copy.
struct Bf16Weights {
  static constexpr bool kPlanes = false;
  const __nv_bfloat16* w;
  __device__ __forceinline__ void stage(unsigned char* dst, int k0, int col0,
                                        int K, int f, int lane) const {
#pragma unroll
    for (int j = 0; j < kChunk * kCols / 8 / 32; ++j) {
      const int p = lane + 32 * j;
      const int r = p / 8, c = p % 8;
      // f % 8 == 0, so an 8-column group is wholly in or out
      const bool ok = k0 + r < K && col0 + 8 * c < f;
      copy16(dst + swz128(r, c),
             ok ? w + static_cast<long long>(k0 + r) * f + col0 + 8 * c : w,
             ok);
    }
  }
};

// The same rows as two u8 planes: 16 columns of each per 16-byte copy
// when both planes are 16-byte aligned and f % 16 == 0 (`wide`, the same
// for every tile of a launch), else 8 columns per 8-byte copy.  Either way
// the stage holds the same bytes.
struct PlaneWeights {
  static constexpr bool kPlanes = true;
  const uint8_t* exp;
  const uint8_t* sm;
  bool wide;
  template <int kW>
  __device__ __forceinline__ void stage_by(unsigned char* dst, int k0,
                                           int col0, int K, int f,
                                           int lane) const {
#pragma unroll
    for (int j = 0; j < kChunk * kCols / kW / 32; ++j) {
      const int p = lane + 32 * j;
      const int r = p / (kCols / kW), g = p % (kCols / kW);
      const bool ok = k0 + r < K && col0 + kW * g < f;
      const long long off =
          ok ? static_cast<long long>(k0 + r) * f + col0 + kW * g : 0;
      // 16-byte chunk g (wide) or half g & 1 of chunk g >> 1
      const int at = kW == 16 ? swz64(r, g) : swz64(r, g >> 1) + (g & 1) * 8;
      if constexpr (kW == 16) {
        copy16(dst + at, exp + off, ok);
        copy16(dst + kPlaneBytes + at, sm + off, ok);
      } else {
        copy8(dst + at, exp + off, ok);
        copy8(dst + kPlaneBytes + at, sm + off, ok);
      }
    }
  }
  __device__ __forceinline__ void stage(unsigned char* dst, int k0, int col0,
                                        int K, int f, int lane) const {
    if (wide) {
      stage_by<16>(dst, k0, col0, K, f, lane);
    } else {
      stage_by<8>(dst, k0, col0, K, f, lane);
    }
  }
};

struct SlabSource {       // the tile's slab slot, read in place
  using Weights = Bf16Weights;
  const __nv_bfloat16* buf;
  const int* tile_slot;
  long long stride;
  __device__ __forceinline__ Weights rows(int tile) const {
    return {buf + static_cast<long long>(tile_slot[tile]) * stride};
  }
};

struct StackSource {      // expert tile / tiles_per_expert of a dense stack
  using Weights = Bf16Weights;
  const __nv_bfloat16* w;
  int tiles_per_expert;
  long long stride;
  __device__ __forceinline__ Weights rows(int tile) const {
    return {w + static_cast<long long>(tile / tiles_per_expert) * stride};
  }
};

struct PlaneSource {      // the same expert, as bit-planes
  using Weights = PlaneWeights;
  const uint8_t* exp;
  const uint8_t* sm;
  int tiles_per_expert;
  long long stride;
  bool wide;              // 16-byte plane copies (see PlaneWeights)
  __device__ __forceinline__ Weights rows(int tile) const {
    const long long o = static_cast<long long>(tile / tiles_per_expert) *
                        stride;
    return {exp + o, sm + o, wide};
  }
};

// the tile's x rows [k0, k0 + kChunk), 8 per 16-byte copy (K % 8 == 0)
__device__ __forceinline__ void stage_x(unsigned char* dst,
                                        const __nv_bfloat16* xt, int k0,
                                        int K, int lane) {
#pragma unroll
  for (int j = 0; j < kRows * kChunk / 8 / 32; ++j) {
    const int p = lane + 32 * j;
    const int r = p / 8, c = p % 8;
    const bool ok = k0 + 8 * c < K;
    copy16(dst + swz128(r, c),
           ok ? xt + static_cast<long long>(r) * K + k0 + 8 * c : xt, ok);
  }
}

// One MMA warp splices its 16 columns (plane chunk `warp`, bf16 chunks
// 2 warp and 2 warp + 1) of a staged plane chunk, read into registers
// first so the stage can be released, into the layout of a staged bf16
// weight chunk.
struct PlaneCols {
  uint4 e[kChunk / 32], s[kChunk / 32];
  __device__ __forceinline__ void read(const unsigned char* planes, int warp,
                                       int lane) {
#pragma unroll
    for (int h = 0; h < kChunk / 32; ++h) {
      const int at = swz64(lane + 32 * h, warp);
      e[h] = *reinterpret_cast<const uint4*>(planes + at);
      s[h] = *reinterpret_cast<const uint4*>(planes + kPlaneBytes + at);
    }
  }
  __device__ __forceinline__ void splice(unsigned char* dst, int warp,
                                         int lane) const {
#pragma unroll
    for (int h = 0; h < kChunk / 32; ++h) {
      const int r = lane + 32 * h;
      uint4 lo, hi;
      zipmoe::splice4(e[h].x, s[h].x, lo.x, lo.y);
      zipmoe::splice4(e[h].y, s[h].y, lo.z, lo.w);
      zipmoe::splice4(e[h].z, s[h].z, hi.x, hi.y);
      zipmoe::splice4(e[h].w, s[h].w, hi.z, hi.w);
      *reinterpret_cast<uint4*>(dst + swz128(r, 2 * warp)) = lo;
      *reinterpret_cast<uint4*>(dst + swz128(r, 2 * warp + 1)) = hi;
    }
  }
};

template <class Source>
constexpr int gemm_smem() {
  return kBarBytes + kStages * kStageBytes +
         (Source::Weights::kPlanes ? kWBytes : 0);
}

// Grid: (column blocks of 64, tiles, S when spread else 1).
template <class Source>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) zipmoe_gemm_kernel(
    const __nv_bfloat16* __restrict__ x, const Source src,
    __nv_bfloat16* __restrict__ out, const int K, const int f,
    const __grid_constant__ SlicePlan plan, float* __restrict__ partial,
    int* __restrict__ counters) {
  using Weights = typename Source::Weights;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  volatile int* last_flag = reinterpret_cast<volatile int*>(empty + kStages);
  unsigned char* ring = smem + kBarBytes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.y, col0 = blockIdx.x * kCols;
  const bool spread = gridDim.z > 1;
  const int s_lo = spread ? blockIdx.z : 0;
  const int s_hi = spread ? s_lo + 1 : plan.n;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 32);
      bar_init(&empty[s], kMmaWarps);
    }
  }
  __syncthreads();

  if (warp == kMmaWarps) {            // the producer keeps the ring full
    const Weights w = src.rows(tile);
    const __nv_bfloat16* xt = x + static_cast<long long>(tile) * kRows * K;
    int i = 0;
    for (int k0 = plan.bound[s_lo]; k0 < plan.bound[s_hi];
         k0 += kChunk, ++i) {
      const int st = i % kStages;
      if (i >= kStages) bar_wait(&empty[st], ((i / kStages) - 1) & 1);
      unsigned char* stage = ring + st * kStageBytes;
      stage_x(stage, xt, k0, K, lane);
      w.stage(stage + kXBytes, k0, col0, K, f, lane);
      bar_arrive_copies(&full[st]);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // MMA warps: warp owns output columns [16 warp, 16 warp + 16) of the
  // block.  This lane's ldmatrix row: A (weights, k16 step kk) row
  // 16 kk + row + 8 (mat >> 1), chunk 2 warp + (mat & 1); B (x, k16
  // steps 2 kp and 2 kp + 1) token row `row`, chunk 4 kp + mat.
  unsigned char* spliced = ring + kStages * kStageBytes;
  const int mat = lane >> 3, row = lane & 7;
  const int a_off = swz128(row + ((mat >> 1) << 3), 2 * warp + (mat & 1));
  float total[4] = {0.f, 0.f, 0.f, 0.f};
  int i = 0;
  for (int s = s_lo; s < s_hi; ++s) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = plan.bound[s]; k0 < plan.bound[s + 1]; k0 += kChunk, ++i) {
      const int st = i % kStages;
      bar_wait(&full[st], (i / kStages) & 1);
      // read everything this warp needs from the stage, release it, then
      // multiply: the producer refills the stage meanwhile
      const unsigned char* stage = ring + st * kStageBytes;
      uint32_t b[kChunk / 32][4];     // B fragments, two k16 steps each
#pragma unroll
      for (int kp = 0; kp < kChunk / 32; ++kp) {
        ldsm_x4(b[kp], stage + swz128(row, 4 * kp + mat));
      }
      uint32_t a[kChunk / 16][4];     // A fragments, one per k16 step
      if constexpr (Weights::kPlanes) {
        PlaneCols cols;
        cols.read(stage + kXBytes, warp, lane);
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[st]);
        cols.splice(spliced, warp, lane);
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          ldsm_x4_trans(a[kk], spliced + a_off + kk * 16 * 128);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          ldsm_x4_trans(a[kk], stage + kXBytes + a_off + kk * 16 * 128);
        }
      }
      __syncwarp();   // every lane's reads are done (stage, spliced tile)
      if constexpr (!Weights::kPlanes) {
        if (lane == 0) bar_arrive(&empty[st]);
      }
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        mma_16816(acc, a[kk], b[kk >> 1][(kk & 1) * 2],
                  b[kk >> 1][(kk & 1) * 2 + 1]);
      }
    }
    // slices add left to right: p_0, then + p_1, ...
#pragma unroll
    for (int q = 0; q < 4; ++q) total[q] = s == s_lo ? acc[q] : total[q] + acc[q];
  }

  // accumulator q of this lane: column m (+8 for q >= 2), token 2t (+1 odd q)
  const int m = col0 + 16 * warp + (lane >> 2);
  const long long r0 = static_cast<long long>(tile) * kRows + 2 * (lane & 3);
  const long long at[4] = {r0 * f + m, (r0 + 1) * f + m, r0 * f + m + 8,
                           (r0 + 1) * f + m + 8};
  const bool in[4] = {m < f, m < f, m + 8 < f, m + 8 < f};
  if (!spread) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (in[q]) out[at[q]] = __float2bfloat16_rn(total[q]);
    }
    return;
  }
  const long long slice = static_cast<long long>(gridDim.y) * kRows * f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (in[q]) partial[blockIdx.z * slice + at[q]] = total[q];
  }
  __threadfence();
  asm volatile("bar.sync 1, %0;" ::"n"(kMmaWarps * 32) : "memory");
  if (threadIdx.x == 0) {
    int* c = counters + tile * gridDim.x + blockIdx.x;
    const bool last = atomicAdd(c, 1) == plan.n - 1;
    if (last) *c = 0;                 // ready for the next launch
    *last_flag = last;
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kMmaWarps * 32) : "memory");
  if (!*last_flag) return;
  __threadfence();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (!in[q]) continue;
    float v = __ldcg(partial + at[q]);
    for (int s = 1; s < plan.n; ++s) v += __ldcg(partial + s * slice + at[q]);
    out[at[q]] = __float2bfloat16_rn(v);
  }
}

bool misaligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1u)) != 0;
}

// bounds: n + 1 ascending rows from 0 to K, interior ones on chunk bounds
bool bad_plan(const int* bounds, int n, int K) {
  if (bounds == nullptr || n < 1 || n > kMaxSlices || bounds[0] != 0 ||
      bounds[n] != K) {
    return true;
  }
  for (int s = 1; s <= n; ++s) {
    if (bounds[s] < bounds[s - 1] || (s < n && bounds[s] % kChunk != 0)) {
      return true;
    }
  }
  return false;
}

template <class Source>
int launch_gemm(const void* x, const Source& src, void* out, int n_tiles,
                int K, int f, const int* bounds, int n_slices, int spread,
                void* partial, void* counters, void* stream) {
  if (K % 8 != 0 || misaligned(x, 16) || bad_plan(bounds, n_slices, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool split = spread != 0 && n_slices > 1;
  if (split && (partial == nullptr || counters == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SlicePlan plan{};
  plan.n = n_slices;
  for (int s = 0; s <= n_slices; ++s) plan.bound[s] = bounds[s];
  constexpr int smem = gemm_smem<Source>();
  // the shared-memory limit is set once per device and instantiation
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(zipmoe_gemm_kernel<Source>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid((f + kCols - 1) / kCols, n_tiles, split ? n_slices : 1);
  zipmoe_gemm_kernel<Source><<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), src,
      static_cast<__nv_bfloat16*>(out), K, f, plan,
      static_cast<float*>(partial), static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(zipmoe::kSpliceThreads)
    zipmoe_splice_admit_kernel(
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
  zipmoe_splice_admit_kernel<<<zipmoe::splice_grid(slot_elems),
                               zipmoe::kSpliceThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(buf), slot, slot_elems,
      static_cast<const uint8_t*>(exp), static_cast<const uint8_t*>(sm));
  return static_cast<int>(cudaGetLastError());
}

// Every GEMM entry point ends with the split: `bounds` (host, n_slices + 1
// rows), whether each slice gets its own CTA, and for that case an f32
// scratch of n_slices x rows x f and one zeroed int counter per (tile,
// 64-column block), which the kernel leaves zeroed.

// x [n_tiles * 8, d] against buf [capacity, d, f] by tile slot.
extern "C" int zipmoe_slab_gemm(const void* x, const void* buf,
                                const void* tile_slot, void* out, int n_tiles,
                                int d, int f, long long slot_stride,
                                const int* bounds, int n_slices, int spread,
                                void* partial, void* counters, void* stream) {
  if (n_tiles <= 0 || f <= 0) return 0;
  if (f % 8 != 0 || slot_stride % 8 != 0 || misaligned(buf, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SlabSource src{static_cast<const __nv_bfloat16*>(buf),
                       static_cast<const int*>(tile_slot), slot_stride};
  return launch_gemm(x, src, out, n_tiles, d, f, bounds, n_slices, spread,
                     partial, counters, stream);
}

// x [E, rows, d] @ w [E, d, f] -> out [E, rows, f]; rows % 8 == 0.
extern "C" int zipmoe_grouped_gemm(const void* x, const void* w, void* out,
                                   int n_experts, int rows, int d, int f,
                                   const int* bounds, int n_slices,
                                   int spread, void* partial, void* counters,
                                   void* stream) {
  if (n_experts <= 0 || rows <= 0 || f <= 0) return 0;
  if (rows % kRows != 0 || f % 8 != 0 || misaligned(w, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const StackSource src{static_cast<const __nv_bfloat16*>(w), rows / kRows,
                        static_cast<long long>(d) * f};
  return launch_gemm(x, src, out, n_experts * (rows / kRows), d, f, bounds,
                     n_slices, spread, partial, counters, stream);
}

// x [E, rows, d] against splice(exp, sm) of u8 planes [E, d, f].
extern "C" int zipmoe_zip_gemm_grouped(const void* x, const void* exp,
                                       const void* sm, void* out,
                                       int n_experts, int rows, int d, int f,
                                       const int* bounds, int n_slices,
                                       int spread, void* partial,
                                       void* counters, void* stream) {
  if (n_experts <= 0 || rows <= 0 || f <= 0) return 0;
  if (rows % kRows != 0 || f % 8 != 0 || misaligned(exp, 8) ||
      misaligned(sm, 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = f % 16 == 0 && !misaligned(exp, 16) &&
                    !misaligned(sm, 16);
  const PlaneSource src{static_cast<const uint8_t*>(exp),
                        static_cast<const uint8_t*>(sm), rows / kRows,
                        static_cast<long long>(d) * f, wide};
  return launch_gemm(x, src, out, n_experts * (rows / kRows), d, f, bounds,
                     n_slices, spread, partial, counters, stream);
}

// One expert: x [rows, d] against splice(exp, sm) of planes [d, f] — the
// batched kernel at E = 1, so the per-expert path is bit-equal to it.
extern "C" int zipmoe_zip_gemm(const void* x, const void* exp, const void* sm,
                               void* out, int rows, int d, int f,
                               const int* bounds, int n_slices, int spread,
                               void* partial, void* counters, void* stream) {
  return zipmoe_zip_gemm_grouped(x, exp, sm, out, 1, rows, d, f, bounds,
                                 n_slices, spread, partial, counters, stream);
}
