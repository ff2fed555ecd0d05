// MLA decode (DeepSeek-V2's multi-head latent attention), one new token a
// row, absorbed form, in two kernels between the input projections and the
// output projection.
//
// Neither replaces a TPU kernel: the JAX package leaves MLA decode to XLA
// (src/repro/models/attention.py, ``mla_decode_rows``), which fuses it.
// The port ran it as ~60 eager PyTorch ops a layer, three of them host
// copies that synchronise the stream, and converted ``wkv_b`` and the whole
// gathered latent cache to f32 on every call.  These two kernels compute
// the same function in two launches, read the bf16 operands as they lie and
// widen them in registers, and write nothing in f32 but their own small
// scratch in shared memory.
//
// ---------------------------------------------------------------------------
// zipmoe_mla_rope_write_kernel<T>: one block per row b, at p = positions[b].
//   * q_rope of every head rotated by RoPE at p (the halves convention of
//     ``models/layers.apply_rope``), rounded once to T;
//   * the new latent normed: kv_norm * x * rsqrt(mean(x^2) + eps) in f32,
//     rounded once to T, and written at (b, p) of the step's latent cache;
//   * the new rope key rotated at p and written at (b, p).
//   Every rounding sits where the plain code's sits (``apply_rope`` and
//   ``rms_norm_headwise`` each end in ``.to(x.dtype)``), and every product
//   and sum is rounded as PyTorch's elementwise kernels round it (no FMA
//   contraction across what PyTorch computes as two ops).  cos and sin are
//   ``cosf``/``sinf`` of the f32 angle p * freq, as ``torch.cos`` takes
//   them; the frequency table comes from the wrapper, made once per
//   (rope width, theta) on the host and passed by value among the launch's
//   arguments.  The mean of squares adds the
//   squares in the order PyTorch's CUDA reduction adds them for a [B, C]
//   row-wise mean (ATen/native/cuda/Reduce.cuh: `lanes` threads a row,
//   each summing its share through four accumulators, 16-byte vectors of
//   four where the row is at least 128 long, then a shared-memory tree down
//   to one warp and a shuffle-down tree), with the lane count the wrapper
//   reckons from B and C as PyTorch does: the latent written is then bit
//   for bit the plain code's on the card.
//   A position outside [0, T_len) traps (the plain code's index_put_
//   raises past T): no write lands outside the row, and the fault shows.
//   Bound: none worth the name.  It reads 2(C + Dr) + 2 H Dr bytes a row and
//   writes as much; the time is its launch.
//
// zipmoe_mla_absorbed_attend_kernel<T>: one block per (row b, head h), over
// the row's positions t <= p only (p outside [0, T_len) traps).
//   1. Query absorption: q_c[h, c] = sum_d q_nope[b, h, d] w_k[c, h, d] in
//      f32, w_k read as T straight from ``wkv_b`` [C, H, Dn + Dv].
//   2. Scores s[h, t] = (q_c[h] . ckv[b, t] + q_rope[h] . k_rope[b, t]) *
//      scale in f32, an online softmax in f32 and the f32 weighted sum over
//      the latent.  Each warp streams its own positions (pairs t, t + 1 at
//      t = 2 (warp + 8 i)): every lane loads a fixed 4-element slice of a
//      latent row, scores it against its slice of q_c (registers), the
//      warp sums by a butterfly, and the same loaded slice goes into the
//      lane's accumulators.  No
//      shared memory and no block barrier in this loop.  The 8 warps'
//      running sums are merged in warp order at the end.
//   3. Value absorption: out[h, v] = sum_c o_c[h, c] w_v[c, h, v] in f32
//      (four fixed slices of c, added in order), rounded once to T.
//   Every sum of a (row, head) is taken in an order that depends on the
//   widths and the positions alone, not on B or T_pad: a row's output
//   is bit for bit the same alone, in any batch and under any padding, and
//   masked or padded positions are never read.
//   Bound on the H100: f32 operations at these sizes.  A (row, head) does
//   2 (2C + Dr) flops a position on f32 cores (67 TFLOP/s) against 2(C +
//   Dr) bytes a position; deepseekv2-lite's and kanana-2's 16 rows (16 and
//   32 heads, C 512, ~700 positions) come to ~0.5 and ~1 GFLOP a layer
//   against ~14 and ~18 MB.  The design spends those flops without
//   staging: a latent row is loaded once a head and used twice from
//   registers (score and sum).  A block holding all of a row's heads would
//   put a row's whole work on one SM; one head a block spreads it over
//   B * H blocks, whose heads re-read the row from L2.  (Blocks of 2 or 4
//   heads, sharing each load, measured no faster at the cells' shapes.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLanes = 512;   // PyTorch's reduce block is at most 512 wide
constexpr int kMaxHalfRope = 64;    // rope pairs, rope width <= 128
constexpr int kMaxKC = 4;        // latent slices of 4 a lane: C <= 512
constexpr int kMaxKD = 2;        // nope slices of 4 a lane: Dn <= 256
constexpr int kMaxC = 4 * 32 * kMaxKC;
constexpr int kVSlices = 4;      // value absorption: c in four fixed slices
constexpr int kMaxDv = 256;
constexpr int kRowsAtOnce = 4;   // query absorption: latent rows a warp step

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

// the rope frequencies, by value among a launch's arguments
struct RopeFreqs {
  float v[kMaxHalfRope];
};

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// four consecutive elements as loaded: one 8-byte load for bf16, one
// 16-byte load for f32 (the wrapper checks the alignment), widened to f32
// where they are used, so a load in flight holds as few registers as it can
template <typename T>
struct Raw4;
template <>
struct Raw4<__nv_bfloat16> {
  uint2 v;
};
template <>
struct Raw4<float> {
  float4 v;
};

__device__ __forceinline__ Raw4<__nv_bfloat16> load_raw(
    const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint2*>(p))};
}
__device__ __forceinline__ Raw4<float> load_raw(const float* p) {
  return {__ldg(reinterpret_cast<const float4*>(p))};
}
template <typename T>
__device__ __forceinline__ Raw4<T> zero_raw();
template <>
__device__ __forceinline__ Raw4<__nv_bfloat16> zero_raw<__nv_bfloat16>() {
  return {make_uint2(0u, 0u)};
}
template <>
__device__ __forceinline__ Raw4<float> zero_raw<float>() {
  return {make_float4(0.f, 0.f, 0.f, 0.f)};
}

__device__ __forceinline__ void widen(const Raw4<__nv_bfloat16>& r,
                                      float (&v)[4]) {
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&r.v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&r.v.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void widen(const Raw4<float>& r, float (&v)[4]) {
  v[0] = r.v.x;
  v[1] = r.v.y;
  v[2] = r.v.z;
  v[3] = r.v.w;
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
  widen(load_raw(p), v);
}

// eight consecutive elements widened to f32: one 16-byte load for bf16
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&lo)[4],
                                      float (&hi)[4]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  widen(Raw4<__nv_bfloat16>{make_uint2(raw.x, raw.y)}, lo);
  widen(Raw4<__nv_bfloat16>{make_uint2(raw.z, raw.w)}, hi);
}
__device__ __forceinline__ void load8(const float* p, float (&lo)[4],
                                      float (&hi)[4]) {
  load4(p, lo);
  load4(p + 4, hi);
}

// x1 cos - x2 sin and x1 sin + x2 cos, each product and the sum rounded on
// its own as PyTorch's elementwise ops round them
__device__ __forceinline__ void rotate(float x1, float x2, float c, float s,
                                       float& o1, float& o2) {
  o1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
  o2 = __fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c));
}

// One lane's share of PyTorch's row reduction of n f32 squares: vectors of
// four at vector index lane, lane + lanes, ... into four accumulators
// (vectorised), or elements lane + i lanes four at a time (not), then the
// accumulators added in order.
template <typename T>
__device__ float torch_lane_sum(const T* x, int n, int lanes, int vec,
                                int lane) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (vec) {
    for (int idx = lane; idx * 4 + 3 < n; idx += lanes) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = to_f32(x[idx * 4 + i]);
        acc[i] = __fadd_rn(acc[i], __fmul_rn(v, v));
      }
    }
  } else {
    int idx = lane;
    while (idx + 3 * lanes < n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = to_f32(x[idx + i * lanes]);
        acc[i] = __fadd_rn(acc[i], __fmul_rn(v, v));
      }
      idx += 4 * lanes;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (idx >= n) break;
      const float v = to_f32(x[idx]);
      acc[i] = __fadd_rn(acc[i], __fmul_rn(v, v));
      idx += lanes;
    }
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    zipmoe_mla_rope_write_kernel(
        const T* __restrict__ q, const T* __restrict__ kv,
        const float* __restrict__ kv_norm, const RopeFreqs freqs,
        const int64_t* __restrict__ positions, T* __restrict__ ckv,
        T* __restrict__ k_rope, T* __restrict__ q_rope, int H, int Dn,
        int Dr, int C, int T_len, int lanes, int vec, float factor,
        float eps) {
  __shared__ float cs[kMaxHalfRope], sn[kMaxHalfRope];
  __shared__ float part[kMaxLanes];
  __shared__ float rs;
  const int b = blockIdx.x, tid = threadIdx.x, half = Dr / 2;
  const int64_t p = positions[b];
  if (p < 0 || p >= T_len) __trap();
  const float pf = static_cast<float>(p);
  for (int i = tid; i < half; i += kThreads) {
    const float ang = __fmul_rn(pf, freqs.v[i]);
    cs[i] = cosf(ang);
    sn[i] = sinf(ang);
  }
  const T* x = kv + static_cast<int64_t>(b) * (C + Dr);
  for (int l = tid; l < lanes; l += kThreads)
    part[l] = torch_lane_sum(x, C, lanes, vec, l);
  __syncthreads();
  // the shared-memory tree of a block wider than a warp, then one warp
  for (int off = lanes / 2; off >= 32; off >>= 1) {
    for (int l = tid; l < off; l += kThreads)
      part[l] = __fadd_rn(part[l], part[l + off]);
    __syncthreads();
  }
  if (tid < 32) {
    const int width = lanes < 32 ? lanes : 32;
    float v = tid < width ? part[tid] : 0.f;
    for (int off = width >> 1; off > 0; off >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(kFull, v, off));
    if (tid == 0) rs = rsqrtf(__fadd_rn(__fmul_rn(v, factor), eps));
  }
  __syncthreads();
  const float r = rs;
  const int64_t at = static_cast<int64_t>(b) * T_len + p;
  for (int c = tid; c < C; c += kThreads)
    ckv[at * C + c] =
        from_f32<T>(__fmul_rn(__fmul_rn(to_f32(x[c]), r), kv_norm[c]));
  for (int i = tid; i < half; i += kThreads) {
    float o1, o2;
    rotate(to_f32(x[C + i]), to_f32(x[C + half + i]), cs[i], sn[i], o1, o2);
    k_rope[at * Dr + i] = from_f32<T>(o1);
    k_rope[at * Dr + half + i] = from_f32<T>(o2);
  }
  const int Dq = Dn + Dr;
  for (int j = tid; j < H * half; j += kThreads) {
    const int h = j / half, i = j - h * half;
    const T* qh = q + (static_cast<int64_t>(b) * H + h) * Dq + Dn;
    float o1, o2;
    rotate(to_f32(qh[i]), to_f32(qh[half + i]), cs[i], sn[i], o1, o2);
    T* out = q_rope + (static_cast<int64_t>(b) * H + h) * Dr;
    out[i] = from_f32<T>(o1);
    out[half + i] = from_f32<T>(o2);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    zipmoe_mla_absorbed_attend_kernel(
        const T* __restrict__ q, const T* __restrict__ q_rope,
        const T* __restrict__ wkv_b, const T* __restrict__ ckv,
        const T* __restrict__ k_rope, const int64_t* __restrict__ positions,
        T* __restrict__ out, int H, int Dn, int Dr, int Dv, int C, int T_len,
        float scale) {
  __shared__ __align__(16) float vec_sm[kMaxC];   // q_c, then o_c
  __shared__ float m_sm[kWarps], l_sm[kWarps];
  __shared__ float vpart[kVSlices][kMaxDv];
  const int b = blockIdx.y, h = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Dw = Dn + Dv;                 // wkv_b's columns a head
  const int64_t row_w = static_cast<int64_t>(H) * Dw;
  const int64_t p = positions[b];
  if (p < 0 || p >= T_len) __trap();
  const int n_pos = static_cast<int>(p) + 1;

  // -- 1. query absorption: q_c[c] into vec_sm ------------------------------
  {
    float qn[kMaxKD][4];
    const T* src = q + (static_cast<int64_t>(b) * H + h) * (Dn + Dr);
#pragma unroll
    for (int k = 0; k < kMaxKD; ++k) {
      const int d = 4 * (lane + 32 * k);
#pragma unroll
      for (int e = 0; e < 4; ++e) qn[k][e] = d < Dn ? to_f32(src[d + e]) : 0.f;
    }
    for (int c0 = warp * kRowsAtOnce; c0 < C; c0 += kWarps * kRowsAtOnce) {
      float w[kRowsAtOnce][kMaxKD][4];
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u)
#pragma unroll
        for (int k = 0; k < kMaxKD; ++k) {
          const int d = 4 * (lane + 32 * k);
          if (c0 + u < C && d < Dn)
            load4(wkv_b + (c0 + u) * row_w + h * Dw + d, w[u][k]);
        }
      // the rows' butterflies interleaved level by level
      float s[kRowsAtOnce];
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) {
        float a = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxKD; ++k)
          if (c0 + u < C && 4 * (lane + 32 * k) < Dn) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a = fmaf(qn[k][e], w[u][k][e], a);
          }
        s[u] = a;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < kRowsAtOnce; ++u)
          s[u] += __shfl_xor_sync(kFull, s[u], o);
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < kRowsAtOnce; ++u)
          if (c0 + u < C) vec_sm[c0 + u] = s[u];
      }
    }
  }
  __syncthreads();

  // -- 2. scores, online softmax and the weighted latent sum --------------
  float qc[kMaxKC][4], qr[4], acc[kMaxKC][4];
  float m = -CUDART_INF_F, l = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxKC; ++k) {
    const int c = 4 * (lane + 32 * k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qc[k][e] = c < C ? vec_sm[c + e] : 0.f;
      acc[k][e] = 0.f;
    }
  }
  {
    const T* src = q_rope + (static_cast<int64_t>(b) * H + h) * Dr;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      qr[e] = 4 * lane < Dr ? to_f32(src[4 * lane + e]) : 0.f;
  }
  const T* crow = ckv + static_cast<int64_t>(b) * T_len * C;
  const T* rrow = k_rope + static_cast<int64_t>(b) * T_len * Dr;
  // the warp's next pair of positions is in flight while it scores this
  // one: its latent slices and rope slice, as loaded
  Raw4<T> next[2][kMaxKC + 1];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = t0 + j;
#pragma unroll
      for (int k = 0; k < kMaxKC; ++k) {
        const int c = 4 * (lane + 32 * k);
        next[j][k] = t < n_pos && c < C
                         ? load_raw(crow + static_cast<int64_t>(t) * C + c)
                         : zero_raw<T>();
      }
      next[j][kMaxKC] =
          t < n_pos && 4 * lane < Dr
              ? load_raw(rrow + static_cast<int64_t>(t) * Dr + 4 * lane)
              : zero_raw<T>();
    }
  };
  if (2 * warp < n_pos) fetch(2 * warp);
  for (int t0 = 2 * warp; t0 < n_pos; t0 += 2 * kWarps) {
    const bool two = t0 + 1 < n_pos;
    float x[2][kMaxKC][4], kr[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int k = 0; k < kMaxKC; ++k) widen(next[j][k], x[j][k]);
      widen(next[j][kMaxKC], kr[j]);
    }
    if (t0 + 2 * kWarps < n_pos) fetch(t0 + 2 * kWarps);
    // the two scores, their butterflies (xor shuffles: the same bits in
    // every lane, each level adding the same two values in either order)
    // interleaved level by level, then the exponentials, the rescale and
    // the sums
    float sc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxKC; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) a = fmaf(qc[k][e], x[j][k][e], a);
#pragma unroll
      for (int e = 0; e < 4; ++e) a = fmaf(qr[e], kr[j][e], a);
      sc[j] = a;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < 2; ++j) sc[j] += __shfl_xor_sync(kFull, sc[j], o);
    sc[0] = __fmul_rn(sc[0], scale);
    sc[1] = two ? __fmul_rn(sc[1], scale) : -CUDART_INF_F;
    const float mn = fmaxf(m, fmaxf(sc[0], sc[1]));
    const float alpha = expf(m - mn);
    const float p0 = expf(sc[0] - mn);
    const float p1 = two ? expf(sc[1] - mn) : 0.f;
    if (mn > m) {                   // warp-uniform; alpha is 1 otherwise
      l = __fmul_rn(l, alpha);
#pragma unroll
      for (int k = 0; k < kMaxKC; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[k][e] = __fmul_rn(acc[k][e], alpha);
      m = mn;
    }
    l = __fadd_rn(__fadd_rn(l, p0), p1);
#pragma unroll
    for (int k = 0; k < kMaxKC; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[k][e] = fmaf(p1, x[1][k][e], fmaf(p0, x[0][k][e], acc[k][e]));
  }
  // merge the warps' running sums in warp order into vec_sm, then divide
  if (lane == 0) {
    m_sm[warp] = m;
    l_sm[warp] = l;
  }
  __syncthreads();
  float wt = 0.f, mx = -CUDART_INF_F, denom = 0.f;
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_sm[w]);
  for (int w = 0; w < kWarps; ++w) {
    const float e = expf(m_sm[w] - mx);   // 0 for a warp with none
    denom = fmaf(e, l_sm[w], denom);
    if (w == warp) wt = e;
  }
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) {
#pragma unroll
      for (int k = 0; k < kMaxKC; ++k) {
        const int c = 4 * (lane + 32 * k);
        if (c < C) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = __fmul_rn(wt, acc[k][e]);
            float* dst = &vec_sm[c + e];
            *dst = w == 0 ? v : __fadd_rn(*dst, v);
          }
        }
      }
    }
    __syncthreads();
  }
  for (int c = tid; c < C; c += kThreads)
    vec_sm[c] = __fdiv_rn(vec_sm[c], denom);
  __syncthreads();

  // -- 3. value absorption: four slices of c, then added in order ----------
  const int groups = Dv / 8;              // 8 output columns a task
  for (int task = tid; task < kVSlices * groups; task += kThreads) {
    const int sl = task / groups, v0 = 8 * (task - sl * groups);
    const T* w = wkv_b + h * Dw + Dn + v0;
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int c = sl; c < C; c += kVSlices) {
      float lo[4], hi[4];
      load8(w + c * row_w, lo, hi);
      const float o = vec_sm[c];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] = fmaf(o, lo[e], a[e]);
        a[4 + e] = fmaf(o, hi[e], a[4 + e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) vpart[sl][v0 + e] = a[e];
  }
  __syncthreads();
  for (int v = tid; v < Dv; v += kThreads) {
    float o = vpart[0][v];
#pragma unroll
    for (int sl = 1; sl < kVSlices; ++sl) o = __fadd_rn(o, vpart[sl][v]);
    out[(static_cast<int64_t>(b) * H + h) * Dv + v] = from_f32<T>(o);
  }
}

template <typename T>
int rope_write(const void* q, const void* kv, const void* kv_norm,
               const RopeFreqs& freqs, const void* positions, void* ckv,
               void* k_rope, void* q_rope, int B, int H, int Dn, int Dr, int C,
               int T_len, int lanes, int vec, float factor, float eps,
               cudaStream_t stream) {
  zipmoe_mla_rope_write_kernel<T><<<B, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv),
      static_cast<const float*>(kv_norm), freqs,
      static_cast<const int64_t*>(positions), static_cast<T*>(ckv),
      static_cast<T*>(k_rope), static_cast<T*>(q_rope), H, Dn, Dr, C, T_len,
      lanes, vec, factor, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int attend(const void* q, const void* q_rope, const void* wkv_b,
           const void* ckv, const void* k_rope, const void* positions,
           void* out, int B, int H, int Dn, int Dr, int Dv, int C, int T_len,
           float scale, cudaStream_t stream) {
  const dim3 grid(H, B);
  zipmoe_mla_absorbed_attend_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(q_rope),
      static_cast<const T*>(wkv_b), static_cast<const T*>(ckv),
      static_cast<const T*>(k_rope),
      static_cast<const int64_t*>(positions), static_cast<T*>(out), H, Dn,
      Dr, Dv, C, T_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 bfloat16, 1 float32 (every operand but kv_norm, freqs and
// positions).  freqs is a host array of Dr / 2 floats, copied into the
// launch's arguments.  Widths, caps and alignment are checked by the
// Python wrapper (kernels/mla_decode.py); a launch error comes back as its
// code.
extern "C" int zipmoe_mla_rope_write(const void* q, const void* kv,
                                     const void* kv_norm, const float* freqs,
                                     const void* positions, void* ckv,
                                     void* k_rope, void* q_rope, int B, int H,
                                     int Dn, int Dr, int C, int T_len,
                                     int lanes, int vec, float factor,
                                     float eps, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (Dr / 2 > kMaxHalfRope) return static_cast<int>(cudaErrorInvalidValue);
  RopeFreqs f{};
  for (int i = 0; i < Dr / 2; ++i) f.v[i] = freqs[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rope_write<__nv_bfloat16>(q, kv, kv_norm, f, positions, ckv,
                                     k_rope, q_rope, B, H, Dn, Dr, C, T_len,
                                     lanes, vec, factor, eps, s);
  return rope_write<float>(q, kv, kv_norm, f, positions, ckv, k_rope, q_rope,
                           B, H, Dn, Dr, C, T_len, lanes, vec, factor, eps,
                           s);
}

extern "C" int zipmoe_mla_absorbed_attend(
    const void* q, const void* q_rope, const void* wkv_b, const void* ckv,
    const void* k_rope, const void* positions, void* out, int B, int H,
    int Dn, int Dr, int Dv, int C, int T_len, float scale, int dtype,
    void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return attend<__nv_bfloat16>(q, q_rope, wkv_b, ckv, k_rope, positions,
                                 out, B, H, Dn, Dr, Dv, C, T_len, scale, s);
  return attend<float>(q, q_rope, wkv_b, ckv, k_rope, positions, out, B, H,
                       Dn, Dr, Dv, C, T_len, scale, s);
}
