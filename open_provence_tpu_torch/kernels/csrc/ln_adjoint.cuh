// The LayerNorm adjoint row body shared by kernels 10, 11, 12 and 13: the LN
// backward (layer_norm.cu) and the tails of the LN->GEMM backwards
// (mlp_tail_bwd.cu; ln_gemm_bwd.cu on its split route, fp32 and K > 2048,
// and the second pass, reduce, of its fused one).
//
// Given x [M, K], the scale s [K] and the cotangent of LN(x)*s, dy [M, K]
// (g itself for the plain LN, in x's type; g.W in fp32 for an LN folded into
// a GEMM), each warp takes one row at a time and
//   1. recomputes mean and rstd from E[x^2] - E[x]^2 in fp32;
//   2. forms h = (x - mean) * rstd;
//   3. writes dx = rstd * (dy*s - mean(dy*s) - h * mean(dy*s*h)) in x's type,
//      plus, for the add+LN form (ops/layer_norm.py::_add_ln_bwd), the
//      residual stream's cotangent gh, added in fp32 before the one round;
//   4. adds dy*h to fp32 sums of dscale over the rows it visits.
// dscale sums in a fixed order, with no atomics on data, so two runs give the
// same bits: a warp sums its rows in order, a CTA adds its warps' sums in warp
// order into one partial row [parts, K], and a second launch adds the partial
// rows in a fixed order and rounds once to s's type. parts = ceil(M / ROWS),
// a function of the shape alone (kernels.LN_ADJOINT_ROWS mirrors ROWS). The
// TPU kernels (ops/layer_norm.py::_ln_bwd_kernel, geglu.py's
// _ln_matmul_bwd_kernel / _ln_geglu_bwd_kernel / _ln_geglu_wo_bwd_kernel)
// sum row tiles in order too.
//
// Memory bound: x and dy are read once and dx written once (75.5 MB at
// M = 16384, K = 768 in bf16; 100.7 MB with gh or an fp32 dy), against
// ~2 KFLOP a row. Two instances:
//   * registers (K = 768 and 1024, the configs' widths; K a compile-time
//     number of 256-column chunks): lane l owns columns [8l, 8l + 8) of every
//     chunk, so a row moves in 16-byte loads and stores (one per chunk and
//     operand in bf16, two in fp32), lives in registers from its load to its
//     store, and the statistics and both means come from registers. A warp
//     holds two rows at once: it issues both rows' loads, then reduces and
//     writes one while the other's are still in flight; 16 warps an SM at
//     K = 768 in bf16 (128 registers a thread), 8 elsewhere. Each lane keeps
//     its columns' dscale sums in registers, and the CTA writes them to
//     shared memory once, at its end. Every pointer must be 16-byte aligned
//     (the wrappers see to it; a misaligned launch is refused).
//   * strided (every other K, any alignment): a lane walks columns lane,
//     lane + 32, ... in element loads, reading a row of x three times and dy
//     twice (the repeats hit L1), with a shared-memory row of dscale sums per
//     warp. Same ROWS, so the same partial rows.
#pragma once

#include "common.cuh"

// Internal linkage: each .cu that includes this keeps its own copy of the
// kernels, so no launch depends on another translation unit's registration.
namespace ln_adjoint {
namespace {

// The launch shape of both instances (the measured choice; PERF.md lists
// the designs tried): warps a CTA and rows a warp.
constexpr int WARPS = 8, ROWS_PER_WARP = 8;
constexpr int ROWS = WARPS * ROWS_PER_WARP;
// Columns a warp covers with one 16-byte access of bf16 a lane.
constexpr int CHUNK = 256;
// The widths with a register instance, as chunk counts.
constexpr int REGISTER_CHUNKS[] = {3, 4};
// The reduction of the partial rows: warps a CTA, each summing every
// REDUCE_WARPS-th partial row of 32 columns.
constexpr int REDUCE_WARPS = 16;

// Partial dscale rows a launch over M rows writes ([parts(M), K] fp32).
inline int parts(int M) { return (M + ROWS - 1) / ROWS; }

// Chunks of the register instance for width K, or 0 for the strided one.
inline int register_chunks(int K) {
  for (int n : REGISTER_CHUNKS)
    if (K == n * CHUNK) return n;
  return 0;
}

// Eight consecutive elements of T as 16-byte words: one in bf16, two in fp32.
template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  // bf16 -> fp32 is the bits shifted into the high half. The conversion is
  // opaque to the compiler (asm volatile), so each use converts the loaded
  // words again instead of keeping 8 floats a word alive across a row's
  // reductions: registers, not these few instructions, bound the rows a
  // warp can have in flight.
  __device__ __forceinline__ void to_f32(float* f) const {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t lo, hi;
      asm volatile("shl.b32 %0, %2, 16;\n\tand.b32 %1, %2, 0xffff0000;"
                   : "=r"(lo), "=r"(hi)
                   : "r"(words[i]));
      f[2 * i] = __uint_as_float(lo);
      f[2 * i + 1] = __uint_as_float(hi);
    }
  }
  __device__ static __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    *reinterpret_cast<uint4*>(p) = pack8(f);
  }
};

template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void to_f32(float* f) const {
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
  __device__ static __forceinline__ void store(float* p, const float* f) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

// One lane's share of a row: its 8 columns of each of the NCH chunks of x
// and dy, as loaded.
template <typename T, typename DY, int NCH>
struct RowShare {
  Vec8<T> x[NCH];
  Vec8<DY> dy[NCH];
  __device__ __forceinline__ void load(const T* xr, const DY* dyr) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      x[j].load(xr + j * CHUNK);
      dy[j].load(dyr + j * CHUNK);
    }
  }
};

// The scale of a lane's columns: held in registers in bf16 (a word a
// chunk), read again from L1 at each use in fp32, where a row already takes
// twice the registers.
template <typename T, int NCH>
struct ScaleShare {
  Vec8<T> v[NCH];
  __device__ __forceinline__ void init(const T* s) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) v[j].load(s + j * CHUNK);
  }
  __device__ __forceinline__ void get(int j, float* f) const { v[j].to_f32(f); }
};

template <int NCH>
struct ScaleShare<float, NCH> {
  const float* p;
  __device__ __forceinline__ void init(const float* s) { p = s; }
  __device__ __forceinline__ void get(int j, float* f) const {
    Vec8<float> v;
    v.load(p + j * CHUNK);
    v.to_f32(f);
  }
};

// CTAs an SM should hold: 16 warps (128 registers a thread) where a lane's
// two rows fit (bf16 x at K = 768), else 8.
template <typename T, int NCH>
constexpr int min_ctas() {
  return (sizeof(T) == 2 && NCH <= 3 ? 16 : 8) / WARPS;
}

// dx of one row from its loaded share, and the row's dy*h added to acc.
template <typename T, typename DY, bool ADD_GH, int NCH>
__device__ __forceinline__ void adjoint_row(const RowShare<T, DY, NCH>& row,
                                            const ScaleShare<T, NCH>& sv, const T* gh, T* dx,
                                            float (&acc)[NCH][8], float eps) {
  constexpr int K = NCH * CHUNK;
  Vec8<T> ghv[NCH];
  if constexpr (ADD_GH) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) ghv[j].load(gh + j * CHUNK);
  }
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    float v[8];
    row.x[j].to_f32(v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s += v[e];
      s2 += v[e] * v[e];
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = s / (float)K;
  const float rstd = rsqrtf(fmaxf(s2 / (float)K - mean * mean, 0.f) + eps);
  float m1 = 0.f, m2 = 0.f;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    float v[8], d[8], sc[8];
    row.x[j].to_f32(v);
    row.dy[j].to_f32(d);
    sv.get(j, sc);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float h = (v[e] - mean) * rstd;
      const float ds = d[e] * sc[e];
      m1 += ds;
      m2 += ds * h;
      acc[j][e] += d[e] * h;
    }
  }
  m1 = warp_sum(m1) / (float)K;
  m2 = warp_sum(m2) / (float)K;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    float v[8], d[8], sc[8], g[8];
    row.x[j].to_f32(v);
    row.dy[j].to_f32(d);
    sv.get(j, sc);
    if constexpr (ADD_GH) ghv[j].to_f32(g);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float h = (v[e] - mean) * rstd;
      v[e] = rstd * (d[e] * sc[e] - m1 - h * m2);
      if constexpr (ADD_GH) v[e] += g[e];
    }
    Vec8<T>::store(dx + j * CHUNK, v);
  }
}

template <typename T, typename DY, bool ADD_GH, int NCH>
__global__ void __launch_bounds__(WARPS * 32, (min_ctas<T, NCH>()))
    register_row_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                        const DY* __restrict__ dy, const T* __restrict__ gh, T* __restrict__ dx,
                        float* __restrict__ partial, int M, float eps) {
  constexpr int K = NCH * CHUNK;
  __shared__ __align__(16) float ds_warp[WARPS][K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = lane * 8;  // of each chunk
  ScaleShare<T, NCH> sv;
  sv.init(scale + col);
  float acc[NCH][8];
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;

  const int row0 = blockIdx.x * ROWS + warp * ROWS_PER_WARP;
  const int rows = min(ROWS_PER_WARP, M - row0);  // warp-uniform; may be <= 0
  // Two rows a turn, both loaded before the first is reduced. The loop is
  // not unrolled, so the compiler keeps two rows, not all of a warp's, in
  // registers.
  RowShare<T, DY, NCH> a, b;
  const size_t base = (size_t)row0 * K + col;
#pragma unroll 1
  for (int i = 0; i < rows; i += 2) {
    const size_t off = base + (size_t)i * K;
    a.load(x + off, dy + off);
    if (i + 1 < rows) b.load(x + off + K, dy + off + K);
    adjoint_row<T, DY, ADD_GH, NCH>(a, sv, gh + off, dx + off, acc, eps);
    if (i + 1 >= rows) break;
    adjoint_row<T, DY, ADD_GH, NCH>(b, sv, gh + off + K, dx + off + K, acc, eps);
  }
  // The warps' sums, added in warp order into the CTA's partial row.
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    float4* dst = reinterpret_cast<float4*>(&ds_warp[warp][j * CHUNK + col]);
    dst[0] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    dst[1] = make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
  }
  __syncthreads();
  for (int c = threadIdx.x * 4; c < K; c += WARPS * 32 * 4) {
    float4 total = *reinterpret_cast<const float4*>(&ds_warp[0][c]);
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float4 v = *reinterpret_cast<const float4*>(&ds_warp[w][c]);
      total.x += v.x, total.y += v.y, total.z += v.z, total.w += v.w;
    }
    *reinterpret_cast<float4*>(partial + (size_t)blockIdx.x * K + c) = total;
  }
}

// Every other width: element loads strided by 32, a shared-memory row of
// dscale sums per warp. ADD_GH is a template argument, so the form without gh
// is the code it was before gh existed and gives the same bits.
template <typename T, typename DY, bool ADD_GH>
__global__ void __launch_bounds__(WARPS * 32)
    row_kernel(const T* __restrict__ x, const T* __restrict__ scale, const DY* __restrict__ dy,
               const T* __restrict__ gh, T* __restrict__ dx, float* __restrict__ partial, int M,
               int K, float eps) {
  extern __shared__ float ds_warp[];  // [WARPS][K]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* mine = ds_warp + (size_t)warp * K;
  for (int c = lane; c < K; c += 32) mine[c] = 0.f;
  const int row0 = blockIdx.x * ROWS + warp * ROWS_PER_WARP;
  for (int rr = 0; rr < ROWS_PER_WARP && row0 + rr < M; ++rr) {
    const size_t off = (size_t)(row0 + rr) * K;
    const T* xr = x + off;
    const DY* dyr = dy + off;
    float mean, rstd;
    warp_row_stats(xr, K, eps, &mean, &rstd);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < K; c += 32) {
      const float h = (to_f32(xr[c]) - mean) * rstd;
      const float d = to_f32(dyr[c]);
      const float ds = d * to_f32(scale[c]);
      s1 += ds;
      s2 += ds * h;
      mine[c] += d * h;
    }
    s1 = warp_sum(s1) / (float)K;
    s2 = warp_sum(s2) / (float)K;
    T* dxr = dx + off;
    for (int c = lane; c < K; c += 32) {
      const float h = (to_f32(xr[c]) - mean) * rstd;
      const float ds = to_f32(dyr[c]) * to_f32(scale[c]);
      float v = rstd * (ds - s1 - h * s2);
      if constexpr (ADD_GH) v += to_f32(gh[off + c]);
      dxr[c] = from_f32<T>(v);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < K; c += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc += ds_warp[(size_t)w * K + c];
    partial[(size_t)blockIdx.x * K + c] = acc;
  }
}

// dscale[c] = the sum of partial[p][c] over p, in a fixed order: warp w of a
// CTA sums rows p = w, w + REDUCE_WARPS, ... of 32 columns (a lane each, so a
// warp reads 128-byte lines), then warp 0 adds the warp sums in order.
template <typename T>
__global__ void __launch_bounds__(REDUCE_WARPS * 32)
    reduce_kernel(const float* __restrict__ partial, int n_parts, int K, T* __restrict__ dscale) {
  __shared__ float sums[REDUCE_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < K) {
#pragma unroll 8
    for (int p = warp; p < n_parts; p += REDUCE_WARPS) acc += partial[(size_t)p * K + c];
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < K) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < REDUCE_WARPS; ++w) total += sums[w][lane];
    dscale[c] = from_f32<T>(total);
  }
}

// The second pass on `stream`: dscale [K] from n_parts partial rows [n_parts,
// K] fp32 (this file's row kernels write parts(M); kernels 11 and 12's fused
// route one a tile of 128 rows).
template <typename T>
int reduce(const float* partial, int n_parts, int K, void* dscale, cudaStream_t stream) {
  reduce_kernel<T><<<(K + 31) / 32, REDUCE_WARPS * 32, 0, stream>>>(partial, n_parts, K,
                                                                    static_cast<T*>(dscale));
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, typename DY, bool ADD_GH, int NCH>
int launch_register_rows(const void* x, const void* scale, const void* dy, const void* gh,
                         void* dx, float* partial, int M, float eps, cudaStream_t stream) {
  register_row_kernel<T, DY, ADD_GH, NCH><<<parts(M), WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const DY*>(dy),
      static_cast<const T*>(gh), static_cast<T*>(dx), partial, M, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename DY, bool ADD_GH>
int launch_rows(const void* x, const void* scale, const void* dy, const void* gh, void* dx,
                float* partial, int M, int K, float eps, cudaStream_t stream) {
  switch (register_chunks(K)) {
    case 3:
      return launch_register_rows<T, DY, ADD_GH, 3>(x, scale, dy, gh, dx, partial, M, eps,
                                                    stream);
    case 4:
      return launch_register_rows<T, DY, ADD_GH, 4>(x, scale, dy, gh, dx, partial, M, eps,
                                                    stream);
    default:
      break;
  }
  const size_t smem = (size_t)WARPS * K * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      row_kernel<T, DY, ADD_GH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  row_kernel<T, DY, ADD_GH><<<parts(M), WARPS * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const DY*>(dy),
      static_cast<const T*>(gh), static_cast<T*>(dx), partial, M, K, eps);
  return (int)cudaGetLastError();
}

// Both launches on `stream`; partial holds parts(M) * K floats. ADD_GH (the
// add + LN form of kernel 10) adds gh [M, K] in x's type. The register
// instance (K = 768, 1024) refuses pointers that are not 16-byte aligned.
template <typename T, typename DY, bool ADD_GH = false>
int launch(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
           float* partial, int M, int K, float eps, cudaStream_t stream,
           const void* gh = nullptr) {
  if (register_chunks(K) != 0 &&
      !(aligned16(x) && aligned16(scale) && aligned16(dy) && aligned16(dx) &&
        (!ADD_GH || aligned16(gh))))
    return (int)cudaErrorMisalignedAddress;
  const int rows_err =
      launch_rows<T, DY, ADD_GH>(x, scale, dy, gh, dx, partial, M, K, eps, stream);
  if (rows_err != 0) return rows_err;
  return reduce<T>(partial, parts(M), K, dscale, stream);
}

// What a launch over M x K runs: {instance (1 registers, 0 strided), partial
// rows, rows a CTA, warps a CTA, chunks of 256 columns (0 when strided),
// warps of the reduction}.
inline void design(int M, int K, int* out) {
  const int d[6] = {register_chunks(K) != 0, parts(M), ROWS, WARPS, register_chunks(K),
                    REDUCE_WARPS};
  for (int i = 0; i < 6; ++i) out[i] = d[i];
}

}  // namespace
}  // namespace ln_adjoint
