// The LayerNorm adjoint row body shared by kernels 10, 11 and 12: the LN
// backward (layer_norm.cu) and the tails of the LN->GEMM backwards
// (ln_gemm_bwd.cu).
//
// Given x [M, K], the scale s [K] and the cotangent of LN(x)*s, dy [M, K]
// (g itself for the plain LN; g.W for an LN folded into a GEMM), each warp
// takes one row at a time and
//   1. recomputes mean and rstd from E[x^2] - E[x]^2 in fp32;
//   2. forms h = (x - mean) * rstd;
//   3. writes dx = rstd * (dy*s - mean(dy*s) - h * mean(dy*s*h)) in x's type,
//      plus, for the add+LN form (ops/layer_norm.py::_add_ln_bwd), the
//      residual stream's cotangent gh, added in fp32 before the one round;
//   4. adds dy*h to its own fp32 row of dscale partial sums.
// dscale sums in a fixed order, with no atomics, so two runs give the same
// bits: each lane owns the same columns of every row it visits, a CTA sums
// its 8 warps' rows in order into one partial row [parts, K], and a second
// launch sums the partial rows in a fixed order (8 strided warp sums, then
// those in order) and rounds once to s's type. The
// TPU kernels (ops/layer_norm.py::_ln_bwd_kernel, geglu.py's
// _ln_matmul_bwd_kernel / _ln_geglu_bwd_kernel) sum row tiles in order too.
//
// Memory bound: a row of x is read three times and dy twice (the repeats hit
// L1/L2), dx written once; the partials are K floats per 64 rows.
#pragma once

#include "common.cuh"

// Internal linkage: each .cu that includes this keeps its own copy of the
// kernels, so no launch depends on another translation unit's registration.
namespace ln_adjoint {
namespace {

constexpr int WARPS = 8, ROWS_PER_WARP = 8, ROWS = WARPS * ROWS_PER_WARP;

// Partial dscale rows a launch over M rows writes ([parts(M), K] fp32).
inline int parts(int M) { return (M + ROWS - 1) / ROWS; }

// ADD_GH is a template argument, so the form without gh compiles to the
// code it was before gh existed and gives the same bits.
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

// dscale[c] = the sum of partial[p][c] over p, in a fixed order: warp w of
// a block sums rows p = w, w + 8, ... of 32 columns (a lane each, so the
// loads coalesce), then warp 0 adds the 8 warp sums in order.
template <typename T>
__global__ void __launch_bounds__(256)
    reduce_kernel(const float* __restrict__ partial, int n_parts, int K, T* __restrict__ dscale) {
  __shared__ float sums[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < K)
    for (int p = warp; p < n_parts; p += 8) acc += partial[(size_t)p * K + c];
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < K) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) total += sums[w][lane];
    dscale[c] = from_f32<T>(total);
  }
}

template <typename T, typename DY, bool ADD_GH>
int launch_rows(const void* x, const void* scale, const void* dy, const void* gh, void* dx,
                float* partial, int M, int K, float eps, cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * K * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      row_kernel<T, DY, ADD_GH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  row_kernel<T, DY, ADD_GH><<<parts(M), WARPS * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const DY*>(dy),
      static_cast<const T*>(gh), static_cast<T*>(dx), partial, M, K, eps);
  return (int)cudaGetLastError();
}

// Both launches on `stream`; partial holds parts(M) * K floats; gh [M, K] in
// x's type, or null.
template <typename T, typename DY>
int launch(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
           float* partial, int M, int K, float eps, cudaStream_t stream,
           const void* gh = nullptr) {
  const int n_parts = parts(M);
  const int rows_err =
      gh == nullptr
          ? launch_rows<T, DY, false>(x, scale, dy, gh, dx, partial, M, K, eps, stream)
          : launch_rows<T, DY, true>(x, scale, dy, gh, dx, partial, M, K, eps, stream);
  if (rows_err != 0) return rows_err;
  reduce_kernel<T><<<(K + 31) / 32, 256, 0, stream>>>(partial, n_parts, K,
                                                      static_cast<T*>(dscale));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ln_adjoint
