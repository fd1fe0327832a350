// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is templated on its storage type T (float or __nv_bfloat16),
// reads and writes T, and computes in fp32. The C entry points take a dtype
// code (DTYPE_F32 / DTYPE_BF16), launch on the caller's stream and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

enum { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an fp32 value to T's precision and back: the storage-dtype rounding
// point of the JAX package's kernels (identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Row statistics of a bias-free LayerNorm, as ops/layer_norm.py::_ln_kernel
// computes them: fp32 mean and E[x^2], var = max(E[x^2] - mean^2, 0),
// rstd = rsqrt(var + eps). Called by one full warp for one row.
template <typename T>
__device__ __forceinline__ void warp_row_stats(const T* row, int hidden, float eps,
                                               float* mean_out, float* rstd_out) {
  const int lane = threadIdx.x & 31;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < hidden; c += 32) {
    const float v = to_f32(row[c]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = s / (float)hidden;
  const float var = fmaxf(s2 / (float)hidden - mean * mean, 0.f);
  *mean_out = mean;
  *rstd_out = rsqrtf(var + eps);
}

// Eight bf16 (16 bytes) as floats, and back.
__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// The mask bias of ops/flash_attention.py: -finfo(f32).max, not -inf.
#define OPT_NEG_BIG (-FLT_MAX)
