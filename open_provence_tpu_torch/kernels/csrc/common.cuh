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

// D += A . B on tensor cores: one m16n8k16 product of bf16 fragments with
// fp32 accumulation. Fragment layouts (PTX ISA, "mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4, each 32-bit register holding two bf16 of
// consecutive k (lower half first):
//   a[0] = A[g][2t..], a[1] = A[g+8][2t..], a[2] = A[g][2t+8..], a[3] = A[g+8][2t+8..]
//   b[0] = B[2t..][g], b[1] = B[2t+8..][g]   (B is k x n, read as n-major rows)
//   d[0..1] = D[g][2t, 2t+1], d[2..3] = D[g+8][2t, 2t+1]
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix: four 8x8 b16 matrices from shared memory; lane l gives the
// address of row l % 8 of matrix l / 8 and receives, in r[i], matrix i's
// elements [l / 4][2 (l % 4) .. +1] — or with .trans [2 (l % 4) .. +1][l / 4].
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

// Two bf16 at an even element offset, as one 32-bit fragment register.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The mask bias of ops/flash_attention.py: -finfo(f32).max, not -inf.
#define OPT_NEG_BIG (-FLT_MAX)
