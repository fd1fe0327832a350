// Backward of the LayerNorm folded into its GEMM: kernels 12 and 11.
//
// opt_ln_matmul_bwd replaces ops/geglu.py::_ln_matmul_bwd_kernel (the
//   adjoint of attn_norm -> Wqkv): given x [M, K], s [K], W [N, K] (torch
//   layout) and g = d out [M, N], it writes dx [M, K], dW [N, K], ds [K].
// opt_ln_geglu_bwd replaces ops/geglu.py::_ln_geglu_bwd_kernel (the adjoint
//   of mlp_norm -> Wi -> act * gate): given Wi [2I, K] and g [M, I], it
//   writes dx, dWi [2I, K] and ds.
//
// The TPU kernel does all of it in one pass over row tiles, with the weight
// and an fp32 dW accumulator resident in 16+ MB of VMEM. A Hopper CTA has
// 227 KB of shared memory, so the work is split into launches on the
// caller's stream, each simple, with the intermediates in scratch buffers
// the wrapper allocates:
//   1. xn = T(h * s), h = (x - mean) * rstd from fp32 E[x^2] - E[x]^2: the
//      forward's rounding point, into scratch [M, K];
//   2. (GeGLU) pre = T(xn . Wi^T) [M, 2I], the forward's rounded inp | gate,
//      then in place the TPU kernel's rounding chain (geglu.py:384-393):
//      a = T(act(inp)), da = act'(inp) in fp32, gi = T(g * da * gate),
//      gg = T(g * a), so G = [gi | gg] is the cotangent of [inp | gate];
//   3. dW = G^T . xn, rounded once to the weight's type: in bf16 the M rows
//      are cut into chunks (kernels.dw_chunk_rows), each chunk's fp32 sums
//      go to scratch [chunks, N, K] and a second pass adds them in chunk
//      order (fixed order, no atomics); in fp32 one CTA sums all M rows;
//   4. dy = G . W in fp32, into scratch [M, K];
//   5. the LN-adjoint row body (ln_adjoint.cuh) on (x, s, dy): dx and ds.
// At base widths (M = 16384, K = 768, N = 2304 or 2I = 2304) steps 2-4 are
// 58 GFLOP each, so the GEMMs bound it. Steps 1-4 run on gemm.cuh, the
// engine the forward (ln_gemm.cu) runs on: in bf16 all three products on
// wgmma fed by TMA (gemm_wgmma.cuh; step 2 K-major x K-major, step 3 both
// operands MN-major, step 4 an MN-major W); fp32 on FMA (true fp32, no
// TF32).
#include "gemm.cuh"
#include "ln_adjoint.cuh"

namespace {

using gemm_engine::gemm;
using gemm_engine::normalize;

// ---- step 2b: the GeGLU cotangents, in place over pre -------------------------

template <typename T>
__global__ void geglu_grad_kernel(T* __restrict__ pre, const T* __restrict__ g, int M, int I,
                                  int act) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)M * I) return;
  const size_t m = idx / I, j = idx % I;
  T* row = pre + m * 2 * I;
  const float inp = to_f32(row[j]), gate = to_f32(row[I + j]);
  const float a = round_to<T>(activation(inp, act));
  const float da = activation_grad(inp, act);
  const float gv = to_f32(g[idx]);
  row[j] = from_f32<T>(gv * da * gate);
  row[I + j] = from_f32<T>(gv * a);
}

// Steps 1, 3, 4, 5 around a cotangent G [M, N] of xn . W^T, W [N, K]; for
// GeGLU, G is step 2's output and W is Wi.
template <typename T>
int ln_gemm_bwd(const T* x, const T* scale, const T* w, const T* G, T* dx, T* dw, T* dscale,
                const T* xn, float* dy, float* partial, float* dw_partial, int chunk_rows, int M,
                int K, int N, float eps, cudaStream_t s) {
  OPT_TRY(gemm<true, true>(G, N, xn, K, dw, K, N, K, M, s, 0, dw_partial, chunk_rows));  // dW
  OPT_TRY(gemm<false, true>(G, N, w, K, dy, K, M, K, N, s));                             // dy
  return ln_adjoint::launch<T, float>(x, scale, dy, dx, dscale, partial, M, K, eps, s);
}

template <typename T>
int matmul_bwd(const void* x, const void* scale, const void* w, const void* g, void* dx,
               void* dw, void* dscale, void* xn, float* dy, float* partial, float* dw_partial,
               int chunk_rows, int M, int K, int N, float eps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(scale);
  T* xnt = static_cast<T*>(xn);
  OPT_TRY(normalize<T>(xt, st, xnt, M, K, eps, s));
  return ln_gemm_bwd<T>(xt, st, static_cast<const T*>(w), static_cast<const T*>(g),
                        static_cast<T*>(dx), static_cast<T*>(dw), static_cast<T*>(dscale), xnt,
                        dy, partial, dw_partial, chunk_rows, M, K, N, eps, s);
}

template <typename T>
int geglu_bwd(const void* x, const void* scale, const void* wi, const void* g, void* dx,
              void* dwi, void* dscale, void* xn, void* pre, float* dy, float* partial,
              float* dw_partial, int chunk_rows, int M, int K, int I, float eps, int act,
              cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(scale);
  const T* wt = static_cast<const T*>(wi);
  T* xnt = static_cast<T*>(xn);
  T* pret = static_cast<T*>(pre);
  OPT_TRY(normalize<T>(xt, st, xnt, M, K, eps, s));
  OPT_TRY(gemm<false, false>(xnt, K, wt, K, pret, 2 * I, M, 2 * I, K, s));  // [inp | gate]
  const size_t n = (size_t)M * I;
  geglu_grad_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      pret, static_cast<const T*>(g), M, I, act);
  OPT_TRY((int)cudaGetLastError());
  return ln_gemm_bwd<T>(xt, st, wt, pret, static_cast<T*>(dx), static_cast<T*>(dwi),
                        static_cast<T*>(dscale), xnt, dy, partial, dw_partial, chunk_rows, M, K,
                        2 * I, eps, s);
}

}  // namespace

// Scratch the wrapper allocates: xn [M, K] in the storage type, dy [M, K]
// fp32, partial [ln_adjoint::parts(M), K] fp32, for GeGLU pre [M, 2I] in the
// storage type, and in bf16 dw_partial [ceil(M / chunk_rows), N or 2I, K]
// fp32 (fp32 ignores it and chunk_rows). All tensors contiguous.
extern "C" int opt_ln_matmul_bwd(const void* x, const void* scale, const void* w, const void* g,
                                 void* dx, void* dw, void* dscale, void* xn, float* dy,
                                 float* partial, float* dw_partial, int m, int k, int n,
                                 int chunk_rows, float eps, int dtype, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return matmul_bwd<float>(x, scale, w, g, dx, dw, dscale, xn, dy, partial, dw_partial,
                             chunk_rows, m, k, n, eps, s);
  if (dtype == DTYPE_BF16)
    return matmul_bwd<__nv_bfloat16>(x, scale, w, g, dx, dw, dscale, xn, dy, partial, dw_partial,
                                     chunk_rows, m, k, n, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int opt_ln_geglu_bwd(const void* x, const void* scale, const void* wi, const void* g,
                                void* dx, void* dwi, void* dscale, void* xn, void* pre,
                                float* dy, float* partial, float* dw_partial, int m, int k,
                                int intermediate, int chunk_rows, float eps, int act, int dtype,
                                void* stream) {
  if (m <= 0 || k <= 0 || intermediate <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return geglu_bwd<float>(x, scale, wi, g, dx, dwi, dscale, xn, pre, dy, partial, dw_partial,
                            chunk_rows, m, k, intermediate, eps, act, s);
  if (dtype == DTYPE_BF16)
    return geglu_bwd<__nv_bfloat16>(x, scale, wi, g, dx, dwi, dscale, xn, pre, dy, partial,
                                    dw_partial, chunk_rows, m, k, intermediate, eps, act, s);
  return (int)cudaErrorInvalidValue;
}
