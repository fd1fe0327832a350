// Bias-free LayerNorm over the last dim: one warp per row.
//
// Replaces ops/layer_norm.py::_ln_kernel (the embedding norm, final_norm and
// the prediction head's norm). Memory bound: it reads each row twice (the
// second read hits L1/L2) and writes it once; the statistics are fp32
// E[x] and E[x^2] exactly as the TPU kernel takes them. A warp per row keeps
// the reduction in shuffles, with no shared memory and no block barrier.
#include "common.cuh"
#include "ln_adjoint.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // 8 warps of 32 threads

template <typename T>
__global__ void layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                                  T* __restrict__ out, int rows, int hidden, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const T* xr = x + (size_t)row * hidden;
  T* orow = out + (size_t)row * hidden;
  float mean, rstd;
  warp_row_stats(xr, hidden, eps, &mean, &rstd);
  for (int c = threadIdx.x & 31; c < hidden; c += 32) {
    const float y = (to_f32(xr[c]) - mean) * rstd;
    orow[c] = from_f32<T>(y * to_f32(scale[c]));
  }
}

template <typename T>
void launch(const void* x, const void* scale, void* out, int rows, int hidden, float eps,
            cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  layer_norm_kernel<T><<<grid, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(out), rows,
      hidden, eps);
}

}  // namespace

extern "C" int opt_layer_norm(const void* x, const void* scale, void* out, int rows,
                              int hidden, float eps, int dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    launch<float>(x, scale, out, rows, hidden, eps, s);
  else if (dtype == DTYPE_BF16)
    launch<__nv_bfloat16>(x, scale, out, rows, hidden, eps, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// ---- backward: kernel 10 -----------------------------------------------------
//
// Replaces ops/layer_norm.py::_ln_bwd_kernel (the adjoint of the embedding
// norm, final_norm and the prediction head's norm): the LN-adjoint row body
// of ln_adjoint.cuh with dy = g. dx comes back in x's type, dscale in the
// scale's (the same as x's here); partial holds ceil(rows / 64) * hidden
// floats of scratch for the fixed-order dscale sum. Any rows (the head norm
// has B), any hidden.
extern "C" int opt_layer_norm_bwd(const void* x, const void* scale, const void* g, void* dx,
                                  void* dscale, float* partial, int rows, int hidden, float eps,
                                  int dtype, void* stream) {
  if (rows <= 0 || hidden <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return ln_adjoint::launch<float, float>(x, scale, g, dx, dscale, partial, rows, hidden, eps, s);
  if (dtype == DTYPE_BF16)
    return ln_adjoint::launch<__nv_bfloat16, __nv_bfloat16>(x, scale, g, dx, dscale, partial,
                                                            rows, hidden, eps, s);
  return (int)cudaErrorInvalidValue;
}
