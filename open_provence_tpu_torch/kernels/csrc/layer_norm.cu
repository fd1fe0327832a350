// Bias-free LayerNorm over the last dim: one warp per row.
//
// Replaces ops/layer_norm.py::_ln_kernel (the embedding norm, final_norm and
// the prediction head's norm). Memory bound: it reads each row twice (the
// second read hits L1/L2) and writes it once; the statistics are fp32
// E[x] and E[x^2] exactly as the TPU kernel takes them. A warp per row keeps
// the reduction in shuffles, with no shared memory and no block barrier.
//
// The same file holds the residual add + LayerNorm (opt_add_layer_norm,
// replacing ops/layer_norm.py::_add_ln_kernel) and the LayerNorm adjoint
// (opt_layer_norm_bwd, replacing ops/layer_norm.py::_ln_bwd_kernel).
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

// h = T(x + y), out = LN(h) * scale: the residual add fused into the norm
// that follows it. The sum is taken in fp32 and rounded once to T; the
// statistics and the normalization read the ROUNDED sum, summed in
// warp_row_stats' order, so (h, out) equal an add followed by
// layer_norm_kernel bit for bit. Memory bound: x and y are read twice (the
// repeat hits L1/L2), h and out written once, where the two separate passes
// write h, read it again and write out.
template <typename T>
__global__ void add_layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                      const T* __restrict__ scale, T* __restrict__ h,
                                      T* __restrict__ out, int rows, int hidden, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const size_t off = (size_t)row * hidden;
  const T* xr = x + off;
  const T* yr = y + off;
  T* hr = h + off;
  T* orow = out + off;
  const int lane = threadIdx.x & 31;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < hidden; c += 32) {
    const T hv = from_f32<T>(to_f32(xr[c]) + to_f32(yr[c]));
    hr[c] = hv;
    const float v = to_f32(hv);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = s / (float)hidden;
  const float var = fmaxf(s2 / (float)hidden - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  for (int c = lane; c < hidden; c += 32) {
    const float v = round_to<T>(to_f32(xr[c]) + to_f32(yr[c]));
    const float n = (v - mean) * rstd;
    orow[c] = from_f32<T>(n * to_f32(scale[c]));
  }
}

template <typename T>
void launch_add(const void* x, const void* y, const void* scale, void* h, void* out, int rows,
                int hidden, float eps, cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  add_layer_norm_kernel<T><<<grid, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(scale),
      static_cast<T*>(h), static_cast<T*>(out), rows, hidden, eps);
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

// ---- residual add + LayerNorm: kernel 7 ----------------------------------------
//
// Replaces ops/layer_norm.py::_add_ln_kernel: (h, out) = (x + y, LN(x + y)),
// all [rows, hidden] in one storage type. Its adjoint is opt_layer_norm_bwd
// on h with the cotangent of h passed as gh.
extern "C" int opt_add_layer_norm(const void* x, const void* y, const void* scale, void* h,
                                  void* out, int rows, int hidden, float eps, int dtype,
                                  void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    launch_add<float>(x, y, scale, h, out, rows, hidden, eps, s);
  else if (dtype == DTYPE_BF16)
    launch_add<__nv_bfloat16>(x, y, scale, h, out, rows, hidden, eps, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// ---- backward: kernel 10 -----------------------------------------------------
//
// Replaces ops/layer_norm.py::_ln_bwd_kernel (the adjoint of the embedding
// norm, final_norm and the prediction head's norm, and with gh the adjoint
// of the add + LayerNorm above): the LN-adjoint row body of ln_adjoint.cuh
// with dy = g. gh [rows, hidden] in x's type is the cotangent that reaches
// x past the norm (the residual stream's); it is added to dx in fp32 before
// the round, and may be null. dx comes back in x's type, dscale in the
// scale's (the same as x's here); partial holds ln_adjoint::parts(rows) *
// hidden floats of scratch for the fixed-order dscale sum. Any rows (the
// head norm has B), any hidden; at hidden 768 and 1024 every pointer must be
// 16-byte aligned.
namespace {

template <typename T>
int layer_norm_bwd(const void* x, const void* scale, const void* g, const void* gh, void* dx,
                   void* dscale, float* partial, int rows, int hidden, float eps,
                   cudaStream_t s) {
  if (gh == nullptr)
    return ln_adjoint::launch<T, T>(x, scale, g, dx, dscale, partial, rows, hidden, eps, s);
  return ln_adjoint::launch<T, T, true>(x, scale, g, dx, dscale, partial, rows, hidden, eps, s,
                                        gh);
}

}  // namespace

extern "C" int opt_layer_norm_bwd(const void* x, const void* scale, const void* g,
                                  const void* gh, void* dx, void* dscale, float* partial,
                                  int rows, int hidden, float eps, int dtype, void* stream) {
  if (rows <= 0 || hidden <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return layer_norm_bwd<float>(x, scale, g, gh, dx, dscale, partial, rows, hidden, eps, s);
  if (dtype == DTYPE_BF16)
    return layer_norm_bwd<__nv_bfloat16>(x, scale, g, gh, dx, dscale, partial, rows, hidden, eps,
                                         s);
  return (int)cudaErrorInvalidValue;
}

// The LN adjoint's design for rows x hidden (kernels 10-13 alike), as
// ln_adjoint::design reports it: six ints into out.
extern "C" int opt_ln_adjoint_design(int rows, int hidden, int* out) {
  if (rows <= 0 || hidden <= 0) return -1;
  ln_adjoint::design(rows, hidden, out);
  return 0;
}
