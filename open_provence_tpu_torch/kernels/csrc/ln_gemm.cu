// LayerNorm folded into the GEMM that consumes it: kernels 2 and 4 of the
// forward path, and kernel 6, the GEGLU GEMM without a norm.
//
// opt_ln_matmul replaces ops/geglu.py::_ln_matmul_kernel (attn_norm -> Wqkv,
//   layers 1 and up): out[M, N] = LN(x)[M, K] . W[N, K]^T.
// opt_ln_geglu replaces ops/geglu.py::_ln_geglu_kernel (mlp_norm -> Wi ->
//   act * gate): out[M, I] = act(LN(x) . Wi[:I]^T) * (LN(x) . Wi[I:]^T),
//   with Wi [2I, K] in torch's [out, in] layout.
//
// opt_geglu replaces ops/geglu.py::_geglu_kernel (a norm with a bias cannot
//   fold into the GEMM, so the MLP gets rows that are normalized already):
//   out[M, I] = act(x . Wi[:I]^T) * (x . Wi[I:]^T), one launch of the GEMM
//   engine with the GEGLU epilogue, x read as it lies.
//
// Kernels 2 and 4: two launches on the caller's stream, both from gemm.cuh, which the
// backward (ln_gemm_bwd.cu) shares: the normalized rows xn = T(LN(x) * s),
// rounded to the storage type at the TPU kernel's rounding point (_ln_rows),
// into a scratch [M, K] the wrapper allocates; then xn . W^T on the GEMM
// engine, with the GEGLU epilogue for kernel 4. bf16 (the serving and
// training dtype) runs on wgmma fed by TMA from a producer warpgroup
// (gemm_wgmma.cuh: fp32 sums, 128 x 256 tiles, a 4-stage ring); fp32 on
// FMA, so fp32 stays true fp32 (no TF32).
#include "gemm.cuh"

namespace {

using gemm_engine::Epi;

template <typename T, Epi E>
int ln_gemm(const void* x, const void* scale, const void* w, void* out, void* xn, int m, int k,
            int n, float eps, int act, cudaStream_t s) {
  T* xnt = static_cast<T*>(xn);
  OPT_TRY(gemm_engine::normalize<T>(static_cast<const T*>(x), static_cast<const T*>(scale),
                                    xnt, m, k, eps, s));
  return gemm_engine::gemm<false, false, E>(xnt, k, static_cast<const T*>(w), k,
                                            static_cast<T*>(out), n, m, n, k, s, act);
}

template <Epi E>
int dispatch(const void* x, const void* scale, const void* w, void* out, void* xn, int m, int k,
             int n, float eps, int act, int dtype, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return ln_gemm<float, E>(x, scale, w, out, xn, m, k, n, eps, act, s);
  if (dtype == DTYPE_BF16)
    return ln_gemm<__nv_bfloat16, E>(x, scale, w, out, xn, m, k, n, eps, act, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// xn: scratch [M, K] in the storage type. All tensors contiguous.
extern "C" int opt_ln_matmul(const void* x, const void* scale, const void* w, void* out,
                             void* xn, int m, int k, int n, float eps, int dtype, void* stream) {
  return dispatch<Epi::STORE>(x, scale, w, out, xn, m, k, n, eps, 0, dtype, stream);
}

extern "C" int opt_geglu(const void* x, const void* wi, void* out, int m, int k,
                         int intermediate, int act, int dtype, void* stream) {
  if (m <= 0 || intermediate <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return gemm_engine::gemm<false, false, Epi::GEGLU>(
        static_cast<const float*>(x), k, static_cast<const float*>(wi), k,
        static_cast<float*>(out), intermediate, m, intermediate, k, s, act);
  if (dtype == DTYPE_BF16)
    return gemm_engine::gemm<false, false, Epi::GEGLU>(
        static_cast<const __nv_bfloat16*>(x), k, static_cast<const __nv_bfloat16*>(wi), k,
        static_cast<__nv_bfloat16*>(out), intermediate, m, intermediate, k, s, act);
  return (int)cudaErrorInvalidValue;
}

extern "C" int opt_ln_geglu(const void* x, const void* scale, const void* wi, void* out,
                            void* xn, int m, int k, int intermediate, float eps, int act,
                            int dtype, void* stream) {
  return dispatch<Epi::GEGLU>(x, scale, wi, out, xn, m, k, intermediate, eps, act, dtype, stream);
}

// How the GEMM engine runs a layout (ta, tb: A, B transposed, as gemm<TA, TB>
// takes them) in a dtype, fixed when the library is built: out[0] = the
// products (0 FMA, 2 wgmma); out[1] = the fill (0 loads between two barriers
// a tile, 2 a TMA ring with mbarriers, one producer thread); out[2] = the
// ring's stages; out[3], out[4], out[5] = the tile's rows, B rows (output
// columns, half of them under GEGLU) and depth. Every bf16 layout runs on
// the one wgmma kernel. Returns 0, or -1 for another dtype.
extern "C" int opt_gemm_design(int ta, int tb, int dtype, int* out) {
  namespace ge = gemm_engine;
  (void)ta;
  (void)tb;
  if (dtype == DTYPE_F32) {
    const int design[6] = {0, 0, 1, ge::simt::BM, ge::simt::BN, ge::simt::BK};
    for (int i = 0; i < 6; ++i) out[i] = design[i];
  } else if (dtype == DTYPE_BF16) {
    const int design[6] = {2, 2, ge::wgm::STAGES, ge::wgm::BM, ge::wgm::BN, ge::wgm::BK};
    for (int i = 0; i < 6; ++i) out[i] = design[i];
  } else {
    return -1;
  }
  return 0;
}
