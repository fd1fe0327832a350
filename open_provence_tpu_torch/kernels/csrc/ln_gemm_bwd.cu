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
// and an fp32 dW accumulator resident in 16+ MB of VMEM, and never stores
// the projection, dy or the normalized rows. A Hopper CTA has 227 KB of
// shared memory and CTAs run in no order, so here the work is a few
// launches of the GEMM engine (gemm.cuh) on the caller's stream, with the
// intermediates in scratch the wrapper allocates:
//   1. xn = T(h * s), h = (x - mean) * rstd from fp32 E[x^2] - E[x]^2: the
//      forward's rounding point, into scratch [M, K], and (the fused route)
//      each row's (mean, rstd) into stats [M, 2] fp32;
//   2. (GeGLU) the recomputed projection [inp | gate] = xn . Wi^T with the
//      GEGLU_GRAD epilogue: the thread that holds an input's fp32 sum holds
//      its gate's and applies the TPU kernel's rounding chain
//      (geglu.py:384-393) with g's tile, brought into the ring by TMA:
//      a = T(act(inp)), da = act'(inp) in fp32, gi = T(g * da * gate),
//      gg = T(g * a), so G = [gi | gg] [M, 2I] (the cotangent of [inp |
//      gate]) is written and the projection never is;
//   3. dW = G^T . xn, rounded once to the weight's type: in bf16 the M rows
//      are cut into chunks (kernels.dw_chunk_rows), each chunk's fp32 sums
//      go to scratch [chunks, N, K] and a second pass adds them in chunk
//      order (fixed order, no atomics); in fp32 one CTA sums all M rows;
//   4. dy = G . W and the LN adjoint. The fused route (bf16, K <= 2048):
//      one launch, the LN_ADJOINT epilogue (gemm_wgmma.cuh) applies the
//      adjoint to each fp32 dy tile in the registers that summed it; a
//      row's 256-column tiles lie in ceil(K / 256) CTAs of a persistent,
//      cooperative grid, which add their row sums in rank order through L2;
//      it writes dx and dscale's partial rows [ceil(M / 128), K], which
//      ln_adjoint.cuh's second pass adds in row order. dy never reaches
//      device memory. The split route (fp32, the parity path; and bf16 past
//      2048 columns): dy in fp32 into scratch [M, K], then the LN-adjoint
//      row body (ln_adjoint.cuh) on (x, s, dy). The route is a function of
//      the type and K alone (kernels.ln_gemm_bwd_fused), never a fallback.
// At base widths (M = 16384, K = 768, N = 2304 or 2I = 2304) steps 2-4 are
// 58 GFLOP each, so the products bound it: bf16 on wgmma fed by TMA
// (gemm_wgmma.cuh; step 2 K-major x K-major, step 3 both operands MN-major,
// step 4 an MN-major W); fp32 on FMA (true fp32, no TF32). Launches in bf16:
// kernel 12 five (normalize, dW, dW's chunk sum, dy with the adjoint, the
// dscale sum), kernel 11 six (and the projection).
#include "gemm.cuh"
#include "ln_adjoint.cuh"

namespace {

using gemm_engine::Epi;
using gemm_engine::gemm;
using gemm_engine::normalize;

// The fused route: bf16, and a row's tiles in at most ADJ_MAX_CLUSTER CTAs.
template <typename T>
bool fused_route(int K) {
  return sizeof(T) == 2 &&
         gemm_engine::adjoint_cluster(K) <= gemm_engine::wgm::ADJ_MAX_CLUSTER;
}

// The fused route's row scratch: stats [M, 2] fp32, then (a multiple of 16
// bytes on) the row tiles' exchanged sums [ceil(M / 128)][C][128] float2,
// then their arrival counts [ceil(M / 128)] int32; the wrapper allocates
// kernels.ln_gemm_bwd_rows(M, K) floats.
struct RowScratch {
  float2* stats;
  float2* exchange;
  int* arrivals;
};

RowScratch row_scratch(void* rows, int M, int K) {
  constexpr int BM = gemm_engine::wgm::BM;
  const size_t tiles = (M + BM - 1) / BM, stats_floats = ((size_t)M * 2 + 3) / 4 * 4;
  float* base = static_cast<float*>(rows);
  float* exchange = base + stats_floats;
  return {reinterpret_cast<float2*>(base), reinterpret_cast<float2*>(exchange),
          reinterpret_cast<int*>(exchange + tiles * gemm_engine::adjoint_cluster(K) * BM * 2)};
}

// Steps 3 and 4 around a cotangent G [M, N] of xn . W^T, W [N, K]; for
// GeGLU, G is step 2's output and W is Wi. `rows` on the fused route, dy on
// the split one.
template <typename T>
int ln_gemm_bwd(const T* x, const T* scale, const T* w, const T* G, T* dx, T* dw, T* dscale,
                const T* xn, const RowScratch& rows, float* dy, float* partial,
                float* dw_partial, int chunk_rows, int M, int K, int N, float eps,
                cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if (fused_route<T>(K)) {
      OPT_TRY(gemm<true, true>(G, N, xn, K, dw, K, N, K, M, s, 0, dw_partial, chunk_rows));
      gemm_engine::EpiInputs adjoint;
      adjoint.tile = x;
      adjoint.scale = scale;
      adjoint.stats = rows.stats;
      adjoint.ds_partial = partial;
      adjoint.exchange = rows.exchange;
      adjoint.arrivals = rows.arrivals;
      OPT_TRY(gemm<false, true, Epi::LN_ADJOINT>(G, N, w, K, dx, K, M, K, N, s, 0, nullptr, 0,
                                                 adjoint));
      constexpr int tile_rows = gemm_engine::wgm::BM;  // of a partial row of dscale
      return ln_adjoint::reduce<T>(partial, (M + tile_rows - 1) / tile_rows, K, dscale, s);
    }
  }
  OPT_TRY(gemm<true, true>(G, N, xn, K, dw, K, N, K, M, s, 0, dw_partial, chunk_rows));  // dW
  OPT_TRY(gemm<false, true>(G, N, w, K, dy, K, M, K, N, s));                             // dy
  return ln_adjoint::launch<T, float>(x, scale, dy, dx, dscale, partial, M, K, eps, s);
}

// The scratch a route reads must be there (the wrapper allocates by
// kernels.ln_gemm_bwd_fused, which mirrors fused_route), and the fused
// route's normalize pass writes the rows' statistics and clears the row
// tiles' arrival counts.
template <typename T>
bool scratch_for_route(const void* rows, const float* dy, int K) {
  return fused_route<T>(K) ? rows != nullptr : dy != nullptr;
}

template <typename T>
RowScratch normalize_rows(const T* x, const T* scale, T* xn, void* rows, int M, int K, float eps,
                          cudaStream_t s, int* err) {
  const RowScratch scratch = fused_route<T>(K) ? row_scratch(rows, M, K) : RowScratch{};
  *err = normalize<T>(x, scale, xn, M, K, eps, s, scratch.stats, scratch.arrivals);
  return scratch;
}

template <typename T>
int matmul_bwd(const void* x, const void* scale, const void* w, const void* g, void* dx,
               void* dw, void* dscale, void* xn, void* rows, float* dy, float* partial,
               float* dw_partial, int chunk_rows, int M, int K, int N, float eps,
               cudaStream_t s) {
  if (!scratch_for_route<T>(rows, dy, K)) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(scale);
  T* xnt = static_cast<T*>(xn);
  int err = 0;
  const RowScratch scratch = normalize_rows<T>(xt, st, xnt, rows, M, K, eps, s, &err);
  OPT_TRY(err);
  return ln_gemm_bwd<T>(xt, st, static_cast<const T*>(w), static_cast<const T*>(g),
                        static_cast<T*>(dx), static_cast<T*>(dw), static_cast<T*>(dscale), xnt,
                        scratch, dy, partial, dw_partial, chunk_rows, M, K, N, eps, s);
}

template <typename T>
int geglu_bwd(const void* x, const void* scale, const void* wi, const void* g, void* dx,
              void* dwi, void* dscale, void* xn, void* cot, void* rows, float* dy,
              float* partial, float* dw_partial, int chunk_rows, int M, int K, int I, float eps,
              int act, cudaStream_t s) {
  if (!scratch_for_route<T>(rows, dy, K)) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(scale);
  const T* wt = static_cast<const T*>(wi);
  T* xnt = static_cast<T*>(xn);
  T* G = static_cast<T*>(cot);
  int err = 0;
  const RowScratch scratch = normalize_rows<T>(xt, st, xnt, rows, M, K, eps, s, &err);
  OPT_TRY(err);
  gemm_engine::EpiInputs upstream;
  upstream.tile = g;
  OPT_TRY(gemm<false, false, Epi::GEGLU_GRAD>(xnt, K, wt, K, G, 2 * I, M, I, K, s, act, nullptr,
                                              0, upstream));  // G = [gi | gg]
  return ln_gemm_bwd<T>(xt, st, wt, G, static_cast<T*>(dx), static_cast<T*>(dwi),
                        static_cast<T*>(dscale), xnt, scratch, dy, partial, dw_partial,
                        chunk_rows, M, K, 2 * I, eps, s);
}

}  // namespace

// Scratch the wrapper allocates (all contiguous): xn [M, K] in the storage
// type; on the fused route (bf16, ceil(K / 256) <= 8) rows (RowScratch:
// the rows' statistics, the row tiles' exchanged sums and arrival counts)
// and partial [ceil(M / 128), K] fp32, dy null; on the split route dy [M, K]
// fp32 and partial [ln_adjoint::parts(M), K] fp32, rows null; for GeGLU
// cot [M, 2I] in the storage type (G = [gi | gg]); in bf16 dw_partial
// [ceil(M / chunk_rows), N or 2I, K] fp32 (fp32 ignores it and chunk_rows).
extern "C" int opt_ln_matmul_bwd(const void* x, const void* scale, const void* w, const void* g,
                                 void* dx, void* dw, void* dscale, void* xn, void* rows,
                                 float* dy, float* partial, float* dw_partial, int m, int k,
                                 int n, int chunk_rows, float eps, int dtype, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return matmul_bwd<float>(x, scale, w, g, dx, dw, dscale, xn, rows, dy, partial, dw_partial,
                             chunk_rows, m, k, n, eps, s);
  if (dtype == DTYPE_BF16)
    return matmul_bwd<__nv_bfloat16>(x, scale, w, g, dx, dw, dscale, xn, rows, dy, partial,
                                     dw_partial, chunk_rows, m, k, n, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int opt_ln_geglu_bwd(const void* x, const void* scale, const void* wi, const void* g,
                                void* dx, void* dwi, void* dscale, void* xn, void* cot,
                                void* rows, float* dy, float* partial, float* dw_partial, int m,
                                int k, int intermediate, int chunk_rows, float eps, int act,
                                int dtype, void* stream) {
  if (m <= 0 || k <= 0 || intermediate <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return geglu_bwd<float>(x, scale, wi, g, dx, dwi, dscale, xn, cot, rows, dy, partial,
                            dw_partial, chunk_rows, m, k, intermediate, eps, act, s);
  if (dtype == DTYPE_BF16)
    return geglu_bwd<__nv_bfloat16>(x, scale, wi, g, dx, dwi, dscale, xn, cot, rows, dy,
                                    partial, dw_partial, chunk_rows, m, k, intermediate, eps, act,
                                    s);
  return (int)cudaErrorInvalidValue;
}

// The design of kernels 11 and 12 at width k in a dtype, fixed when the
// library is built: out[0] = the route (1 fused: dy and the LN adjoint in
// one launch; 0 split), out[1] = the CTAs that hold a row on the fused
// route (0 when split), out[2] = the rows of x a partial row of dscale sums, out[3] =
// the most CTAs a row takes, out[4] = the groups of out[1] CTAs the fused
// route's persistent grid holds on the current card (0 when split). Returns
// 0, or -1 for another dtype.
extern "C" int opt_ln_gemm_bwd_design(int k, int dtype, int* out) {
  namespace ge = gemm_engine;
  bool fused;
  if (dtype == DTYPE_F32)
    fused = fused_route<float>(k);
  else if (dtype == DTYPE_BF16)
    fused = fused_route<__nv_bfloat16>(k);
  else
    return -1;
  const int cluster = fused ? ge::adjoint_cluster(k) : 0;
  const int groups = fused ? ge::adjoint_groups(cluster) : 0;
  const int design[5] = {fused, cluster, fused ? ge::wgm::BM : ln_adjoint::ROWS,
                         ge::wgm::ADJ_MAX_CLUSTER, groups};
  for (int i = 0; i < 5; ++i) out[i] = design[i];
  return 0;
}
