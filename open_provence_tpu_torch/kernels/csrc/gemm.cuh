// The one GEMM engine of the LayerNorm->GEMM kernels, forward (ln_gemm.cu)
// and backward (ln_gemm_bwd.cu), and the pass that writes the normalized
// rows it reads.
//
// C[m, n] = sum_k A(m, k) B(k, n). A(m, k) is A[m * lda + k] (TA false) or
// A[k * lda + m] (TA true); B(k, n) is B[n * ldb + k] (TB false: torch's
// [out, in] weight) or B[k * ldb + n] (TB true). Any M, N, K; the bf16 path
// reads each operand by TMA, whose row strides (and a contiguous k) must be
// multiples of 8 elements (the wrappers check it).
//
// Epilogues: STORE casts the fp32 sum to C's type. GEGLU (TB false) reads
// B as Wi [2N, K] and writes C[m, n] = act(A . Wi[n]) * (A . Wi[N + n])
// with the TPU kernel's rounding chain (geglu<OutT>, gemm_wgmma.cuh). Its
// tiles hold the input rows of half as many output columns followed, block
// by block, by their gate rows, so the thread that holds an input's sum also
// holds its gate's. GEGLU_GRAD (the backward's recomputed projection) has
// GEGLU's tiles and writes the cotangents of inp and gate instead,
// C[m, n] = gi and C[m, N + n] = gg (geglu_grad<T>), from the upstream
// cotangent g [M, N] (EpiInputs::tile): the projection never reaches
// device memory. LN_ADJOINT (bf16, dy = G . W) is the LN adjoint on the
// fp32 dy tile (gemm_wgmma.cuh): C = dx, and dscale's partial rows.
//
// Routes, by type alone, with no fallback between them: fp32 on FMA (true
// fp32, no TF32; STORE, GEGLU and GEGLU_GRAD); bf16 on wgmma fed by TMA from
// one producer thread (gemm_wgmma.cuh) for every layout: the forward's
// xn . W^T and the backward's recomputed projection K-major x K-major,
// dy = G . W with an MN-major B, and the weight gradients dW = G^T . X (TA)
// with both operands MN-major. A weight gradient contracts over the M rows
// of activations (16384 at B=32, S=512) into few output tiles (54 of
// 128 x 256 at base width), so its bf16 depth is cut into chunks of rows:
// each chunk's CTAs write fp32 partial sums into scratch the wrapper
// allocates, and dw_sum_kernel adds them in chunk order and rounds once. The
// chunk length is the caller's, a function of the shape alone
// (kernels.dw_chunk_rows), so every launch sums in the same order; no
// atomics.
#pragma once

#include "activation.cuh"
#include "common.cuh"
#include "gemm_wgmma.cuh"

// Return a launch's error code if it is not 0 (variadic: template argument
// lists carry commas).
#define OPT_TRY(...)                  \
  do {                                \
    const int err_ = (__VA_ARGS__);   \
    if (err_ != 0) return err_;       \
  } while (0)

// Each including source gets its own copy (an unnamed namespace), as in
// ln_adjoint.cuh, so no kernel symbol is shared across objects.
namespace gemm_engine {
namespace {

// xn = T(h * s), h = (x - mean) * rstd from fp32 E[x^2] - E[x]^2: the
// rounding point of the TPU kernels' _ln_rows. One warp a row. STATS (the
// backward's LN_ADJOINT route) also writes each row's (mean, rstd) and
// clears the arrival count of each tile of wgm::BM rows.
template <typename T, bool STATS>
__global__ void __launch_bounds__(256)
    normalize_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ xn,
                     float2* __restrict__ stats, int* __restrict__ arrivals, int M, int K,
                     float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  T* out = xn + (size_t)row * K;
  float mean, rstd;
  warp_row_stats(xr, K, eps, &mean, &rstd);
  for (int c = threadIdx.x & 31; c < K; c += 32)
    out[c] = from_f32<T>(((to_f32(xr[c]) - mean) * rstd) * to_f32(scale[c]));
  if constexpr (STATS) {
    if ((threadIdx.x & 31) == 0) {
      stats[row] = make_float2(mean, rstd);
      if (row % wgm::BM == 0) arrivals[row / wgm::BM] = 0;
    }
  }
}

template <typename T>
int normalize(const T* x, const T* scale, T* xn, int M, int K, float eps, cudaStream_t s,
              float2* stats = nullptr, int* arrivals = nullptr) {
  if (stats != nullptr)
    normalize_kernel<T, true><<<(M + 7) / 8, 256, 0, s>>>(x, scale, xn, stats, arrivals, M, K,
                                                          eps);
  else
    normalize_kernel<T, false><<<(M + 7) / 8, 256, 0, s>>>(x, scale, xn, stats, arrivals, M, K,
                                                           eps);
  return (int)cudaGetLastError();
}

// Row r of a tile's B rows: its row of B and whether it exists. GEGLU and
// GEGLU_GRAD tiles take blocks of 2H rows: H input rows, then the same
// columns' gate rows.
template <Epi E, int H>
__device__ __forceinline__ int b_row(int n0, int r, int N, bool* ok) {
  if constexpr (gated(E)) {
    const int col = n0 + (r / (2 * H)) * H + r % H;
    *ok = col < N;
    return r % (2 * H) < H ? col : N + col;
  } else {
    *ok = n0 + r < N;
    return n0 + r;
  }
}

// ---- fp32: FMA over 64x64 tiles, 4x4 outputs a thread (true fp32, no TF32)

namespace simt {
constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256, PAD = 4;
}

// g: GEGLU_GRAD's upstream cotangent [M, N], else unused.
template <bool TA, bool TB, Epi E>
__global__ void __launch_bounds__(simt::THREADS)
    gemm_fma_kernel(const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
                    float* __restrict__ C, int ldc, int M, int N, int K, int act,
                    const float* __restrict__ g) {
  using namespace simt;
  static_assert(!gated(E) || !TB, "GEGLU reads Wi in torch's [out, in] layout");
  static_assert(E != Epi::LN_ADJOINT, "fp32 runs the LN adjoint as a pass of its own");
  constexpr int OUT_N = gated(E) ? BN / 2 : BN;  // output columns a tile
  __shared__ float As[BK][BM + PAD];
  __shared__ float Bs[BK][BN + PAD];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * OUT_N;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = 0; e < BM * BK / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      // Consecutive threads walk each operand's contiguous dim.
      const int ar = TA ? idx % BM : idx / BK, ak = TA ? idx / BM : idx % BK;
      const int br = TB ? idx % BN : idx / BK, bk = TB ? idx / BN : idx % BK;
      const int gm = m0 + ar, gka = k0 + ak, gkb = k0 + bk;
      bool bok;
      const int gn = b_row<E, BN / 2>(n0, br, N, &bok);
      float av = 0.f, bv = 0.f;
      if (gm < M && gka < K) av = TA ? A[(size_t)gka * lda + gm] : A[(size_t)gm * lda + gka];
      if (bok && gkb < K) bv = TB ? B[(size_t)gkb * ldb + gn] : B[(size_t)gn * ldb + gkb];
      As[ak][ar] = av;
      Bs[bk][br] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  // Thread (ty, tx) holds tile columns tx + 16 j; under GEGLU and
  // GEGLU_GRAD, j = 0, 1 are inputs and j + 2 their gates.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < (gated(E) ? 2 : 4); ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      float* out = C + (size_t)gm * ldc + gn;
      if constexpr (E == Epi::GEGLU_GRAD) {
        const float2 cot =
            geglu_grad<float>(acc[i][j], acc[i][j + 2], g[(size_t)gm * N + gn], act);
        out[0] = cot.x;
        out[N] = cot.y;
      } else if constexpr (E == Epi::GEGLU)
        *out = geglu<float>(acc[i][j], acc[i][j + 2], act);
      else
        *out = acc[i][j];
    }
  }
}

// ---- the weight gradients' second pass ------------------------------------------

// C[r, c] = round(sum over chunks j, in order, of partial[j][r, c]), the
// partials [chunks][M][N] fp32; four columns a thread (N % 4 == 0).
template <typename OutT>
__global__ void __launch_bounds__(256)
    dw_sum_kernel(const float* __restrict__ partial, int chunks, int M, int N,
                  OutT* __restrict__ C, int ldc) {
  const size_t v = (size_t)blockIdx.x * 256 + threadIdx.x, plane = (size_t)M * N;
  if (v >= plane / 4) return;
  float4 sum = reinterpret_cast<const float4*>(partial)[v];
  for (int j = 1; j < chunks; ++j) {
    const float4 p = reinterpret_cast<const float4*>(partial + j * plane)[v];
    sum.x += p.x;
    sum.y += p.y;
    sum.z += p.z;
    sum.w += p.w;
  }
  const size_t row = v * 4 / N, col = v * 4 % N;
  OutT* out = C + row * ldc + col;
  out[0] = from_f32<OutT>(sum.x);
  out[1] = from_f32<OutT>(sum.y);
  out[2] = from_f32<OutT>(sum.z);
  out[3] = from_f32<OutT>(sum.w);
}

// C = A . B on the caller's stream, by the routes above. N is C's column
// count (under GEGLU half of B's rows; GEGLU_GRAD writes 2N columns); act
// is the GeGLU activation code. A bf16 weight gradient (TA) takes
// `partial`, fp32 scratch of ceil(K / chunk_rows) x M x N, and chunk_rows,
// a multiple of 64; fp32 ignores them. `epi`: GEGLU_GRAD's g, LN_ADJOINT's
// operands (gemm_wgmma.cuh).
template <bool TA, bool TB, Epi E = Epi::STORE, typename T, typename OutT>
int gemm(const T* A, int lda, const T* B, int ldb, OutT* C, int ldc, int M, int N, int K,
         cudaStream_t s, int act = 0, float* partial = nullptr, int chunk_rows = 0,
         const EpiInputs& epi = {}) {
  if (M <= 0 || N <= 0) return 0;
  if constexpr (sizeof(T) == 4) {
    constexpr int out_n = gated(E) ? simt::BN / 2 : simt::BN;
    const dim3 grid((N + out_n - 1) / out_n, (M + simt::BM - 1) / simt::BM);
    const float* g = static_cast<const float*>(epi.tile);
    if (E == Epi::GEGLU_GRAD && g == nullptr) return (int)cudaErrorInvalidValue;
    gemm_fma_kernel<TA, TB, E><<<grid, simt::THREADS, 0, s>>>(A, lda, B, ldb, C, ldc, M, N, K,
                                                              act, g);
    return (int)cudaGetLastError();
  } else if constexpr (TA) {
    if (partial == nullptr || chunk_rows <= 0 || K <= 0 || N % 4) return (int)cudaErrorInvalidValue;
    OPT_TRY(gemm_wgmma<true, TB, E>(A, lda, B, ldb, partial, N, M, N, K, s, act, chunk_rows));
    const size_t vectors = (size_t)M * N / 4;
    dw_sum_kernel<OutT><<<(unsigned)((vectors + 255) / 256), 256, 0, s>>>(
        partial, (K + chunk_rows - 1) / chunk_rows, M, N, C, ldc);
    return (int)cudaGetLastError();
  } else {
    return gemm_wgmma<TA, TB, E>(A, lda, B, ldb, C, ldc, M, N, K, s, act, 0, epi);
  }
}

}  // namespace
}  // namespace gemm_engine
