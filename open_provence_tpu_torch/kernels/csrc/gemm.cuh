// The one GEMM engine of the LayerNorm->GEMM kernels, forward (ln_gemm.cu)
// and backward (ln_gemm_bwd.cu), and the pass that writes the normalized
// rows it reads.
//
// C[m, n] = sum_k A(m, k) B(k, n). A(m, k) is A[m * lda + k] (TA false) or
// A[k * lda + m] (TA true); B(k, n) is B[n * ldb + k] (TB false: torch's
// [out, in] weight) or B[k * ldb + n] (TB true). Any M, N, K; the bf16 path
// moves 16-byte chunks along each operand's contiguous dim, which must then
// be a multiple of 8 (the wrappers check it).
//
// Epilogues: STORE casts the fp32 sum to C's type. GEGLU (TB false) reads
// B as Wi [2N, K] and writes C[m, n] = act(A . Wi[n]) * (A . Wi[N + n])
// with the TPU kernel's rounding chain (geglu<OutT>, gemm_wgmma.cuh). Its
// tiles hold the input rows of half as many output columns followed, block
// by block, by their gate rows, so the thread that holds an input's sum also
// holds its gate's.
//
// Routes, by layout and type alone: fp32 on FMA (true fp32, no TF32); bf16
// with both operands K-major (TA and TB false: the forward's xn . W^T and
// the backward's recomputed projection) on wgmma fed by a producer
// warpgroup (gemm_wgmma.cuh); the transposed bf16 layouts of the backward
// (dW = G^T . xn, dy = G . W) on mma.sync.
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
// rounding point of the TPU kernels' _ln_rows. One warp a row.
template <typename T>
__global__ void __launch_bounds__(256)
    normalize_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ xn,
                     int M, int K, float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  T* out = xn + (size_t)row * K;
  float mean, rstd;
  warp_row_stats(xr, K, eps, &mean, &rstd);
  for (int c = threadIdx.x & 31; c < K; c += 32)
    out[c] = from_f32<T>(((to_f32(xr[c]) - mean) * rstd) * to_f32(scale[c]));
}

template <typename T>
int normalize(const T* x, const T* scale, T* xn, int M, int K, float eps, cudaStream_t s) {
  normalize_kernel<T><<<(M + 7) / 8, 256, 0, s>>>(x, scale, xn, M, K, eps);
  return (int)cudaGetLastError();
}

// Row r of a tile's B rows: its row of B and whether it exists. GEGLU
// tiles take blocks of 2H rows: H input rows, then the same columns' gate
// rows.
template <Epi E, int H>
__device__ __forceinline__ int b_row(int n0, int r, int N, bool* ok) {
  if constexpr (E == Epi::GEGLU) {
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

template <bool TA, bool TB, Epi E>
__global__ void __launch_bounds__(simt::THREADS)
    gemm_fma_kernel(const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
                    float* __restrict__ C, int ldc, int M, int N, int K, int act) {
  using namespace simt;
  static_assert(E == Epi::STORE || !TB, "GEGLU reads Wi in torch's [out, in] layout");
  constexpr int OUT_N = E == Epi::GEGLU ? BN / 2 : BN;  // output columns a tile
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
  // Thread (ty, tx) holds tile columns tx + 16 j; under GEGLU, j = 0, 1 are
  // inputs and j + 2 their gates.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < (E == Epi::GEGLU ? 2 : 4); ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      if constexpr (E == Epi::GEGLU)
        C[(size_t)gm * ldc + gn] = geglu<float>(acc[i][j], acc[i][j + 2], act);
      else
        C[(size_t)gm * ldc + gn] = acc[i][j];
    }
  }
}

// ---- bf16, a transposed operand: mma.sync m16n8k16, fp32 accumulation -------
//
// 128x128 CTA tiles, 8 warps as 2 (m) x 4 (n), a warp owns 64 x 32: 4 x 4
// m16n8 tiles. Each operand tile sits in shared memory as it lies in device
// memory (rows along its contiguous dim, padded by 8 against bank
// conflicts), filled by a 3-stage cp.async ring; ldmatrix reads the
// fragments, with .trans where the tile's rows run along the contraction.
// B is always transposed here (TB): the K-major x K-major layout and GEGLU
// run on gemm_wgmma_kernel.
namespace tc {
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
template <bool T_>
__host__ __device__ constexpr int a_stage() { return T_ ? BK * (BM + 8) : BM * (BK + 8); }
template <bool T_>
__host__ __device__ constexpr int b_stage() { return T_ ? BK * (BN + 8) : BN * (BK + 8); }
template <bool TA, bool TB>
constexpr size_t smem_bytes() {
  return (size_t)STAGES * (a_stage<TA>() + b_stage<TB>()) * sizeof(__nv_bfloat16);
}
}  // namespace tc

template <bool TA, bool TB, typename OutT>
__global__ void __launch_bounds__(tc::THREADS)
    gemm_mma_kernel(const __nv_bfloat16* __restrict__ A, int lda,
                    const __nv_bfloat16* __restrict__ B, int ldb, OutT* __restrict__ C, int ldc,
                    int M, int N, int K) {
  using namespace tc;
  using bf16 = __nv_bfloat16;
  static_assert(TB, "the K-major x K-major layout runs on wgmma");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + STAGES * a_stage<TA>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_k = (K + BK - 1) / BK;

  auto issue = [&](int kt) {
    if (kt < n_k) {
      bf16* as = As + (kt % STAGES) * a_stage<TA>();
      bf16* bs = Bs + (kt % STAGES) * b_stage<TB>();
      const int k0 = kt * BK;
#pragma unroll
      for (int e = 0; e < BM * BK / 8 / THREADS; ++e) {
        const int c = tid + e * THREADS;
        if constexpr (TA) {  // tile [BK][BM]: rows k, m contiguous
          const int r = c / (BM / 8), mc = (c % (BM / 8)) * 8;
          const bool ok = k0 + r < K && m0 + mc < M;
          cp_async16(as + r * (BM + 8) + mc, ok ? A + (size_t)(k0 + r) * lda + m0 + mc : A,
                     ok ? 16 : 0);
        } else {  // tile [BM][BK]: rows m, k contiguous
          const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
          const bool ok = m0 + r < M && k0 + kc < K;
          cp_async16(as + r * (BK + 8) + kc, ok ? A + (size_t)(m0 + r) * lda + k0 + kc : A,
                     ok ? 16 : 0);
        }
      }
#pragma unroll
      for (int e = 0; e < BN * BK / 8 / THREADS; ++e) {  // tile [BK][BN]: rows k, n contiguous
        const int c = tid + e * THREADS;
        const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
        const bool ok = k0 + r < K && n0 + nc < N;
        cp_async16(bs + r * (BN + 8) + nc, ok ? B + (size_t)(k0 + r) * ldb + n0 + nc : B,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();  // an empty group keeps the wait count uniform
  };

  float acc[4][4][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is past tile kt - 1
    issue(kt + STAGES - 1);
    const bf16* as = As + (kt % STAGES) * a_stage<TA>();
    const bf16* bs = Bs + (kt % STAGES) * b_stage<TB>();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      // ldmatrix.x4: lane l addresses row l % 8 of matrix l / 8. A fragment
      // matrices: (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15,
      // k 8-15); B pairs: (n 0-7, k 0-7), (n 0-7, k 8-15), then n 8-15.
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int mb = warp_m * 64 + mt * 16;
        if constexpr (TA)
          ldmatrix_x4_trans(a[mt], as + (ks + (lane >> 4) * 8 + (lane & 7)) * (BM + 8) + mb +
                                       ((lane >> 3) & 1) * 8);
        else
          ldmatrix_x4(a[mt], as + (mb + (lane & 7) + ((lane >> 3) & 1) * 8) * (BK + 8) + ks +
                                 (lane >> 4) * 8);
      }
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        const int nb = warp_n * 32 + pair * 16;
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (ks + ((lane >> 3) & 1) * 8 + (lane & 7)) * (BN + 8) + nb +
                                 (lane >> 4) * 8);
        b[2 * pair][0] = r[0];
        b[2 * pair][1] = r[1];
        b[2 * pair + 1][0] = r[2];
        b[2 * pair + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[mt][nt], a[mt], b[nt]);
    }
  }
  cp_async_wait<0>();

  // acc[mt][nt] holds tile columns warp_n * 32 + nt * 8 + 2t + j.
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + warp_m * 64 + mt * 16 + g + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + warp_n * 32 + nt * 8 + 2 * t + j;
          if (col < N) C[(size_t)row * ldc + col] = from_f32<OutT>(acc[mt][nt][half * 2 + j]);
        }
    }
}

// C = A . B on the caller's stream, by the routes above. N is C's column
// count (under GEGLU half of B's rows); act is GEGLU's activation code.
template <bool TA, bool TB, Epi E = Epi::STORE, typename T, typename OutT>
int gemm(const T* A, int lda, const T* B, int ldb, OutT* C, int ldc, int M, int N, int K,
         cudaStream_t s, int act = 0) {
  if (M <= 0 || N <= 0) return 0;
  if constexpr (sizeof(T) == 2 && !TA && !TB) {
    return gemm_wgmma<E>(A, lda, B, ldb, C, ldc, M, N, K, s, act);
  } else if constexpr (sizeof(T) == 4) {
    constexpr int out_n = E == Epi::GEGLU ? simt::BN / 2 : simt::BN;
    const dim3 grid((N + out_n - 1) / out_n, (M + simt::BM - 1) / simt::BM);
    gemm_fma_kernel<TA, TB, E><<<grid, simt::THREADS, 0, s>>>(A, lda, B, ldb, C, ldc, M, N, K,
                                                              act);
  } else {
    static_assert(E == Epi::STORE, "GEGLU reads Wi in torch's [out, in] layout");
    constexpr size_t smem = tc::smem_bytes<TA, TB>();
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_mma_kernel<TA, TB, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + tc::BN - 1) / tc::BN, (M + tc::BM - 1) / tc::BM);
    gemm_mma_kernel<TA, TB, OutT><<<grid, tc::THREADS, smem, s>>>(A, lda, B, ldb, C, ldc, M, N,
                                                                  K);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gemm_engine
