// LayerNorm folded into the GEMM that consumes it: kernels 2 and 4 of the
// forward path.
//
// opt_ln_matmul replaces ops/geglu.py::_ln_matmul_kernel (attn_norm -> Wqkv,
//   layers 1 and up): out[M, N] = LN(x)[M, K] . W[N, K]^T.
// opt_ln_geglu replaces ops/geglu.py::_ln_geglu_kernel (mlp_norm -> Wi ->
//   act * gate): out[M, I] = act(LN(x) . Wi[:I]^T) * (LN(x) . Wi[I:]^T),
//   with Wi [2I, K] in torch's [out, in] layout.
//
// Each CTA takes the fp32 row statistics of its rows (one warp per row)
// before its K loop and normalizes x into shared memory, rounded to the
// storage type (the rounding point of the TPU kernel's _ln_rows), so the
// normalized [M, K] activations never reach device memory. GEGLU keeps two accumulators per output (input half and
// gate half) and applies the TPU kernel's epilogue chain: round each half to
// the storage type, the activation in fp32 on the rounded input, round, then
// the product with the gate rounded to the storage type.
//
// bf16 (the serving dtype): tensor cores through mma.sync m16n8k16 with fp32
// accumulation; each CTA normalizes its 64-row slab once into shared memory
// and streams weight tiles past it with cp.async. At base widths the
// products are 58 GFLOP a call, so the tensor-core rate bounds it; wgmma and
// TMA, which reach the card's full rate, are later work.
// fp32: plain FMA over 64x64 tiles, so fp32 stays true fp32 (no TF32).
#include "common.cuh"

#include <algorithm>

namespace {

enum { ACT_GELU = 0, ACT_GELU_TANH = 1, ACT_RELU = 2, ACT_SILU = 3 };

__device__ __forceinline__ float activation(float x, int act) {
  switch (act) {
    case ACT_GELU:
      return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
    case ACT_GELU_TANH: {
      const float inner = 0.79788456080286536f * (x + 0.044715f * (x * x * x));
      return 0.5f * x * (1.f + tanhf(inner));
    }
    case ACT_RELU:
      return fmaxf(x, 0.f);
    default:  // ACT_SILU
      return x / (1.f + expf(-x));
  }
}

// Epilogue of one output: the GEGLU rounding chain, or the plain cast.
template <typename T, bool GEGLU>
__device__ __forceinline__ T finish(float acc, float gate_acc, int act) {
  if constexpr (GEGLU) {
    const float inp = round_to<T>(acc);
    const float gate = round_to<T>(gate_acc);
    return from_f32<T>(round_to<T>(activation(inp, act)) * gate);
  } else {
    return from_f32<T>(acc);
  }
}

// Row statistics of rows m0 .. m0 + rows - 1 into shared memory (zeros past M).
template <typename T>
__device__ __forceinline__ void tile_row_stats(const T* x, int M, int K, int m0, int rows,
                                               float eps, float* mean, float* rstd) {
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    float mu = 0.f, rs = 0.f;
    if (m0 + r < M) warp_row_stats(x + (size_t)(m0 + r) * K, K, eps, &mu, &rs);
    if ((threadIdx.x & 31) == 0) {
      mean[r] = mu;
      rstd[r] = rs;
    }
  }
}

// ---- fp32: FMA tiles --------------------------------------------------------

namespace simt {
constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256, PAD = 4;
}

template <bool GEGLU>
__global__ void __launch_bounds__(simt::THREADS)
    ln_gemm_fma_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ w, float* __restrict__ out, int M, int K,
                       int N, float eps, int act) {
  using namespace simt;
  __shared__ float row_mean[BM], row_rstd[BM];
  __shared__ float As[BK][BM + PAD];
  __shared__ float Bs[BK][BN + PAD];
  __shared__ float Gs[GEGLU ? BK : 1][BN + PAD];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  tile_row_stats(x, M, K, m0, BM, eps, row_mean, row_rstd);
  __syncthreads();

  const int tx = tid & 15, ty = tid >> 4;  // outputs (ty + 16i, tx + 16j)
  float acc[4][4] = {};
  float gacc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = 0; e < BM * BK / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / BK, kk = idx % BK;
      const int gm = m0 + r, gn = n0 + r, gk = k0 + kk;
      float v = 0.f, wv = 0.f, gv = 0.f;
      if (gm < M && gk < K) v = ((x[(size_t)gm * K + gk] - row_mean[r]) * row_rstd[r]) * scale[gk];
      if (gn < N && gk < K) {
        wv = w[(size_t)gn * K + gk];
        if constexpr (GEGLU) gv = w[(size_t)(N + gn) * K + gk];
      }
      As[kk][r] = v;
      Bs[kk][r] = wv;
      if constexpr (GEGLU) Gs[kk][r] = gv;
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
      if constexpr (GEGLU) {
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Gs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) gacc[i][j] = fmaf(a[i], b[j], gacc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[(size_t)gm * N + gn] = finish<float, GEGLU>(acc[i][j], gacc[i][j], act);
    }
  }
}

// ---- bf16: mma.sync tiles ---------------------------------------------------
//
// A CTA owns 64 rows. It normalizes their whole [64, K] slab into shared
// memory once, then walks output tiles across N (every gridDim.x-th one),
// streaming 128-row weight tiles through a 3-stage cp.async ring. 8 warps as
// 2 (rows) x 4 (weight rows); a warp owns 32 rows x 32 weight rows: 2 x 4
// m16n8 tiles, fed by ldmatrix. For the matmul the 128 weight rows are
// output columns n0 .. n0+127; for GEGLU they are the input-half rows of
// output columns n0 .. n0+63 followed by their gate-half rows, so each warp
// holds the input and gate accumulators of the same 16 output columns.

namespace tc {
constexpr int BM = 64, BROWS = 128, BK = 64, B_LD = BK + 8, STAGES = 3, THREADS = 256;
constexpr int B_CHUNKS = BROWS * BK / 8 / THREADS;  // 16-byte copies a thread a stage
inline size_t smem_bytes(int K) {
  return (size_t)(BM * (K + 8) + STAGES * BROWS * B_LD) * sizeof(__nv_bfloat16);
}
}  // namespace tc

template <bool GEGLU>
__device__ __forceinline__ int b_tile_row(int warp_n, int nt) {
  if constexpr (GEGLU) return (nt >> 1) * 64 + warp_n * 16 + (nt & 1) * 8;
  return warp_n * 32 + nt * 8;
}

// K % 8 == 0 (16-byte rows); the wrapper checks it.
template <bool GEGLU>
__global__ void __launch_bounds__(tc::THREADS)
    ln_gemm_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ scale,
                       const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ out,
                       int M, int K, int N, float eps, int act) {
  using namespace tc;
  constexpr int OUT_N = GEGLU ? BROWS / 2 : BROWS;  // output columns per tile
  __shared__ float row_mean[BM], row_rstd[BM];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int A_LD = K + 8;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][A_LD]
  __nv_bfloat16* Bs = As + BM * A_LD;                               // [STAGES][BROWS][B_LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int m0 = blockIdx.y * BM;
  tile_row_stats(x, M, K, m0, BM, eps, row_mean, row_rstd);
  __syncthreads();

  // The normalized slab, rounded to bf16, 8 values per 16-byte chunk; the
  // pad chunk past K is zeroed, since a last 16-wide k step may read it.
  const int row_chunks = K / 8 + 1;
  for (int c = tid; c < BM * row_chunks; c += THREADS) {
    const int r = c / row_chunks, k = (c % row_chunks) * 8;
    float v[8] = {};
    if (m0 + r < M && k < K) {
      float xs[8], ss[8];
      unpack8(*reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k), xs);
      unpack8(*reinterpret_cast<const uint4*>(scale + k), ss);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = ((xs[i] - row_mean[r]) * row_rstd[r]) * ss[i];
    }
    *reinterpret_cast<uint4*>(As + r * A_LD + k) = pack8(v);
  }

  const int n_k = (K + BK - 1) / BK;
  const int n_tiles = (N + OUT_N - 1) / OUT_N;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = tile * OUT_N;
    // One stage: 128 weight rows x BK k, in 16-byte chunks.
    auto issue = [&](int kt) {
      if (kt < n_k) {
        __nv_bfloat16* stage = Bs + (kt % STAGES) * BROWS * B_LD;
#pragma unroll
        for (int e = 0; e < B_CHUNKS; ++e) {
          const int c = tid + e * THREADS;
          const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8, k = kt * BK + kc;
          const int col = n0 + (GEGLU ? (r & 63) : r);
          const int wrow = (GEGLU && r >= 64) ? N + col : col;
          const bool ok = col < N && k < K;
          cp_async16(stage + r * B_LD + kc, ok ? w + (size_t)wrow * K + k : w, ok ? 16 : 0);
        }
      }
      cp_async_commit();  // an empty group keeps the wait count uniform
    };

    float acc[2][4][4] = {};
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) issue(s);
    for (int kt = 0; kt < n_k; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage kt landed; every warp is past tile kt - 1
      issue(kt + STAGES - 1);
      const __nv_bfloat16* stage = Bs + (kt % STAGES) * BROWS * B_LD;
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        const int kk = kt * BK + ks;
        if (kk >= K) break;
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int row = warp_m * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(a[mt], As + row * A_LD + kk + (lane >> 4) * 8);
        }
#pragma unroll
        for (int pair = 0; pair < 2; ++pair) {
          const int brow = b_tile_row<GEGLU>(warp_n, 2 * pair) + (lane >> 4) * 8 + (lane & 7);
          uint32_t r[4];
          ldmatrix_x4(r, stage + brow * B_LD + ks + ((lane >> 3) & 1) * 8);
          b[2 * pair][0] = r[0];
          b[2 * pair][1] = r[1];
          b[2 * pair + 1][0] = r[2];
          b[2 * pair + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[mt][nt], a[mt], b[nt]);
      }
    }

#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + warp_m * 32 + mt * 16 + g + half * 8;
        if (row >= M) continue;
        __nv_bfloat16* orow = out + (size_t)row * N;
#pragma unroll
        for (int nt = 0; nt < (GEGLU ? 2 : 4); ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = n0 + b_tile_row<GEGLU>(warp_n, nt) + 2 * t + j;
            float gate = 0.f;
            if constexpr (GEGLU) gate = acc[mt][nt + 2][half * 2 + j];
            if (col < N)
              orow[col] = finish<__nv_bfloat16, GEGLU>(acc[mt][nt][half * 2 + j], gate, act);
          }
        }
      }
    }
    __syncthreads();  // the ring is reused by the next output tile
  }
}

template <bool GEGLU>
int dispatch(const void* x, const void* scale, const void* w, void* out, int m, int k, int n,
             float eps, int act, int dtype, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    const dim3 grid((n + simt::BN - 1) / simt::BN, (m + simt::BM - 1) / simt::BM);
    ln_gemm_fma_kernel<GEGLU><<<grid, simt::THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(w), static_cast<float*>(out), m, k, n, eps, act);
  } else if (dtype == DTYPE_BF16) {
    // Split the output tiles of a row block over enough CTAs to give each
    // SM about two; every CTA normalizes its slab once per split.
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    constexpr int out_n = GEGLU ? tc::BROWS / 2 : tc::BROWS;
    const int m_tiles = (m + tc::BM - 1) / tc::BM, n_tiles = (n + out_n - 1) / out_n;
    const int splits = std::min(n_tiles, std::max(1, (2 * sms + m_tiles - 1) / m_tiles));
    const size_t smem = tc::smem_bytes(k);
    err = cudaFuncSetAttribute(ln_gemm_mma_kernel<GEGLU>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ln_gemm_mma_kernel<GEGLU><<<dim3(splits, m_tiles), tc::THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(scale),
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out), m, k, n, eps,
        act);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int opt_ln_matmul(const void* x, const void* scale, const void* w, void* out, int m,
                             int k, int n, float eps, int dtype, void* stream) {
  return dispatch<false>(x, scale, w, out, m, k, n, eps, 0, dtype, stream);
}

extern "C" int opt_ln_geglu(const void* x, const void* scale, const void* wi, void* out, int m,
                            int k, int intermediate, float eps, int act, int dtype,
                            void* stream) {
  return dispatch<true>(x, scale, wi, out, m, k, intermediate, eps, act, dtype, stream);
}
