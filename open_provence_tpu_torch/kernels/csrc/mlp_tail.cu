// The whole MLP in one kernel, forward: kernel 8.
//
// opt_ln_geglu_wo replaces ops/geglu.py::_ln_geglu_wo_kernel:
//   out[M, K] = (act(LN(x) . Wi[:I]^T) * (LN(x) . Wi[I:]^T)) . Wo^T
// with Wi [2I, K] and Wo [K, I] in torch's [out, in] layout and the TPU
// kernel's rounding points: the normalized rows, inp and gate rounded to the
// storage type, act(inp) rounded, h = act * gate in the storage type, fp32
// accumulation in all three products, LN statistics as E[x^2] - E[x]^2.
//
// The TPU kernel keeps both halves of Wi, Wo and a [bm, I] pair of fp32
// accumulators resident in VMEM. A Hopper CTA has 227 KB and 64 K registers,
// so here the CTA loops over I in chunks (mlp_tail.cuh): per chunk it forms
// inp and gate [rows, 64] over the K loop, writes h = act * gate into shared
// memory, and adds h_chunk . Wo[:, chunk]^T into the [rows, K] output
// accumulator its warps split by columns. Recomputing h for column slices of
// the output (the other form) would triple the Wi operations. Two launches
// on the caller's stream: the normalized rows into scratch [M, K] (the pass
// kernels 2 and 4 share, gemm.cuh), then the fused kernel; the [M, I]
// product never reaches device memory.
//
// Work: 6*M*K*I operations (8.7e10 at M = 16384, K = 768, I = 1152), so the
// tensor-core rate bounds it. Each CTA reads all of Wi and Wo (5.3 MB from
// L2) for 32 rows, 32 operations a byte of L2 traffic, and stages slabs
// synchronously: that, not the bound, sets its time today.
#include "mlp_tail.cuh"

namespace mlp_tail {
namespace {

// ---- bf16 -----------------------------------------------------------------------

namespace tc_fwd {
constexpr int OS = 32;  // contraction slab (columns of I) of the output product
template <int NT>
constexpr size_t smem_bytes(int K) {
  const size_t slab = 2 * CH * tc::LDS > WARPS * 8 * NT * (OS + 8) ? 2 * CH * tc::LDS
                                                                   : WARPS * 8 * NT * (OS + 8);
  return ((size_t)tc::BM * (K + 8) + tc::BM * tc::LDS + slab) * sizeof(bf16);
}
}  // namespace tc_fwd

// NT: n8-tiles of the output a warp holds, K <= 64 * NT.
template <int NT>
__global__ void __launch_bounds__(THREADS)
    tail_fwd_mma_kernel(const bf16* __restrict__ xn, const bf16* __restrict__ wi,
                        const bf16* __restrict__ wo, bf16* __restrict__ out, int M, int K, int I,
                        int act) {
  using namespace tc;
  constexpr int OS = tc_fwd::OS, LDO = OS + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = K + 8;
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);  // [BM][ldx] normalized rows
  bf16* Hs = Xs + BM * ldx;                      // [BM][LDS] the chunk's act * gate
  bf16* Bs = Hs + BM * LDS;                      // a slab of Wi or of Wo

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // narrow products: m-tile wm, columns 16 wn ..
  const int m0 = blockIdx.x * BM;

  stage(Xs, ldx, BM, K, xn, K, [&](int r) { return m0 + r < M ? (long long)(m0 + r) : -1; }, 0,
        K);

  float o[2 * NT][4] = {};  // rows mt * 16 .., columns warp * 8 * NT + nt * 8 ..
  for (int i0 = 0; i0 < I; i0 += CH) {
    float pi[2][4] = {}, pg[2][4] = {};  // inp and gate: 16 rows x 16 columns of the chunk
    for (int k0 = 0; k0 < K; k0 += KS) {
      __syncthreads();  // the previous slab is consumed
      stage(Bs, LDS, 2 * CH, KS, wi, K, [&](int r) { return wi_chunk_row(r, i0, I); }, k0, K);
      __syncthreads();
      const int ksteps = min(KS, K - k0) / 16;
      const bf16* a = Xs + wm * 16 * ldx + k0;
      warp_mma<1, 1, false>(pi, a, ldx, Bs + wn * 16 * LDS, LDS, ksteps, lane);
      warp_mma<1, 1, false>(pg, a, ldx, Bs + (CH + wn * 16) * LDS, LDS, ksteps, lane);
    }
    // Every warp passed a barrier since it last read Hs (the previous chunk).
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Hs[(wm * 16 + g + 8 * (e >> 1)) * LDS + wn * 16 + nt * 8 + 2 * t + (e & 1)] =
            gemm_engine::geglu<bf16>(pi[nt][e], pg[nt][e], act);
    for (int s0 = 0; s0 < CH; s0 += OS) {
      __syncthreads();  // Hs is whole; the previous slab is consumed
      stage(Bs, LDO, WARPS * 8 * NT, OS, wo, I,
            [&](int n) { return n < K ? (long long)n : -1; }, i0 + s0, I);
      __syncthreads();
      warp_mma<2, NT / 2, false>(o, Hs + s0, LDS, Bs + warp * 8 * NT * LDO, LDO, OS / 16, lane);
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + mt * 16 + g + 8 * half;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = warp * 8 * NT + nt * 8 + 2 * t;  // K is even: col and col + 1 together
        if (col >= K) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * K + col) = __floats2bfloat162_rn(
            o[mt * NT + nt][2 * half], o[mt * NT + nt][2 * half + 1]);
      }
    }
}

template <int NT>
int launch_mma(const bf16* xn, const bf16* wi, const bf16* wo, bf16* out, int M, int K, int I,
               int act, cudaStream_t s) {
  const size_t smem = tc_fwd::smem_bytes<NT>(K);
  const cudaError_t err = cudaFuncSetAttribute(
      tail_fwd_mma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tail_fwd_mma_kernel<NT><<<(M + tc::BM - 1) / tc::BM, THREADS, smem, s>>>(xn, wi, wo, out, M, K,
                                                                         I, act);
  return (int)cudaGetLastError();
}

// ---- fp32 -----------------------------------------------------------------------

namespace simt_fwd {
constexpr int OS = 16;  // contraction slab (columns of I) of the output product
template <int JN>
constexpr size_t smem_bytes(int K) {
  const size_t slab =
      simt::KS * simt::LDB > OS * (16 * JN + 1) ? simt::KS * simt::LDB : OS * (16 * JN + 1);
  return ((size_t)simt::BM * (K + 1) + simt::BM * simt::LDC + slab) * sizeof(float);
}
}  // namespace simt_fwd

// JN: output columns a thread holds (tx + 16 j), K <= 16 * JN.
template <int JN>
__global__ void __launch_bounds__(THREADS)
    tail_fwd_fma_kernel(const float* __restrict__ xn, const float* __restrict__ wi,
                        const float* __restrict__ wo, float* __restrict__ out, int M, int K,
                        int I, int act) {
  using namespace simt;
  constexpr int OS = simt_fwd::OS, LDW = 16 * JN + 1;
  extern __shared__ float smem_f[];
  const int ldx = K + 1;
  float* Xs = smem_f;          // [BM][ldx]
  float* Hs = Xs + BM * ldx;   // [BM][LDC]
  float* Bs = Hs + BM * LDC;   // a slab of Wi ([KS][LDB]) or of Wo ([OS][LDW])
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * BM;

  for (int idx = threadIdx.x; idx < BM * K; idx += THREADS) {
    const int r = idx / K, c = idx % K;
    Xs[r * ldx + c] = m0 + r < M ? xn[(size_t)(m0 + r) * K + c] : 0.f;
  }

  float o[JN] = {};
  for (int i0 = 0; i0 < I; i0 += CH) {
    float pi[4] = {}, pg[4] = {};  // inp and gate of columns tx + 16 j of the chunk
    for (int k0 = 0; k0 < K; k0 += KS) {
      __syncthreads();
      stage_t(Bs, LDB, 2 * CH, KS, wi, K, [&](int c) { return wi_chunk_row(c, i0, I); }, k0, K);
      __syncthreads();
      const int ks = min(KS, K - k0);
      fma_row<4>(pi, Xs + ty * ldx + k0, Bs + tx, LDB, ks);
      fma_row<4>(pg, Xs + ty * ldx + k0, Bs + CH + tx, LDB, ks);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Hs[ty * LDC + tx + 16 * j] = gemm_engine::geglu<float>(pi[j], pg[j], act);
    for (int s0 = 0; s0 < CH; s0 += OS) {
      __syncthreads();
      // Ws[ii][n] = Wo[n][i0 + s0 + ii]
      stage_t(Bs, LDW, K, OS, wo, I, [&](int n) { return (long long)n; }, i0 + s0, I);
      __syncthreads();
      fma_row<JN>(o, Hs + ty * LDC + s0, Bs + tx, LDW, OS);
    }
  }
  if (m0 + ty < M) {
#pragma unroll
    for (int j = 0; j < JN; ++j)
      if (tx + 16 * j < K) out[(size_t)(m0 + ty) * K + tx + 16 * j] = o[j];
  }
}

template <int JN>
int launch_fma(const float* xn, const float* wi, const float* wo, float* out, int M, int K, int I,
               int act, cudaStream_t s) {
  const size_t smem = simt_fwd::smem_bytes<JN>(K);
  const cudaError_t err = cudaFuncSetAttribute(
      tail_fwd_fma_kernel<JN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tail_fwd_fma_kernel<JN><<<(M + simt::BM - 1) / simt::BM, THREADS, smem, s>>>(xn, wi, wo, out,
                                                                             M, K, I, act);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mlp_tail

// xn: scratch [M, K] in the storage type. All tensors contiguous. K <= 1024;
// bf16 also takes K % 16 == 0 and I % 8 == 0 (the wrapper checks both).
extern "C" int opt_ln_geglu_wo(const void* x, const void* scale, const void* wi, const void* wo,
                               void* out, void* xn, int m, int k, int intermediate, float eps,
                               int act, int dtype, void* stream) {
  if (m <= 0 || k <= 0 || intermediate <= 0) return 0;
  if (k > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    const float* wit = static_cast<const float*>(wi);
    const float* wot = static_cast<const float*>(wo);
    float* xnt = static_cast<float*>(xn);
    float* outt = static_cast<float*>(out);
    OPT_TRY(gemm_engine::normalize<float>(static_cast<const float*>(x),
                                          static_cast<const float*>(scale), xnt, m, k, eps, s));
    if (k <= 256) return mlp_tail::launch_fma<16>(xnt, wit, wot, outt, m, k, intermediate, act, s);
    if (k <= 768) return mlp_tail::launch_fma<48>(xnt, wit, wot, outt, m, k, intermediate, act, s);
    return mlp_tail::launch_fma<64>(xnt, wit, wot, outt, m, k, intermediate, act, s);
  }
  if (dtype == DTYPE_BF16) {
    using mlp_tail::bf16;
    const bf16* wit = static_cast<const bf16*>(wi);
    const bf16* wot = static_cast<const bf16*>(wo);
    bf16* xnt = static_cast<bf16*>(xn);
    bf16* outt = static_cast<bf16*>(out);
    if (k % 16 || intermediate % 8) return (int)cudaErrorInvalidValue;
    OPT_TRY(gemm_engine::normalize<bf16>(static_cast<const bf16*>(x),
                                         static_cast<const bf16*>(scale), xnt, m, k, eps, s));
    if (k <= 256) return mlp_tail::launch_mma<4>(xnt, wit, wot, outt, m, k, intermediate, act, s);
    if (k <= 768) return mlp_tail::launch_mma<12>(xnt, wit, wot, outt, m, k, intermediate, act, s);
    return mlp_tail::launch_mma<16>(xnt, wit, wot, outt, m, k, intermediate, act, s);
  }
  return (int)cudaErrorInvalidValue;
}
