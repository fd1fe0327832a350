// The whole MLP in one kernel, backward: kernel 13.
//
// opt_ln_geglu_wo_bwd replaces ops/geglu.py::_ln_geglu_wo_bwd_kernel: from
// x [M, K], the LN scale s [K], Wi [2I, K], Wo [K, I] (torch's [out, in]
// layout) and g = d out [M, K] it writes dx [M, K], ds [K], dWi [2I, K] and
// dWo [K, I], with the TPU kernel's rounding points: recompute xn = T(LN(x)
// * s), inp and gate rounded to the storage type, a = T(act(inp)), h =
// T(a * gate); dh = g . Wo in fp32; gi = T(dh * act'(inp) * gate), gg =
// T(dh * a); dWo = g^T . h, dWi = [gi | gg]^T . xn, dy = gi . W_inp +
// gg . W_gate in fp32, then the LN adjoint (dscale = sum dy * hn).
//
// The TPU kernel walks the row tiles in sequence with fp32 dWi, dWo and
// dscale resident across its whole grid; CTAs run in no order and keep
// nothing between them. Here it is a row pass and the engine's GEMMs, all on
// the caller's stream, with no atomics and a fixed summation order
// everywhere, so two runs give the same bits:
//   1. xn into scratch [M, K] (gemm.cuh's normalize pass);
//   2. the row pass (mlp_tail.cuh): a CTA keeps its rows of xn and g in
//      shared memory and walks I in chunks; per chunk inp, gate and dh come
//      from slabs of Wi and Wo, the chain gives h, gi, gg in shared memory,
//      and gi . W_inp + gg . W_gate adds into the rows' dy accumulator in
//      registers. inp, gate and dh never exist in device memory. h and
//      [gi | gg] are written once, to scratch [M, I] and [M, 2I], and dy in
//      fp32 to scratch [M, K];
//   3. dWi = [gi | gg]^T . xn and dWo = g^T . h on the GEMM engine (bf16:
//      wgmma, the M rows in chunks summed in order, rounded once);
//   4. the LN-adjoint row body (ln_adjoint.cuh) on (x, s, dy): dx and ds.
// Against kernel 11 plus the library's two Wo gradients this keeps the
// [M, 2I] projection and dh out of device memory (one write and one read
// each) and writes h once more. A weight pass that recomputed h, gi and gg
// per tile of dWi or dWo (no [M, I] tensor in device memory at all) would
// cost 6*M*K*I more operations and is later work. Work here: 16*M*K*I
// operations, the TPU kernel's count (the row pass's five products are 10,
// the two weight GEMMs 6), so the tensor-core rate bounds it.
#include "ln_adjoint.cuh"
#include "mlp_tail.cuh"

namespace mlp_tail {
namespace {
using gemm_engine::gemm;
using gemm_engine::normalize;

// The GeGLU chain of one element: h, gi, gg in the storage type from the
// fp32 sums inp, gate, dh.
template <typename T>
__device__ __forceinline__ void chain(float inp_acc, float gate_acc, float dh, int act, T* h,
                                      T* gi, T* gg) {
  const float inp = round_to<T>(inp_acc), gate = round_to<T>(gate_acc);
  const float a = round_to<T>(activation(inp, act));
  const float da = activation_grad(inp, act);
  *h = from_f32<T>(a * gate);
  *gi = from_f32<T>(dh * da * gate);
  *gg = from_f32<T>(dh * a);
}

// ---- bf16 -----------------------------------------------------------------------

namespace tc_bwd {
constexpr int OS = 16;  // contraction slab (rows of Wi per half) of the dy product
template <int NT>
constexpr size_t smem_bytes(int K) {
  const size_t narrow = (2 * CH + tc::KS) * tc::LDS, wide = 2 * OS * (WARPS * 8 * NT + 8);
  return ((size_t)2 * tc::BM * (K + 8) + 3 * tc::BM * tc::LDS + (narrow > wide ? narrow : wide)) *
         sizeof(bf16);
}
}  // namespace tc_bwd

// NT: n8-tiles of dy a warp holds, K <= 64 * NT.
template <int NT>
__global__ void __launch_bounds__(THREADS)
    tail_bwd_rows_mma_kernel(const bf16* __restrict__ xn, const bf16* __restrict__ g,
                             const bf16* __restrict__ wi, const bf16* __restrict__ wo,
                             bf16* __restrict__ h_out, bf16* __restrict__ cot,
                             float* __restrict__ dy, int M, int K, int I, int act) {
  using namespace tc;
  constexpr int OS = tc_bwd::OS, LDW = WARPS * 8 * NT + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = K + 8;
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);  // [BM][ldx] normalized rows
  bf16* Gs = Xs + BM * ldx;                      // [BM][ldx] d out
  bf16* Hs = Gs + BM * ldx;                      // [BM][LDS] the chunk's h
  bf16* GIs = Hs + BM * LDS;                     // [BM][LDS] gi
  bf16* GGs = GIs + BM * LDS;                    // [BM][LDS] gg
  bf16* Bs = GGs + BM * LDS;  // narrow: Wi slab [2 CH][LDS] + Wo slab [KS][LDS]; wide: [2 OS][LDW]
  bf16* Bo = Bs + 2 * CH * LDS;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // narrow products: m-tile wm, columns 16 wn ..
  const int m0 = blockIdx.x * BM;
  auto own_row = [&](int r) { return m0 + r < M ? (long long)(m0 + r) : -1; };

  stage(Xs, ldx, BM, K, xn, K, own_row, 0, K);
  stage(Gs, ldx, BM, K, g, K, own_row, 0, K);

  float acc[2 * NT][4] = {};  // dy: rows mt * 16 .., columns warp * 8 * NT + nt * 8 ..
  for (int i0 = 0; i0 < I; i0 += CH) {
    float pi[2][4] = {}, pg[2][4] = {}, pd[2][4] = {};  // inp, gate, dh: 16 rows x 16 columns
    for (int k0 = 0; k0 < K; k0 += KS) {
      __syncthreads();  // the previous slabs are consumed
      stage(Bs, LDS, 2 * CH, KS, wi, K, [&](int r) { return wi_chunk_row(r, i0, I); }, k0, K);
      // Wo rows k0 .. (the contraction of dh = g . Wo), the chunk's columns.
      stage(Bo, LDS, KS, CH, wo, I, [&](int r) { return k0 + r < K ? (long long)(k0 + r) : -1; },
            i0, I);
      __syncthreads();
      const int ksteps = min(KS, K - k0) / 16;
      const bf16* a = Xs + wm * 16 * ldx + k0;
      warp_mma<1, 1, false>(pi, a, ldx, Bs + wn * 16 * LDS, LDS, ksteps, lane);
      warp_mma<1, 1, false>(pg, a, ldx, Bs + (CH + wn * 16) * LDS, LDS, ksteps, lane);
      warp_mma<1, 1, true>(pd, Gs + wm * 16 * ldx + k0, ldx, Bo + wn * 16, LDS, ksteps, lane);
    }
    // Every warp passed a barrier since it last read the chunk tiles.
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = (wm * 16 + gq + 8 * (e >> 1)) * LDS + wn * 16 + nt * 8 + 2 * t + (e & 1);
        chain<bf16>(pi[nt][e], pg[nt][e], pd[nt][e], act, Hs + at, GIs + at, GGs + at);
      }
    for (int s0 = 0; s0 < CH; s0 += OS) {
      __syncthreads();  // the chunk tiles are whole; the previous slab is consumed
      if (s0 == 0) {
        // h and [gi | gg] to scratch, 16 bytes a store.
        for (int c = threadIdx.x; c < BM * (CH / 8); c += THREADS) {
          const int r = c / (CH / 8), cc = (c % (CH / 8)) * 8;
          if (m0 + r >= M || i0 + cc >= I) continue;
          const size_t row = (size_t)(m0 + r);
          *reinterpret_cast<uint4*>(h_out + row * I + i0 + cc) =
              *reinterpret_cast<const uint4*>(Hs + r * LDS + cc);
          *reinterpret_cast<uint4*>(cot + row * 2 * I + i0 + cc) =
              *reinterpret_cast<const uint4*>(GIs + r * LDS + cc);
          *reinterpret_cast<uint4*>(cot + row * 2 * I + I + i0 + cc) =
              *reinterpret_cast<const uint4*>(GGs + r * LDS + cc);
        }
      }
      // Rows i0 + s0 .. of W_inp, then of W_gate: the contraction of dy.
      stage(Bs, LDW, 2 * OS, K, wi, K,
            [&](int r) {
              const int i = i0 + s0 + (r < OS ? r : r - OS);
              return i < I ? (long long)(r < OS ? i : I + i) : -1;
            },
            0, K);
      __syncthreads();
      warp_mma<2, NT / 2, true>(acc, GIs + s0, LDS, Bs + warp * 8 * NT, LDW, OS / 16, lane);
      warp_mma<2, NT / 2, true>(acc, GGs + s0, LDS, Bs + OS * LDW + warp * 8 * NT, LDW, OS / 16,
                                lane);
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + mt * 16 + gq + 8 * half;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = warp * 8 * NT + nt * 8 + 2 * t;  // K is even
        if (col >= K) continue;
        *reinterpret_cast<float2*>(dy + (size_t)row * K + col) =
            make_float2(acc[mt * NT + nt][2 * half], acc[mt * NT + nt][2 * half + 1]);
      }
    }
}

template <int NT>
int launch_rows_mma(const bf16* xn, const bf16* g, const bf16* wi, const bf16* wo, bf16* h,
                    bf16* cot, float* dy, int M, int K, int I, int act, cudaStream_t s) {
  const size_t smem = tc_bwd::smem_bytes<NT>(K);
  const cudaError_t err = cudaFuncSetAttribute(
      tail_bwd_rows_mma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tail_bwd_rows_mma_kernel<NT><<<(M + tc::BM - 1) / tc::BM, THREADS, smem, s>>>(
      xn, g, wi, wo, h, cot, dy, M, K, I, act);
  return (int)cudaGetLastError();
}

int rows_pass(const bf16* xn, const bf16* g, const bf16* wi, const bf16* wo, bf16* h, bf16* cot,
              float* dy, int M, int K, int I, int act, cudaStream_t s) {
  if (K % 16 || I % 8) return (int)cudaErrorInvalidValue;
  if (K <= 256) return launch_rows_mma<4>(xn, g, wi, wo, h, cot, dy, M, K, I, act, s);
  if (K <= 768) return launch_rows_mma<12>(xn, g, wi, wo, h, cot, dy, M, K, I, act, s);
  return launch_rows_mma<16>(xn, g, wi, wo, h, cot, dy, M, K, I, act, s);
}

// ---- fp32 -----------------------------------------------------------------------

namespace simt_bwd {
constexpr int OS = 8;  // contraction slab (rows of Wi per half) of the dy product
template <int JN>
constexpr size_t smem_bytes(int K) {
  const size_t narrow = simt::KS * (simt::LDB + simt::LDC), wide = 2 * OS * (16 * JN + 1);
  return ((size_t)2 * simt::BM * (K + 1) + 3 * simt::BM * simt::LDC +
          (narrow > wide ? narrow : wide)) *
         sizeof(float);
}
}  // namespace simt_bwd

// JN: columns of dy a thread holds (tx + 16 j), K <= 16 * JN.
template <int JN>
__global__ void __launch_bounds__(THREADS)
    tail_bwd_rows_fma_kernel(const float* __restrict__ xn, const float* __restrict__ g,
                             const float* __restrict__ wi, const float* __restrict__ wo,
                             float* __restrict__ h_out, float* __restrict__ cot,
                             float* __restrict__ dy, int M, int K, int I, int act) {
  using namespace simt;
  constexpr int OS = simt_bwd::OS, LDW = 16 * JN + 1;
  extern __shared__ float smem_f[];
  const int ldx = K + 1;
  float* Xs = smem_f;            // [BM][ldx]
  float* Gs = Xs + BM * ldx;     // [BM][ldx]
  float* Hs = Gs + BM * ldx;     // [BM][LDC]
  float* GIs = Hs + BM * LDC;    // [BM][LDC]
  float* GGs = GIs + BM * LDC;   // [BM][LDC]
  float* Bs = GGs + BM * LDC;    // narrow: Wi [KS][LDB] + Wo [KS][LDC]; wide: [2 OS][LDW]
  float* Bo = Bs + KS * LDB;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * BM;

  for (int idx = threadIdx.x; idx < BM * K; idx += THREADS) {
    const int r = idx / K, c = idx % K;
    const bool ok = m0 + r < M;
    Xs[r * ldx + c] = ok ? xn[(size_t)(m0 + r) * K + c] : 0.f;
    Gs[r * ldx + c] = ok ? g[(size_t)(m0 + r) * K + c] : 0.f;
  }

  float acc[JN] = {};
  for (int i0 = 0; i0 < I; i0 += CH) {
    float pi[4] = {}, pg[4] = {}, pd[4] = {};  // columns tx + 16 j of the chunk
    for (int k0 = 0; k0 < K; k0 += KS) {
      __syncthreads();
      stage_t(Bs, LDB, 2 * CH, KS, wi, K, [&](int c) { return wi_chunk_row(c, i0, I); }, k0, K);
      stage_n(Bo, LDC, CH, KS, wo, I, [&](int kk) { return k0 + kk < K ? (long long)(k0 + kk) : -1; },
              i0, I);
      __syncthreads();
      const int ks = min(KS, K - k0);
      fma_row<4>(pi, Xs + ty * ldx + k0, Bs + tx, LDB, ks);
      fma_row<4>(pg, Xs + ty * ldx + k0, Bs + CH + tx, LDB, ks);
      fma_row<4>(pd, Gs + ty * ldx + k0, Bo + tx, LDC, ks);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int at = ty * LDC + tx + 16 * j;
      chain<float>(pi[j], pg[j], pd[j], act, Hs + at, GIs + at, GGs + at);
      const int col = i0 + tx + 16 * j;
      if (m0 + ty < M && col < I) {
        const size_t row = (size_t)(m0 + ty);
        h_out[row * I + col] = Hs[at];
        cot[row * 2 * I + col] = GIs[at];
        cot[row * 2 * I + I + col] = GGs[at];
      }
    }
    for (int s0 = 0; s0 < CH; s0 += OS) {
      __syncthreads();
      stage_n(Bs, LDW, K, 2 * OS, wi, K,
              [&](int r) {
                const int i = i0 + s0 + (r < OS ? r : r - OS);
                return i < I ? (long long)(r < OS ? i : I + i) : -1;
              },
              0, K);
      __syncthreads();
      fma_row<JN>(acc, GIs + ty * LDC + s0, Bs + tx, LDW, OS);
      fma_row<JN>(acc, GGs + ty * LDC + s0, Bs + OS * LDW + tx, LDW, OS);
    }
  }
  if (m0 + ty < M) {
#pragma unroll
    for (int j = 0; j < JN; ++j)
      if (tx + 16 * j < K) dy[(size_t)(m0 + ty) * K + tx + 16 * j] = acc[j];
  }
}

template <int JN>
int launch_rows_fma(const float* xn, const float* g, const float* wi, const float* wo, float* h,
                    float* cot, float* dy, int M, int K, int I, int act, cudaStream_t s) {
  const size_t smem = simt_bwd::smem_bytes<JN>(K);
  const cudaError_t err = cudaFuncSetAttribute(
      tail_bwd_rows_fma_kernel<JN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tail_bwd_rows_fma_kernel<JN><<<(M + simt::BM - 1) / simt::BM, THREADS, smem, s>>>(
      xn, g, wi, wo, h, cot, dy, M, K, I, act);
  return (int)cudaGetLastError();
}

int rows_pass(const float* xn, const float* g, const float* wi, const float* wo, float* h,
              float* cot, float* dy, int M, int K, int I, int act, cudaStream_t s) {
  if (K <= 256) return launch_rows_fma<16>(xn, g, wi, wo, h, cot, dy, M, K, I, act, s);
  if (K <= 768) return launch_rows_fma<48>(xn, g, wi, wo, h, cot, dy, M, K, I, act, s);
  return launch_rows_fma<64>(xn, g, wi, wo, h, cot, dy, M, K, I, act, s);
}

template <typename T>
int tail_bwd(const void* x, const void* scale, const void* wi, const void* wo, const void* g,
             void* dx, void* dwi, void* dwo, void* dscale, void* xn, void* h, void* cot, float* dy,
             float* partial, float* dw_partial, int rows_wi, int rows_wo, int M, int K, int I,
             float eps, int act, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(scale);
  const T* gt = static_cast<const T*>(g);
  T* xnt = static_cast<T*>(xn);
  T* ht = static_cast<T*>(h);
  T* cott = static_cast<T*>(cot);
  OPT_TRY(normalize<T>(xt, st, xnt, M, K, eps, s));
  OPT_TRY(rows_pass(xnt, gt, static_cast<const T*>(wi), static_cast<const T*>(wo), ht, cott, dy,
                    M, K, I, act, s));
  // dWi = [gi | gg]^T . xn and dWo = g^T . h, summed over M; in bf16 in
  // chunks of rows_wi and rows_wo rows through the one dw_partial, in turn.
  OPT_TRY(gemm<true, true>(cott, 2 * I, xnt, K, static_cast<T*>(dwi), K, 2 * I, K, M, s, 0,
                           dw_partial, rows_wi));
  OPT_TRY(gemm<true, true>(gt, K, ht, I, static_cast<T*>(dwo), I, K, I, M, s, 0, dw_partial,
                           rows_wo));
  return ln_adjoint::launch<T, float>(xt, st, dy, dx, dscale, partial, M, K, eps, s);
}

}  // namespace
}  // namespace mlp_tail

// Scratch the wrapper allocates: xn [M, K], h [M, I] and cot [M, 2I] in the
// storage type, dy [M, K] fp32, partial [ln_adjoint::parts(M), K] fp32 and, in bf16,
// dw_partial fp32 for the larger of dWi's ceil(M / rows_wi) x 2I x K and
// dWo's ceil(M / rows_wo) x K x I partial sums. All tensors contiguous.
// K <= 1024; bf16 also takes K % 16 == 0 and I % 8 == 0.
extern "C" int opt_ln_geglu_wo_bwd(const void* x, const void* scale, const void* wi,
                                   const void* wo, const void* g, void* dx, void* dwi, void* dwo,
                                   void* dscale, void* xn, void* h, void* cot, float* dy,
                                   float* partial, float* dw_partial, int m, int k,
                                   int intermediate, int rows_wi, int rows_wo, float eps, int act,
                                   int dtype, void* stream) {
  if (m <= 0 || k <= 0 || intermediate <= 0) return 0;
  if (k > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return mlp_tail::tail_bwd<float>(x, scale, wi, wo, g, dx, dwi, dwo, dscale, xn, h, cot, dy,
                                     partial, dw_partial, rows_wi, rows_wo, m, k, intermediate,
                                     eps, act, s);
  if (dtype == DTYPE_BF16)
    return mlp_tail::tail_bwd<__nv_bfloat16>(x, scale, wi, wo, g, dx, dwi, dwo, dscale, xn, h,
                                             cot, dy, partial, dw_partial, rows_wi, rows_wo, m,
                                             k, intermediate, eps, act, s);
  return (int)cudaErrorInvalidValue;
}
