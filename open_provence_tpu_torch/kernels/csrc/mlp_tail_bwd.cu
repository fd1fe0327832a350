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
//   2. the row pass. bf16 (mlp_tail.cuh, wgb::): one CTA a tile of 128 rows
//      x 64 columns of I runs [inp | gate] = xn . Wi^T and dh = g . Wo on
//      wgmma through one TMA ring and applies the chain in its epilogue; h
//      [M, I] and [gi | gg] [M, 2I] go to scratch once, staged for 16-byte
//      stores, and inp, gate and dh never reach device memory. fp32: a CTA of
//      16 rows also adds gi . W_inp + gg . W_gate into its rows' dy in
//      registers (the card's fp32 parity path);
//   3. bf16: dy = [gi | gg] . Wi in fp32 on the GEMM engine (an MN-major B),
//      the product kernel 11 runs; the row pass cannot hold a [128, K] fp32
//      dy beside its sums in the 168 registers a consumer thread has;
//   4. dWi = [gi | gg]^T . xn and dWo = g^T . h on the GEMM engine (bf16:
//      the M rows in chunks summed in order, rounded once);
//   5. the LN-adjoint row body (ln_adjoint.cuh) on (x, s, dy): dx and ds.
// Against kernel 11 plus the library's products for dh and dWo this keeps
// dh and the [M, 2I] projection out of device memory and saves a launch.
// Work: 16*M*K*I operations, the TPU kernel's count (the row pass's three
// products 6, dy 4, the two weight gradients 6), so the tensor-core rate
// bounds it.
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

// One CTA a tile of TILE_M rows x NI columns of I: a k-step's stage holds
// xn [TILE_M][64], the Wi rows of the NI columns (blocks of 8 input rows,
// each followed by their 8 gate rows), g [TILE_M][64] and Wo [64 k-rows][NI],
// all 128-byte swizzled. Consumer c holds rows 64 c .. + 63 of [inp | gate]
// (2 NI columns, interleaved as the engine's GEGLU tiles are) and of dh.
__global__ void __launch_bounds__(wgb::CTA_THREADS, 1)
    tail_bwd_rows_wgmma_kernel(const __grid_constant__ CUtensorMap xn_map,
                               const __grid_constant__ CUtensorMap wi_map,
                               const __grid_constant__ CUtensorMap g_map,
                               const __grid_constant__ CUtensorMap wo_map, bf16* __restrict__ h,
                               bf16* __restrict__ cot, int M, int K, int I, int act) {
  using namespace wgb;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = hop::smem_u32(smem);
  const int tid = threadIdx.x, group = tid / GROUP, t = tid % GROUP, lane = t & 31;
  const int i0 = blockIdx.x * NI, m0 = blockIdx.y * TILE_M, n_k = (K + BK - 1) / BK;
  // Offsets inside a stage.
  constexpr int WI = X_BYTES, G = WI + WI_BYTES, WO = G + X_BYTES;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], WGS * GROUP / 32);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (group == WGS) {  // ---- the producer: one thread issues every copy ----
    hop::reg_dealloc<REGS_PRODUCER>();
    if (t != 0) return;
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % STAGES, k0 = kt * BK;
      hop::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
      hop::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
      const uint32_t st = ring + s * STAGE_BYTES;
      hop::tma_load_2d(st, &xn_map, k0, m0, &full[s]);
#pragma unroll
      for (int j = 0; j < NI / GATE_BLOCK; ++j)
        hop::tma_load_3d(st + WI + j * 2 * GATE_BLOCK * ROW_BYTES, &wi_map, k0,
                         i0 + j * GATE_BLOCK, 0, &full[s]);
      hop::tma_load_2d(st + G, &g_map, k0, m0, &full[s]);
      hop::tma_load_2d(st + WO, &wo_map, i0, k0, &full[s]);
    }
    return;
  }

  // ---- a consumer warpgroup: tile rows 64 * group .. + 63 ----
  hop::reg_alloc<REGS_CONSUMER>();
  const int warp = t >> 5, g = lane >> 2, q = lane & 3;
  float ig[NI], dh[NI / 2];  // 2 NI and NI columns: half as many sums a thread
#pragma unroll
  for (int i = 0; i < NI; ++i) ig[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NI / 2; ++i) dh[i] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % STAGES;
    hop::mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint32_t st = ring + s * STAGE_BYTES, rows = group * 64 * ROW_BYTES;
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      hop::wgmma_ss<2 * NI>(ig, hop::k_major<BK>(st + rows, kk), hop::k_major<BK>(st + WI, kk), 1);
      hop::wgmma_ss<NI, 0, 1>(dh, hop::k_major<BK>(st + G + rows, kk),
                              hop::mn_major<NI>(st + WO, kk), 1);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<1>();  // the previous k-step's products are done with its stage
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
  }
  hop::wgmma_wait<0>();
  hop::pin<NI>(ig);
  hop::pin<NI / 2>(dh);

  // Both consumers are past their last product and every copy was waited
  // for: the ring is free. The chain into [64][NI + 8] tiles of h, gi, gg
  // (the thread that holds an input's sum holds its gate's and its dh), then
  // 16-byte stores (I % 8 == 0).
  hop::bar_sync(BAR_CONSUMERS, WGS * GROUP);
  constexpr int TILE = 64 * STAGED_PITCH;
  bf16* staged = reinterpret_cast<bf16*>(smem) + group * 3 * TILE;  // h, gi, gg
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int at = (warp * 16 + g + 8 * i) * STAGED_PITCH + 2 * q;
#pragma unroll
    for (int j = 0; j < NI / 8; ++j) {  // ig blocks 2j (inputs), 2j + 1 (gates); dh block j
      const float* in = ig + 8 * j + 2 * i;
      const float* d = dh + 4 * j + 2 * i;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        chain<bf16>(in[e], in[4 + e], d[e], act, staged + at + 8 * j + e,
                    staged + TILE + at + 8 * j + e, staged + 2 * TILE + at + 8 * j + e);
    }
  }
  hop::bar_sync(bar_consumer(group), GROUP);
  constexpr int CHUNKS = NI / 8;
  for (int idx = t; idx < 64 * CHUNKS; idx += GROUP) {
    const int r = idx / CHUNKS, cc = (idx % CHUNKS) * 8, row = m0 + group * 64 + r;
    if (row >= M || i0 + cc >= I) continue;
    const bf16* src = staged + r * STAGED_PITCH + cc;
    const size_t at = (size_t)row * 2 * I + i0 + cc;
    *reinterpret_cast<uint4*>(h + (size_t)row * I + i0 + cc) = *reinterpret_cast<const uint4*>(src);
    *reinterpret_cast<uint4*>(cot + at) = *reinterpret_cast<const uint4*>(src + TILE);
    *reinterpret_cast<uint4*>(cot + at + I) = *reinterpret_cast<const uint4*>(src + 2 * TILE);
  }
}

int rows_pass(const bf16* xn, const bf16* g, const bf16* wi, const bf16* wo, bf16* h, bf16* cot,
              int M, int K, int I, int act, cudaStream_t s) {
  using namespace wgb;
  if (K % 16 || I % 8 || reinterpret_cast<uintptr_t>(xn) % 16 ||
      reinterpret_cast<uintptr_t>(g) % 16 || reinterpret_cast<uintptr_t>(wi) % 16 ||
      reinterpret_cast<uintptr_t>(wo) % 16 || reinterpret_cast<uintptr_t>(h) % 16 ||
      reinterpret_cast<uintptr_t>(cot) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xn_map, wi_map, g_map, wo_map;
  const cuuint64_t rows_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t rows_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t rows_box[2] = {BK, TILE_M};  // xn and g [M, K] in boxes of TILE_M rows x 64
  const cuuint64_t wi_dims[3] = {(cuuint64_t)K, (cuuint64_t)I, 2};
  const cuuint64_t wi_strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)I * K * 2};
  const cuuint32_t wi_box[3] = {BK, GATE_BLOCK, 2};  // 8 input rows, then their gate rows
  const cuuint64_t wo_dims[2] = {(cuuint64_t)I, (cuuint64_t)K}, wo_strides[1] = {(cuuint64_t)I * 2};
  const cuuint32_t wo_box[2] = {NI, BK};  // Wo [K, I]: 64 k-rows x NI columns
  if (!gemm_engine::bf16_map(&xn_map, xn, 2, rows_dims, rows_strides, rows_box) ||
      !gemm_engine::bf16_map(&g_map, g, 2, rows_dims, rows_strides, rows_box) ||
      !gemm_engine::bf16_map(&wi_map, wi, 3, wi_dims, wi_strides, wi_box) ||
      !gemm_engine::bf16_map(&wo_map, wo, 2, wo_dims, wo_strides, wo_box))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      tail_bwd_rows_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((I + NI - 1) / NI, (M + TILE_M - 1) / TILE_M);
  tail_bwd_rows_wgmma_kernel<<<grid, CTA_THREADS, SMEM_BYTES, s>>>(xn_map, wi_map, g_map, wo_map,
                                                                   h, cot, M, K, I, act);
  return (int)cudaGetLastError();
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
  const T* wit = static_cast<const T*>(wi);
  const T* wot = static_cast<const T*>(wo);
  OPT_TRY(normalize<T>(xt, st, xnt, M, K, eps, s));
  if constexpr (sizeof(T) == 4) {
    OPT_TRY(rows_pass(xnt, gt, wit, wot, ht, cott, dy, M, K, I, act, s));
  } else {
    OPT_TRY(rows_pass(xnt, gt, wit, wot, ht, cott, M, K, I, act, s));
    OPT_TRY(gemm<false, true>(cott, 2 * I, wit, K, dy, K, M, K, 2 * I, s));  // dy = [gi | gg] . Wi
  }
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
