// The bf16 products of the GEMM engine (gemm.cuh) on Hopper:
// C[m, n] = sum_k A(m, k) B(k, n), A(m, k) = A[m * lda + k] (K-major) or
// A[k * lda + m] (TA: MN-major), B(k, n) = B[n * ldb + k] (K-major: torch's
// [out, in] weight) or B[k * ldb + n] (TB: MN-major). Rows 2 and 4
// (ln_gemm.cu), row 6 (opt_geglu) and row 11's recomputed projection run
// the K-major x K-major product; the backward's dy = G . W (rows 11, 12) an
// MN-major B; the weight gradients dW = G^T . X (rows 11, 12, 13) both
// operands MN-major.
//
// What bounds it: at M = 16384, K = 768 and 2304 B rows a call is 58 GFLOP
// against 31 MB of operands and output, ~1900 operations a byte: the tensor
// cores, whose full rate only wgmma reaches. So a CTA is built around wgmma:
//   - three warpgroups: a producer and two consumers that meet only at
//     mbarriers (no __syncthreads() in the mainloop); setmaxnreg moves the
//     producer's registers to the consumers (40 / 232 a thread);
//   - a 128 x 256 tile of the product: consumer c owns rows 64c .. 64c + 63
//     and holds their 64 x 256 fp32 sums (128 registers a thread) as one
//     wgmma.m64n256k16 chain, four a k-step of 64;
//   - k-steps of BK = 64 through a ring of 4 stages of A (128 x 64) and B
//     (256 x 64), 48 KB a stage, in 128-byte swizzle panels: a K-major tile
//     is its rows of 64 k; an MN-major one is 64 k-rows of 64 columns a
//     panel (two for A, one a consumer; four for B), which wgmma reads with
//     its transpose immediates set (hop::mn_major);
//   - one producer thread fills the ring by TMA, boxes of the two tensor maps
//     the launcher encodes, swizzled as wgmma reads them; reads past M, N or
//     K give zeros, so no edge is assumed away (M, N any; K % 8 == 0 where k
//     is an operand's contiguous dim). The copied bytes complete the stage's
//     mbarrier, so the producer never waits for a copy, only for a stage the
//     consumers released, and all four stages are in flight. A consumer
//     keeps one product group in flight and releases a stage when the group
//     after it is issued. The producer first filled the ring with a
//     warpgroup's cp.async copies (as attention_wgmma.cuh does, where the
//     producer rotates each tile); a stage could then be published only
//     after the copies were waited for, two tiles ahead, and it measured
//     15 % slower on an H100 (PERF.md);
//   - bf16 out: the epilogue waits for both consumers (the ring is then
//     free), stages the rounded results in a freed stage as [64][cols + 8]
//     and writes them as 16-byte stores (element stores at a ragged N or row
//     pitch). fp32 out (dy, and the weight gradients' partial sums): each
//     thread stores its pairs of sums as 8-byte stores straight from the
//     accumulator; a quad of threads writes 32 contiguous bytes, whole
//     sectors.
//   - the depth may be cut into chunks of `chunk_rows` (a multiple of BK),
//     one a grid z index, each writing its own fp32 partial C: the weight
//     gradients sum M = 16384 rows into only 54 tiles of 128 x 256, too few
//     CTAs for 132 SMs. gemm.cuh sums the partials in chunk order.
// Measured slower on an H100 and left out (PERF.md): persistent CTAs
// (storing from registers, or through a staging buffer of their own, while
// the producer fills the next tile); two-CTA clusters that multicast the
// shared B tile; and a producer warpgroup that normalizes the raw rows of x
// in each A tile, which would spare the normalize pass and its xn scratch.
//
// GEGLU (K-major only): the B tile's 256 rows are the input rows of 128
// output columns and their gate rows, interleaved in blocks of 8 (n0 + 8j ..
// n0 + 8j + 7, then the same columns' gate rows I + n0 + 8j ...). wgmma's
// accumulator gives a thread the same two columns of every block of 8
// (hopper.cuh), so the thread that holds an input's sum holds its gate's.
// The sums go through the TPU kernel's rounding chain (geglu<OutT>).
//
// Every sum is one wgmma chain in a fixed order over k (and chunks are
// summed in a fixed order), so two launches on the same inputs give the
// same bits.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda

#include "activation.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace gemm_engine {
namespace {

enum class Epi { STORE, GEGLU };

// The TPU kernel's GeGLU rounding chain (ops/geglu.py::_ln_geglu_kernel):
// round each half to the storage type, the activation in fp32 on the rounded
// input, round, then the product with the rounded gate.
template <typename OutT>
__device__ __forceinline__ OutT geglu(float inp, float gate, int act) {
  const float a = round_to<OutT>(activation(round_to<OutT>(inp), act));
  return from_f32<OutT>(a * round_to<OutT>(gate));
}

namespace wgm {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int GROUP = 128, CONSUMERS = 2, THREADS = (CONSUMERS + 1) * GROUP;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ROW_BYTES = BK * 2;  // one swizzle panel row
constexpr int A_BYTES = BM * ROW_BYTES, B_BYTES = BN * ROW_BYTES;
constexpr int PANEL_BYTES = 64 * ROW_BYTES;  // 64 rows of a K-major tile, or an MN-major panel
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + the slack to a 1024-byte boundary
constexpr int GATE_BLOCK = 8;                             // GEGLU: input rows, then as many gate rows
constexpr int BAR_CONSUMERS = 1;                          // named barriers; 0 is __syncthreads
__device__ __forceinline__ int bar_consumer(int c) { return 2 + c; }
// Output columns a tile, and the pitch of a consumer's staged rows.
template <Epi E>
__host__ __device__ constexpr int out_cols() { return E == Epi::GEGLU ? BN / 2 : BN; }
template <Epi E>
__host__ __device__ constexpr int staged_pitch() { return out_cols<E>() + 8; }
static_assert(CONSUMERS * 64 * staged_pitch<Epi::STORE>() * 2 <= STAGES * STAGE_BYTES,
              "the staged output fits in the freed ring");
}  // namespace wgm

// a_map: A [M, K] in boxes of 128 rows x 64, or (TA) A^T [K, M] in boxes of
// 64 k-rows x 64 columns; b_map: B [N, K] in boxes of 256 rows x 64 (STORE),
// Wi as [2][N][K] in boxes of 2 x 8 rows x 64 (GEGLU), or (TB) B^T [K, N] in
// boxes of 64 k-rows x 64 columns. TA: grid z is the depth's chunk, k in
// [z * chunk_rows, min(K, (z + 1) * chunk_rows)), written to C + z * c_chunk.
// vec: bf16 C's rows may take 16-byte stores (C 16-byte aligned, ldc % 8 == 0).
template <bool TA, bool TB, Epi E, typename OutT>
__global__ void __launch_bounds__(wgm::THREADS, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap b_map, OutT* __restrict__ C, int ldc,
                      int M, int N, int K, int chunk_rows, size_t c_chunk, int act, int vec) {
  using namespace wgm;
  using bf16 = __nv_bfloat16;
  static_assert(E == Epi::STORE || (!TA && !TB), "GEGLU reads Wi in torch's [out, in] layout");
  static_assert(sizeof(OutT) == 2 || E == Epi::STORE, "GEGLU rounds to bf16");
  constexpr int OUT_N = out_cols<E>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = hop::smem_u32(smem);
  const int tid = threadIdx.x, group = tid / GROUP, t = tid % GROUP, lane = t & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * OUT_N;
  int kt0 = 0, n_k = (K + BK - 1) / BK;
  if constexpr (TA) {  // only the weight gradients split their depth
    const int k_begin = blockIdx.z * chunk_rows, k_end = min(K, k_begin + chunk_rows);
    kt0 = k_begin / BK;
    n_k = (k_end - k_begin + BK - 1) / BK;
    C += blockIdx.z * c_chunk;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);  // the producer's arrival; the bytes complete it
      hop::mbar_init(&empty[s], CONSUMERS * GROUP / 32);  // lane 0 of each consumer warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (group == CONSUMERS) {  // ---- the producer: one thread issues every copy ----
    hop::reg_dealloc<PRODUCER_REGS>();
    if (t != 0) return;
    for (int i = 0; i < n_k; ++i) {
      const int s = i % STAGES, k0 = (kt0 + i) * BK;
      hop::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
      hop::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
      const uint32_t a = ring + s * STAGE_BYTES, b = a + A_BYTES;
      if constexpr (TA) {
#pragma unroll
        for (int p = 0; p < BM / 64; ++p)
          hop::tma_load_2d(a + p * PANEL_BYTES, &a_map, m0 + 64 * p, k0, &full[s]);
      } else {
        hop::tma_load_2d(a, &a_map, k0, m0, &full[s]);
      }
      if constexpr (TB) {
#pragma unroll
        for (int p = 0; p < BN / 64; ++p)
          hop::tma_load_2d(b + p * PANEL_BYTES, &b_map, n0 + 64 * p, k0, &full[s]);
      } else if constexpr (E == Epi::GEGLU) {
#pragma unroll
        for (int j = 0; j < BN / (2 * GATE_BLOCK); ++j)
          hop::tma_load_3d(b + j * 2 * GATE_BLOCK * ROW_BYTES, &b_map, k0,
                           n0 + j * GATE_BLOCK, 0, &full[s]);
      } else {
        hop::tma_load_2d(b, &b_map, k0, n0, &full[s]);
      }
    }
    return;
  }

  // ---- a consumer warpgroup: tile rows 64 * group .. + 63 ----
  hop::reg_alloc<CONSUMER_REGS>();
  const int warp = t >> 5, g = lane >> 2, q = lane & 3;
  const uint32_t a_rows = group * PANEL_BYTES;  // K-major: 64 rows; MN-major: one panel
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[i % STAGES]);
  };
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < n_k; ++i) {
    const int s = i % STAGES;
    hop::mbar_wait(&full[s], (i / STAGES) & 1);
    const uint32_t a = ring + s * STAGE_BYTES + a_rows, b = ring + s * STAGE_BYTES + A_BYTES;
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hop::wgmma_ss<BN, TA, TB>(acc, TA ? hop::mn_major<64>(a, kk) : hop::k_major<BK>(a, kk),
                                TB ? hop::mn_major<BN>(b, kk) : hop::k_major<BK>(b, kk), 1);
    hop::wgmma_commit();
    hop::wgmma_wait<1>();  // step i - 1's products are done with its stage
    if (i > 0) release(i - 1);
  }
  hop::wgmma_wait<0>();
  hop::pin<BN / 2>(acc);

  if constexpr (sizeof(OutT) == 4) {
    // fp32 sums as they lie in the accumulator: columns 8n + 2q, + 1 of
    // rows g and g + 8 of the warp's 16 (N even: a pair is in or out whole).
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + group * 64 + warp * 16 + g + 8 * i;
      if (row >= M) continue;
      OutT* out = C + (size_t)row * ldc;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const int col = n0 + 8 * n + 2 * q;
        if (col < N)
          *reinterpret_cast<float2*>(out + col) = make_float2(acc[4 * n + 2 * i],
                                                               acc[4 * n + 2 * i + 1]);
      }
    }
  } else {
    // Both consumers are past their last product, and every copy the producer
    // made was waited for: the ring is free. Stage this warpgroup's rows at
    // [64][OUT_N + 8] (row pitch 4 banks apart: no conflicts), then store 16
    // bytes at a time.
    hop::bar_sync(BAR_CONSUMERS, CONSUMERS * GROUP);
    constexpr int LD = staged_pitch<E>();
    bf16* staged = reinterpret_cast<bf16*>(smem) + group * 64 * LD;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bf16* row = staged + (warp * 16 + g + 8 * i) * LD + 2 * q;
      if constexpr (E == Epi::GEGLU) {
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {  // accumulator blocks 2j (inputs), 2j + 1 (gates)
          const float* in = acc + 8 * j + 2 * i;
          const float* gate = in + 4;
          __nv_bfloat162 v;
          v.x = geglu<bf16>(in[0], gate[0], act);
          v.y = geglu<bf16>(in[1], gate[1], act);
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = v;
        }
      } else {
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
              __floats2bfloat162_rn(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
      }
    }
    hop::bar_sync(bar_consumer(group), GROUP);
    constexpr int CHUNKS = OUT_N / 8;  // 16-byte chunks of a staged row
    for (int idx = t; idx < 64 * CHUNKS; idx += GROUP) {
      const int r = idx / CHUNKS, col = n0 + (idx % CHUNKS) * 8;
      const int row = m0 + group * 64 + r;
      if (row >= M || col >= N) continue;
      const bf16* src = staged + r * LD + (idx % CHUNKS) * 8;
      OutT* dst = C + (size_t)row * ldc + col;
      if (vec && col + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && col + e < N; ++e) dst[e] = src[e];
      }
    }
  }
}

// cuTensorMapEncodeTiled, a driver function, reached through the runtime so
// that the library needs no -lcuda link.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor of `rank` dims (innermost first; strides of the outer dims in
// bytes) cut into boxes, 128-byte swizzled as wgmma reads them; reads past
// the edges give zeros.
bool bf16_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The product on the caller's stream. chunk_rows 0: the whole depth in one
// chunk; else (TA only) a multiple of BK, the chunks' fp32 partial C's one
// after another (M * ldc elements apart).
template <bool TA, bool TB, Epi E, typename OutT>
int gemm_wgmma(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B, int ldb, OutT* C,
               int ldc, int M, int N, int K, cudaStream_t s, int act, int chunk_rows = 0) {
  using namespace wgm;
  if (chunk_rows <= 0) chunk_rows = K > 0 ? K : 1;
  // TMA boxes: 16-byte aligned bases and row strides (the wrappers refuse
  // anything else before here); fp32 out in pairs of columns.
  if (((!TA || !TB) && K % 8) || lda % 8 || ldb % 8 ||
      (chunk_rows < K && (!TA || chunk_rows % BK)) ||
      reinterpret_cast<uintptr_t>(A) % 16 || reinterpret_cast<uintptr_t>(B) % 16 ||
      (sizeof(OutT) == 4 && (N % 2 || ldc % 2 || reinterpret_cast<uintptr_t>(C) % 8)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap a_map, b_map;
  bool ok;
  if constexpr (TA) {
    const cuuint64_t dims[2] = {(cuuint64_t)M, (cuuint64_t)K}, strides[1] = {(cuuint64_t)lda * 2};
    const cuuint32_t box[2] = {64, BK};
    ok = bf16_map(&a_map, A, 2, dims, strides, box);
  } else {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M}, strides[1] = {(cuuint64_t)lda * 2};
    const cuuint32_t box[2] = {BK, BM};
    ok = bf16_map(&a_map, A, 2, dims, strides, box);
  }
  if constexpr (TB) {
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K}, strides[1] = {(cuuint64_t)ldb * 2};
    const cuuint32_t box[2] = {64, BK};
    ok = ok && bf16_map(&b_map, B, 2, dims, strides, box);
  } else if constexpr (E == Epi::GEGLU) {
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, 2};
    const cuuint64_t strides[2] = {(cuuint64_t)ldb * 2, (cuuint64_t)N * ldb * 2};
    const cuuint32_t box[3] = {BK, GATE_BLOCK, 2};
    ok = ok && bf16_map(&b_map, B, 3, dims, strides, box);
  } else {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N}, strides[1] = {(cuuint64_t)ldb * 2};
    const cuuint32_t box[2] = {BK, BN};
    ok = ok && bf16_map(&b_map, B, 2, dims, strides, box);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(gemm_wgmma_kernel<TA, TB, E, OutT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int vec = ldc % 8 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0;
  // Consecutive CTAs share their A rows: one row of tiles a wave or so.
  const dim3 grid((N + out_cols<E>() - 1) / out_cols<E>(), (M + BM - 1) / BM,
                  K > 0 ? (K + chunk_rows - 1) / chunk_rows : 1);
  gemm_wgmma_kernel<TA, TB, E, OutT><<<grid, THREADS, SMEM_BYTES, s>>>(
      a_map, b_map, C, ldc, M, N, K, chunk_rows, (size_t)M * ldc, act, vec);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gemm_engine
