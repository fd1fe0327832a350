// The bf16 products of the GEMM engine (gemm.cuh) on Hopper:
// C[m, n] = sum_k A(m, k) B(k, n), A(m, k) = A[m * lda + k] (K-major) or
// A[k * lda + m] (TA: MN-major), B(k, n) = B[n * ldb + k] (K-major: torch's
// [out, in] weight) or B[k * ldb + n] (TB: MN-major). Rows 2 and 4
// (ln_gemm.cu), row 6 (opt_geglu) and row 11's recomputed projection
// (epilogue GEGLU_GRAD) run the K-major x K-major product; the backward's
// dy = G . W an MN-major B (rows 11, 12 with the LN adjoint in its epilogue,
// LN_ADJOINT; row 13 and the split route STORE it in fp32); the weight
// gradients dW = G^T . X (rows 11, 12, 13) both operands MN-major.
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
// Measured slower on an H100 and left out (PERF.md): persistent CTAs for
// the short STORE and GEGLU epilogues (storing from registers, or through a
// staging buffer of their own, while the producer fills the next tile; the
// long GEGLU_GRAD and LN_ADJOINT epilogues are persistent); two-CTA clusters
// that multicast the shared B tile; and a producer warpgroup that normalizes
// the raw rows of x in each A tile, which would spare the normalize pass and
// its xn scratch.
//
// GEGLU and GEGLU_GRAD (K-major only): the B tile's 256 rows are the input
// rows of 128 output columns and their gate rows, interleaved in blocks of 8
// (n0 + 8j .. n0 + 8j + 7, then the same columns' gate rows I + n0 + 8j
// ...). wgmma's accumulator gives a thread the same two columns of every
// block of 8 (hopper.cuh), so the thread that holds an input's sum holds its
// gate's. GEGLU writes act(inp) * gate through the TPU kernel's rounding
// chain (geglu<OutT>). GEGLU_GRAD is the recomputed projection of the
// backward kernel 11: it writes the cotangents G = [gi | gg] of [inp | gate]
// (geglu_grad<T>) from the upstream cotangent g, so the projection itself
// never reaches device memory. Its chain (erf and exp a pair) is long beside
// the tile's products, so GEGLU_GRAD is persistent: a grid of resident CTAs,
// each running tiles b, b + gridDim.x, ..., the producer filling three
// stages of the next tile while the consumers run the chain; the epilogue
// is instantiated for each activation, so an unrolled tile holds one.
//
// The epilogue operand (GEGLU_GRAD: g's [128][128] tile; LN_ADJOINT: x's
// [128][256]) comes by TMA through the ring, as panels of [128 rows][64
// columns] (128-byte swizzled, two a stage) in the one or two stages after
// the last k-step's: the producer fills them once the consumers release
// them, during the last k-steps, so the epilogue rarely waits. The
// epilogues read and write them as plain shared-memory words (no volatile
// accesses, which would order every load after the one before).
//
// LN_ADJOINT (TB: dy = G . W, bf16 out): the LN adjoint of kernels 11 and
// 12 (ln_gemm_bwd.cu) applied to the fp32 dy tile in the registers that
// summed it, so dy never reaches device memory. A row's K columns lie in
// C = ceil(K / 256) CTAs (at most ADJ_MAX_CLUSTER, so K <= 2048), which must
// add their row sums before any can finish a row. The kernel is persistent:
// a cooperative grid of as many whole groups of C CTAs as the card holds at
// once (44 of 3 at K = 768 on 132 SMs), every CTA resident, each group
// running every 44th row tile, the producer filling the next tile's first
// k-steps while the consumers finish the last. Each CTA forms h = (x - mean)
// * rstd from the normalize pass's row statistics, sums dh = dy * s and
// dh * h over its 256 columns (a quad of threads a row), stores the 128
// pairs of sums in L2 ([row tile][rank][row]), fences, counts its arrival
// on the row tile's counter and waits until all C have; then it adds the C
// pairs of each row in rank order and writes dx = rstd * (dh - mean(dh) -
// h * mean(dh * h)), staged in x's place and stored 16 bytes at a time.
// dscale's partial sums of dy * h go down the tile's 128 rows (pairs of rows
// by a thread, four pairs of a warp by shuffles, the 16 slots in order
// through shared memory) into row `row tile` of [ceil(M / 128), K] fp32,
// which ln_adjoint.cuh's second pass adds in row order. Thread-block
// clusters exchanging through distributed shared memory were built first
// and measured slower on an H100 (PERF.md): the card holds 39 clusters of
// 3 at once (117 SMs), so 128 row tiles took four rounds where plain CTAs
// take three.
//
// Every sum is one wgmma chain in a fixed order over k (and chunks, row
// sums and column sums are added in a fixed order), so two launches on the
// same inputs give the same bits. The one atomic, LN_ADJOINT's arrival
// count, counts CTAs and adds no data.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda

#include "activation.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace gemm_engine {
namespace {

enum class Epi { STORE, GEGLU, GEGLU_GRAD, LN_ADJOINT };

// The epilogues whose B tile interleaves input and gate rows.
__host__ __device__ constexpr bool gated(Epi E) {
  return E == Epi::GEGLU || E == Epi::GEGLU_GRAD;
}

// The TPU kernel's GeGLU rounding chain (ops/geglu.py::_ln_geglu_kernel):
// round each half to the storage type, the activation in fp32 on the rounded
// input, round, then the product with the rounded gate.
template <typename OutT>
__device__ __forceinline__ OutT geglu(float inp, float gate, int act) {
  const float a = round_to<OutT>(activation(round_to<OutT>(inp), act));
  return from_f32<OutT>(a * round_to<OutT>(gate));
}

// The TPU kernel's GeGLU cotangents (ops/geglu.py::_ln_geglu_bwd_kernel):
// inp and gate rounded to the storage type, a = T(act(inp)), da = act'(inp)
// in fp32; (gi, gg) = (g * da * gate, g * a), the cotangents of inp and
// gate for the upstream cotangent g, which the caller rounds to T as it
// stores them.
template <typename T, int ACT>
__device__ __forceinline__ float2 geglu_grad(float inp_acc, float gate_acc, float g) {
  const float inp = round_to<T>(inp_acc), gate = round_to<T>(gate_acc);
  const float2 ad = activation_and_grad<ACT>(inp);
  const float a = round_to<T>(ad.x);
  return make_float2(g * ad.y * gate, g * a);
}

// The same for an activation code known only at run time (the FMA route).
template <typename T>
__device__ __forceinline__ float2 geglu_grad(float inp_acc, float gate_acc, float g, int act) {
  switch (act) {
    case ACT_GELU:
      return geglu_grad<T, ACT_GELU>(inp_acc, gate_acc, g);
    case ACT_GELU_TANH:
      return geglu_grad<T, ACT_GELU_TANH>(inp_acc, gate_acc, g);
    case ACT_RELU:
      return geglu_grad<T, ACT_RELU>(inp_acc, gate_acc, g);
    default:
      return geglu_grad<T, ACT_SILU>(inp_acc, gate_acc, g);
  }
}

namespace wgm {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int GROUP = 128, CONSUMERS = 2, THREADS = (CONSUMERS + 1) * GROUP;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ROW_BYTES = BK * 2;  // one swizzle panel row
constexpr int A_BYTES = BM * ROW_BYTES, B_BYTES = BN * ROW_BYTES;
constexpr int PANEL_BYTES = 64 * ROW_BYTES;  // 64 rows of a K-major tile, or an MN-major panel
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int GATE_BLOCK = 8;                // GEGLU: input rows, then as many gate rows
constexpr int BAR_CONSUMERS = 1;             // named barriers; 0 is __syncthreads
__device__ __forceinline__ int bar_consumer(int c) { return 2 + c; }
// The epilogue operand: panels of [BM rows][64 columns], two a ring stage.
constexpr int EPI_PANEL_BYTES = BM * ROW_BYTES, EPI_PANELS_A_STAGE = 2;
// LN_ADJOINT: the most CTAs a row's tiles take (so K <= 2048), and what a
// CTA keeps beside the ring: dscale's column sums over each warp's rows g and
// g + 4 (mod 8) in COLUMN_SLOTS rows of COLUMN_PITCH floats (the pad puts a
// warp's stores on different banks), then the CTA's columns of the scale
// [BN] bf16. The ring is left to the epilogue's x and the next tile's first
// k-steps.
constexpr int ADJ_MAX_CLUSTER = 8;
constexpr int COLUMN_SLOTS = CONSUMERS * 4 * 2, COLUMN_PITCH = BN + 8;
constexpr int ADJ_COLUMN_BYTES = COLUMN_SLOTS * COLUMN_PITCH * 4, ADJ_SCALE_BYTES = BN * 2;
constexpr int ADJ_EXTRA_BYTES = ADJ_COLUMN_BYTES + ADJ_SCALE_BYTES;
// Output columns a tile, the pitch of a consumer's staged rows (STORE,
// GEGLU), the epilogue operand's panels and the dynamic shared memory.
template <Epi E>
__host__ __device__ constexpr int out_cols() { return gated(E) ? BN / 2 : BN; }
template <Epi E>
__host__ __device__ constexpr int staged_pitch() { return out_cols<E>() + 8; }
template <Epi E>
__host__ __device__ constexpr int epi_panels() {
  return E == Epi::GEGLU_GRAD || E == Epi::LN_ADJOINT ? out_cols<E>() / 64 : 0;
}
// GEGLU_GRAD stages gg beside the ring: two panels of [BM][64] bf16.
constexpr int GG_BYTES = 2 * EPI_PANEL_BYTES;
template <Epi E>
__host__ __device__ constexpr int smem_bytes() {  // + the slack to a 1024-byte boundary
  return STAGES * STAGE_BYTES + 1024 +
         (E == Epi::LN_ADJOINT ? ADJ_EXTRA_BYTES : E == Epi::GEGLU_GRAD ? GG_BYTES : 0);
}
static_assert(CONSUMERS * 64 * staged_pitch<Epi::STORE>() * 2 <= STAGES * STAGE_BYTES,
              "the staged output fits in the freed ring");
static_assert(epi_panels<Epi::LN_ADJOINT>() <= 2 * EPI_PANELS_A_STAGE &&
                  EPI_PANELS_A_STAGE * EPI_PANEL_BYTES <= STAGE_BYTES && STAGES >= 4,
              "the epilogue operand takes two stages the last k-steps left free");
static_assert(CONSUMERS * GROUP == BN, "one consumer thread a column of dscale's partial row");
static_assert(smem_bytes<Epi::LN_ADJOINT>() <= 227 * 1024 &&
                  smem_bytes<Epi::GEGLU_GRAD>() <= 227 * 1024,
              "one persistent CTA an SM");
}  // namespace wgm

// The CTAs that hold an LN_ADJOINT row at width N: one a tile of BN columns.
__host__ __device__ constexpr int adjoint_cluster(int N) { return (N + wgm::BN - 1) / wgm::BN; }

// What an epilogue reads and writes beside C: nothing for STORE and GEGLU;
// GEGLU_GRAD the upstream cotangent g [M, N] (tile: boxes of 128 rows x 64);
// LN_ADJOINT x [M, N] alike, the scale [N], each row's (mean, rstd) from
// the normalize pass, dscale's partial rows [ceil(M / BM), N], the row
// tiles' row sums [ceil(M / BM)][C][BM] and their arrival counts
// [ceil(M / BM)] (zero at launch: the normalize pass clears them).
template <Epi E>
struct EpiOperands {};
template <>
struct EpiOperands<Epi::GEGLU_GRAD> {
  CUtensorMap tile;
};
template <>
struct EpiOperands<Epi::LN_ADJOINT> {
  CUtensorMap tile;
  const __nv_bfloat16* scale;
  const float2* stats;
  float* ds_partial;
  float2* exchange;
  int* arrivals;
};

// Byte offset, in a 128-byte swizzled panel, of 16-byte chunk c of row r.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return r * wgm::ROW_BYTES + ((c ^ (r & 7)) << 4);
}

// Panel p of the epilogue operand: stage base + p / 2 of the ring, as a byte
// offset from the ring's start. The epilogues read and write shared memory
// through plain pointers at such offsets, which the compiler may schedule
// (the barriers and waits around them are compiler barriers).
__device__ __forceinline__ uint32_t epi_panel(int base, int p) {
  using namespace wgm;
  return ((base + p / EPI_PANELS_A_STAGE) % STAGES) * STAGE_BYTES +
         (p % EPI_PANELS_A_STAGE) * EPI_PANEL_BYTES;
}

__device__ __forceinline__ uint32_t& word_at(unsigned char* smem, uint32_t offset) {
  return *reinterpret_cast<uint32_t*>(smem + offset);
}

// Two bf16 as fp32: the bits shifted into the high half.
__device__ __forceinline__ float2 bf16x2_to_f32(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// Two floats rounded to bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t f32_to_bf16x2(float lo, float hi) {
  uint32_t v;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(v) : "f"(hi), "f"(lo));
  return v;
}

// 16 staged bytes (eight bf16 of a row) to global memory: one store, or
// element stores for the first `valid` at a ragged edge.
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const unsigned char* src, bool whole,
                                       int valid) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  if (whole) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
    for (int i = 0; i < 8 && i < valid; ++i) dst[i] = e[i];
  }
}

// GEGLU_GRAD: G = [gi | gg] of the warpgroup's 64 rows from the projection's
// sums, for the activation ACT; g in the epilogue stage `base`. gi replaces g
// in its panels; gg is staged alike beside the ring (GG_BYTES), in the
// warpgroup's own rows.
template <int ACT>
__device__ __forceinline__ void geglu_grad_epilogue(const float (&acc)[wgm::BN / 2],
                                                    unsigned char* smem, int base, uint64_t* full,
                                                    __nv_bfloat16* C, int ldc, int M, int N,
                                                    int m0, int n0, int vec) {
  using namespace wgm;
  const int group = threadIdx.x / GROUP, t = threadIdx.x % GROUP, lane = t & 31;
  const int warp = t >> 5, g = lane >> 2, q = lane & 3;
  hop::mbar_wait(&full[base % STAGES], (base / STAGES) & 1);  // g's two panels
  hop::bar_sync(bar_consumer(group), GROUP);  // the last tile's gg rows are stored
  const uint32_t g_tile = epi_panel(base, 0), gg_tile = STAGES * STAGE_BYTES;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = group * 64 + warp * 16 + g + 8 * i;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {  // accumulator blocks 2j (inputs), 2j + 1 (gates)
      const uint32_t off = (j / 8) * EPI_PANEL_BYTES + swizzled(r, j % 8) + 4 * q;
      const float2 gv = bf16x2_to_f32(word_at(smem, g_tile + off));
      const float* in = acc + 8 * j + 2 * i;
      const float* gate = in + 4;
      const float2 c0 = geglu_grad<__nv_bfloat16, ACT>(in[0], gate[0], gv.x);  // (gi, gg)
      const float2 c1 = geglu_grad<__nv_bfloat16, ACT>(in[1], gate[1], gv.y);
      word_at(smem, g_tile + off) = f32_to_bf16x2(c0.x, c1.x);  // gi and gg, rounded
      word_at(smem, gg_tile + off) = f32_to_bf16x2(c0.y, c1.y);
    }
  }
  hop::bar_sync(bar_consumer(group), GROUP);
  constexpr int CHUNKS = BN / 16;  // 16-byte chunks of a row of 128 output columns
  for (int idx = t; idx < 2 * 64 * CHUNKS; idx += GROUP) {
    const int half = idx / (64 * CHUNKS), r = group * 64 + idx / CHUNKS % 64, c = idx % CHUNKS;
    const int row = m0 + r, col = n0 + 8 * c;
    if (row >= M || col >= N) continue;
    const uint32_t src =
        (half ? gg_tile : g_tile) + (c / 8) * EPI_PANEL_BYTES + swizzled(r, c % 8);
    store8(C + (size_t)row * ldc + half * N + col, smem + src, vec && col + 8 <= N, N - col);
  }
}

// LN_ADJOINT: dx of the warpgroup's 64 rows of row tile `rt` and the CTA's
// partial row of dscale, from the fp32 dy tile in acc; x in the epilogue
// stages from `base` (see the head of this file). The CTA is rank `rank` of
// the `cluster` CTAs that hold the row tile's columns.
__device__ __forceinline__ void ln_adjoint_epilogue(const float (&acc)[wgm::BN / 2],
                                                    const EpiOperands<Epi::LN_ADJOINT>& epi,
                                                    unsigned char* smem, int base, uint64_t* full,
                                                    __nv_bfloat16* C, int ldc, int M, int N,
                                                    int rt, int cluster, int rank) {
  using namespace wgm;
  const int group = threadIdx.x / GROUP, t = threadIdx.x % GROUP, lane = t & 31;
  const int warp = t >> 5, g = lane >> 2, q = lane & 3;
  const int m0 = rt * BM, n0 = rank * BN;
  unsigned char* columns = smem + STAGES * STAGE_BYTES;  // [COLUMN_SLOTS][COLUMN_PITCH] fp32
  const uint32_t scales = STAGES * STAGE_BYTES + ADJ_COLUMN_BYTES;  // [BN] bf16
  int r[2];
  float mean[2], rstd[2], s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r[i] = group * 64 + warp * 16 + g + 8 * i;
    const float2 st = m0 + r[i] < M ? epi.stats[m0 + r[i]] : make_float2(0.f, 0.f);
    mean[i] = st.x;
    rstd[i] = st.y;
  }
  // Both warpgroups are past the last tile's reads of the column sums.
  hop::bar_sync(BAR_CONSUMERS, CONSUMERS * GROUP);
  hop::mbar_wait(&full[base % STAGES], (base / STAGES) & 1);  // x's four panels
  hop::mbar_wait(&full[(base + 1) % STAGES], ((base + 1) / STAGES) & 1);
  // Columns 8n + 2q, + 1 of the tile: the row sums of dh = dy * s and dh * h,
  // and dscale's column sums of dy * h over the thread's two rows, added over
  // rows g, g + 4 of the warp's eight and stored by lanes g = 0, 4 into slot
  // (group * 4 + warp) * 2 + g / 4, in row order.
  float* column = reinterpret_cast<float*>(columns) +
                  ((group * 4 + warp) * 2 + (g >> 2)) * COLUMN_PITCH;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const int c = 8 * n + 2 * q;
    const float2 sc = bf16x2_to_f32(word_at(smem, scales + 2 * c));
    const uint32_t panel = epi_panel(base, n / 8);
    float h[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 xv = bf16x2_to_f32(word_at(smem, panel + swizzled(r[i], n % 8) + 4 * q));
      h[i][0] = (xv.x - mean[i]) * rstd[i];
      h[i][1] = (xv.y - mean[i]) * rstd[i];
      const float d0 = acc[4 * n + 2 * i] * sc.x, d1 = acc[4 * n + 2 * i + 1] * sc.y;
      s1[i] += d0;
      s2[i] += d0 * h[i][0];
      s1[i] += d1;
      s2[i] += d1 * h[i][1];
    }
    float v0 = acc[4 * n] * h[0][0] + acc[4 * n + 2] * h[1][0];
    float v1 = acc[4 * n + 1] * h[0][1] + acc[4 * n + 3] * h[1][1];
    v0 += __shfl_xor_sync(0xffffffffu, v0, 4);
    v1 += __shfl_xor_sync(0xffffffffu, v1, 4);
    v0 += __shfl_xor_sync(0xffffffffu, v0, 8);
    v1 += __shfl_xor_sync(0xffffffffu, v1, 8);
    if ((g & 3) == 0) *reinterpret_cast<float2*>(column + c) = make_float2(v0, v1);
  }
  // A row's sums over the quad that holds it, then the row tile's exchange:
  // lane 0 of the quad stores them at [rt][rank][row] (L2), every writer
  // fences, and once both warpgroups have, thread 0 adds the CTA's arrival
  // and waits for the other ranks'. Then each row's totals are added in rank
  // order.
  float2* tile_sums = epi.exchange + (size_t)rt * cluster * BM;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], m);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], m);
    }
    if (q == 0) tile_sums[rank * BM + r[i]] = make_float2(s1[i], s2[i]);
  }
  __threadfence();
  hop::bar_sync(BAR_CONSUMERS, CONSUMERS * GROUP);  // both warpgroups' sums and columns
  if (threadIdx.x == 0) {
    atomicAdd(&epi.arrivals[rt], 1);
    for (uint32_t tries = 0; hop::load_acquire(&epi.arrivals[rt]) < cluster; ++tries) {
      if (tries > (1u << 24)) __trap();  // a rank that never comes: a protocol fault
      __nanosleep(32);
    }
    __threadfence();
  }
  hop::bar_sync(BAR_CONSUMERS, CONSUMERS * GROUP);
  float m1[2], m2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float2 total = __ldcg(&tile_sums[r[i]]);
    for (int p = 1; p < cluster; ++p) {
      const float2 v = __ldcg(&tile_sums[p * BM + r[i]]);
      total.x += v.x;
      total.y += v.y;
    }
    m1[i] = total.x / (float)N;
    m2[i] = total.y / (float)N;
  }
  {  // dscale's partial row: column t of the tile, its slots in row order
    const int col = group * GROUP + t;
    const float* sums = reinterpret_cast<const float*>(columns) + col;
    float total = sums[0];
#pragma unroll
    for (int slot = 1; slot < COLUMN_SLOTS; ++slot) total += sums[slot * COLUMN_PITCH];
    if (n0 + col < N) epi.ds_partial[(size_t)rt * N + n0 + col] = total;
  }
  // dx = rstd * (dh - m1 - h * m2), rounded, in x's place.
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const int c = 8 * n + 2 * q;
    const float2 sc = bf16x2_to_f32(word_at(smem, scales + 2 * c));
    const uint32_t panel = epi_panel(base, n / 8);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t& at = word_at(smem, panel + swizzled(r[i], n % 8) + 4 * q);
      const float2 xv = bf16x2_to_f32(at);
      const float h0 = (xv.x - mean[i]) * rstd[i], h1 = (xv.y - mean[i]) * rstd[i];
      const float d0 = acc[4 * n + 2 * i] * sc.x, d1 = acc[4 * n + 2 * i + 1] * sc.y;
      at = f32_to_bf16x2(rstd[i] * (d0 - m1[i] - h0 * m2[i]),
                         rstd[i] * (d1 - m1[i] - h1 * m2[i]));
    }
  }
  hop::bar_sync(bar_consumer(group), GROUP);
  constexpr int CHUNKS = BN / 8;
  for (int idx = t; idx < 64 * CHUNKS; idx += GROUP) {
    const int rr = group * 64 + idx / CHUNKS, c = idx % CHUNKS;
    const int row = m0 + rr, col = n0 + 8 * c;
    if (row >= M || col >= N) continue;
    store8(C + (size_t)row * ldc + col, smem + epi_panel(base, c / 8) + swizzled(rr, c % 8),
           col + 8 <= N, N - col);
  }
}

// a_map: A [M, K] in boxes of 128 rows x 64, or (TA) A^T [K, M] in boxes of
// 64 k-rows x 64 columns; b_map: B [N, K] in boxes of 256 rows x 64 (STORE),
// Wi as [2][N][K] in boxes of 2 x 8 rows x 64 (GEGLU, GEGLU_GRAD), or (TB,
// and so LN_ADJOINT) B^T [K, N] in boxes of 64 k-rows x 64 columns. TA:
// grid z is the depth's chunk, k in [z * chunk_rows, min(K, (z + 1) *
// chunk_rows)), written to C + z * c_chunk. vec: bf16 C's rows may take
// 16-byte stores (C 16-byte aligned, ldc % 8 == 0; GEGLU_GRAD also N % 8 ==
// 0). LN_ADJOINT is persistent, on a cooperative grid (adjoint_groups).
template <bool TA, bool TB, Epi E, typename OutT>
__global__ void __launch_bounds__(wgm::THREADS, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap b_map, OutT* __restrict__ C, int ldc,
                      int M, int N, int K, int chunk_rows, size_t c_chunk, int act, int vec,
                      const __grid_constant__ EpiOperands<E> epi) {
  using namespace wgm;
  using bf16 = __nv_bfloat16;
  static_assert(!gated(E) || (!TA && !TB), "GEGLU reads Wi in torch's [out, in] layout");
  static_assert(E != Epi::LN_ADJOINT || (!TA && TB), "the LN adjoint follows dy = G . W");
  static_assert(sizeof(OutT) == 2 || E == Epi::STORE, "GEGLU, its cotangents and dx are bf16");
  constexpr int OUT_N = out_cols<E>();
  constexpr int EPI_STAGES = epi_panels<E>() / EPI_PANELS_A_STAGE;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = hop::smem_u32(smem);
  const int tid = threadIdx.x, group = tid / GROUP, t = tid % GROUP, lane = t & 31;
  // The tiles a CTA runs, jobs 0, 1, ...: tile(job, &rt, &n0) gives the row
  // tile and first column of one, false past the last. STORE and GEGLU run
  // one, the CTA's grid index. GEGLU_GRAD and LN_ADJOINT are persistent, on
  // a grid of resident CTAs: GEGLU_GRAD's CTA b runs tiles b, b + gridDim.x,
  // ... in row-major order; LN_ADJOINT's CTA b is rank b % C of the C =
  // adjoint_cluster(N) CTAs that hold a row tile's columns, and its group
  // b / C runs every (gridDim.x / C)-th row tile.
  const int row_tiles = (M + BM - 1) / BM, col_tiles = (N + OUT_N - 1) / OUT_N;
  int cluster = 1, rank = 0;
  if constexpr (E == Epi::LN_ADJOINT) {
    cluster = adjoint_cluster(N);
    rank = blockIdx.x % cluster;
  }
  auto tile = [&](int job, int* rt, int* n0) {
    if constexpr (E == Epi::LN_ADJOINT) {
      *rt = blockIdx.x / cluster + job * (gridDim.x / cluster);
      *n0 = rank * BN;
      return *rt < row_tiles;
    } else if constexpr (E == Epi::GEGLU_GRAD) {
      const int flat = blockIdx.x + job * gridDim.x;
      *rt = flat / col_tiles;
      *n0 = flat % col_tiles * OUT_N;
      return flat < row_tiles * col_tiles;
    } else {
      *rt = blockIdx.y;
      *n0 = blockIdx.x * OUT_N;
      return job == 0;
    }
  };
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

  // The ring's iterations run on across a persistent CTA's tiles: a tile takes
  // n_k k-steps, then EPI_STAGES stages of the epilogue operand.
  if (group == CONSUMERS) {  // ---- the producer: one thread issues every copy ----
    hop::reg_dealloc<PRODUCER_REGS>();
    if (t != 0) return;
    int it = 0, rt, n0;
    for (int job = 0; tile(job, &rt, &n0); ++job) {
      const int m0 = rt * BM;
      for (int i = 0; i < n_k; ++i, ++it) {
        const int s = it % STAGES, k0 = (kt0 + i) * BK;
        hop::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
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
        } else if constexpr (gated(E)) {
#pragma unroll
          for (int j = 0; j < BN / (2 * GATE_BLOCK); ++j)
            hop::tma_load_3d(b + j * 2 * GATE_BLOCK * ROW_BYTES, &b_map, k0,
                             n0 + j * GATE_BLOCK, 0, &full[s]);
        } else {
          hop::tma_load_2d(b, &b_map, k0, n0, &full[s]);
        }
      }
      // The epilogue operand, into stages as the consumers release them: the
      // k-steps' before the last (which stays with the consumers until their
      // products are done).
      if constexpr (EPI_STAGES > 0) {
        for (int e = 0; e < EPI_STAGES; ++e, ++it) {
          const int s = it % STAGES;
          hop::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          hop::mbar_arrive_expect_tx(&full[s], EPI_PANELS_A_STAGE * EPI_PANEL_BYTES);
#pragma unroll
          for (int p = 0; p < EPI_PANELS_A_STAGE; ++p)
            hop::tma_load_2d(ring + s * STAGE_BYTES + p * EPI_PANEL_BYTES, &epi.tile,
                             n0 + 64 * (EPI_PANELS_A_STAGE * e + p), m0, &full[s]);
        }
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
  if constexpr (E == Epi::LN_ADJOINT) {  // the CTA's columns of the scale, for all its tiles
    const int col = group * GROUP + t;
    reinterpret_cast<bf16*>(smem + STAGES * STAGE_BYTES + ADJ_COLUMN_BYTES)[col] =
        rank * BN + col < N ? epi.scale[rank * BN + col] : __float2bfloat16(0.f);
  }
  int it = 0, rt, n0;
  for (int job = 0; tile(job, &rt, &n0); ++job, it += n_k + EPI_STAGES) {
    const int m0 = rt * BM;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < n_k; ++i) {
      const int s = (it + i) % STAGES;
      hop::mbar_wait(&full[s], ((it + i) / STAGES) & 1);
      const uint32_t a = ring + s * STAGE_BYTES + a_rows, b = ring + s * STAGE_BYTES + A_BYTES;
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hop::wgmma_ss<BN, TA, TB>(acc, TA ? hop::mn_major<64>(a, kk) : hop::k_major<BK>(a, kk),
                                  TB ? hop::mn_major<BN>(b, kk) : hop::k_major<BK>(b, kk), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();  // step i - 1's products are done with its stage
      if (i > 0) release(it + i - 1);
    }
    hop::wgmma_wait<0>();
    hop::pin<BN / 2>(acc);
    const int base = it + n_k;  // the epilogue operand's first stage

    if constexpr (E == Epi::GEGLU_GRAD || E == Epi::LN_ADJOINT)
      release(base - 1);  // the last k-step's stage: the producer may fill it for the next tile
    if constexpr (E == Epi::GEGLU_GRAD) {
      switch (act) {  // one activation an unrolled epilogue
        case ACT_GELU:
          geglu_grad_epilogue<ACT_GELU>(acc, smem, base, full, C, ldc, M, N, m0, n0, vec);
          break;
        case ACT_GELU_TANH:
          geglu_grad_epilogue<ACT_GELU_TANH>(acc, smem, base, full, C, ldc, M, N, m0, n0, vec);
          break;
        case ACT_RELU:
          geglu_grad_epilogue<ACT_RELU>(acc, smem, base, full, C, ldc, M, N, m0, n0, vec);
          break;
        default:
          geglu_grad_epilogue<ACT_SILU>(acc, smem, base, full, C, ldc, M, N, m0, n0, vec);
      }
      release(base);  // g's stage, read
    } else if constexpr (E == Epi::LN_ADJOINT) {
      ln_adjoint_epilogue(acc, epi, smem, base, full, C, ldc, M, N, rt, cluster, rank);
      for (int e = 0; e < EPI_STAGES; ++e) release(base + e);  // x's stages, read
    } else if constexpr (sizeof(OutT) == 4) {
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
      // Both consumers are past their last product, and every copy the
      // producer made was waited for: the ring is free. Stage this warpgroup's
      // rows at [64][OUT_N + 8] (row pitch 4 banks apart: no conflicts), then
      // store 16 bytes at a time.
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

// A row-major bf16 [rows, cols] tensor (row pitch ld) in boxes of BM rows x
// 64 columns: a K-major A operand, and the epilogue operand's panels.
bool row_tiles_map(CUtensorMap* map, const void* base, int rows, int cols, int ld) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {wgm::BK, wgm::BM};
  return bf16_map(map, base, 2, dims, strides, box);
}

// The epilogue's own operands, as the launcher takes them (pointers only).
// (in the storage type: fp32 reads g on FMA).
struct EpiInputs {
  const void* tile = nullptr;  // g (GEGLU_GRAD) or x (LN_ADJOINT): [M, N], contiguous
  const void* scale = nullptr;
  const float2* stats = nullptr;
  float* ds_partial = nullptr;
  float2* exchange = nullptr;
  int* arrivals = nullptr;
};

// The CTAs of a persistent instance the current card holds at once (one an
// SM): its grid, so that every CTA is resident. 0 if none.
template <bool TB, Epi E>
int resident_ctas() {
  using namespace wgm;
  static int known[64] = {};  // by card
  int card = 0;
  if (cudaGetDevice(&card) != cudaSuccess || card >= 64) return 0;
  if (known[card] == 0) {
    auto kernel = gemm_wgmma_kernel<false, TB, E, __nv_bfloat16>;
    int per_sm = 0, sms = 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<E>()) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                      smem_bytes<E>()) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, card) != cudaSuccess)
      return 0;
    known[card] = per_sm * sms;
  }
  return known[card];
}

// The groups of C CTAs (one a row tile's columns) a persistent LN_ADJOINT
// launch takes on the current card: as many as it holds at once.
int adjoint_groups(int C) {
  return C < 1 || C > wgm::ADJ_MAX_CLUSTER ? 0 : resident_ctas<true, Epi::LN_ADJOINT>() / C;
}

// The product on the caller's stream. chunk_rows 0: the whole depth in one
// chunk; else (TA only) a multiple of BK, the chunks' fp32 partial C's one
// after another (M * ldc elements apart).
template <bool TA, bool TB, Epi E, typename OutT>
int gemm_wgmma(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B, int ldb, OutT* C,
               int ldc, int M, int N, int K, cudaStream_t s, int act, int chunk_rows = 0,
               const EpiInputs& in = {}) {
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
    ok = row_tiles_map(&a_map, A, M, K, lda);
  }
  if constexpr (TB) {
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K}, strides[1] = {(cuuint64_t)ldb * 2};
    const cuuint32_t box[2] = {64, BK};
    ok = ok && bf16_map(&b_map, B, 2, dims, strides, box);
  } else if constexpr (gated(E)) {
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, 2};
    const cuuint64_t strides[2] = {(cuuint64_t)ldb * 2, (cuuint64_t)N * ldb * 2};
    const cuuint32_t box[3] = {BK, GATE_BLOCK, 2};
    ok = ok && bf16_map(&b_map, B, 3, dims, strides, box);
  } else {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N}, strides[1] = {(cuuint64_t)ldb * 2};
    const cuuint32_t box[2] = {BK, BN};
    ok = ok && bf16_map(&b_map, B, 2, dims, strides, box);
  }
  EpiOperands<E> epi;
  if constexpr (epi_panels<E>() > 0) {
    ok = ok && in.tile != nullptr && N % 8 == 0 &&
         reinterpret_cast<uintptr_t>(in.tile) % 16 == 0 &&
         row_tiles_map(&epi.tile, in.tile, M, N, N);
  }
  int groups = 0;  // LN_ADJOINT
  if constexpr (E == Epi::LN_ADJOINT) {
    const int row_tiles = (M + BM - 1) / BM, resident = adjoint_groups(adjoint_cluster(N));
    groups = row_tiles < resident ? row_tiles : resident;
    ok = ok && in.scale != nullptr && in.stats != nullptr && in.ds_partial != nullptr &&
         in.exchange != nullptr && in.arrivals != nullptr && groups > 0 &&
         reinterpret_cast<uintptr_t>(C) % 16 == 0 && ldc % 8 == 0 &&
         adjoint_cluster(N) <= ADJ_MAX_CLUSTER;
    epi.scale = static_cast<const __nv_bfloat16*>(in.scale);
    epi.stats = in.stats;
    epi.ds_partial = in.ds_partial;
    epi.exchange = in.exchange;
    epi.arrivals = in.arrivals;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kernel = gemm_wgmma_kernel<TA, TB, E, OutT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<E>());
  if (err != cudaSuccess) return (int)err;
  const int vec = ldc % 8 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0 &&
                  (E != Epi::GEGLU_GRAD || N % 8 == 0);
  // Consecutive CTAs share their A rows: one row of tiles a wave or so.
  const dim3 grid((N + out_cols<E>() - 1) / out_cols<E>(), (M + BM - 1) / BM,
                  K > 0 ? (K + chunk_rows - 1) / chunk_rows : 1);
  if constexpr (E == Epi::GEGLU_GRAD) {  // persistent: a grid of resident CTAs
    const int tiles = grid.x * grid.y, resident = resident_ctas<false, E>();
    if (resident <= 0) return (int)cudaErrorInvalidValue;
    gemm_wgmma_kernel<TA, TB, E, OutT><<<tiles < resident ? tiles : resident, THREADS,
                                         smem_bytes<E>(), s>>>(a_map, b_map, C, ldc, M, N, K,
                                                               chunk_rows, (size_t)M * ldc, act,
                                                               vec, epi);
  } else if constexpr (E == Epi::LN_ADJOINT) {  // persistent: a cooperative grid of resident CTAs
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(groups * adjoint_cluster(N));
    config.blockDim = dim3(THREADS);
    config.dynamicSmemBytes = smem_bytes<E>();
    config.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    const cudaError_t launched =
        cudaLaunchKernelEx(&config, gemm_wgmma_kernel<TA, TB, E, OutT>, a_map, b_map, C, ldc, M, N,
                           K, chunk_rows, (size_t)M * ldc, act, vec, epi);
    if (launched != cudaSuccess) return (int)launched;
  } else {
    gemm_wgmma_kernel<TA, TB, E, OutT><<<grid, THREADS, smem_bytes<E>(), s>>>(
        a_map, b_map, C, ldc, M, N, K, chunk_rows, (size_t)M * ldc, act, vec, epi);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gemm_engine
