// Building blocks of the whole-MLP kernels, forward (mlp_tail.cu) and
// backward (mlp_tail_bwd.cu).
//
// bf16 runs on wgmma fed by TMA from one producer thread, as the GEMM engine
// (gemm_wgmma.cuh) does, a producer warpgroup beside consumer warpgroups of
// 64 rows each. ptxas gives a warp of a CTA of three warpgroups 168
// registers, also after setmaxnreg (attention_wgmma.cuh), so a consumer
// holds at most ~130 fp32 sums beside its addressing; that, not shared
// memory, shapes both designs (their constants: wgf:: and wgb::). Both read
// their row operands from L2 again for each tile of output columns, so a
// taller or wider tile reads fewer bytes for the same products.
//   - Forward (kernel 8): a cluster of C = ceil(K / 128) CTAs shares a tile
//     of 128 rows; CTA j owns output columns 128 j .. 128 j + 127 (64 sums a
//     consumer thread). The cluster walks I in chunks of 64 C columns: each
//     CTA forms inp and gate of its 64 columns of the chunk over the K loop
//     (the engine's GEGLU interleave, 64 sums), applies the rounding chain,
//     writes its h panel [128][64] into its own shared memory, from where the
//     bulk-copy engine copies it into every peer's (distributed shared
//     memory), then adds the whole chunk's h . Wo[its columns, chunk]^T to
//     its output, h read from shared memory into registers as wgmma's A. So
//     the cluster reads Wi and Wo once a tile, and h never reaches device
//     memory.
//   - Backward row pass (kernel 13): one CTA a tile of 192 rows x 64 columns
//     of I (three consumer warpgroups; a CTA of four warpgroups gives a
//     thread 128 registers) runs [inp | gate] = xn . Wi^T (64 sums) and dh =
//     g . Wo (an MN-major Wo, 32 sums) through one ring and applies the chain
//     in its epilogue; inp, gate and dh never reach device memory.
// fp32: FMA, 16 rows and 256 threads a CTA, a thread holds one row x JN
// columns (true fp32, no TF32), slabs staged with plain loads between two
// barriers: the card's fp32 parity path.
#pragma once

#include "gemm.cuh"

namespace mlp_tail {

using bf16 = __nv_bfloat16;

// Internal linkage, as in gemm.cuh: mlp_tail.cu and mlp_tail_bwd.cu reopen
// these namespaces for their kernels.
namespace {

constexpr int THREADS = 256;
constexpr int CH = 64;  // fp32: columns of I a chunk

// ---- bf16 -----------------------------------------------------------------------

constexpr int GROUP = 128, CONSUMERS = 2, WG_THREADS = (CONSUMERS + 1) * GROUP;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ROWS = 128, BK = 64;       // rows a tile, depth a k-step
constexpr int ROW_BYTES = BK * 2;        // one 128-byte swizzle panel row
constexpr int PANEL_BYTES = ROWS * ROW_BYTES;  // [128][64] bf16, 16 KB
constexpr int GATE_BLOCK = gemm_engine::wgm::GATE_BLOCK;
constexpr int SMEM_LIMIT = 232448;       // bytes a CTA may ask for
constexpr int BAR_CONSUMERS = 1;         // named barriers; 0 is __syncthreads
__device__ __forceinline__ int bar_consumer(int c) { return 2 + c; }

// The forward's cluster kernel.
namespace wgf {
constexpr int OUT_COLS = 128;  // output columns a CTA
constexpr int SHARE = 64;      // columns of h a CTA forms a chunk: one panel
constexpr int MAX_CLUSTER = 8;  // K <= 1024
constexpr int MAX_STAGES = 4;
// A ring stage holds a k-step's xn [128][64] and the Wi rows of the CTA's
// share (SHARE / 8 blocks of 8 input rows, each followed by the same
// columns' 8 gate rows), or one panel of Wo [128 output columns][64 columns
// of the chunk] (half the stage).
constexpr int STAGE_BYTES = 2 * PANEL_BYTES;
constexpr int STAGED_PITCH = OUT_COLS + 8;  // the epilogue's staged rows
__host__ __device__ constexpr int cluster(int K) { return (K + OUT_COLS - 1) / OUT_COLS; }
// The ring's stages beside C panels of h, the barriers and the 1024-byte slack.
__host__ __device__ constexpr int stages(int C) {
  return (SMEM_LIMIT - 1024 - 256 - C * PANEL_BYTES) / STAGE_BYTES < MAX_STAGES
             ? (SMEM_LIMIT - 1024 - 256 - C * PANEL_BYTES) / STAGE_BYTES
             : MAX_STAGES;
}
__host__ __device__ constexpr int smem_bytes(int C) {
  return stages(C) * STAGE_BYTES + C * PANEL_BYTES + 1024;
}
static_assert(stages(MAX_CLUSTER) >= 2, "a ring of two stages beside the widest h");
static_assert(CONSUMERS * 64 * STAGED_PITCH * 2 <= 2 * STAGE_BYTES, "the staged output fits");
}  // namespace wgf

// The backward's row pass: WGS consumer warpgroups of 64 rows each. Its
// 96 sums a thread fit the 128 registers a thread of a CTA of four
// warpgroups gets, and a taller tile reads the weights' columns for more
// rows: per row and column of I, a tile reads (2 / NI + 3 / TILE_M) of xn's,
// g's and the weights' bytes.
namespace wgb {
constexpr int NI = 64;  // columns of I a tile
constexpr int WGS = 3, TILE_M = 64 * WGS, CTA_THREADS = (WGS + 1) * GROUP;
constexpr int REGS_PRODUCER = 40, REGS_CONSUMER = 152;
static_assert(REGS_PRODUCER + WGS * REGS_CONSUMER <= 65536 / GROUP, "registers after setmaxnreg");
constexpr int STAGES = 3;
// A stage: xn [TILE_M][64], Wi [2 NI][64] (interleaved), g [TILE_M][64],
// Wo [64 k][NI].
constexpr int X_BYTES = TILE_M * ROW_BYTES, WI_BYTES = 2 * NI * ROW_BYTES, WO_BYTES = BK * NI * 2;
constexpr int STAGE_BYTES = 2 * X_BYTES + WI_BYTES + WO_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
constexpr int STAGED_PITCH = NI + 8;  // h, gi, gg rows staged for 16-byte stores
static_assert(SMEM_BYTES + 256 <= SMEM_LIMIT, "the ring fits");
static_assert(WGS * 3 * 64 * STAGED_PITCH * 2 <= STAGES * STAGE_BYTES,
              "the staged outputs fit in the freed ring");
}  // namespace wgb

// The Wi rows of an fp32 chunk's narrow products as one [2 * CH] slab: the
// chunk's CH input rows, then its CH gate rows.
__device__ __forceinline__ long long wi_chunk_row(int r, int i0, int I) {
  const int col = i0 + (r < CH ? r : r - CH);
  if (col >= I) return -1;
  return r < CH ? col : I + col;
}

// ---- fp32 -----------------------------------------------------------------------

namespace simt {
constexpr int BM = 16;   // rows a CTA: thread (ty, tx) = (tid / 16, tid % 16) holds row ty
constexpr int KS = 32;   // contraction slab of the chunk's narrow products
constexpr int LDB = 2 * CH + 1, LDC = CH + 1;
}  // namespace simt

// tile[kk][c] = src[row_of(c) * src_ld + k0 + kk] for c < cols, kk < ks: a
// slab whose source rows are output columns, transposed so the contraction
// runs down the tile. Zeros for a negative row or k0 + kk >= k_limit.
template <typename RowFn>
__device__ __forceinline__ void stage_t(float* tile, int ld, int cols, int ks, const float* src,
                                        long long src_ld, RowFn row_of, int k0, int k_limit) {
  for (int idx = threadIdx.x; idx < cols * ks; idx += THREADS) {
    const int c = idx / ks, kk = idx % ks;
    const long long row = row_of(c);
    tile[kk * ld + c] =
        row >= 0 && k0 + kk < k_limit ? src[row * src_ld + k0 + kk] : 0.f;
  }
}

// tile[kk][c] = src[row_of(kk) * src_ld + c0 + c] for kk < ks, c < cols: a
// slab whose source rows run along the contraction. Zeros for a negative row
// or c0 + c >= c_limit.
template <typename RowFn>
__device__ __forceinline__ void stage_n(float* tile, int ld, int cols, int ks, const float* src,
                                        long long src_ld, RowFn row_of, int c0, int c_limit) {
  for (int idx = threadIdx.x; idx < cols * ks; idx += THREADS) {
    const int kk = idx / cols, c = idx % cols;
    const long long row = row_of(kk);
    tile[kk * ld + c] = row >= 0 && c0 + c < c_limit ? src[row * src_ld + c0 + c] : 0.f;
  }
}

// acc[j] += sum over kk < ks of a[kk] * b[kk * ldb + 16 * j], j < J: one
// thread's row of A against the columns tx + 16 j of a slab (b points at
// column tx).
template <int J>
__device__ __forceinline__ void fma_row(float* acc, const float* a, const float* b, int ldb,
                                        int ks) {
  for (int kk = 0; kk < ks; ++kk) {
    const float av = a[kk];
#pragma unroll
    for (int j = 0; j < J; ++j) acc[j] = fmaf(av, b[kk * ldb + 16 * j], acc[j]);
  }
}

}  // namespace
}  // namespace mlp_tail
