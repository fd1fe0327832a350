// Building blocks of the whole-MLP kernels, forward (mlp_tail.cu) and
// backward (mlp_tail_bwd.cu): a CTA owns a tile of rows, keeps their
// normalized x (and in the backward their cotangent g) in shared memory, and
// walks the intermediate dim I in chunks of CH columns. For each chunk it
// forms inp and gate (and dh) of its rows from slabs of Wi (and Wo) staged in
// shared memory, applies the GeGLU chain into shared memory, and adds the
// chunk's share of a [rows, K] product to accumulators in registers that the
// CTA's warps (threads, in fp32) split by columns. So no [M, I] operand of a
// product is read from device memory.
//
// bf16: mma.sync m16n8k16 with fp32 accumulation, 32 rows and 8 warps a CTA;
// a warp holds 32 rows x 8*NT output columns (NT = 12 at K = 768: 96
// registers a thread). fp32: FMA, 16 rows and 256 threads a CTA, a thread
// holds one row x JN columns (true fp32, no TF32). Slabs are staged with
// plain 16-byte loads between two barriers: simple and right first; a
// cp.async ring, wgmma and TMA are later work.
#pragma once

#include "gemm.cuh"

namespace mlp_tail {

using bf16 = __nv_bfloat16;

// Internal linkage, as in gemm.cuh: mlp_tail.cu and mlp_tail_bwd.cu reopen
// these namespaces for their kernels.
namespace {

constexpr int THREADS = 256, WARPS = 8;
constexpr int CH = 64;  // columns of I a chunk

// ---- bf16 -----------------------------------------------------------------------

namespace tc {
constexpr int BM = 32;        // rows a CTA
constexpr int KS = 64;        // contraction slab of the chunk's narrow products
constexpr int LDS = KS + 8;   // row stride of [.][KS] slabs and of [.][CH] tiles
static_assert(CH == KS, "the chunk tiles share the slab stride");
}  // namespace tc

// rows x cols (cols % 8 == 0) from src into tile, 16 bytes a copy: tile row r
// is src row row_of(r) (negative: zeros), columns col0 .. col0 + cols - 1,
// zeros from col_limit (a multiple of 8) on.
template <typename RowFn>
__device__ __forceinline__ void stage(bf16* tile, int ld, int rows, int cols, const bf16* src,
                                      long long src_ld, RowFn row_of, int col0, int col_limit) {
  const int per_row = cols / 8;
  for (int c = threadIdx.x; c < rows * per_row; c += THREADS) {
    const int r = c / per_row, cc = (c % per_row) * 8;
    const long long row = row_of(r);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row >= 0 && col0 + cc < col_limit)
      v = *reinterpret_cast<const uint4*>(src + row * src_ld + col0 + cc);
    *reinterpret_cast<uint4*>(tile + r * ld + cc) = v;
  }
}

// One warp: acc[mt * 2 * PAIRS + nt][4] += A . B over `ksteps` steps of 16 of
// the contraction, for MT m-tiles of 16 rows and 2 * PAIRS n-tiles of 8
// columns. `a` points at (the first row, the first contraction column) of A,
// rows contiguous along the contraction. B_TRANS false: `b` points at (the
// first output column's row, the first contraction column) of a tile whose
// rows are output columns; true: at (the first contraction row, the first
// output column) of a tile whose rows run along the contraction. Element e of
// an accumulator is row mt * 16 + lane / 4 + 8 * (e / 2), column nt * 8 +
// 2 * (lane % 4) + e % 2. The lane addressing is gemm.cuh's.
template <int MT, int PAIRS, bool B_TRANS>
__device__ __forceinline__ void warp_mma(float (*acc)[4], const bf16* a, int lda, const bf16* b,
                                         int ldb, int ksteps, int lane) {
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k = ks * 16;
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(af[mt], a + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * lda + k +
                              (lane >> 4) * 8);
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      uint32_t r[4];
      if constexpr (B_TRANS)
        ldmatrix_x4_trans(r, b + (k + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldb + p * 16 +
                                 (lane >> 4) * 8);
      else
        ldmatrix_x4(r, b + (p * 16 + (lane >> 4) * 8 + (lane & 7)) * ldb + k +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16_16816(acc[mt * 2 * PAIRS + 2 * p], af[mt], r);
        mma_bf16_16816(acc[mt * 2 * PAIRS + 2 * p + 1], af[mt], r + 2);
      }
    }
  }
}

// The Wi rows of a chunk's narrow products as one [2 * CH][LDS] slab: the
// chunk's CH input rows, then its CH gate rows, contraction columns k0 ..
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
