// The Hopper design shared by the bf16 attention forward (flash_attention.cu)
// and both passes of its backward (flash_attention_bwd.cu), at every head dim
// the library is built for: a CTA is one producer warpgroup and one to four
// consumer warpgroups that meet only at mbarriers.
//
// Every pass has an "own" side (64 rows a consumer warpgroup, loaded once,
// rotated on the way in; in the dK/dV pass at D >= 128, 64 rows a pair of
// warpgroups that split D) and a "streamed" side that is walked in tiles of 64
// rows: keys (K rotated, V, the key bias) in the forward and the dQ pass,
// queries (Q rotated, dO, lse, delta) in the dK/dV pass. The streamed side
// goes through a ring of NST stages in shared memory:
//   - the producer starts 16-byte cp.async copies of the raw tile straight
//     into the swizzled layout wgmma reads (rows past S are zero-filled), the
//     tile's cos/sin rows into a side buffer and its per-row scalars into the
//     stage, NST - 1 tiles ahead of the consumers, with no register staging;
//   - when a tile has landed (cp.async.wait_group) each producer thread
//     rotates, in place, exactly the chunks it copied itself (a thread owns
//     both halves d and d + D/2 of its columns, so it needs no other thread's
//     data), with the rounding of attn::rope_chunk (where the call has rotated
//     the streamed operand into scratch first, see Pass, the ring carries no
//     cos/sin and nothing is rotated there); it turns the mask values
//     into the additive key bias (or lse into base-2 units), makes its writes
//     visible to the async proxy (fence.proxy.async) and arrives on the
//     stage's "full" mbarrier. That happens one tile ahead of the consumers'
//     use, off their critical path; rotated q and k never reach device memory;
//   - consumers wait on "full", run their wgmma products on the stage, and
//     arrive on its "empty" mbarrier, which the producer waits on before it
//     copies into the stage again. No __syncthreads() a tile.
// The producer names each tile by its first row in the stage; a stage whose
// first row is -1 ends the walk. So only the producer decides which tiles are
// walked: in the forward and the dQ pass it leaves out every key tile that
// holds no valid key (decided from the tile's own 64 mask values, scanned once
// a CTA), unless no tile of the walk holds one: then the batch row is all
// padding, or no row of the CTA has a valid key in reach, and the full walk is
// kept. A padded key's probability is exactly 0 for every row that has a valid
// key in reach, before or after a valid tile (a later rescale by
// 2^(-FLT_MAX - m) is 0), so no bit of such a row changes.
//
// cp.async and not TMA fills the ring: the rotation has every producer
// thread touch the tile anyway, cp.async zero-fills rows past S by its source
// size, and it needs no tensor map, whose encoding would cost host time on
// every launch of a host-bound serving path.
#pragma once

#include "attention_common.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace attn {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int GROUP = 128;            // threads of a warpgroup
constexpr int ROWS = hop::TILE_ROWS;  // rows of every tile, own or streamed
constexpr int MAX_TRACKED_TILES = 256;  // key tiles of a walk whose validity a CTA keeps
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Named barriers: one for the producer warpgroup, one a consumer warpgroup.
constexpr int BAR_PRODUCER = 1;
__device__ __forceinline__ int bar_consumer(int group) { return 2 + group; }

// The shape of a pass, fixed when the library is built: NCONS consumer
// warpgroups a CTA, a ring of NST stages, and the registers a thread keeps
// after setmaxnreg (CONSUMER_REGS, PRODUCER_REGS; 0: each keeps the launch's
// share). TABLES: the producer copies cos/sin beside each tile and rotates it
// in the ring; else the call first rotates the streamed operand (and the own
// one of the backward) into scratch (rotate_rows), so that the ring carries
// half the bytes a tile and has no cos/sin buffers. A consumer warpgroup
// waits out the latency of each wgmma chain and of its own softmax chain, so
// the more of them an SM holds the better; registers, shared memory and the
// bytes a tile decide how many.
template <int NCONS_, int NST_, bool TABLES_, int CONSUMER_REGS_ = 0, int PRODUCER_REGS_ = 0>
struct Pass {
  static constexpr int NCONS = NCONS_, NST = NST_;
  static constexpr bool TABLES = TABLES_, REALLOC = CONSUMER_REGS_ > 0;
  static constexpr int CONSUMER_REGS = CONSUMER_REGS_, PRODUCER_REGS = PRODUCER_REGS_;
  static constexpr int THREADS = (NCONS + 1) * GROUP;
  static_assert(NST >= 2 && NST <= 4 && NCONS >= 1 && NCONS <= 4, "pass shape");
  static_assert(!REALLOC || (NCONS * CONSUMER_REGS + PRODUCER_REGS) * GROUP <= 65536,
                "registers after setmaxnreg");
};
// ptxas allocates every warp of a CTA within the share its launch bounds give
// (a quarter of the SM's 65536 registers for the warps of each of its four
// schedulers), also after setmaxnreg has raised a warpgroup's count: a
// consumer beside a producer warpgroup and two other consumers has 168
// registers, and one of more spills its accumulators and serializes its
// wgmma chains. A pass whose consumers need more runs one consumer beside the
// producer (255 registers). The forward (the registers of S, one 64 x D
// accumulator and P: under 96 up to D = 64, under 128 at D = 128, ~216 at
// D = 256): three consumers, four in a global layer at D <= 64 (a +-64 layer
// gains nothing from 256-row CTAs: its walk grows with its rows); one at
// D = 256, with two stages of pre-rotated K (a 64-row stage is 64 KB; three
// pass 227 KB beside the own Q tile). The dQ pass (S, dP, dQ, dS): three at
// D <= 64, through setmaxnreg; two at D = 128 and one at D = 256 (three own
// Q and dO tiles and a ring pass 227 KB at D = 128, two own tiles of 64 x 256
// and two stages fill the CTA at D = 256). The dK/dV pass (S^T, dP^T and two
// 64 x D accumulators: ~200 registers at D = 64): see DkvForm. The backward
// streams pre-rotated Q and K past D = 64.
template <int D, bool GLOBAL>
using FwdPass = std::conditional_t<(D <= 64), Pass<(GLOBAL ? 4 : 3), 3, true>,
                std::conditional_t<(D <= 128), Pass<3, 3, true>, Pass<1, 2, false>>>;
template <int D>
using DqPass = std::conditional_t<(D <= 64), Pass<3, 3, true, 144, 56>,
               std::conditional_t<(D <= 128), Pass<2, 3, false>, Pass<1, 2, false>>>;
// How the dK/dV pass lays 64 keys on its consumers. WHOLE (D <= 64): each
// warpgroup holds both accumulators of its own 64 keys, two a CTA. COLUMNS
// (D = 128): a pair of warpgroups shares 64 keys and splits the D columns of
// dK and dV; one makes P^T, the other dP^T and dS^T, and they hand them over
// through shared memory (four products of 64 x 64 x D a tile pair, as WHOLE).
// ROLES (D = 256, where even half of both accumulators passes 168 registers
// beside S^T and dP^T): a CTA of one warpgroup makes dV (S^T, P^T, dV +=
// P^T.dO) or dK (S^T, dP^T, dS^T, dK += dS^T.Q) of its 64 keys, by the parity
// of its tile; S^T runs twice, five products where the others run four, and
// nothing is handed over.
enum class DkvForm { WHOLE, COLUMNS, ROLES };
template <int D>
__host__ __device__ constexpr DkvForm dkv_form() {
  return D <= 64 ? DkvForm::WHOLE : D <= 128 ? DkvForm::COLUMNS : DkvForm::ROLES;
}
template <int D>
using DkvPass = std::conditional_t<(D <= 64), Pass<2, 3, true, 224, 56>,
                std::conditional_t<(D <= 128), Pass<2, 3, false>, Pass<1, 2, false>>>;
constexpr int SMEM_LIMIT = 232448;  // bytes a CTA may ask for
// The route of the bf16 passes as opt_flash_attention_design reports it: 2,
// wgmma (opt_gemm_design's code) from a shared-memory ring that a producer
// warpgroup fills with cp.async and hands over at mbarriers.
constexpr int ROUTE = 2;

// A consumer warpgroup's own bytes. Forward: Q, then the output on its way
// out as [64][D + 8]. Backward: two tiles (and 64 fp32 of delta), then two
// [64][D + 8] on the way out.
template <int D>
__host__ __device__ constexpr int fwd_own_bytes() {
  return (ROWS * (D + 8) * 2 + 1023) / 1024 * 1024;
}
template <int D>
__host__ __device__ constexpr int bwd_own_bytes() {
  return 2 * ROWS * (D + 8) * 2;
}

// What a CTA's warpgroups share beside the ring.
struct Control {
  uint64_t full[4], empty[4];
  int warp_any[4];  // producer warps: saw a valid key in the batch row
  int skip;         // tiles without a valid key are left out (keys) or write zeros (queries)
  unsigned char tile_valid[MAX_TRACKED_TILES];
};

template <int D, int NST, bool TABLES = true>
struct Ring {
  static_assert(NST >= 2 && NST <= 4, "ring depth");
  static constexpr int TILE = hop::Tile<D>::BYTES;
  static constexpr int AUX = 1024;  // two rows of 64 fp32, the tile's first row, two flags
  static constexpr int STAGE = 2 * TILE + AUX;  // the rotated tile, the raw tile, the scalars
  // cos/sin buffers: tiles landed but not rotated (none for a pre-rotated stream)
  static constexpr int NCS = TABLES ? NST - 1 : 0;
  static constexpr int CS = 2 * TILE;
  static constexpr int BYTES = NST * STAGE + NCS * CS;

  __device__ static __forceinline__ int rot(int s) { return s * STAGE; }
  __device__ static __forceinline__ int raw(int s) { return s * STAGE + TILE; }
  __device__ static __forceinline__ int aux0(int s) { return s * STAGE + 2 * TILE; }
  __device__ static __forceinline__ int aux1(int s) { return aux0(s) + ROWS * 4; }
  __device__ static __forceinline__ int first_row(int s) { return aux0(s) + 2 * ROWS * 4; }
  __device__ static __forceinline__ int cos(int c) { return NST * STAGE + c * CS; }
  __device__ static __forceinline__ int sin(int c) { return cos(c) + TILE; }
};

// The streamed side of one CTA.
struct Stream {
  const bf16* rot;  // rows of one (batch, head), rotated on arrival: K or Q
  long long rot_ss;
  const bf16* raw;  // V or dO
  long long raw_ss;
  const bf16* cos_t;  // [S, D] or null
  const bf16* sin_t;
  const int* mrow;     // the batch row's key mask [S], or null
  const float* lse;    // queries only: [S] of this (batch, head)
  const float* delta;  // queries only
  int S;
  int first, last;     // tiles start at first, first + 64, ... <= last
  int own_first, own_rows;  // queries only: the CTA's own keys
};

__device__ __forceinline__ void mbarriers_init(Control* ctl, int stages, int consumers) {
  for (int s = 0; s < stages; ++s) {  // one arrival a warp: lane 0, after __syncwarp()
    hop::mbar_init(&ctl->full[s], GROUP / 32);
    hop::mbar_init(&ctl->empty[s], consumers * GROUP / 32);
  }
  hop::fence_barrier_init();
}

// x * cos + rotate_half(x) * sin for the two bf16 pairs of one 32-bit word of
// the low half (d < D/2) and of the high half, on packed bf16: each product
// rounded to bf16, then their sum rounded, attn::rope_chunk's roundings (the
// fp32 product of two bf16 is exact, and so is the fp32 sum of two bf16 wherever
// it is not absorbed, so rounding once in bf16 gives the same bits). The .rn
// forms keep ptxas from fusing a product with the sum.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ void rotate_word(uint32_t& lo, uint32_t& hi, uint32_t cos_lo,
                                            uint32_t cos_hi, uint32_t sin_lo, uint32_t sin_hi) {
  const uint32_t neg = 0x80008000u;  // the sign bits of both halves
  const uint32_t out_lo = add_bf16x2(mul_bf16x2(lo, cos_lo), mul_bf16x2(hi, sin_lo) ^ neg);
  hi = add_bf16x2(mul_bf16x2(hi, cos_hi), mul_bf16x2(lo, sin_hi));
  lo = out_lo;
}

// The producer warpgroup's whole life. `pt` is the thread's index in it.
// KEYS: the stream is keys (aux0 = key bias); else queries (aux0 = lse in
// base-2 units, +inf past S, aux1 = delta). TABLES: cos/sin are copied into
// the ring with the tile and the tile is rotated there; else the stream comes
// rotated already (st.cos_t is null) and the ring has no cos/sin buffers.
template <int D, int NST, bool KEYS, bool TABLES = true>
__device__ __forceinline__ void produce(uint32_t ring, unsigned char* ring_ptr, Control* ctl,
                                        const Stream& st, int pt) {
  using R = Ring<D, NST, TABLES>;
  using T = hop::Tile<D>;
  constexpr int HALF_CHUNKS = D / 16;  // chunk pairs (d, d + D/2) a row
  constexpr int TASKS = ROWS * HALF_CHUNKS;
  const int lane = pt & 31, pw = pt >> 5;
  const int S = st.S;

  // Whether the 64 keys from row t0 on hold a valid one: one warp, two a lane.
  auto tile_has_valid_key = [&](int t0) {
    const int i0 = t0 + lane, i1 = i0 + 32;
    return __any_sync(0xffffffffu,
                      (i0 < S && st.mrow[i0] != 0) || (i1 < S && st.mrow[i1] != 0)) != 0;
  };
  auto any_warp = [&](bool warp_any) {  // over the producer's four warps
    if (lane == 0) ctl->warp_any[pw] = warp_any;
    hop::bar_sync(BAR_PRODUCER, GROUP);
    const bool any = (ctl->warp_any[0] | ctl->warp_any[1] | ctl->warp_any[2] | ctl->warp_any[3]) != 0;
    hop::bar_sync(BAR_PRODUCER, GROUP);  // warp_any may be written again
    return any;
  };
  // Keys: which tiles of the walk hold a valid key (tile_valid, from the
  // walk's first tile on). Where none does, either the batch row is all
  // padding, which keeps the full walk, or no row of this CTA has a valid key
  // in reach, and then any walk will do: so nothing is left out. Queries:
  // which of the CTA's own key tiles hold a valid key; where none does the
  // batch row is scanned, and if it has a valid key elsewhere the CTA streams
  // nothing and writes zeros.
  int last = st.last;
  const int walk_first = st.first / ROWS;
  bool skip = false;
  if (st.mrow != nullptr) {
    if (KEYS) {
      const int walk_tiles = last < st.first ? 0 : last / ROWS - walk_first + 1;
      if (walk_tiles <= MAX_TRACKED_TILES) {
        bool warp_any = false;
        for (int i = pw; i < walk_tiles; i += 4) {
          const bool valid = tile_has_valid_key((walk_first + i) * ROWS);
          if (lane == 0) ctl->tile_valid[i] = valid;
          warp_any |= valid;
        }
        skip = any_warp(warp_any);
      }
    } else {
      const int own_tiles = st.own_rows / ROWS;
      bool valid = false;
      if (pw < own_tiles) {
        valid = st.own_first + pw * ROWS < S && tile_has_valid_key(st.own_first + pw * ROWS);
        if (lane == 0) ctl->tile_valid[pw] = valid;
      }
      const bool own_any = any_warp(valid);
      skip = own_any;
      if (!own_any) {
        bool warp_any = false;
        for (int t0 = pw * ROWS; t0 < S; t0 += 4 * ROWS) warp_any |= tile_has_valid_key(t0);
        skip = any_warp(warp_any);
        if (skip) last = st.first - 1;
      }
    }
  }
  if (pt == 0) ctl->skip = skip;
  auto next_tile = [&](int t0) {
    if (KEYS && skip)
      while (t0 <= last && !ctl->tile_valid[t0 / ROWS - walk_first]) t0 += ROWS;
    return t0;
  };

  auto copy_in = [&](int t0, int n) {  // copies of tile number n, starting at row t0
    const int s = n % NST, c = n % (TABLES ? R::NCS : 1);
    hop::mbar_wait(&ctl->empty[s], ((n / NST) & 1) ^ 1);
    for (int task = pt; task < TASKS; task += GROUP) {
      const int r = task / HALF_CHUNKS, cp = task % HALF_CHUNKS;
      const int pos = t0 + r;
      const bool ok = pos < S;
      const long long row = ok ? pos : S - 1;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d0 = cp * 8 + half * (D / 2);
        const int at = T::chunk(r, d0);
        hop::cp_async_16(ring + R::rot(s) + at, st.rot + row * st.rot_ss + d0, ok);
        hop::cp_async_16(ring + R::raw(s) + at, st.raw + row * st.raw_ss + d0, ok);
        if (TABLES && st.cos_t != nullptr) {
          hop::cp_async_16(ring + R::cos(c) + at, st.cos_t + row * D + d0, ok);
          hop::cp_async_16(ring + R::sin(c) + at, st.sin_t + row * D + d0, ok);
        }
      }
    }
    if (pt < ROWS) {
      const int pos = t0 + pt;
      const bool ok = pos < S;
      const int row = ok ? pos : S - 1;
      if (KEYS) {
        if (st.mrow != nullptr) hop::cp_async_4(ring + R::aux0(s) + pt * 4, st.mrow + row, ok);
      } else {
        hop::cp_async_4(ring + R::aux0(s) + pt * 4, st.lse + row, ok);
        hop::cp_async_4(ring + R::aux1(s) + pt * 4, st.delta + row, ok);
      }
    }
  };

  auto finish = [&](int t0, int n) {  // tile n has landed: rotate, publish
    const int s = n % NST, c = n % (TABLES ? R::NCS : 1);
    if (TABLES && st.cos_t != nullptr) {
      for (int task = pt; task < TASKS; task += GROUP) {
        const int r = task / HALF_CHUNKS, cp = task % HALF_CHUNKS;
        const int at_lo = T::chunk(r, cp * 8), at_hi = T::chunk(r, cp * 8 + D / 2);
        uint4 lo = hop::lds128(ring + R::rot(s) + at_lo);
        uint4 hi = hop::lds128(ring + R::rot(s) + at_hi);
        const uint4 cl = hop::lds128(ring + R::cos(c) + at_lo);
        const uint4 ch = hop::lds128(ring + R::cos(c) + at_hi);
        const uint4 sl = hop::lds128(ring + R::sin(c) + at_lo);
        const uint4 sh = hop::lds128(ring + R::sin(c) + at_hi);
        rotate_word(lo.x, hi.x, cl.x, ch.x, sl.x, sh.x);
        rotate_word(lo.y, hi.y, cl.y, ch.y, sl.y, sh.y);
        rotate_word(lo.z, hi.z, cl.z, ch.z, sl.z, sh.z);
        rotate_word(lo.w, hi.w, cl.w, ch.w, sl.w, sh.w);
        hop::sts128(ring + R::rot(s) + at_lo, lo);
        hop::sts128(ring + R::rot(s) + at_hi, hi);
      }
    }
    if (pt < ROWS) {
      float* a0 = reinterpret_cast<float*>(ring_ptr + R::aux0(s)) + pt;
      const bool ok = t0 + pt < S;
      if (KEYS) {  // attn::key_bias, and whether this warp's 32 keys all have none
        const bool padded = st.mrow != nullptr && *reinterpret_cast<const int*>(a0) == 0;
        *a0 = !ok ? -INFINITY : (padded ? OPT_NEG_BIG : 0.f);
        const bool all_valid = __all_sync(0xffffffffu, ok && !padded);
        if (lane == 0) reinterpret_cast<int*>(ring_ptr + R::first_row(s))[1 + pw] = all_valid;
      } else {  // a row whose keys are all masked keeps lse = -FLT_MAX
        const float lse = *a0;
        *a0 = !ok ? INFINITY : (lse == OPT_NEG_BIG ? OPT_NEG_BIG : lse * LOG2E);
      }
    }
    if (pt == 0) *reinterpret_cast<int*>(ring_ptr + R::first_row(s)) = t0;
    hop::fence_proxy_async();
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&ctl->full[s]);
  };

  int copy_t = next_tile(st.first), copied = 0;
  for (int i = 0; i < NST - 1; ++i) {
    if (copy_t <= last) {
      copy_in(copy_t, copied++);
      copy_t = next_tile(copy_t + ROWS);
    }
    hop::cp_async_commit_group();  // an empty group keeps the wait count uniform
  }
  int finished = 0;
  for (int t0 = next_tile(st.first); t0 <= last; t0 = next_tile(t0 + ROWS)) {
    hop::cp_async_wait_group<NST - 2>();
    finish(t0, finished++);
    if (copy_t <= last) {
      copy_in(copy_t, copied++);
      copy_t = next_tile(copy_t + ROWS);
    }
    hop::cp_async_commit_group();
  }
  // The end of the walk.
  const int s = finished % NST;
  hop::mbar_wait(&ctl->empty[s], ((finished / NST) & 1) ^ 1);
  if (pt == 0) *reinterpret_cast<int*>(ring_ptr + R::first_row(s)) = -1;
  __syncwarp();
  if (lane == 0) hop::mbar_arrive(&ctl->full[s]);
}

// Rows of one [B, H, S, D] operand rotated into contiguous scratch
// [B, H, S, D], one 16-byte chunk a thread, with attn::rope_chunk's roundings:
// the bits the producer's rotation in the ring gives.
template <int D>
__global__ void __launch_bounds__(256) rotate_rows_kernel(Strided src, const bf16* cos_t,
                                                          const bf16* sin_t, bf16* dst, int S,
                                                          int H, long long chunks) {
  constexpr int CH = D / 8;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chunks) return;
  const long long row = c / CH;  // over (b, h, s)
  const int d0 = (int)(c % CH) * 8, s = (int)(row % S);
  const long long bh = row / S;
  const bf16* from =
      rows_of<const bf16>(src, (int)(bh / H), (int)(bh % H)) + (long long)s * src.ss;
  *reinterpret_cast<uint4*>(dst + row * D + d0) = rope_chunk<D>(from, d0, cos_t, sin_t, s);
}

template <int D>
int rotate_rows(const Strided& src, const void* cos_t, const void* sin_t, void* dst, int batch,
                int S, int H, cudaStream_t stream) {
  const long long chunks = (long long)batch * H * S * (D / 8);
  rotate_rows_kernel<D><<<(unsigned)((chunks + 255) / 256), 256, 0, stream>>>(
      src, static_cast<const bf16*>(cos_t), static_cast<const bf16*>(sin_t),
      static_cast<bf16*>(dst), S, H, chunks);
  return (int)cudaGetLastError();
}

// Where a CTA reads the rotated rows of one (batch, head) of an operand: the
// pre-rotated scratch (contiguous, `which`-th operand of `batch` x H x S x D)
// where the pass streams it so and the call has tables, with no tables left to
// apply; else the operand itself and the tables.
struct RotatedRows {
  const bf16* rows;
  long long ss;
  const bf16* cos_t;
  const bf16* sin_t;
};
template <int D, bool PREROTATED>
__device__ __forceinline__ RotatedRows rotated_rows(const Strided& src, void* scratch, int which,
                                                    const void* cos_t, const void* sin_t, int b,
                                                    int h, int S, int H) {
  if (PREROTATED && cos_t != nullptr) {
    const size_t at = (((size_t)which * gridDim.z + b) * H + h) * S * D;
    return {static_cast<const bf16*>(scratch) + at, D, nullptr, nullptr};
  }
  return {rows_of<const bf16>(src, b, h), src.ss, static_cast<const bf16*>(cos_t),
          static_cast<const bf16*>(sin_t)};
}

// A consumer's view of the ring: wait for a tile, learn where it starts, read
// it, release its stage.
template <int D, int NST>
struct Reader {
  using R = Ring<D, NST>;
  uint32_t ring;
  unsigned char* ring_ptr;
  Control* ctl;

  // Tile number n of the walk (0, 1, ...) lies in stage n % NST.
  // Its first row, or -1 at the end of the walk, once it has arrived.
  __device__ __forceinline__ int wait(int n) const {
    hop::mbar_wait(&ctl->full[n % NST], (n / NST) & 1);
    return *reinterpret_cast<volatile int*>(ring_ptr + R::first_row(n % NST));
  }
  // Keys only: every key of the tile is valid (its bias row is all zeros).
  __device__ __forceinline__ bool all_valid(int n) const {
    const volatile int* flags =
        reinterpret_cast<const volatile int*>(ring_ptr + R::first_row(n % NST));
    return flags[1] != 0 && flags[2] != 0;
  }
  __device__ __forceinline__ void release(int n) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) hop::mbar_arrive(&ctl->empty[n % NST]);
  }
  __device__ __forceinline__ uint32_t rot(int n) const { return ring + R::rot(n % NST); }
  __device__ __forceinline__ uint32_t raw(int n) const { return ring + R::raw(n % NST); }
  __device__ __forceinline__ const float* aux0(int n) const {
    return reinterpret_cast<const float*>(ring_ptr + R::aux0(n % NST));
  }
  __device__ __forceinline__ const float* aux1(int n) const {
    return reinterpret_cast<const float*>(ring_ptr + R::aux1(n % NST));
  }
};

// Whether every pair of a 64-row tile starting at a0 and one starting at b0
// lies inside the band (always, for a global layer).
__device__ __forceinline__ bool band_free(int a0, int b0, int window) {
  return window < 0 || (a0 + ROWS - 1 - b0 <= window && b0 + ROWS - 1 - a0 <= window);
}

// Whether any pair of the two tiles lies inside the band.
__device__ __forceinline__ bool band_reach(int a0, int b0, int window) {
  return window < 0 || (b0 + ROWS - 1 >= a0 - window && b0 <= a0 + ROWS - 1 + window);
}

// Rows r0 .. r0 + 63 of one (batch, head) into a swizzled own tile, rotated
// when tables are given, zeros past S; by the 128 threads of one warpgroup
// (`t` is the thread's index in it).
template <int D>
__device__ __forceinline__ void load_own(uint32_t tile, const bf16* rows, long long ss, int r0,
                                         int S, const bf16* cos_t, const bf16* sin_t, int t) {
  if constexpr (D <= 128) {
    constexpr int CH = D / 8, EACH = ROWS * CH / GROUP;  // chunks a thread: all loads in flight
    uint4 v[EACH];
#pragma unroll
    for (int i = 0; i < EACH; ++i) {
      const int c = t + i * GROUP, r = c / CH, d0 = (c % CH) * 8, pos = r0 + r;
      v[i] = make_uint4(0, 0, 0, 0);
      if (pos < S) v[i] = rope_chunk<D>(rows + (long long)pos * ss, d0, cos_t, sin_t, pos);
    }
#pragma unroll
    for (int i = 0; i < EACH; ++i) {
      const int c = t + i * GROUP, r = c / CH, d0 = (c % CH) * 8;
      hop::sts128(tile + hop::Tile<D>::chunk(r, d0), v[i]);
    }
  } else {
    // A thread takes chunk pairs (d, d + D/2), four a batch: both halves and
    // their cos and sin words, six 16-byte loads a pair where rope_chunk takes
    // eight, rotated as the producer rotates (rotate_word).
    constexpr int HALF_CH = D / 16, PAIRS = ROWS * HALF_CH / GROUP, BATCH = 4;
    static_assert(PAIRS % BATCH == 0, "whole batches");
#pragma unroll 1
    for (int i0 = 0; i0 < PAIRS; i0 += BATCH) {
      uint4 w[BATCH][6];  // lo, hi, cos lo, cos hi, sin lo, sin hi
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int task = t + (i0 + i) * GROUP, r = task / HALF_CH, d0 = (task % HALF_CH) * 8;
        const int pos = r0 + r;
#pragma unroll
        for (int j = 0; j < 6; ++j) w[i][j] = make_uint4(0, 0, 0, 0);
        if (pos < S) {
          const bf16* row = rows + (long long)pos * ss;
          w[i][0] = *reinterpret_cast<const uint4*>(row + d0);
          w[i][1] = *reinterpret_cast<const uint4*>(row + d0 + D / 2);
          if (cos_t != nullptr) {
            const long long at = (long long)pos * D + d0;
            w[i][2] = *reinterpret_cast<const uint4*>(cos_t + at);
            w[i][3] = *reinterpret_cast<const uint4*>(cos_t + at + D / 2);
            w[i][4] = *reinterpret_cast<const uint4*>(sin_t + at);
            w[i][5] = *reinterpret_cast<const uint4*>(sin_t + at + D / 2);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int task = t + (i0 + i) * GROUP, r = task / HALF_CH, d0 = (task % HALF_CH) * 8;
        uint4 lo = w[i][0], hi = w[i][1];
        if (cos_t != nullptr && r0 + r < S) {
          rotate_word(lo.x, hi.x, w[i][2].x, w[i][3].x, w[i][4].x, w[i][5].x);
          rotate_word(lo.y, hi.y, w[i][2].y, w[i][3].y, w[i][4].y, w[i][5].y);
          rotate_word(lo.z, hi.z, w[i][2].z, w[i][3].z, w[i][4].z, w[i][5].z);
          rotate_word(lo.w, hi.w, w[i][2].w, w[i][3].w, w[i][4].w, w[i][5].w);
        }
        hop::sts128(tile + hop::Tile<D>::chunk(r, d0), lo);
        hop::sts128(tile + hop::Tile<D>::chunk(r, d0 + D / 2), hi);
      }
    }
  }
}

// C[64 x 64] = A . B^T for two K-major tiles of D columns (scores, dP): the
// first step overwrites the accumulator.
template <int D>
__device__ __forceinline__ void rows_times_rows(float* acc, uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hop::wgmma_ss<64>(acc, hop::k_major<D>(a_tile, kk), hop::k_major<D>(b_tile, kk), kk > 0);
}

// C[64 x N] += P . B[:, col0 : col0 + N] for P[64 x 64] as four register A
// fragments and a tile of 64 rows x D columns read as an MN-major B operand
// (col0 a multiple of 64). Past N = 128 in two products of half the width.
template <int D, int N = D>
__device__ __forceinline__ void frags_times_tile(float* acc, const uint32_t (*pa)[4],
                                                 uint32_t b_tile, int col0 = 0) {
  if constexpr (N > 128) {
    frags_times_tile<D, N / 2>(acc, pa, b_tile, col0);
    frags_times_tile<D, N / 2>(acc + N / 4, pa, b_tile, col0 + N / 2);
  } else {
    const uint32_t at = b_tile + (col0 / hop::Tile<D>::PW) * hop::Tile<D>::PANEL_BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hop::wgmma_rs<N>(acc, pa[kk], hop::mn_major<D>(at, kk), 1);
  }
}

// Keep the registers of A fragments live up to this point: wgmma reads them
// after the instruction has issued, until its wait.
__device__ __forceinline__ void pin_frags(uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]));
}

// A warpgroup's 64 x N fp32 accumulator (acc[4 n + e], see hopper.cuh), times
// mult and rounded to bf16, into the first N columns of a staging tile of
// rows LD apart ([64][N + 8] unless given).
template <int N, int LD = N + 8>
__device__ __forceinline__ void stage_acc(const float* acc, float mult, bf16* staged, int t) {
  const int warp = t >> 5, g = (t & 31) >> 2, q = t & 3;
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<__nv_bfloat162*>(staged + (warp * 16 + g + 8 * i) * LD + n * 8 + 2 * q) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] * mult, acc[4 * n + 2 * i + 1] * mult);
}

}  // namespace wg
}  // namespace attn
