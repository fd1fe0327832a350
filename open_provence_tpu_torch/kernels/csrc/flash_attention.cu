// Flash-attention forward: kernel 3 of the forward path (the packed Wqkv
// output) and kernel 9 (separate q, k, v), one kernel for both.
//
// Replaces ops/flash_attention.py::_flash_kernel_packed and ::_flash_kernel.
// q, k, v and the output are [B, H, S, D] operands read through (batch, head,
// row) strides (attention_common.cuh: Strided). opt_flash_attention takes
// separate tensors of any strides with a unit last stride; the packed
// buffer is the special case "three offsets into one buffer": one
// [B, S, 3*H*D] buffer in HF lane order (qkv, head, dim), q at h*D, k at
// H*D + h*D, v at 2*H*D + h*D of each row, and the output a view of
// [B, S, H*D], ready for Wo. D is 32,
// 64, 128 or 256, any head count. Rotary runs in-kernel from [S, D] cos/sin
// tables given in the storage type, rounding as the plain composition does
// (x*cos and rotate_half(x)*sin each rounded to T, then their sum), so the
// rotated q/k never reach device memory.
//
// One CTA per (q tile of 64 rows, head, batch row) walks the key tiles of 64.
// For local layers the walk is bounded by the band |i - j| <= window, so a
// CTA visits at most ceil((64 + 2*window) / 64) + 1 key tiles; this is the
// TPU's separate banded kernel folded into a loop bound. Scores, the online
// softmax (running max, rescale, running sum) and the P.V accumulator are
// fp32; P is rounded to T before the P.V product and summed unrounded, as
// the TPU kernel does. Masking is one additive bias per score: key padding
// and the band each add -FLT_MAX, clamped so two stacked biases stay finite
// (the bf16 kernel reads the key mask once a key tile into shared memory).
// Keys past S (a ragged last tile) get -inf and so weigh exactly 0. Rows
// whose running sum is 0 write 0.
//
// For training the kernel also writes the fp32 log-sum-exp m + log(l) of
// each (batch, head, query row) into lse [B, H, S], which the backward
// (flash_attention_bwd.cu) needs to rebuild P. Serving passes a null lse:
// the kernel then skips the store, and nothing else changes. A row whose
// keys are all masked has every score at -FLT_MAX, so its lse is -FLT_MAX
// too (log l vanishes beside it) and stays finite.
//
// What bounds it on this card. By the shapes a global layer is bound by
// operations at long S (4*S*S*D a head on the tensor cores) and by bytes at
// S = 512 and for every +-64 layer; in practice a kernel here is bound by
// latency long before either: a key tile's loads, the dependent chain of its
// softmax (32 exponentials a thread through the special-function unit, which
// at D = 64 is as busy as the tensor cores) and the wgmma chains all have to
// be waited out by somebody.
//
// bf16, D = 32, 64, 128 (attention_wgmma.cuh has the shared design): a CTA is
// a producer warpgroup, which fills a ring of key tiles in shared memory with
// cp.async and rotates K there one tile ahead of its use, and three consumer
// warpgroups of 64 query rows each that meet it only at mbarriers: no load
// sits between two barriers. Both products run on wgmma from the swizzled
// tiles (S = Q.K^T with both operands in shared memory, P from the
// accumulator's registers as the A operand of P.V, V read MN-major). The
// softmax runs in base 2 with scale * log2(e) folded into the score and one
// ex2.approx a score, lse stays in natural log. Key tiles without a valid key
// are not walked. 192-row CTAs read K and V a third as often as 64-row ones;
// three warpgroups an SM overlap one's products with another's exponentials.
// bf16, D = 256: mma.sync m16n8k16 as before (each of 4 warps owns 16 query
// rows, Q fragments read from shared memory at each key tile), with ex2 and
// the skipped key tiles: a 64 x 256 output beside the scores leaves no
// registers for three warpgroups. fp32: the same walk with fp32 FMA from
// shared memory (true fp32), unchanged: it exists for parity, no main path
// runs it.
#include "attention_wgmma.cuh"

#ifdef OPT_HEAD_DIM  // ---- the kernels of one head dim ------------------------

namespace {

using attn::BK;
using attn::BQ;
using attn::biased_score;
using attn::pack_bf16;
using attn::rope_chunk;
using attn::rope_elem;

using attn::rows_of;
using Args = attn::FwdArgs;

// ---- fp32: FMA ------------------------------------------------------------

namespace simt {
constexpr int THREADS = 256;
template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(2 * BQ * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ) * sizeof(float);
}
}  // namespace simt

template <int D>
__global__ void __launch_bounds__(simt::THREADS) flash_fma_kernel(Args args) {
  using T = float;
  constexpr int THREADS = simt::THREADS;
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);      // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);      // [BK][D]
  float* Ps = Vs + BK * D;            // [BQ][BK + 1]
  float* m_run = Ps + BQ * (BK + 1);  // [BQ]
  float* l_run = m_run + BQ;          // [BQ]
  float* alpha = l_run + BQ;          // [BQ]

  const int S = args.S;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const T* qb = rows_of<const T>(args.q, b, h);
  const T* kb = rows_of<const T>(args.k, b, h);
  const T* vb = rows_of<const T>(args.v, b, h);
  const T* cos_t = static_cast<const T*>(args.cos_t);
  const T* sin_t = static_cast<const T*>(args.sin_t);
  const int* mrow = args.mask == nullptr ? nullptr : args.mask + (size_t)b * S;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D, pos = q0 + r;
    Qs[r * (D + 1) + d] =
        pos < S ? rope_elem<T, D>(qb + pos * args.q.ss, d, cos_t, sin_t, pos) : 0.f;
  }
  if (tid < BQ) {
    m_run[tid] = OPT_NEG_BIG;
    l_run[tid] = 0.f;
  }

  const int tx = tid & 15, ty = tid >> 4;
  constexpr int DJ = D / 16;
  float acc[4][DJ] = {};

  int k_first, k_last;
  attn::band_range(q0, BQ, BK, S, args.window, &k_first, &k_last);
  for (int k0 = k_first; k0 <= k_last; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are consumed
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, d = idx % D, pos = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (pos < S) {
        kv = rope_elem<T, D>(kb + pos * args.k.ss, d, cos_t, sin_t, pos);
        vv = vb[pos * args.v.ss + d];
      }
      Ks[r * (D + 1) + d] = kv;
      Vs[r * D + d] = vv;
    }
    __syncthreads();

    // Scores for rows ty + 16i, keys tx + 16j, with the additive bias.
    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = biased_score(
            s[i][j], args.scale, q0 + ty + 16 * i, k0 + tx + 16 * j, S, mrow, args.window);
    __syncthreads();

    // Online softmax: warp w owns rows 8w .. 8w+7, two keys per lane.
    const int lane = tid & 31, warp = tid >> 5;
    constexpr int ROWS_PER_WARP = BQ / (THREADS / 32);
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      float* prow = Ps + r * (BK + 1);
      const float v0 = prow[lane], v1 = prow[lane + 32];
      const float m_prev = m_run[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(v0, v1)));
      const float p0 = expf(v0 - m_new), p1 = expf(v1 - m_new);
      const float row_sum = warp_sum(p0 + p1);
      prow[lane] = p0;
      prow[lane + 32] = p1;
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[r] = a;
        l_run[r] = l_run[r] * a + row_sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V for rows ty + 16i, dims tx + 16j.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();

  if (args.lse != nullptr && tid < BQ && q0 + tid < S)
    args.lse[((size_t)b * args.H + h) * S + q0 + tid] = m_run[tid] + logf(l_run[tid]);
  T* out = rows_of<T>(args.out, b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, pos = q0 + r;
    if (pos >= S) continue;
    const float l = l_run[r];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    T* orow = out + pos * args.out.ss;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = acc[i][j] * inv;
  }
}

// ---- bf16: mma.sync -------------------------------------------------------

namespace tc {
constexpr int THREADS = 128;  // 4 warps x 16 query rows
template <int D>
constexpr size_t smem_bytes() {  // the Q, K and V tiles and the key tile's bias
  return (size_t)(BQ + 2 * BK) * (D + 8) * sizeof(__nv_bfloat16) + BK * sizeof(float);
}
}  // namespace tc

// 16-byte rows throughout: D % 8 == 0 and 16-byte aligned rows (the wrapper
// checks the strides and pointers).
template <int D>
__global__ void __launch_bounds__(tc::THREADS) flash_mma_kernel(Args args) {
  using T = __nv_bfloat16;
  constexpr int THREADS = tc::THREADS, LD = D + 8, CH = D / 8;
  constexpr int DC = D / 16;  // k-chunks of Q.K^T and d-pairs of the output
  constexpr int KN = BK / 8;  // n-tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* Ks = Qs + BQ * LD;                    // [BK][LD], rotated
  T* Vs = Ks + BK * LD;                    // [BK][LD]
  float* kbias = reinterpret_cast<float*>(Vs + BK * LD);  // [BK]: key padding, keys past S

  const int S = args.S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const T* qb = rows_of<const T>(args.q, b, h);
  const T* kb = rows_of<const T>(args.k, b, h);
  const T* vb = rows_of<const T>(args.v, b, h);
  const T* cos_t = static_cast<const T*>(args.cos_t);
  const T* sin_t = static_cast<const T*>(args.sin_t);
  const int* mrow = args.mask == nullptr ? nullptr : args.mask + (size_t)b * S;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int r = c / CH, d0 = (c % CH) * 8, pos = q0 + r;
    *reinterpret_cast<uint4*>(Qs + r * LD + d0) =
        pos < S ? rope_chunk<D>(qb + pos * args.q.ss, d0, cos_t, sin_t, pos) : zero;
  }
  __syncthreads();

  // This warp's query rows: qrow = 16*warp + g, and qrow + 8. ldmatrix row
  // addresses: lane l points at row l % 8 (+8 for lanes 8-15 and 24-31) and
  // column +8 for lanes 16-31 (A operand order). The Q fragments are read
  // from shared memory at each key tile: at the head dims this kernel still
  // serves (wgmma carries the others) they would not fit beside the output.
  static_assert(!attn::wg::forward_carried<D>(), "this head dim runs on wgmma");
  const int qrow = warp * 16 + g;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;

  float o[2 * DC][4] = {};
  float m_run[2] = {OPT_NEG_BIG, OPT_NEG_BIG}, l_run[2] = {0.f, 0.f};

  int k_first, k_last;
  attn::band_range(q0, BQ, BK, S, args.window, &k_first, &k_last);
  // A key tile without a valid key is left out wherever the walk holds a
  // valid key at all (attention_wgmma.cuh has the argument).
  const bool skip_padded = attn::walk_has_valid_key(mrow, k_first, k_last, tid, THREADS);
  for (int k0 = k_first; k0 <= k_last; k0 += BK) {
    // Every warp is done with the previous Ks/Vs.
    if (!attn::tile_barrier(skip_padded, mrow, k0, S, tid)) continue;
    // Four chunks' loads in flight a thread (all of a D = 64 tile's).
#pragma unroll 4
    for (int it = 0; it < BK * CH / THREADS; ++it) {
      const int c = tid + it * THREADS;
      const int r = c / CH, d0 = (c % CH) * 8, pos = k0 + r;
      uint4 kv = zero, vv = zero;
      if (pos < S) {
        kv = rope_chunk<D>(kb + pos * args.k.ss, d0, cos_t, sin_t, pos);
        vv = *reinterpret_cast<const uint4*>(vb + pos * args.v.ss + d0);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + d0) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LD + d0) = vv;
    }
    // The mask is read once a key, not once a score.
    if (tid < BK) kbias[tid] = attn::key_bias(k0 + tid, S, mrow);
    __syncthreads();

    // Scores: 16 rows x 64 keys per warp, each accumulator summed over the
    // dim chunks c in order. B operand = K rows (keys) read 16 keys x 16 dims
    // per ldmatrix.x4: r0/r1 key tile 2p, r2/r3 tile 2p+1.
    float s[KN][4] = {};
#pragma unroll
    for (int c = 0; c < DC; ++c) {  // one Q fragment at a time, read where it is needed
      uint32_t qf[4];
      ldmatrix_x4(qf, Qs + (warp * 16 + a_row) * LD + c * 16 + a_col);
#pragma unroll
      for (int p = 0; p < KN / 2; ++p) {
        uint32_t r[4];
        ldmatrix_x4(r, Ks + (p * 16 + a_col + (lane & 7)) * LD + c * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[2 * p], qf, r);
        mma_bf16_16816(s[2 * p + 1], qf, r + 2);
      }
    }

    // Bias, then the online softmax of rows qrow (i = 0) and qrow + 8
    // (i = 1); a row's 64 scores live in the 4 lanes of a quad.
    float m_new[2], alpha[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + qrow + 8 * i;
      float mx = OPT_NEG_BIG;
#pragma unroll
      for (int nt = 0; nt < KN; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& v = s[nt][2 * i + j];
          const int col = nt * 8 + 2 * t + j;
          v = attn::banded_score(v, args.scale, qi, k0 + col, kbias[col], args.window);
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      m_new[i] = fmaxf(m_run[i], mx);
      alpha[i] = attn::exp_ex2(m_run[i] - m_new[i]);
    }
    // P straight from the score accumulators into the A operand of P.V,
    // rounded to bf16: key tile nt fills half of key chunk nt / 2.
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < KN; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = attn::exp_ex2(s[nt][e] - m_new[e >> 1]);
        row_sum[e >> 1] += p[e];
      }
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float rs = row_sum[i];
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_run[i] = l_run[i] * alpha[i] + rs;
      m_run[i] = m_new[i];
    }
#pragma unroll
    for (int dn = 0; dn < 2 * DC; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }
    // O += P.V. B operand = V read transposed, 16 keys x 16 dims per
    // ldmatrix.x4.trans: r0/r1 dim tile 2q, r2/r3 dim tile 2q+1.
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
      for (int q = 0; q < DC; ++q) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Vs + (kc * 16 + a_row) * LD + q * 16 + a_col);
        mma_bf16_16816(o[2 * q], pa[kc], r);
        mma_bf16_16816(o[2 * q + 1], pa[kc], r + 2);
      }
    }
  }

  T* out = rows_of<T>(args.out, b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = q0 + qrow + 8 * i;
    if (pos >= S) continue;
    if (args.lse != nullptr && t == 0)  // no tile walked: a row whose keys are all masked
      args.lse[((size_t)b * args.H + h) * S + pos] =
          l_run[i] == 0.f ? OPT_NEG_BIG : m_run[i] + logf(l_run[i]);
    const float inv = 1.f / (l_run[i] == 0.f ? 1.f : l_run[i]);
    T* orow = out + pos * args.out.ss;
#pragma unroll
    for (int dn = 0; dn < 2 * DC; ++dn) {
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(o[dn][2 * i] * inv, o[dn][2 * i + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(&orow[dn * 8 + 2 * t]) = v;
    }
  }
}

// ---- bf16 on wgmma: the ring of attention_wgmma.cuh -------------------------------
//
// NCONS consumer warpgroups (three; four in a global layer at D <= 64) own 64
// query rows each (Q rotated into a swizzled tile once); the producer
// warpgroup streams the key tiles. A consumer's
// tile: S = Q.K^T (both operands in shared memory), the online softmax in
// registers in base 2 (scale * log2(e) folded into the score, one ex2.approx
// a score), P rounded to bf16 in the accumulator's own registers as the A
// operand of O += P.V (V read as an MN-major operand, no transpose). A
// consumer leaves out a key tile that lies wholly outside its own rows' band.

namespace wgk {
namespace wg = attn::wg;
template <int D>
__host__ __device__ constexpr int own_bytes() { return wg::fwd_own_bytes<D>(); }
template <int D, int NCONS>
constexpr size_t smem_bytes() {
  return 1024 + NCONS * own_bytes<D>() + wg::Ring<D, wg::STAGES>::BYTES;
}
}  // namespace wgk

template <int D, int NCONS>
__global__ void __launch_bounds__((NCONS + 1) * attn::wg::GROUP, 1)
    flash_wgmma_kernel(const Args args) {
  namespace wg = attn::wg;
  using T = __nv_bfloat16;
  constexpr int NST = wg::STAGES, OWN = wgk::own_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ wg::Control ctl;
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring_ptr = smem + NCONS * OWN;
  const uint32_t ring = hop::smem_u32(ring_ptr);

  const int S = args.S;
  const int tid = threadIdx.x, group = tid / wg::GROUP, t = tid % wg::GROUP;
  const int q0 = blockIdx.x * (wg::ROWS * NCONS), h = blockIdx.y, b = blockIdx.z;
  const T* cos_t = static_cast<const T*>(args.cos_t);
  const T* sin_t = static_cast<const T*>(args.sin_t);
  if (tid == 0) wg::mbarriers_init(&ctl, NST, NCONS);
  __syncthreads();

  if (group == NCONS) {  // ---- the producer ----
    wg::Stream st;
    st.rot = rows_of<const T>(args.k, b, h);
    st.rot_ss = args.k.ss;
    st.raw = rows_of<const T>(args.v, b, h);
    st.raw_ss = args.v.ss;
    st.cos_t = cos_t;
    st.sin_t = sin_t;
    st.mrow = args.mask == nullptr ? nullptr : args.mask + (size_t)b * S;
    st.lse = st.delta = nullptr;
    st.S = S;
    attn::band_range(q0, wg::ROWS * NCONS, wg::ROWS, S, args.window, &st.first, &st.last);
    st.own_first = st.own_rows = 0;
    wg::produce<D, NST, true>(ring, ring_ptr, &ctl, st, t);
  } else {  // ---- a consumer warpgroup ----
    const int lane = t & 31, warp = t >> 5, g = lane >> 2, qd = lane & 3;
    const int q0w = q0 + group * wg::ROWS;
    unsigned char* own_ptr = smem + group * OWN;
    const uint32_t own = hop::smem_u32(own_ptr);
    wg::load_own<D>(own, rows_of<const T>(args.q, b, h), args.q.ss, q0w, S, cos_t, sin_t, t);
    hop::fence_proxy_async();
    hop::bar_sync(wg::bar_consumer(group), wg::GROUP);

    const float c = args.scale * wg::LOG2E;
    const int window = args.window;
    const int row0 = q0w + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_run[2] = {OPT_NEG_BIG, OPT_NEG_BIG}, l_run[2] = {0.f, 0.f};  // m in base-2 units

    wg::Reader<D, NST> rd{ring, ring_ptr, &ctl};
    for (int n = 0;; ++n) {
      const int k0 = rd.wait(n);
      if (k0 < 0) break;
      if (wg::band_reach(q0w, k0, window)) {
        float s[32];
        hop::wgmma_fence();
        wg::rows_times_rows<D>(s, own, rd.rot(n));
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::pin<32>(s);

        // The row maxima in base 2. Where every key of the tile is valid and
        // inside the band of all 64 rows there is no bias to add; elsewhere s
        // becomes the biased score in base 2.
        float m_new[2] = {m_run[0], m_run[1]}, alpha[2], sum[2] = {0.f, 0.f};
        const bool plain = rd.all_valid(n) && wg::band_free(q0w, k0, window);
        if (plain) {
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int j = 0; j < 32; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
#pragma unroll
          for (int i = 0; i < 2; ++i) m_new[i] = fmaxf(m_new[i], mx[i] * c);
        } else {  // attn::banded_score in base 2
          const float* kb = rd.aux0(n);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 kbv = *reinterpret_cast<const float2*>(kb + j * 8 + 2 * qd);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float bias = (e & 1) ? kbv.y : kbv.x;
              const int kj = k0 + j * 8 + 2 * qd + (e & 1), qi = row0 + 8 * (e >> 1);
              if (window >= 0 && abs(qi - kj) > window) bias = fminf(bias, OPT_NEG_BIG);
              const float v = fmaf(s[4 * j + e], c, bias);
              s[4 * j + e] = v;
              m_new[e >> 1] = fmaxf(m_new[e >> 1], v);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
          m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
          alpha[i] = hop::ex2(m_run[i] - m_new[i]);
          m_run[i] = m_new[i];
        }
        // P from the score accumulators into the A operand of P.V, rounded to
        // bf16 and summed unrounded. The plain tile's scores are still raw.
        const float to_base2 = plain ? c : 1.f;
        uint32_t pa[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = hop::ex2(fmaf(s[4 * j + e], to_base2, -m_new[e >> 1]));
            sum[e >> 1] += p[e];
          }
          pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
          pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
          sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
          l_run[i] = l_run[i] * alpha[i] + sum[i];
        }
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o[4 * j + 0] *= alpha[0];
            o[4 * j + 1] *= alpha[0];
            o[4 * j + 2] *= alpha[1];
            o[4 * j + 3] *= alpha[1];
          }
        }
        hop::wgmma_fence();
        wg::frags_times_tile<D>(o, pa, rd.raw(n));
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::pin<D / 2>(o);
      }
      rd.release(n);
    }

    // A row no tile was walked for (every key tile in its reach left out)
    // writes 0 and the lse of a row whose keys are all masked.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pos = row0 + 8 * i;
      if (args.lse != nullptr && qd == 0 && pos < S)
        args.lse[((size_t)b * args.H + h) * S + pos] =
            m_run[i] == OPT_NEG_BIG ? OPT_NEG_BIG : m_run[i] * wg::LN2 + logf(l_run[i]);
      const float inv = 1.f / (l_run[i] == 0.f ? 1.f : l_run[i]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n + 2 * i] *= inv;
        o[4 * n + 2 * i + 1] *= inv;
      }
    }
    // Through shared memory (Q's tile, done with) to 16-byte row stores.
    constexpr int LD = D + 8, CH = D / 8;
    T* staged = reinterpret_cast<T*>(own_ptr);
    hop::bar_sync(wg::bar_consumer(group), wg::GROUP);
    wg::stage_acc<D>(o, 1.f, staged, t);
    hop::bar_sync(wg::bar_consumer(group), wg::GROUP);
    T* out = rows_of<T>(args.out, b, h);
    for (int ch = t; ch < wg::ROWS * CH; ch += wg::GROUP) {
      const int r = ch / CH, d0 = (ch % CH) * 8, pos = q0w + r;
      if (pos < S)
        *reinterpret_cast<uint4*>(out + (long long)pos * args.out.ss + d0) =
            *reinterpret_cast<const uint4*>(staged + r * LD + d0);
    }
  }
}

template <int D, int NCONS>
int launch_wgmma(const Args& args, int batch, cudaStream_t stream) {
  constexpr size_t smem = wgk::smem_bytes<D, NCONS>();
  static_assert(smem <= attn::wg::SMEM_LIMIT, "shared memory of a CTA");
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<D, NCONS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tile = attn::wg::ROWS * NCONS;
  const dim3 grid((args.S + tile - 1) / tile, args.H, batch);
  flash_wgmma_kernel<D, NCONS>
      <<<grid, (NCONS + 1) * attn::wg::GROUP, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int launch(Kernel kernel, const Args& args, int batch, int threads, size_t smem,
           cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((args.S + BQ - 1) / BQ, args.H, batch);
  kernel<<<grid, threads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <int D>
int by_dtype(const Args& args, int batch, int dtype, cudaStream_t stream) {
  if (dtype == DTYPE_F32)
    return launch(flash_fma_kernel<D>, args, batch, simt::THREADS, simt::smem_bytes<D>(),
                  stream);
  if (dtype == DTYPE_BF16) {
    if constexpr (attn::wg::forward_carried<D>()) {
      // The layer's kind picks the CTA's shape, not a trial.
      constexpr int WIDE = attn::wg::fwd_global_ncons<D>();
      if (WIDE != attn::wg::FWD_NCONS && args.window < 0)
        return launch_wgmma<D, WIDE>(args, batch, stream);
      return launch_wgmma<D, attn::wg::FWD_NCONS>(args, batch, stream);
    } else
      return launch(flash_mma_kernel<D>, args, batch, tc::THREADS, tc::smem_bytes<D>(), stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

namespace attn {
int OPT_ATTN_CAT(forward_d, OPT_HEAD_DIM)(const FwdArgs& args, int batch, int dtype,
                                           cudaStream_t stream) {
  return by_dtype<OPT_HEAD_DIM>(args, batch, dtype, stream);
}
}  // namespace attn

#else  // ---- the entry points --------------------------------------------------

namespace attn {
#define OPT_ATTN_DECLARE(D) int forward_d##D(const FwdArgs&, int, int, cudaStream_t);
OPT_ATTN_FOR_EACH_D(OPT_ATTN_DECLARE)
#undef OPT_ATTN_DECLARE
}  // namespace attn

namespace {

int forward(const attn::FwdArgs& args, int batch, int head_dim, int dtype, void* stream) {
  if (batch <= 0 || args.S <= 0 || args.H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
#define OPT_ATTN_CASE(D) \
  case D:                \
    return attn::forward_d##D(args, batch, dtype, s);
    OPT_ATTN_FOR_EACH_D(OPT_ATTN_CASE)
#undef OPT_ATTN_CASE
    default:  // no instance: the wrapper refuses other head dims
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// window < 0 means a global layer; cos_t/sin_t may be null (no rotary),
// mask may be null (no key padding) and lse may be null (serving). Strides
// are in elements; the bf16 kernels move 16-byte chunks and write the output
// two values at a time, so every pointer is 16-byte aligned and every stride
// a multiple of 8 (the wrappers check it).
// q, k, v, out: [B, H, S, D] with the (batch, head, row) strides given, in
// elements: three ints each, in that order, in `strides` (q, k, v, out).
extern "C" int opt_flash_attention(const void* q, const void* k, const void* v, const int* mask,
                                   const void* cos_t, const void* sin_t, void* out, float* lse,
                                   int batch, int seq, int heads, int head_dim,
                                   const long long* strides, int window, float scale, int dtype,
                                   void* stream) {
  const void* ptrs[4] = {q, k, v, out};
  attn::Strided t[4];
  for (int i = 0; i < 4; ++i)
    t[i] = attn::Strided{const_cast<void*>(ptrs[i]), strides[3 * i], strides[3 * i + 1],
                         strides[3 * i + 2]};
  const attn::FwdArgs args{t[0], t[1], t[2], t[3], mask, cos_t, sin_t,
                           lse,  seq,  heads, window, scale};
  return forward(args, batch, head_dim, dtype, stream);
}

// How the bf16 kernels of a head dim are built, fixed when the library is
// compiled: out[0] = 1 for wgmma from a shared-memory ring filled by cp.async
// with mbarriers, 0 for mma.sync between two barriers a tile; out[1] = the
// ring's stages (1: a single buffer); out[2] = rows of a CTA's own tile;
// out[3] = rows of a streamed tile; out[4] = with `backward`, rows of the dQ
// pass's own tile (out[1] and out[2] are then the dK/dV pass's), else rows of
// a CTA's own tile in a global layer (out[2]: in a layer with a window).
// Returns 0, or -1 without an instance.
extern "C" int opt_flash_attention_design(int head_dim, int backward, int* out) {
  namespace wg = attn::wg;
  switch (head_dim) {
#define OPT_ATTN_CASE(D)                                                   \
  case D:                                                                  \
    if (backward ? wg::backward_carried<D>() : wg::forward_carried<D>()) { \
      out[0] = 1;                                                          \
      out[1] = wg::STAGES;                                                 \
      out[2] = wg::ROWS * (backward ? wg::DKV_NCONS : wg::FWD_NCONS);      \
      out[4] = wg::ROWS * (backward ? wg::DQ_NCONS : wg::fwd_global_ncons<D>()); \
    } else {                                                               \
      out[0] = 0;                                                          \
      out[1] = 1;                                                          \
      out[2] = backward && D > 128 ? 32 : 64;                              \
      out[4] = 64;                                                         \
    }                                                                      \
    out[3] = 64;                                                           \
    return 0;
    OPT_ATTN_FOR_EACH_D(OPT_ATTN_CASE)
#undef OPT_ATTN_CASE
    default:
      return -1;
  }
}

// The message of a CUDA error code, for the Python wrappers.
extern "C" const char* opt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#endif  // OPT_HEAD_DIM
