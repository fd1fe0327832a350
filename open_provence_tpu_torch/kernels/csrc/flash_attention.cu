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
// bf16, every head dim (attention_wgmma.cuh has the shared design): a CTA is
// a producer warpgroup, which fills a ring of key tiles in shared memory with
// cp.async and rotates K there one tile ahead of its use, and consumer
// warpgroups of 64 query rows each that meet it only at mbarriers: no load
// sits between two barriers. Both products run on wgmma from the swizzled
// tiles (S = Q.K^T with both operands in shared memory, P from the
// accumulator's registers as the A operand of P.V, V read MN-major). The
// softmax runs in base 2 with scale * log2(e) folded into the score and one
// ex2.approx a score, lse stays in natural log. Key tiles without a valid key
// are not walked. Three consumers a CTA (four in a global layer at D <= 64)
// read K and V a third as often as 64-row CTAs and overlap one's products
// with another's exponentials. At D = 256 a consumer's 64 x 256 output takes
// 128 registers, so a CTA is one consumer beside the producer (255 registers;
// beside two more warpgroups it would have 168), with a two-stage ring, and
// the call rotates K into scratch first (attention_wgmma.cuh: FwdPass,
// rotate_rows), so that a stage carries K and V alone and the producer only
// copies. fp32: the same walk
// with fp32 FMA from shared memory (true fp32), unchanged: it exists for
// parity, no main path runs it.
#include "attention_wgmma.cuh"

#ifdef OPT_HEAD_DIM  // ---- the kernels of one head dim ------------------------

namespace {

using attn::BK;
using attn::BQ;
using attn::biased_score;
using attn::pack_bf16;
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

// ---- bf16 on wgmma: the ring of attention_wgmma.cuh -------------------------------
//
// NCONS consumer warpgroups (attention_wgmma.cuh: FwdPass) own 64 query rows
// each (Q rotated into a swizzled tile once); the producer warpgroup streams
// the key tiles. A consumer's
// tile: S = Q.K^T (both operands in shared memory), the online softmax in
// registers in base 2 (scale * log2(e) folded into the score, one ex2.approx
// a score), P rounded to bf16 in the accumulator's own registers as the A
// operand of O += P.V (V read as an MN-major operand, no transpose; at
// D = 256 two products of 128 columns). A consumer leaves out a key tile that
// lies wholly outside its own rows' band.

namespace wgk {
namespace wg = attn::wg;
template <int D>
__host__ __device__ constexpr int own_bytes() { return wg::fwd_own_bytes<D>(); }
template <int D, bool GLOBAL>
constexpr size_t smem_bytes() {
  using P = wg::FwdPass<D, GLOBAL>;
  return 1024 + P::NCONS * own_bytes<D>() + wg::Ring<D, P::NST, P::TABLES>::BYTES;
}
}  // namespace wgk

template <int D, bool GLOBAL>
__global__ void __launch_bounds__(attn::wg::FwdPass<D, GLOBAL>::THREADS, 1)
    flash_wgmma_kernel(const Args args) {
  namespace wg = attn::wg;
  using T = __nv_bfloat16;
  using P = wg::FwdPass<D, GLOBAL>;
  static_assert(!P::REALLOC, "the forward's warpgroups keep the launch's registers");
  constexpr int NCONS = P::NCONS, NST = P::NST, OWN = wgk::own_bytes<D>();
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
    const wg::RotatedRows rk =
        wg::rotated_rows<D, !P::TABLES>(args.k, args.rot, 0, cos_t, sin_t, b, h, S, args.H);
    wg::Stream st;
    st.rot = rk.rows;
    st.rot_ss = rk.ss;
    st.raw = rows_of<const T>(args.v, b, h);
    st.raw_ss = args.v.ss;
    st.cos_t = rk.cos_t;
    st.sin_t = rk.sin_t;
    st.mrow = args.mask == nullptr ? nullptr : args.mask + (size_t)b * S;
    st.lse = st.delta = nullptr;
    st.S = S;
    attn::band_range(q0, wg::ROWS * NCONS, wg::ROWS, S, args.window, &st.first, &st.last);
    st.own_first = st.own_rows = 0;
    wg::produce<D, NST, true, P::TABLES>(ring, ring_ptr, &ctl, st, t);
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

template <int D, bool GLOBAL>
int launch_wgmma(const Args& args, int batch, cudaStream_t stream) {
  constexpr size_t smem = wgk::smem_bytes<D, GLOBAL>();
  static_assert(smem <= attn::wg::SMEM_LIMIT, "shared memory of a CTA");
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<D, GLOBAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  using P = attn::wg::FwdPass<D, GLOBAL>;
  const int tile = attn::wg::ROWS * P::NCONS;
  const dim3 grid((args.S + tile - 1) / tile, args.H, batch);
  flash_wgmma_kernel<D, GLOBAL><<<grid, P::THREADS, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <int D>
int by_dtype(const Args& args, int batch, int dtype, cudaStream_t stream) {
  if (dtype == DTYPE_F32) {
    constexpr size_t smem = simt::smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_fma_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((args.S + BQ - 1) / BQ, args.H, batch);
    flash_fma_kernel<D><<<grid, simt::THREADS, smem, stream>>>(args);
    return (int)cudaGetLastError();
  }
  if (dtype == DTYPE_BF16) {
    if constexpr (!attn::wg::FwdPass<D, false>::TABLES) {  // K rotated into the scratch first
      if (args.cos_t != nullptr) {
        if (args.rot == nullptr) return (int)cudaErrorInvalidValue;
        const int err = attn::wg::rotate_rows<D>(args.k, args.cos_t, args.sin_t, args.rot, batch,
                                                 args.S, args.H, stream);
        if (err != 0) return err;
      }
    }
    // The layer's kind picks the CTA's shape, not a trial; a head dim whose
    // global layers take the same shape builds one kernel.
    constexpr bool WIDE = attn::wg::FwdPass<D, true>::NCONS != attn::wg::FwdPass<D, false>::NCONS;
    if constexpr (WIDE)
      if (args.window < 0) return launch_wgmma<D, true>(args, batch, stream);
    return launch_wgmma<D, false>(args, batch, stream);
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
// scratch: batch * heads * seq * head_dim elements of the storage type where
// opt_flash_attention_design reports a pre-rotated operand (out[10]), else
// null.
extern "C" int opt_flash_attention(const void* q, const void* k, const void* v, const int* mask,
                                   const void* cos_t, const void* sin_t, void* out, float* lse,
                                   void* scratch, int batch, int seq, int heads, int head_dim,
                                   const long long* strides, int window, float scale, int dtype,
                                   void* stream) {
  const void* ptrs[4] = {q, k, v, out};
  attn::Strided t[4];
  for (int i = 0; i < 4; ++i)
    t[i] = attn::Strided{const_cast<void*>(ptrs[i]), strides[3 * i], strides[3 * i + 1],
                         strides[3 * i + 2]};
  const attn::FwdArgs args{t[0], t[1], t[2],  t[3], mask,   cos_t, sin_t,
                           lse,  scratch, seq, heads, window, scale};
  return forward(args, batch, head_dim, dtype, stream);
}

// How the bf16 kernels of a head dim are built, fixed when the library is
// compiled (every head dim runs wgmma from a shared-memory ring filled by
// cp.async with mbarriers). Forward: out[0] = consumer warpgroups a CTA and
// out[1] = the ring's stages in a layer with a window, out[2] = rows of a
// CTA's own tile there, out[3] = rows of a streamed tile, out[4] = rows of a
// CTA's own tile in a global layer, out[5] = its consumer warpgroups, out[6] =
// its stages, out[7] = 1 where cos/sin are staged in the ring (0: read from
// L2), out[8] = the same in a global layer, out[9] = 0. With `backward`, the
// same fields of the dK/dV pass in out[0..2] and out[7], of the dQ pass in
// out[4..6] and out[8]; out[9] = how the dK/dV pass lays 64 keys on its
// consumers (attention_wgmma.cuh: DkvForm, 0 WHOLE, 1 COLUMNS, 2 ROLES).
// out[10]: how many [B, H, S, D] operands the call rotates into its scratch
// (forward: K; backward: Q and K) when it has rope tables. out[11]: the
// route (attention_wgmma.cuh: ROUTE). Returns 0, or -1 without an instance.
namespace {
template <typename P, typename Q>
void report(int* out, int rows_p, int rows_q, int form, int rotated) {
  const int fields[12] = {P::NCONS, P::NST,    rows_p, attn::wg::ROWS, rows_q,  Q::NCONS,
                          Q::NST,   P::TABLES, Q::TABLES, form,        rotated, attn::wg::ROUTE};
  for (int i = 0; i < 12; ++i) out[i] = fields[i];
}
}  // namespace

extern "C" int opt_flash_attention_design(int head_dim, int backward, int* out) {
  namespace wg = attn::wg;
  switch (head_dim) {
#define OPT_ATTN_CASE(D)                                                                   \
  case D:                                                                                  \
    if (backward)                                                                          \
      report<wg::DkvPass<D>, wg::DqPass<D>>(                                               \
          out, wg::dkv_form<D>() == wg::DkvForm::WHOLE ? wg::ROWS * wg::DkvPass<D>::NCONS \
                                                         : wg::ROWS,                       \
          wg::ROWS * wg::DqPass<D>::NCONS, (int)wg::dkv_form<D>(),                         \
          wg::DqPass<D>::TABLES ? 0 : 2);                                                  \
    else                                                                                   \
      report<wg::FwdPass<D, false>, wg::FwdPass<D, true>>(                                 \
          out, wg::ROWS * wg::FwdPass<D, false>::NCONS, wg::ROWS * wg::FwdPass<D, true>::NCONS, \
          0, wg::FwdPass<D, false>::TABLES ? 0 : 1);                                      \
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
