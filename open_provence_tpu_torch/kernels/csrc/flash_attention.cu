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
// bf16 (the serving dtype): both products on tensor cores (mma.sync
// m16n8k16, fp32 accumulation), FlashAttention-2 style: each of 4 warps owns
// 16 query rows and keeps its scores, softmax state and output accumulator
// in registers; P goes from the score accumulators to the P.V operand
// without touching shared memory. fp32: the same walk with fp32 FMA from
// shared memory (true fp32). The work is 4*S*S*D FLOPs a head for global
// layers, so the tensor-core rate bounds it; overlapping the K/V loads
// (cp.async/TMA) and wgmma are later work. A warp's 16 x D fp32 output is
// D/2 registers a thread; past D = 128 the Q fragments are read from shared
// memory at each key tile instead of living in D/4 more registers.
#include "attention_common.cuh"

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
  // column +8 for lanes 16-31 (A operand order).
  const int qrow = warp * 16 + g;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  constexpr bool Q_IN_REGS = D <= 128;
  uint32_t qa[Q_IN_REGS ? DC : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ldmatrix_x4(qa[c], Qs + (warp * 16 + a_row) * LD + c * 16 + a_col);
  }

  float o[2 * DC][4] = {};
  float m_run[2] = {OPT_NEG_BIG, OPT_NEG_BIG}, l_run[2] = {0.f, 0.f};

  int k_first, k_last;
  attn::band_range(q0, BQ, BK, S, args.window, &k_first, &k_last);
  for (int k0 = k_first; k0 <= k_last; k0 += BK) {
    __syncthreads();  // every warp is done with the previous Ks/Vs
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
    if constexpr (Q_IN_REGS) {
#pragma unroll
      for (int p = 0; p < KN / 2; ++p) {
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          uint32_t r[4];
          ldmatrix_x4(r, Ks + (p * 16 + a_col + (lane & 7)) * LD + c * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16_16816(s[2 * p], qa[c], r);
          mma_bf16_16816(s[2 * p + 1], qa[c], r + 2);
        }
      }
    } else {  // one Q fragment at a time, read where it is needed
#pragma unroll
      for (int c = 0; c < DC; ++c) {
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
      alpha[i] = expf(m_run[i] - m_new[i]);
    }
    // P straight from the score accumulators into the A operand of P.V,
    // rounded to bf16: key tile nt fills half of key chunk nt / 2.
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < KN; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[nt][e] - m_new[e >> 1]);
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
    if (args.lse != nullptr && t == 0)
      args.lse[((size_t)b * args.H + h) * S + pos] = m_run[i] + logf(l_run[i]);
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
  if (dtype == DTYPE_BF16)
    return launch(flash_mma_kernel<D>, args, batch, tc::THREADS, tc::smem_bytes<D>(), stream);
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

// The message of a CUDA error code, for the Python wrappers.
extern "C" const char* opt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#endif  // OPT_HEAD_DIM
