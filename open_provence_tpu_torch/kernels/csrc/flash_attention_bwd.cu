// Flash-attention backward: kernel 14 (the packed Wqkv buffer) and kernel
// 16 (separate q, k, v), one set of kernels for both.
//
// Replaces the TPU's one-pass fused backward (ops/flash_attention.py::
// _bwd_fused_kernel_packed / _1out / _3out, bodies _bwd_fused_compute),
// its split form for long sequences (_bwd_dq_kernel_packed,
// _bwd_dkv_kernel_packed) and the unpacked pair (_bwd_dq_kernel,
// _bwd_dkv_kernel). Every operand is [B, H, S, D] read or written through
// (batch, head, row) strides (attention_common.cuh: Strided): q, k, v, the
// forward's out, g = d out cast to the storage type, and the outputs dq, dk,
// dv. opt_flash_attention_bwd takes separate tensors of any strides with a
// unit last stride; the packed buffer is the special case in which q, k, v
// are three offsets into one [B, S, 3*H*D] buffer, out and g are views of
// [B, S, H*D] and dq, dk, dv three offsets into d(qkv) [B, S, 3*H*D].
// Also given: the int key mask [B, S], rope cos/sin [S, D] in
// the storage type (they get no gradient) and the forward's fp32 lse
// [B, H, S]. D is 32, 64, 128 or 256, any head count. Three launches on the
// caller's stream:
//   1. delta = rowsum(g * out) in fp32 per (batch, head, row), into scratch
//      [B, H, S] (the TPU dispatch computes it from g already cast to the
//      storage type, flash_attention.py:695-696, :2338-2350);
//   2. dK, dV: one CTA per (key tile, head, batch) walks the query tiles
//      inside the band (all of them for a global layer), rebuilding the
//      rotated q and k while loading, P = exp(s*scale + bias - lse) and
//      dS = P * (dO.V^T - delta), and accumulates dV += P^T.dO and
//      dK += dS^T.Q in registers;
//   3. dQ: one CTA per (query tile, head, batch) walks the key tiles the
//      other way round and accumulates dQ += dS.K, so no fp32 atomics make
//      the sums depend on scheduling.
// dq and dk are scaled, rounded to the storage type, then put through the
// rope adjoint (g*cos - rotate_half(g*sin), each product rounded, as the TPU
// kernel's _rope_adjoint_mx) before they are written. The masks are the
// forward's (attention_common.cuh): query rows past S get P = 0; a row
// whose keys are all masked has lse = -FLT_MAX and P = 1 for its (masked)
// keys, finite, and its g is 0 wherever the loss ignores the row.
//
// bf16: all five products on tensor cores (mma.sync m16n8k16, fp32
// accumulation), FlashAttention-2 style; P and dS go from the score
// accumulators into the A operand without shared memory, rounded to bf16 as
// the TPU kernel rounds them. A warp owns 16 rows of its CTA's tile, and a
// warp's fp32 accumulators are rows x columns / 32 registers a thread, so the
// tile shape is picked by D at compile time (tc::Shape): up to D = 64 four
// warps hold 16 x D each; past it the D columns of dK and dV (past 128, of
// dQ) are split over 2 or 4 warps that each recompute the 16 x 64 scores,
// and at D = 256 the key tile is 32 rows, so no accumulator set passes 64
// registers. The rounded gradients go through shared memory on their way
// out, where the rope adjoint finds its partner column d +- D/2 whichever
// warp held it. fp32: the same walks with FMA from shared memory (true
// fp32), 64-row tiles, 32 at D = 256 where four 64-row tiles of D + 1 floats
// pass a CTA's 227 KB. Recomputing S and dP in both passes costs 7 S*S*D
// products a head against the TPU kernel's 5 (more where the columns are
// split); tensor-core rate bounds it, and wgmma/TMA are later work. Any S.
#include "attention_common.cuh"

#ifdef OPT_HEAD_DIM  // ---- the kernels of one head dim ------------------------

namespace {

using attn::pack_bf16;
using attn::rope_chunk;
using attn::rope_elem;
using attn::rows_of;
using Args = attn::BwdArgs;

constexpr int OTHER = 64;  // rows of the other side's tiles a pass walks over

// ---- 1. delta -----------------------------------------------------------------

template <typename T, int D>
__global__ void delta_kernel(Args args, int rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);  // over (b, s, h)
  if (row >= rows) return;
  const int h = row % args.H, bs = row / args.H;
  const int s = bs % args.S, b = bs / args.S;
  const T* g = rows_of<const T>(args.g, b, h) + s * args.g.ss;
  const T* o = rows_of<const T>(args.out, b, h) + s * args.out.ss;
  float acc = 0.f;
  for (int d = threadIdx.x & 31; d < D; d += 32) acc += to_f32(g[d]) * to_f32(o[d]);
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) args.delta[((size_t)b * args.H + h) * args.S + s] = acc;
}

// The rope adjoint of element d of a row, given the row's rounded gradient
// at d (gd) and at its partner d +- D/2 (g_other):
// T(T(gd*c) + T(rotT(g*s)[d])), with rotT(y)[d] = y[d + D/2] for d < D/2
// and -y[d - D/2] after.
template <typename T, int D>
__device__ __forceinline__ float rope_adjoint(float gd, float g_other, int d, const T* cos_t,
                                              const T* sin_t, int pos) {
  if (cos_t == nullptr) return gd;
  constexpr int half = D / 2;
  const int other = d < half ? d + half : d - half;
  const float c = to_f32(cos_t[(size_t)pos * D + d]);
  const float s_other = to_f32(sin_t[(size_t)pos * D + other]);
  const float rot = round_to<T>(g_other * s_other);
  return round_to<T>(round_to<T>(gd * c) + (d < half ? rot : -rot));
}

// P and dS of one score: s is the raw q.k, dp = dO.v, kbias the key's bias
// (attn::key_bias: the bf16 kernels read the mask once a key, not once a
// score).
__device__ __forceinline__ void p_ds(float s, float dp, float lse, float delta, float scale,
                                     int qi, int kj, int S, float kbias, int window, float* p,
                                     float* ds) {
  const float pv =
      qi < S ? expf(attn::banded_score(s, scale, qi, kj, kbias, window) - lse) : 0.f;
  *p = pv;
  *ds = pv * (dp - delta);
}

// ---- fp32: FMA ------------------------------------------------------------------
//
// R x R score tiles, 256 threads as 16 x 16, R / 16 rows and columns of the
// scores and R / 16 rows x D / 16 columns of each accumulator a thread.

namespace simt {
constexpr int THREADS = 256;
template <int D>
__host__ __device__ constexpr int tile() { return D <= 128 ? 64 : 32; }
template <int D>
constexpr size_t smem_bytes() {  // 4 row tiles of D + 1, 2 score tiles of R + 1, 2 rows
  constexpr int R = tile<D>();
  return (size_t)(4 * R * (D + 1) + 2 * R * (R + 1) + 2 * R) * sizeof(float);
}
}  // namespace simt

// Rows r0 .. r0+R-1 of a [R][D + 1] tile from an operand's rows of one
// (batch, head), rotated when `rotate`; zeros past S.
template <int D, int R>
__device__ __forceinline__ void load_rows_f32(float* tile, const float* rows, long long ss,
                                              int r0, bool rotate, const Args& args) {
  const float* cos_t = static_cast<const float*>(args.cos_t);
  const float* sin_t = static_cast<const float*>(args.sin_t);
  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D, pos = r0 + r;
    float v = 0.f;
    if (pos < args.S) {
      const float* row = rows + pos * ss;
      v = rotate ? rope_elem<float, D>(row, d, cos_t, sin_t, pos) : row[d];
    }
    tile[r * (D + 1) + d] = v;
  }
}

template <int D>
__global__ void __launch_bounds__(simt::THREADS) dkv_fma_kernel(Args args) {
  constexpr int R = simt::tile<D>(), RI = R / 16, DJ = D / 16, LD = D + 1, LP = R + 1;
  extern __shared__ float smem[];
  float* Ks = smem;          // [R][LD]
  float* Vs = Ks + R * LD;   // [R][LD]
  float* Qs = Vs + R * LD;   // [R][LD]
  float* Gs = Qs + R * LD;   // [R][LD] dO
  float* Ps = Gs + R * LD;   // [keys][LP]
  float* Ds = Ps + R * LP;   // [keys][LP] dS
  float* lse_s = Ds + R * LP;
  float* delta_s = lse_s + R;

  const int S = args.S, H = args.H;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const float* qb = rows_of<const float>(args.q, b, h);
  const float* kb = rows_of<const float>(args.k, b, h);
  const float* vb = rows_of<const float>(args.v, b, h);
  const float* gb = rows_of<const float>(args.g, b, h);
  const float* lse = args.lse + ((size_t)b * H + h) * S;
  const float* delta = args.delta + ((size_t)b * H + h) * S;
  const int* mrow = args.mask == nullptr ? nullptr : args.mask + (size_t)b * S;

  load_rows_f32<D, R>(Ks, kb, args.k.ss, k0, true, args);
  load_rows_f32<D, R>(Vs, vb, args.v.ss, k0, false, args);

  float dk[RI][DJ] = {}, dv[RI][DJ] = {};  // keys ty + 16i, dims tx + 16j
  int q_first, q_last;
  attn::band_range(k0, R, R, S, args.window, &q_first, &q_last);
  for (int q0 = q_first; q0 <= q_last; q0 += R) {
    __syncthreads();  // the previous tile's Qs/Gs/Ps/Ds are consumed
    load_rows_f32<D, R>(Qs, qb, args.q.ss, q0, true, args);
    load_rows_f32<D, R>(Gs, gb, args.g.ss, q0, false, args);
    if (tid < R) {
      lse_s[tid] = q0 + tid < S ? lse[q0 + tid] : 0.f;
      delta_s[tid] = q0 + tid < S ? delta[q0 + tid] : 0.f;
    }
    __syncthreads();
    // S^T and dP^T for keys ty + 16i, queries tx + 16j.
    float s[RI][RI] = {}, dp[RI][RI] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[RI], vv[RI], qv[RI], gv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        kv[i] = Ks[(ty + 16 * i) * LD + d];
        vv[i] = Vs[(ty + 16 * i) * LD + d];
        qv[i] = Qs[(tx + 16 * i) * LD + d];
        gv[i] = Gs[(tx + 16 * i) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int kr = ty + 16 * i, qc = tx + 16 * j;
        float p, ds;
        p_ds(s[i][j], dp[i][j], lse_s[qc], delta_s[qc], args.scale, q0 + qc, k0 + kr, S,
             attn::key_bias(k0 + kr, S, mrow), args.window, &p, &ds);
        Ps[kr * LP + qc] = p;
        Ds[kr * LP + qc] = ds;
      }
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < R; ++q) {
      float gq[DJ], qq[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        gq[j] = Gs[q * LD + tx + 16 * j];
        qq[j] = Qs[q * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = Ps[(ty + 16 * i) * LP + q], ds = Ds[(ty + 16 * i) * LP + q];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv[i][j] = fmaf(p, gq[j], dv[i][j]);
          dk[i][j] = fmaf(ds, qq[j], dk[i][j]);
        }
      }
    }
  }

  const float* cos_t = static_cast<const float*>(args.cos_t);
  const float* sin_t = static_cast<const float*>(args.sin_t);
  float* dkb = rows_of<float>(args.dk, b, h);
  float* dvb = rows_of<float>(args.dv, b, h);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int pos = k0 + ty + 16 * i;
    if (pos >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;  // its rope partner d +- D/2 is column j +- DJ/2
      const float gd = dk[i][j] * args.scale;
      const float go = dk[i][(j + DJ / 2) % DJ] * args.scale;
      dkb[pos * args.dk.ss + d] = rope_adjoint<float, D>(gd, go, d, cos_t, sin_t, pos);
      dvb[pos * args.dv.ss + d] = dv[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(simt::THREADS) dq_fma_kernel(Args args) {
  constexpr int R = simt::tile<D>(), RI = R / 16, DJ = D / 16, LD = D + 1, LP = R + 1;
  extern __shared__ float smem[];
  float* Qs = smem;          // [R][LD]
  float* Gs = Qs + R * LD;   // [R][LD] dO
  float* Ks = Gs + R * LD;   // [R][LD]
  float* Vs = Ks + R * LD;   // [R][LD]
  float* Ds = Vs + R * LD;   // [queries][LP] dS

  const int S = args.S, H = args.H;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const float* qb = rows_of<const float>(args.q, b, h);
  const float* kb = rows_of<const float>(args.k, b, h);
  const float* vb = rows_of<const float>(args.v, b, h);
  const float* gb = rows_of<const float>(args.g, b, h);
  const float* lse = args.lse + ((size_t)b * H + h) * S;
  const float* delta = args.delta + ((size_t)b * H + h) * S;
  const int* mrow = args.mask == nullptr ? nullptr : args.mask + (size_t)b * S;

  load_rows_f32<D, R>(Qs, qb, args.q.ss, q0, true, args);
  load_rows_f32<D, R>(Gs, gb, args.g.ss, q0, false, args);
  float lse_r[RI], delta_r[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int q = q0 + ty + 16 * i;
    lse_r[i] = q < S ? lse[q] : 0.f;
    delta_r[i] = q < S ? delta[q] : 0.f;
  }

  float dq[RI][DJ] = {};  // queries ty + 16i, dims tx + 16j
  int k_first, k_last;
  attn::band_range(q0, R, R, S, args.window, &k_first, &k_last);
  for (int k0 = k_first; k0 <= k_last; k0 += R) {
    __syncthreads();  // the previous tile's Ks/Vs/Ds are consumed
    load_rows_f32<D, R>(Ks, kb, args.k.ss, k0, true, args);
    load_rows_f32<D, R>(Vs, vb, args.v.ss, k0, false, args);
    __syncthreads();
    float s[RI][RI] = {}, dp[RI][RI] = {};  // queries ty + 16i, keys tx + 16j
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], gv[RI], kv[RI], vv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = Qs[(ty + 16 * i) * LD + d];
        gv[i] = Gs[(ty + 16 * i) * LD + d];
        kv[i] = Ks[(tx + 16 * i) * LD + d];
        vv[i] = Vs[(tx + 16 * i) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int qr = ty + 16 * i, kc = tx + 16 * j;
        float p, ds;
        p_ds(s[i][j], dp[i][j], lse_r[i], delta_r[i], args.scale, q0 + qr, k0 + kc, S,
             attn::key_bias(k0 + kc, S, mrow), args.window, &p, &ds);
        Ds[qr * LP + kc] = ds;
      }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < R; ++kk) {
      float kv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float ds = Ds[(ty + 16 * i) * LP + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) dq[i][j] = fmaf(ds, kv[j], dq[i][j]);
      }
    }
  }

  const float* cos_t = static_cast<const float*>(args.cos_t);
  const float* sin_t = static_cast<const float*>(args.sin_t);
  float* dqb = rows_of<float>(args.dq, b, h);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int pos = q0 + ty + 16 * i;
    if (pos >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      const float gd = dq[i][j] * args.scale;
      const float go = dq[i][(j + DJ / 2) % DJ] * args.scale;
      dqb[pos * args.dq.ss + d] = rope_adjoint<float, D>(gd, go, d, cos_t, sin_t, pos);
    }
  }
}

// ---- bf16: mma.sync ---------------------------------------------------------------

namespace tc {
// A pass's CTA: ROWS_W row-warps of 16 rows (its tile) x SPLIT warps that
// each hold D / SPLIT columns of the accumulators.
template <int D>
struct Shape {
  static constexpr int KV_ROWS_W = D <= 128 ? 4 : 2;
  static constexpr int KV_SPLIT = D <= 64 ? 1 : (D <= 128 ? 2 : 4);
  static constexpr int Q_ROWS_W = 4;
  static constexpr int Q_SPLIT = D <= 128 ? 1 : 2;
};
// Own tiles (two of TILE rows), the other side's two of 64 rows, two fp32 rows
// (dK/dV pass: lse and delta of the query tile; dQ pass: the key tile's bias).
template <int D, int TILE>
constexpr size_t smem_bytes() {
  return (size_t)(2 * TILE + 2 * OTHER) * (D + 8) * sizeof(__nv_bfloat16) +
         2 * OTHER * sizeof(float);
}
}  // namespace tc

// Rows r0 .. r0+R-1 of a [R][D + 8] bf16 tile from an operand's rows of one
// (batch, head), 16-byte chunks, rotated when `rotate`; zeros past S.
template <int D, int R>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* tile, const __nv_bfloat16* rows,
                                               long long ss, int r0, bool rotate,
                                               const Args& args) {
  constexpr int LD = D + 8, CH = D / 8;
  const __nv_bfloat16* cos_t = static_cast<const __nv_bfloat16*>(args.cos_t);
  const __nv_bfloat16* sin_t = static_cast<const __nv_bfloat16*>(args.sin_t);
  for (int c = threadIdx.x; c < R * CH; c += blockDim.x) {
    const int r = c / CH, d0 = (c % CH) * 8, pos = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (pos < args.S) {
      const __nv_bfloat16* row = rows + pos * ss;
      v = rotate ? rope_chunk<D>(row, d0, cos_t, sin_t, pos)
                 : *reinterpret_cast<const uint4*>(row + d0);
    }
    *reinterpret_cast<uint4*>(tile + r * LD + d0) = v;
  }
}

// ldmatrix lane addressing (see common.cuh): A operand rows / B operand
// rows read "n-major" (non-trans), and B read transposed from [k][n] rows.
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }

// A warp's 16 rows of a [.][D + 8] tile as A fragments, one per 16 dims.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (*a)[4], const __nv_bfloat16* rows16,
                                             int lane) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c)
    ldmatrix_x4(a[c], rows16 + a_row(lane) * (D + 8) + c * 16 + a_col(lane));
}

// The 16 rows x 64 columns products of one warp: acc[n-tile][4] += A . B^T,
// each accumulator summed over the dim chunks in order. A is the warp's 16
// rows: register fragments `a` (IN_REGS), else read from rows16 in shared
// memory chunk by chunk; B rows (64 of them) come from a [64][LD] tile.
template <int D, bool IN_REGS>
__device__ __forceinline__ void rows_times_tile(float (*acc)[4], const uint32_t (*a)[4],
                                                const __nv_bfloat16* rows16,
                                                const __nv_bfloat16* tile, int lane) {
  constexpr int LD = D + 8, DC = D / 16;
  if constexpr (IN_REGS) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        uint32_t r[4];
        ldmatrix_x4(r, tile + (p * 16 + a_col(lane) + (lane & 7)) * LD + c * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16_16816(acc[2 * p], a[c], r);
        mma_bf16_16816(acc[2 * p + 1], a[c], r + 2);
      }
  } else {
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      uint32_t af[4];
      ldmatrix_x4(af, rows16 + a_row(lane) * LD + c * 16 + a_col(lane));
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t r[4];
        ldmatrix_x4(r, tile + (p * 16 + a_col(lane) + (lane & 7)) * LD + c * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16_16816(acc[2 * p], af, r);
        mma_bf16_16816(acc[2 * p + 1], af, r + 2);
      }
    }
  }
}

// acc[d-tile][4] += P (16 x 64, as A fragments pa[4][4]) . tile (64 rows x DW
// columns starting at `cols`, a pointer into a [64][LD] tile).
template <int LD, int DW>
__device__ __forceinline__ void frag_times_tile(float (*acc)[4], const uint32_t (*pa)[4],
                                                const __nv_bfloat16* cols, int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int q = 0; q < DW / 16; ++q) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, cols + (kc * 16 + a_row(lane)) * LD + q * 16 + a_col(lane));
      mma_bf16_16816(acc[2 * q], pa[kc], r);
      mma_bf16_16816(acc[2 * q + 1], pa[kc], r + 2);
    }
}

// A warp's 16 rows x DW columns of an fp32 accumulator, times mult and
// rounded to bf16, into a [.][LD] staging tile at (its first row, its first
// column). Row g (+8) of the warp holds columns nt*8 + 2t + j.
template <int LD, int DW>
__device__ __forceinline__ void stage_rows_bf16(const float (*acc)[4], float mult,
                                                __nv_bfloat16* at, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < DW / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<__nv_bfloat162*>(at + (g + 8 * i) * LD + nt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nt][2 * i] * mult, acc[nt][2 * i + 1] * mult);
}

// Write R staged rows (rounded gradients, [R][D + 8]) to an output operand's
// rows r0 .. of one (batch, head) in 16-byte chunks, through the rope adjoint
// when `rotate`.
template <int D, int R>
__device__ __forceinline__ void store_staged_bf16(const __nv_bfloat16* staged,
                                                  __nv_bfloat16* rows, long long ss, int r0,
                                                  bool rotate, const Args& args) {
  constexpr int LD = D + 8, CH = D / 8, half = D / 2;
  const __nv_bfloat16* cos_t = static_cast<const __nv_bfloat16*>(args.cos_t);
  const __nv_bfloat16* sin_t = static_cast<const __nv_bfloat16*>(args.sin_t);
  for (int c = threadIdx.x; c < R * CH; c += blockDim.x) {
    const int r = c / CH, d0 = (c % CH) * 8, pos = r0 + r;
    if (pos >= args.S) continue;
    uint4 v = *reinterpret_cast<const uint4*>(staged + r * LD + d0);
    if (rotate) {
      const int other = d0 < half ? d0 + half : d0 - half;
      float gd[8], go[8], out[8];
      unpack8(v, gd);
      unpack8(*reinterpret_cast<const uint4*>(staged + r * LD + other), go);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out[e] = rope_adjoint<__nv_bfloat16, D>(gd[e], go[e], d0 + e, cos_t, sin_t, pos);
      v = pack8(out);  // exact: the adjoint's values are bf16 already
    }
    *reinterpret_cast<uint4*>(rows + pos * ss + d0) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(tc::Shape<D>::KV_ROWS_W * tc::Shape<D>::KV_SPLIT * 32)
    dkv_mma_kernel(Args args) {
  using T = __nv_bfloat16;
  constexpr int ROWS_W = tc::Shape<D>::KV_ROWS_W, SPLIT = tc::Shape<D>::KV_SPLIT;
  constexpr int TILE = 16 * ROWS_W, DW = D / SPLIT, LD = D + 8, DC = D / 16;
  constexpr bool IN_REGS = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [TILE][LD], rotated
  T* Vs = Ks + TILE * LD;                  // [TILE][LD]
  T* Qs = Vs + TILE * LD;                  // [64][LD], rotated; dK on the way out
  T* Gs = Qs + OTHER * LD;                 // [64][LD] dO; dV on the way out
  float* lse_s = reinterpret_cast<float*>(Gs + OTHER * LD);
  float* delta_s = lse_s + OTHER;

  const int S = args.S, H = args.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp % ROWS_W, col0 = (warp / ROWS_W) * DW;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const T* qb = rows_of<const T>(args.q, b, h);
  const T* gb = rows_of<const T>(args.g, b, h);
  const float* lse = args.lse + ((size_t)b * H + h) * S;
  const float* delta = args.delta + ((size_t)b * H + h) * S;
  const int* mrow = args.mask == nullptr ? nullptr : args.mask + (size_t)b * S;

  load_rows_bf16<D, TILE>(Ks, rows_of<const T>(args.k, b, h), args.k.ss, k0, true, args);
  load_rows_bf16<D, TILE>(Vs, rows_of<const T>(args.v, b, h), args.v.ss, k0, false, args);
  __syncthreads();
  // This warp's 16 keys as A operands: K for S^T = K.Q^T, V for dP^T = V.dO^T.
  const T* k16 = Ks + rw * 16 * LD;
  const T* v16 = Vs + rw * 16 * LD;
  uint32_t ka[IN_REGS ? DC : 1][4], va[IN_REGS ? DC : 1][4];
  if constexpr (IN_REGS) {
    load_a_frags<D>(ka, k16, lane);
    load_a_frags<D>(va, v16, lane);
  }

  // This thread's two keys (rows g and g + 8 of the warp's 16) for the whole walk.
  const float kbias[2] = {attn::key_bias(k0 + rw * 16 + g, S, mrow),
                          attn::key_bias(k0 + rw * 16 + g + 8, S, mrow)};
  float dk[DW / 8][4] = {}, dv[DW / 8][4] = {};
  int q_first, q_last;
  attn::band_range(k0, TILE, OTHER, S, args.window, &q_first, &q_last);
  for (int q0 = q_first; q0 <= q_last; q0 += OTHER) {
    __syncthreads();  // every warp is done with the previous Qs/Gs
    load_rows_bf16<D, OTHER>(Qs, qb, args.q.ss, q0, true, args);
    load_rows_bf16<D, OTHER>(Gs, gb, args.g.ss, q0, false, args);
    if (tid < OTHER) {
      lse_s[tid] = q0 + tid < S ? lse[q0 + tid] : 0.f;
      delta_s[tid] = q0 + tid < S ? delta[q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[8][4] = {}, dp[8][4] = {};  // 16 keys x 64 queries
    rows_times_tile<D, IN_REGS>(s, ka, k16, Qs, lane);
    rows_times_tile<D, IN_REGS>(dp, va, v16, Gs, lane);
    // P^T and dS^T straight into A fragments (keys x queries), bf16.
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + rw * 16 + g + 8 * (e >> 1);
        const int qc = nt * 8 + 2 * t + (e & 1);
        p_ds(s[nt][e], dp[nt][e], lse_s[qc], delta_s[qc], args.scale, q0 + qc, kj, S,
             kbias[e >> 1], args.window, &p[e], &ds[e]);
      }
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      da[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      da[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    frag_times_tile<LD, DW>(dv, pa, Gs + col0, lane);  // dV += P^T . dO
    frag_times_tile<LD, DW>(dk, da, Qs + col0, lane);  // dK += dS^T . Q
  }

  __syncthreads();  // every warp is done with Qs/Gs: they stage dK and dV
  stage_rows_bf16<LD, DW>(dk, args.scale, Qs + rw * 16 * LD + col0, lane);
  stage_rows_bf16<LD, DW>(dv, 1.f, Gs + rw * 16 * LD + col0, lane);
  __syncthreads();
  store_staged_bf16<D, TILE>(Qs, rows_of<T>(args.dk, b, h), args.dk.ss, k0,
                             args.cos_t != nullptr, args);
  store_staged_bf16<D, TILE>(Gs, rows_of<T>(args.dv, b, h), args.dv.ss, k0, false, args);
}

template <int D>
__global__ void __launch_bounds__(tc::Shape<D>::Q_ROWS_W * tc::Shape<D>::Q_SPLIT * 32)
    dq_mma_kernel(Args args) {
  using T = __nv_bfloat16;
  constexpr int ROWS_W = tc::Shape<D>::Q_ROWS_W, SPLIT = tc::Shape<D>::Q_SPLIT;
  constexpr int TILE = 16 * ROWS_W, DW = D / SPLIT, LD = D + 8, DC = D / 16;
  constexpr bool IN_REGS = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [TILE][LD], rotated
  T* Gs = Qs + TILE * LD;                  // [TILE][LD] dO
  T* Ks = Gs + TILE * LD;                  // [64][LD], rotated; dQ on the way out
  T* Vs = Ks + OTHER * LD;                 // [64][LD]
  float* kbias = reinterpret_cast<float*>(Vs + OTHER * LD);  // [64]: the key tile's bias

  const int S = args.S, H = args.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp % ROWS_W, col0 = (warp / ROWS_W) * DW;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const T* kb = rows_of<const T>(args.k, b, h);
  const T* vb = rows_of<const T>(args.v, b, h);
  const float* lse = args.lse + ((size_t)b * H + h) * S;
  const float* delta = args.delta + ((size_t)b * H + h) * S;
  const int* mrow = args.mask == nullptr ? nullptr : args.mask + (size_t)b * S;

  load_rows_bf16<D, TILE>(Qs, rows_of<const T>(args.q, b, h), args.q.ss, q0, true, args);
  load_rows_bf16<D, TILE>(Gs, rows_of<const T>(args.g, b, h), args.g.ss, q0, false, args);
  __syncthreads();
  const T* q16 = Qs + rw * 16 * LD;
  const T* g16 = Gs + rw * 16 * LD;
  uint32_t qa[IN_REGS ? DC : 1][4], ga[IN_REGS ? DC : 1][4];
  if constexpr (IN_REGS) {
    load_a_frags<D>(qa, q16, lane);
    load_a_frags<D>(ga, g16, lane);
  }
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + rw * 16 + g + 8 * i;
    lse_r[i] = q < S ? lse[q] : 0.f;
    delta_r[i] = q < S ? delta[q] : 0.f;
  }

  float dq[DW / 8][4] = {};
  int k_first, k_last;
  attn::band_range(q0, TILE, OTHER, S, args.window, &k_first, &k_last);
  for (int k0 = k_first; k0 <= k_last; k0 += OTHER) {
    __syncthreads();  // every warp is done with the previous Ks/Vs
    load_rows_bf16<D, OTHER>(Ks, kb, args.k.ss, k0, true, args);
    load_rows_bf16<D, OTHER>(Vs, vb, args.v.ss, k0, false, args);
    if (tid < OTHER) kbias[tid] = attn::key_bias(k0 + tid, S, mrow);
    __syncthreads();
    float s[8][4] = {}, dp[8][4] = {};  // 16 queries x 64 keys
    rows_times_tile<D, IN_REGS>(s, qa, q16, Ks, lane);
    rows_times_tile<D, IN_REGS>(dp, ga, g16, Vs, lane);
    uint32_t da[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + rw * 16 + g + 8 * (e >> 1);
        const int kc = nt * 8 + 2 * t + (e & 1);
        p_ds(s[nt][e], dp[nt][e], lse_r[e >> 1], delta_r[e >> 1], args.scale, qi, k0 + kc, S,
             kbias[kc], args.window, &p[e], &ds[e]);
      }
      da[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      da[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    frag_times_tile<LD, DW>(dq, da, Ks + col0, lane);  // dQ += dS . K
  }

  __syncthreads();  // every warp is done with Ks: it stages dQ
  stage_rows_bf16<LD, DW>(dq, args.scale, Ks + rw * 16 * LD + col0, lane);
  __syncthreads();
  store_staged_bf16<D, TILE>(Ks, rows_of<T>(args.dq, b, h), args.dq.ss, q0,
                             args.cos_t != nullptr, args);
}

template <typename Kernel>
int launch(Kernel kernel, const Args& args, int batch, int tile, int threads, size_t smem,
           cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((args.S + tile - 1) / tile, args.H, batch);
  kernel<<<grid, threads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int run(const Args& args, int batch, cudaStream_t s) {
  const int rows = batch * args.S * args.H;
  delta_kernel<T, D><<<(rows + 7) / 8, 256, 0, s>>>(args, rows);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if constexpr (sizeof(T) == 4) {
    constexpr int R = simt::tile<D>();
    err = launch(dkv_fma_kernel<D>, args, batch, R, simt::THREADS, simt::smem_bytes<D>(), s);
    if (err != 0) return err;
    return launch(dq_fma_kernel<D>, args, batch, R, simt::THREADS, simt::smem_bytes<D>(), s);
  } else {
    using Shape = tc::Shape<D>;
    constexpr int KV_TILE = 16 * Shape::KV_ROWS_W, Q_TILE = 16 * Shape::Q_ROWS_W;
    err = launch(dkv_mma_kernel<D>, args, batch, KV_TILE, Shape::KV_ROWS_W * Shape::KV_SPLIT * 32,
                 tc::smem_bytes<D, KV_TILE>(), s);
    if (err != 0) return err;
    return launch(dq_mma_kernel<D>, args, batch, Q_TILE, Shape::Q_ROWS_W * Shape::Q_SPLIT * 32,
                  tc::smem_bytes<D, Q_TILE>(), s);
  }
}

}  // namespace

namespace attn {
int OPT_ATTN_CAT(backward_d, OPT_HEAD_DIM)(const BwdArgs& args, int batch, int dtype,
                                            cudaStream_t stream) {
  if (dtype == DTYPE_F32) return run<float, OPT_HEAD_DIM>(args, batch, stream);
  if (dtype == DTYPE_BF16) return run<__nv_bfloat16, OPT_HEAD_DIM>(args, batch, stream);
  return (int)cudaErrorInvalidValue;
}
}  // namespace attn

#else  // ---- the entry points --------------------------------------------------

namespace attn {
#define OPT_ATTN_DECLARE(D) int backward_d##D(const BwdArgs&, int, int, cudaStream_t);
OPT_ATTN_FOR_EACH_D(OPT_ATTN_DECLARE)
#undef OPT_ATTN_DECLARE
}  // namespace attn

namespace {

int backward(const attn::BwdArgs& args, int batch, int head_dim, int dtype, void* stream) {
  if (batch <= 0 || args.S <= 0 || args.H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
#define OPT_ATTN_CASE(D) \
  case D:                \
    return attn::backward_d##D(args, batch, dtype, s);
    OPT_ATTN_FOR_EACH_D(OPT_ATTN_CASE)
#undef OPT_ATTN_CASE
    default:  // no instance: the wrapper refuses other head dims
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// window < 0 means a global layer; cos_t/sin_t may be null (no rotary) and
// mask may be null (no key padding); delta is scratch of batch * heads * seq
// floats.
// q, k, v, out, g, dq, dk, dv: [B, H, S, D] with the (batch, head, row)
// strides given, in elements: three ints each, in that order, in `strides`.
extern "C" int opt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const int* mask, const void* cos_t, const void* sin_t,
                                       const void* out, const float* lse, const void* g,
                                       float* delta, void* dq, void* dk, void* dv, int batch,
                                       int seq, int heads, int head_dim,
                                       const long long* strides, int window, float scale,
                                       int dtype, void* stream) {
  const void* ptrs[8] = {q, k, v, out, g, dq, dk, dv};
  attn::Strided t[8];
  for (int i = 0; i < 8; ++i)
    t[i] = attn::Strided{const_cast<void*>(ptrs[i]), strides[3 * i], strides[3 * i + 1],
                         strides[3 * i + 2]};
  const attn::BwdArgs args{t[0], t[1], t[2], t[3],  t[4], t[5],  t[6],   t[7], mask,
                           cos_t, sin_t, lse, delta, seq,  heads, window, scale};
  return backward(args, batch, head_dim, dtype, stream);
}

#endif  // OPT_HEAD_DIM
