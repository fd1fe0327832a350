// Flash-attention backward on the packed Wqkv buffer: kernel 14.
//
// Replaces the TPU's one-pass fused backward (ops/flash_attention.py::
// _bwd_fused_kernel_packed / _1out / _3out, bodies _bwd_fused_compute),
// which differ only in how the TPU lays out its outputs. Inputs: qkv
// [B, S, 3*H*D] (through strides), the int key mask [B, S], rope cos/sin
// [S, D] in the storage type, the forward's out [B, S, H*D] and fp32 lse
// [B, H, S], and g = d out [B, S, H*D] cast to the storage type. Output:
// d(qkv) [B, S, 3*H*D], dq/dk/dv in their lanes; the rope tables get no
// gradient. Three launches on the caller's stream:
//   1. delta = rowsum(g * out) in fp32 per (batch, head, row), into scratch
//      [B, H, S] (the TPU dispatch computes it from g already cast to the
//      storage type, flash_attention.py:2338-2350);
//   2. dK, dV: one CTA per (64-key tile, head, batch) walks the query tiles
//      inside the band (all of them for a global layer), rebuilding the
//      rotated q and k while loading, P = exp(s*scale + bias - lse) and
//      dS = P * (dO.V^T - delta), and accumulates dV += P^T.dO and
//      dK += dS^T.Q in registers;
//   3. dQ: one CTA per (64-query tile, head, batch) walks the key tiles the
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
// accumulation), FlashAttention-2 style, 4 warps x 16 rows a CTA; P and dS
// go from the score accumulators into the A operand without shared memory,
// rounded to bf16 as the TPU kernel rounds them. fp32: the same walks with
// FMA from shared memory (true fp32). Recomputing S and dP in both passes
// costs 7 S*S*D products a head against the TPU kernel's 5; tensor-core
// rate bounds it, and wgmma/TMA are later work. Any S.
#include "attention_common.cuh"

namespace {

using attn::BK;
using attn::BQ;
using attn::biased_score;
using attn::pack_bf16;
using attn::rope_chunk;
using attn::rope_elem;

struct Args {
  const void* qkv;
  const int* mask;
  const void* cos_t;
  const void* sin_t;
  const void* out;    // [B, S, H*D]
  const float* lse;   // [B, H, S]
  const void* g;      // [B, S, H*D]
  float* delta;       // [B, H, S] scratch
  void* dqkv;         // [B, S, 3*H*D], contiguous
  int S, H;
  long long stride_b, stride_s;  // of qkv
  int window;
  float scale;
};

// ---- 1. delta -----------------------------------------------------------------

template <typename T, int D>
__global__ void delta_kernel(Args args, int rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);  // over (b, s, h)
  if (row >= rows) return;
  const int h = row % args.H, bs = row / args.H;
  const int s = bs % args.S, b = bs / args.S;
  const size_t off = (size_t)bs * args.H * D + (size_t)h * D;
  const T* g = static_cast<const T*>(args.g) + off;
  const T* o = static_cast<const T*>(args.out) + off;
  float acc = 0.f;
  for (int d = threadIdx.x & 31; d < D; d += 32) acc += to_f32(g[d]) * to_f32(o[d]);
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) args.delta[((size_t)b * args.H + h) * args.S + s] = acc;
}

// The rope adjoint of element d of a row, given the row's rounded gradient
// in gr (indexable by d and d +- D/2): T(T(gr[d]*c) + T(rotT(gr*s)[d])),
// with rotT(y)[d] = y[d + D/2] for d < D/2 and -y[d - D/2] after.
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

// P and dS of one score: s is the raw q.k, dp = dO.v.
__device__ __forceinline__ void p_ds(float s, float dp, float lse, float delta, float scale,
                                     int qi, int kj, int S, const int* mrow, int window, float* p,
                                     float* ds) {
  const float pv = qi < S ? expf(biased_score(s, scale, qi, kj, S, mrow, window) - lse) : 0.f;
  *p = pv;
  *ds = pv * (dp - delta);
}

// ---- fp32: FMA ------------------------------------------------------------------

namespace simt {
constexpr int THREADS = 256;
template <int D>
constexpr size_t smem_bytes() {  // 4 row tiles of D + 1, 2 score tiles of 65, 2 rows
  return (size_t)(4 * 64 * (D + 1) + 2 * 64 * 65 + 2 * 64) * sizeof(float);
}
}  // namespace simt

// Rows r of a [64][D + 1] tile from the packed buffer at lane offset `lane_off`
// (q: h*D, k: H*D + h*D, v: 2*H*D + h*D), rotated when `rotate`; zeros past S.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* tile, const float* base, int r0,
                                              int lane_off, bool rotate, const Args& args) {
  const float* cos_t = static_cast<const float*>(args.cos_t);
  const float* sin_t = static_cast<const float*>(args.sin_t);
  for (int idx = threadIdx.x; idx < 64 * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D, pos = r0 + r;
    float v = 0.f;
    if (pos < args.S) {
      const float* row = base + pos * args.stride_s + lane_off;
      v = rotate ? rope_elem<float, D>(row, d, cos_t, sin_t, pos) : row[d];
    }
    tile[r * (D + 1) + d] = v;
  }
}

template <int D>
__device__ __forceinline__ void load_g_f32(float* tile, const float* g, int r0, int h,
                                           const Args& args) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D, pos = r0 + r;
    tile[r * (D + 1) + d] = pos < args.S ? g[(size_t)pos * args.H * D + h * D + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(simt::THREADS) dkv_fma_kernel(Args args) {
  constexpr int DJ = D / 16, LD = D + 1;
  extern __shared__ float smem[];
  float* Ks = smem;            // [64][LD]
  float* Vs = Ks + 64 * LD;    // [64][LD]
  float* Qs = Vs + 64 * LD;    // [64][LD]
  float* Gs = Qs + 64 * LD;    // [64][LD] dO
  float* Ps = Gs + 64 * LD;    // [keys][65]
  float* Ds = Ps + 64 * 65;    // [keys][65] dS
  float* lse_s = Ds + 64 * 65;
  float* delta_s = lse_s + 64;

  const int S = args.S, H = args.H, HD = H * D;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const float* base = static_cast<const float*>(args.qkv) + (size_t)b * args.stride_b;
  const float* g = static_cast<const float*>(args.g) + (size_t)b * S * HD;
  const float* lse = args.lse + ((size_t)b * H + h) * S;
  const float* delta = args.delta + ((size_t)b * H + h) * S;
  const int* mrow = args.mask == nullptr ? nullptr : args.mask + (size_t)b * S;

  load_rows_f32<D>(Ks, base, k0, HD + h * D, true, args);
  load_rows_f32<D>(Vs, base, k0, 2 * HD + h * D, false, args);

  float dk[4][DJ] = {}, dv[4][DJ] = {};  // keys ty + 16i, dims tx + 16j
  int q_first, q_last;
  attn::band_range(k0, BK, BQ, S, args.window, &q_first, &q_last);
  for (int q0 = q_first; q0 <= q_last; q0 += BQ) {
    __syncthreads();  // the previous tile's Qs/Gs/Ps/Ds are consumed
    load_rows_f32<D>(Qs, base, q0, h * D, true, args);
    load_g_f32<D>(Gs, g, q0, h, args);
    if (tid < 64) {
      lse_s[tid] = q0 + tid < S ? lse[q0 + tid] : 0.f;
      delta_s[tid] = q0 + tid < S ? delta[q0 + tid] : 0.f;
    }
    __syncthreads();
    // S^T and dP^T for keys ty + 16i, queries tx + 16j.
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty + 16 * i) * LD + d];
        vv[i] = Vs[(ty + 16 * i) * LD + d];
        qv[i] = Qs[(tx + 16 * i) * LD + d];
        gv[i] = Gs[(tx + 16 * i) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = ty + 16 * i, qc = tx + 16 * j;
        float p, ds;
        p_ds(s[i][j], dp[i][j], lse_s[qc], delta_s[qc], args.scale, q0 + qc, k0 + kr, S, mrow,
             args.window, &p, &ds);
        Ps[kr * 65 + qc] = p;
        Ds[kr * 65 + qc] = ds;
      }
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < 64; ++q) {
      float gq[DJ], qq[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        gq[j] = Gs[q * LD + tx + 16 * j];
        qq[j] = Qs[q * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * 65 + q], ds = Ds[(ty + 16 * i) * 65 + q];
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
  float* dqkv = static_cast<float*>(args.dqkv) + (size_t)b * S * 3 * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = k0 + ty + 16 * i;
    if (pos >= S) continue;
    float* row = dqkv + (size_t)pos * 3 * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;  // its rope partner d +- D/2 is column j +- DJ/2
      const float gd = dk[i][j] * args.scale;
      const float go = dk[i][(j + DJ / 2) % DJ] * args.scale;
      row[HD + h * D + d] = rope_adjoint<float, D>(gd, go, d, cos_t, sin_t, pos);
      row[2 * HD + h * D + d] = dv[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(simt::THREADS) dq_fma_kernel(Args args) {
  constexpr int DJ = D / 16, LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;            // [64][LD]
  float* Gs = Qs + 64 * LD;    // [64][LD] dO
  float* Ks = Gs + 64 * LD;    // [64][LD]
  float* Vs = Ks + 64 * LD;    // [64][LD]
  float* Ds = Vs + 64 * LD;    // [queries][65] dS

  const int S = args.S, H = args.H, HD = H * D;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* base = static_cast<const float*>(args.qkv) + (size_t)b * args.stride_b;
  const float* g = static_cast<const float*>(args.g) + (size_t)b * S * HD;
  const float* lse = args.lse + ((size_t)b * H + h) * S;
  const float* delta = args.delta + ((size_t)b * H + h) * S;
  const int* mrow = args.mask == nullptr ? nullptr : args.mask + (size_t)b * S;

  load_rows_f32<D>(Qs, base, q0, h * D, true, args);
  load_g_f32<D>(Gs, g, q0, h, args);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    lse_r[i] = q < S ? lse[q] : 0.f;
    delta_r[i] = q < S ? delta[q] : 0.f;
  }

  float dq[4][DJ] = {};  // queries ty + 16i, dims tx + 16j
  int k_first, k_last;
  attn::band_range(q0, BQ, BK, S, args.window, &k_first, &k_last);
  for (int k0 = k_first; k0 <= k_last; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ds are consumed
    load_rows_f32<D>(Ks, base, k0, HD + h * D, true, args);
    load_rows_f32<D>(Vs, base, k0, 2 * HD + h * D, false, args);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};  // queries ty + 16i, keys tx + 16j
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * LD + d];
        gv[i] = Gs[(ty + 16 * i) * LD + d];
        kv[i] = Ks[(tx + 16 * i) * LD + d];
        vv[i] = Vs[(tx + 16 * i) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = ty + 16 * i, kc = tx + 16 * j;
        float p, ds;
        p_ds(s[i][j], dp[i][j], lse_r[i], delta_r[i], args.scale, q0 + qr, k0 + kc, S, mrow,
             args.window, &p, &ds);
        Ds[qr * 65 + kc] = ds;
      }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < 64; ++kk) {
      float kv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = Ds[(ty + 16 * i) * 65 + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) dq[i][j] = fmaf(ds, kv[j], dq[i][j]);
      }
    }
  }

  const float* cos_t = static_cast<const float*>(args.cos_t);
  const float* sin_t = static_cast<const float*>(args.sin_t);
  float* dqkv = static_cast<float*>(args.dqkv) + (size_t)b * S * 3 * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = q0 + ty + 16 * i;
    if (pos >= S) continue;
    float* row = dqkv + (size_t)pos * 3 * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      const float gd = dq[i][j] * args.scale;
      const float go = dq[i][(j + DJ / 2) % DJ] * args.scale;
      row[h * D + d] = rope_adjoint<float, D>(gd, go, d, cos_t, sin_t, pos);
    }
  }
}

// ---- bf16: mma.sync ---------------------------------------------------------------

namespace tc {
constexpr int THREADS = 128;  // 4 warps x 16 rows
template <int D>
constexpr size_t smem_bytes() {  // four [64][D + 8] bf16 tiles, two fp32 rows
  return (size_t)4 * 64 * (D + 8) * sizeof(__nv_bfloat16) + 2 * 64 * sizeof(float);
}
}  // namespace tc

// Rows r0 .. r0+63 of a [64][D + 8] bf16 tile from the packed buffer, 16-byte
// chunks, rotated when `rotate`; zeros past S.
template <int D>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                               int r0, int lane_off, bool rotate,
                                               const Args& args) {
  constexpr int LD = D + 8, CH = D / 8;
  const __nv_bfloat16* cos_t = static_cast<const __nv_bfloat16*>(args.cos_t);
  const __nv_bfloat16* sin_t = static_cast<const __nv_bfloat16*>(args.sin_t);
  for (int c = threadIdx.x; c < 64 * CH; c += blockDim.x) {
    const int r = c / CH, d0 = (c % CH) * 8, pos = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (pos < args.S) {
      const __nv_bfloat16* row = base + pos * args.stride_s + lane_off;
      v = rotate ? rope_chunk<D>(row, d0, cos_t, sin_t, pos)
                 : *reinterpret_cast<const uint4*>(row + d0);
    }
    *reinterpret_cast<uint4*>(tile + r * LD + d0) = v;
  }
}

// dO rows r0 .. r0+63 of head h, from g [S, H*D] of one batch row.
template <int D>
__device__ __forceinline__ void load_g_bf16(__nv_bfloat16* tile, const __nv_bfloat16* g, int r0,
                                            int h, const Args& args) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int c = threadIdx.x; c < 64 * CH; c += blockDim.x) {
    const int r = c / CH, d0 = (c % CH) * 8, pos = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (pos < args.S)
      v = *reinterpret_cast<const uint4*>(g + (size_t)pos * args.H * D + h * D + d0);
    *reinterpret_cast<uint4*>(tile + r * LD + d0) = v;
  }
}

// ldmatrix lane addressing (see common.cuh): A operand rows / B operand
// rows read "n-major" (non-trans), and B read transposed from [k][n] rows.
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }

// The 16 rows x 64 columns products of one warp: s[n-tile][4] += A . B^T,
// A from register fragments (DC k-chunks), B rows (64 of them) from a
// [64][LD] tile.
template <int D>
__device__ __forceinline__ void rows_times_tile(float (*acc)[4], const uint32_t (*a)[4],
                                                const __nv_bfloat16* tile, int lane) {
  constexpr int LD = D + 8, DC = D / 16;
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
}

// out[d-tile][4] += P (16 x 64, as A fragments pa[4][4]) . tile (64 x D).
template <int D>
__device__ __forceinline__ void frag_times_tile(float (*acc)[4], const uint32_t (*pa)[4],
                                                const __nv_bfloat16* tile, int lane) {
  constexpr int LD = D + 8, DC = D / 16;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int q = 0; q < DC; ++q) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, tile + (kc * 16 + a_row(lane)) * LD + q * 16 + a_col(lane));
      mma_bf16_16816(acc[2 * q], pa[kc], r);
      mma_bf16_16816(acc[2 * q + 1], pa[kc], r + 2);
    }
}

// Write a warp's 16 rows x D of an fp32 accumulator into the dqkv lanes at
// lane_off: scaled, rounded to bf16, and rope-adjoint when `rotate`. Row
// g (+8) of the warp holds columns nt*8 + 2t + j; a column's rope partner
// d +- D/2 is n-tile nt +- D/16 of the same thread.
template <int D>
__device__ __forceinline__ void store_rows_bf16(const float (*acc)[4], float mult, int r0,
                                                int lane_off, bool rotate, const Args& args,
                                                __nv_bfloat16* dqkv_b, int lane) {
  constexpr int NT = D / 8;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* cos_t = static_cast<const __nv_bfloat16*>(args.cos_t);
  const __nv_bfloat16* sin_t = static_cast<const __nv_bfloat16*>(args.sin_t);
  const int HD3 = 3 * args.H * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = r0 + g + 8 * i;
    if (pos >= args.S) continue;
    __nv_bfloat16* row = dqkv_b + (size_t)pos * HD3 + lane_off;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = nt * 8 + 2 * t + j;
        const float gd = round_to<__nv_bfloat16>(acc[nt][2 * i + j] * mult);
        if (rotate) {
          const float go =
              round_to<__nv_bfloat16>(acc[(nt + NT / 2) % NT][2 * i + j] * mult);
          v[j] = rope_adjoint<__nv_bfloat16, D>(gd, go, d, cos_t, sin_t, pos);
        } else {
          v[j] = gd;
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(row + nt * 8 + 2 * t) = __floats2bfloat162_rn(v[0], v[1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(tc::THREADS) dkv_mma_kernel(Args args) {
  using T = __nv_bfloat16;
  constexpr int LD = D + 8, DC = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [64][LD], rotated
  T* Vs = Ks + 64 * LD;
  T* Qs = Vs + 64 * LD;  // rotated
  T* Gs = Qs + 64 * LD;  // dO
  float* lse_s = reinterpret_cast<float*>(Gs + 64 * LD);
  float* delta_s = lse_s + 64;

  const int S = args.S, H = args.H, HD = H * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const T* base = static_cast<const T*>(args.qkv) + (size_t)b * args.stride_b;
  const T* gb = static_cast<const T*>(args.g) + (size_t)b * S * HD;
  const float* lse = args.lse + ((size_t)b * H + h) * S;
  const float* delta = args.delta + ((size_t)b * H + h) * S;
  const int* mrow = args.mask == nullptr ? nullptr : args.mask + (size_t)b * S;

  load_rows_bf16<D>(Ks, base, k0, HD + h * D, true, args);
  load_rows_bf16<D>(Vs, base, k0, 2 * HD + h * D, false, args);
  __syncthreads();
  // This warp's 16 keys as A fragments: K for S^T = K.Q^T, V for dP^T = V.dO^T.
  uint32_t ka[DC][4], va[DC][4];
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    ldmatrix_x4(ka[c], Ks + (warp * 16 + a_row(lane)) * LD + c * 16 + a_col(lane));
    ldmatrix_x4(va[c], Vs + (warp * 16 + a_row(lane)) * LD + c * 16 + a_col(lane));
  }

  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  int q_first, q_last;
  attn::band_range(k0, BK, BQ, S, args.window, &q_first, &q_last);
  for (int q0 = q_first; q0 <= q_last; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous Qs/Gs
    load_rows_bf16<D>(Qs, base, q0, h * D, true, args);
    load_g_bf16<D>(Gs, gb, q0, h, args);
    if (tid < 64) {
      lse_s[tid] = q0 + tid < S ? lse[q0 + tid] : 0.f;
      delta_s[tid] = q0 + tid < S ? delta[q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[8][4] = {}, dp[8][4] = {};  // 16 keys x 64 queries
    rows_times_tile<D>(s, ka, Qs, lane);
    rows_times_tile<D>(dp, va, Gs, lane);
    // P^T and dS^T straight into A fragments (keys x queries), bf16.
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + warp * 16 + g + 8 * (e >> 1);
        const int qc = nt * 8 + 2 * t + (e & 1);
        p_ds(s[nt][e], dp[nt][e], lse_s[qc], delta_s[qc], args.scale, q0 + qc, kj, S, mrow,
             args.window, &p[e], &ds[e]);
      }
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      da[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      da[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    frag_times_tile<D>(dv, pa, Gs, lane);  // dV += P^T . dO
    frag_times_tile<D>(dk, da, Qs, lane);  // dK += dS^T . Q
  }

  T* dqkv_b = static_cast<T*>(args.dqkv) + (size_t)b * S * 3 * HD;
  store_rows_bf16<D>(dk, args.scale, k0 + warp * 16, HD + h * D, args.cos_t != nullptr, args,
                     dqkv_b, lane);
  store_rows_bf16<D>(dv, 1.f, k0 + warp * 16, 2 * HD + h * D, false, args, dqkv_b, lane);
}

template <int D>
__global__ void __launch_bounds__(tc::THREADS) dq_mma_kernel(Args args) {
  using T = __nv_bfloat16;
  constexpr int LD = D + 8, DC = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [64][LD], rotated
  T* Gs = Qs + 64 * LD;                    // dO
  T* Ks = Gs + 64 * LD;                    // rotated
  T* Vs = Ks + 64 * LD;

  const int S = args.S, H = args.H, HD = H * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const T* base = static_cast<const T*>(args.qkv) + (size_t)b * args.stride_b;
  const T* gb = static_cast<const T*>(args.g) + (size_t)b * S * HD;
  const float* lse = args.lse + ((size_t)b * H + h) * S;
  const float* delta = args.delta + ((size_t)b * H + h) * S;
  const int* mrow = args.mask == nullptr ? nullptr : args.mask + (size_t)b * S;

  load_rows_bf16<D>(Qs, base, q0, h * D, true, args);
  load_g_bf16<D>(Gs, gb, q0, h, args);
  __syncthreads();
  uint32_t qa[DC][4], ga[DC][4];
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    ldmatrix_x4(qa[c], Qs + (warp * 16 + a_row(lane)) * LD + c * 16 + a_col(lane));
    ldmatrix_x4(ga[c], Gs + (warp * 16 + a_row(lane)) * LD + c * 16 + a_col(lane));
  }
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + warp * 16 + g + 8 * i;
    lse_r[i] = q < S ? lse[q] : 0.f;
    delta_r[i] = q < S ? delta[q] : 0.f;
  }

  float dq[D / 8][4] = {};
  int k_first, k_last;
  attn::band_range(q0, BQ, BK, S, args.window, &k_first, &k_last);
  for (int k0 = k_first; k0 <= k_last; k0 += BK) {
    __syncthreads();  // every warp is done with the previous Ks/Vs
    load_rows_bf16<D>(Ks, base, k0, HD + h * D, true, args);
    load_rows_bf16<D>(Vs, base, k0, 2 * HD + h * D, false, args);
    __syncthreads();
    float s[8][4] = {}, dp[8][4] = {};  // 16 queries x 64 keys
    rows_times_tile<D>(s, qa, Ks, lane);
    rows_times_tile<D>(dp, ga, Vs, lane);
    uint32_t da[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + warp * 16 + g + 8 * (e >> 1);
        const int kj = k0 + nt * 8 + 2 * t + (e & 1);
        p_ds(s[nt][e], dp[nt][e], lse_r[e >> 1], delta_r[e >> 1], args.scale, qi, kj, S, mrow,
             args.window, &p[e], &ds[e]);
      }
      da[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      da[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    frag_times_tile<D>(dq, da, Ks, lane);  // dQ += dS . K
  }

  T* dqkv_b = static_cast<T*>(args.dqkv) + (size_t)b * S * 3 * HD;
  store_rows_bf16<D>(dq, args.scale, q0 + warp * 16, h * D, args.cos_t != nullptr, args, dqkv_b,
                     lane);
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
    err = launch(dkv_fma_kernel<D>, args, batch, BK, simt::THREADS, simt::smem_bytes<D>(), s);
    if (err != 0) return err;
    return launch(dq_fma_kernel<D>, args, batch, BQ, simt::THREADS, simt::smem_bytes<D>(), s);
  } else {
    err = launch(dkv_mma_kernel<D>, args, batch, BK, tc::THREADS, tc::smem_bytes<D>(), s);
    if (err != 0) return err;
    return launch(dq_mma_kernel<D>, args, batch, BQ, tc::THREADS, tc::smem_bytes<D>(), s);
  }
}

}  // namespace

// window < 0 means a global layer; cos_t/sin_t may be null (no rotary) and
// mask may be null (no key padding). qkv strides are in elements; out, g and
// dqkv are contiguous; delta is scratch of batch * heads * seq floats.
extern "C" int opt_flash_attention_packed_bwd(const void* qkv, const int* mask, const void* cos_t,
                                              const void* sin_t, const void* out,
                                              const float* lse, const void* g, float* delta,
                                              void* dqkv, int batch, int seq, int heads,
                                              int head_dim, long long stride_b,
                                              long long stride_s, int window, float scale,
                                              int dtype, void* stream) {
  if (batch <= 0 || seq <= 0) return 0;
  const Args args{qkv, mask, cos_t, sin_t, out, lse, g, delta, dqkv,
                  seq, heads, stride_b, stride_s, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != 64) return (int)cudaErrorInvalidValue;  // the wrapper refuses others
  if (dtype == DTYPE_F32) return run<float, 64>(args, batch, s);
  if (dtype == DTYPE_BF16) return run<__nv_bfloat16, 64>(args, batch, s);
  return (int)cudaErrorInvalidValue;
}
