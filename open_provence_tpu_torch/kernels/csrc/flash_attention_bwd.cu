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
// caller's stream (two where wgmma carries the head dim: delta is made in the
// dQ pass, which then runs before the dK/dV pass):
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
// What bounds it on this card: by the shapes, bytes at S = 512 and operations
// (10*S*S*D a head for the five products; seven are computed, S and dP in
// both passes, since one pass would need fp32 atomics or an S/64-fold fp32
// scratch for dQ and the trainer's bit-exact resume needs sums in a fixed
// order); in practice latency, as in the forward (flash_attention.cu).
//
// bf16, every head dim (attention_wgmma.cuh has the shared design): both
// passes run on wgmma from a ring of tiles filled by a producer warpgroup with
// cp.async, rotated in shared memory one tile ahead, handed over at
// mbarriers. The dQ pass runs first (consumer warpgroups of 64 queries; Q
// rotated and dO are the A operands of S = Q.K^T and dP = dO.V^T; dS goes
// from the accumulators' registers into dQ += dS.K, K read MN-major); its
// prologue computes delta = rowsum(dO * out) while it loads dO and writes it
// for the dK/dV pass (S^T = K.Q^T, dP^T = V.dO^T, then dV += P^T.dO and
// dK += dS^T.Q with the streamed query tiles read MN-major: two consumer
// warpgroups of 64 keys each up to D = 64; past it two 64 x D accumulators
// beside S^T and dP^T pass the registers a thread has, so at D = 128 one pair
// of warpgroups on 64 keys splits the D columns (one makes P^T, the other
// dP^T and dS^T, and they hand them over through shared memory) and at
// D = 256 a CTA of one warpgroup makes dV or dK of its 64 keys). Past D = 64
// the call first rotates Q and K into scratch, which both passes stream.
// P = 2^(s * scale * log2(e) + bias - lse * log2(e)), one ex2.approx a score.
// Key tiles without a valid key are not walked (dQ) or get zeros (dK/dV). The
// rounded gradients go through shared memory on their way out, where the rope
// adjoint finds its partner column d +- D/2. How many consumers, stages and
// registers each pass takes at each D: attention_wgmma.cuh (DqPass, DkvPass,
// DkvForm).
// fp32: the same walks with FMA from shared memory (true fp32), 64-row tiles,
// 32 at D = 256 where four 64-row tiles of D + 1 floats pass a CTA's 227 KB;
// unchanged. Any S.
#include "attention_wgmma.cuh"

#ifdef OPT_HEAD_DIM  // ---- the kernels of one head dim ------------------------

namespace {

using attn::pack_bf16;
using attn::rope_elem;
using attn::rows_of;
using Args = attn::BwdArgs;

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

// P and dS of one score (the fp32 kernels): s is the raw q.k, dp = dO.v,
// kbias the key's bias (attn::key_bias).
__device__ __forceinline__ void p_ds(float s, float dp, float lse, float delta, float scale,
                                     int qi, int kj, int S, float kbias, int window, float* p,
                                     float* ds) {
  const float x = attn::banded_score(s, scale, qi, kj, kbias, window) - lse;
  const float pv = qi < S ? expf(x) : 0.f;
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

// ---- bf16 ----------------------------------------------------------------------

// Write R staged rows (rounded gradients, [R][D + 8]) to an output operand's
// rows r0 .. of one (batch, head) in 16-byte chunks, through the rope adjoint
// when `rotate`; by `step` threads, of which this is number t. Past D = 64 a
// thread takes BATCH chunks at once (four, eight past D = 128) and issues all
// their loads before its first store, which the compiler would otherwise have
// to assume aliases a later load and wait out one by one; their cos and
// partner sin words are read 16 bytes at a time (the values rope_adjoint
// reads one by one).
template <int D, int R>
__device__ __forceinline__ void store_staged_bf16(const __nv_bfloat16* staged,
                                                  __nv_bfloat16* rows, long long ss, int r0,
                                                  bool rotate, const Args& args, int t, int step) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + 8, CH = D / 8, half = D / 2;
  const bf16* cos_t = static_cast<const bf16*>(args.cos_t);
  const bf16* sin_t = static_cast<const bf16*>(args.sin_t);
  if constexpr (D <= 64) {
    for (int c = t; c < R * CH; c += step) {
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
          out[e] = rope_adjoint<bf16, D>(gd[e], go[e], d0 + e, cos_t, sin_t, pos);
        v = pack8(out);  // exact: the adjoint's values are bf16 already
      }
      *reinterpret_cast<uint4*>(rows + pos * ss + d0) = v;
    }
  } else {
    constexpr int BATCH = D > 128 ? 8 : 4;
    for (int c0 = t; c0 < R * CH; c0 += BATCH * step) {
      uint4 v[BATCH], partner[BATCH], cs[BATCH], sn[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int c = c0 + i * step, r = c / CH, d0 = (c % CH) * 8, pos = r0 + r;
        if (c >= R * CH || pos >= args.S) continue;
        v[i] = *reinterpret_cast<const uint4*>(staged + r * LD + d0);
        if (rotate) {
          const int other = d0 < half ? d0 + half : d0 - half;
          partner[i] = *reinterpret_cast<const uint4*>(staged + r * LD + other);
          cs[i] = *reinterpret_cast<const uint4*>(cos_t + (size_t)pos * D + d0);
          sn[i] = *reinterpret_cast<const uint4*>(sin_t + (size_t)pos * D + other);
        }
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int c = c0 + i * step, r = c / CH, d0 = (c % CH) * 8, pos = r0 + r;
        if (c >= R * CH || pos >= args.S) continue;
        if (rotate) {
          float gd[8], go[8], cf[8], sf[8], out[8];
          unpack8(v[i], gd);
          unpack8(partner[i], go);
          unpack8(cs[i], cf);
          unpack8(sn[i], sf);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float rot = round_to<bf16>(go[e] * sf[e]);
            out[e] = round_to<bf16>(round_to<bf16>(gd[e] * cf[e]) + (d0 < half ? rot : -rot));
          }
          v[i] = pack8(out);
        }
        *reinterpret_cast<uint4*>(rows + pos * ss + d0) = v[i];
      }
    }
  }
}

// ---- bf16 on wgmma: the ring of attention_wgmma.cuh -------------------------------
//
// Both passes keep their walks. dK/dV: a consumer warpgroup owns 64 keys (K
// rotated and V in swizzled tiles, the A operands of S^T = K.Q^T and
// dP^T = V.dO^T); the producer streams query tiles (Q rotated, dO, lse in
// base-2 units, delta); P^T and dS^T go from the accumulators' registers into
// the A operand of dV += P^T.dO and dK += dS^T.Q, whose B operands are the
// streamed tiles read MN-major. A warpgroup whose keys are all padding (in a
// batch row that has a valid key) computes nothing and writes zeros: a padded
// key's P is exactly 0 for every row with a valid key in reach. dQ: a
// warpgroup owns 64 queries (Q rotated, dO); the producer streams key tiles as
// in the forward, leaving out those without a valid key; dQ += dS.K. One
// ex2.approx a score in both. Sums run over the tiles in a fixed order, so the
// same input gives the same bits.

namespace bwk {
namespace wg = attn::wg;
template <int D>
__host__ __device__ constexpr int own_bytes() { return wg::bwd_own_bytes<D>(); }
// The split dK/dV pass hands P^T (fp32, 32 values a thread) and dS^T (bf16,
// 16 words a thread) from one warpgroup of the pair to the other, thread t
// to thread t: [32][128] floats and [16][128] words.
constexpr int XCHG_P = 32 * 4 * wg::GROUP, XCHG_BYTES = XCHG_P + 16 * 4 * wg::GROUP;
template <typename P, int D>
constexpr size_t smem_bytes(int own) {
  return 1024 + (size_t)own + wg::Ring<D, P::NST, P::TABLES>::BYTES;
}
template <int D>
constexpr size_t dq_smem() {
  return smem_bytes<wg::DqPass<D>, D>(wg::DqPass<D>::NCONS * own_bytes<D>());
}
template <int D>
constexpr size_t dkv_smem() {
  return wg::dkv_form<D>() == wg::DkvForm::COLUMNS
             ? smem_bytes<wg::DkvPass<D>, D>(own_bytes<D>() + XCHG_BYTES)
             : smem_bytes<wg::DkvPass<D>, D>(wg::DkvPass<D>::NCONS * own_bytes<D>());
}
}  // namespace bwk

// P and dS of a warpgroup's 64 x 64 scores into A fragments. s and dp are the
// accumulators of the two products; `bias`, `lse2` and `delta` give each
// score's key bias (with the band), lse (base 2) and delta as functors of
// (n, e), the accumulator's index pair, whichever of rows and columns are the
// keys. PLAIN: every bias of the tile is 0 and is not asked for.
template <bool WANT_P, bool PLAIN, typename Bias, typename Lse, typename Delta>
__device__ __forceinline__ void p_ds_frags(const float* s, const float* dp, float c, Bias bias,
                                           Lse lse2, Delta delta, uint32_t (*pa)[4],
                                           uint32_t (*da)[4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = hop::ex2(PLAIN ? fmaf(s[4 * n + e], c, -lse2(n, e))
                            : fmaf(s[4 * n + e], c, bias(n, e)) - lse2(n, e));
      ds[e] = p[e] * (dp[4 * n + e] - delta(n, e));
    }
    if constexpr (WANT_P) {
      pa[n >> 1][(n & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    da[n >> 1][(n & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
    da[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
  }
}

template <int D>
__global__ void __launch_bounds__(attn::wg::DkvPass<D>::THREADS, 1)
    dkv_wgmma_kernel(const Args args) {
  namespace wg = attn::wg;
  using T = __nv_bfloat16;
  using Pass = wg::DkvPass<D>;
  static_assert(wg::dkv_form<D>() == wg::DkvForm::WHOLE, "dK/dV form");
  constexpr int NCONS = Pass::NCONS, NST = Pass::NST, OWN = bwk::own_bytes<D>();
  constexpr int TILE = hop::Tile<D>::BYTES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ wg::Control ctl;
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring_ptr = smem + NCONS * OWN;
  const uint32_t ring = hop::smem_u32(ring_ptr);

  const int S = args.S, H = args.H;
  const int tid = threadIdx.x, group = tid / wg::GROUP, t = tid % wg::GROUP;
  const int k0 = blockIdx.x * (wg::ROWS * NCONS), h = blockIdx.y, b = blockIdx.z;
  const T* cos_t = static_cast<const T*>(args.cos_t);
  const T* sin_t = static_cast<const T*>(args.sin_t);
  const int* mrow = args.mask == nullptr ? nullptr : args.mask + (size_t)b * S;
  if (tid == 0) wg::mbarriers_init(&ctl, NST, NCONS);
  __syncthreads();

  if (group == NCONS) {  // ---- the producer: query tiles ----
    hop::reg_dealloc<Pass::PRODUCER_REGS>();
    wg::Stream st;
    st.rot = rows_of<const T>(args.q, b, h);
    st.rot_ss = args.q.ss;
    st.raw = rows_of<const T>(args.g, b, h);
    st.raw_ss = args.g.ss;
    st.cos_t = cos_t;
    st.sin_t = sin_t;
    st.mrow = mrow;
    st.lse = args.lse + ((size_t)b * H + h) * S;
    st.delta = args.delta + ((size_t)b * H + h) * S;
    st.S = S;
    attn::band_range(k0, wg::ROWS * NCONS, wg::ROWS, S, args.window, &st.first, &st.last);
    st.own_first = k0;
    st.own_rows = wg::ROWS * NCONS;
    wg::produce<D, NST, false, Pass::TABLES>(ring, ring_ptr, &ctl, st, t);
  } else {  // ---- a consumer warpgroup: 64 keys ----
    hop::reg_alloc<Pass::CONSUMER_REGS>();
    const int lane = t & 31, warp = t >> 5, g = lane >> 2, qd = lane & 3;
    const int k0w = k0 + group * wg::ROWS;
    unsigned char* own_ptr = smem + group * OWN;
    const uint32_t own_k = hop::smem_u32(own_ptr), own_v = own_k + TILE;
    wg::load_own<D>(own_k, rows_of<const T>(args.k, b, h), args.k.ss, k0w, S, cos_t, sin_t, t);
    wg::load_own<D>(own_v, rows_of<const T>(args.v, b, h), args.v.ss, k0w, S, nullptr, nullptr,
                    t);
    hop::fence_proxy_async();
    hop::bar_sync(wg::bar_consumer(group), wg::GROUP);

    const float c = args.scale * wg::LOG2E;
    const int window = args.window;
    const int key0 = k0w + warp * 16 + g;  // this thread's keys: key0 and key0 + 8
    const float kbias[2] = {attn::key_bias(key0, S, mrow), attn::key_bias(key0 + 8, S, mrow)};
    const bool own_plain = __all_sync(0xffffffffu, kbias[0] == 0.f && kbias[1] == 0.f);
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    wg::Reader<D, NST> rd{ring, ring_ptr, &ctl};
    bool compute = k0w < S;
    for (int n = 0;; ++n) {
      const int q0 = rd.wait(n);
      if (q0 < 0) break;
      // The producer's scan of the mask is published with its first stage.
      if (n == 0 && compute && ctl.skip && !ctl.tile_valid[group]) compute = false;
      if (compute && wg::band_reach(k0w, q0, window)) {
        float s[32], dp[32];  // 64 keys x 64 queries
        hop::wgmma_fence();
        wg::rows_times_rows<D>(s, own_k, rd.rot(n));
        wg::rows_times_rows<D>(dp, own_v, rd.raw(n));
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::pin<32>(s);
        hop::pin<32>(dp);
        const float* lse2 = rd.aux0(n);
        const float* delta = rd.aux1(n);
        uint32_t pa[4][4], da[4][4];
        const auto bias = [&](int j, int e) {
          const int qi = q0 + j * 8 + 2 * qd + (e & 1), kj = key0 + 8 * (e >> 1);
          const float kb = kbias[e >> 1];
          return window >= 0 && abs(qi - kj) > window ? fminf(kb, OPT_NEG_BIG) : kb;
        };
        const auto col_lse = [&](int j, int e) { return lse2[j * 8 + 2 * qd + (e & 1)]; };
        const auto col_delta = [&](int j, int e) { return delta[j * 8 + 2 * qd + (e & 1)]; };
        if (own_plain && wg::band_free(k0w, q0, window))
          p_ds_frags<true, true>(s, dp, c, bias, col_lse, col_delta, pa, da);
        else
          p_ds_frags<true, false>(s, dp, c, bias, col_lse, col_delta, pa, da);
        hop::wgmma_fence();
        wg::frags_times_tile<D>(dv, pa, rd.raw(n));  // dV += P^T . dO
        wg::frags_times_tile<D>(dk, da, rd.rot(n));  // dK += dS^T . Q
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::pin<D / 2>(dv);
        hop::pin<D / 2>(dk);
      }
      rd.release(n);
    }

    T* staged_k = reinterpret_cast<T*>(own_ptr);
    T* staged_v = staged_k + wg::ROWS * (D + 8);
    hop::bar_sync(wg::bar_consumer(group), wg::GROUP);  // the own tiles are done with
    wg::stage_acc<D>(dk, args.scale, staged_k, t);
    wg::stage_acc<D>(dv, 1.f, staged_v, t);
    hop::bar_sync(wg::bar_consumer(group), wg::GROUP);
    store_staged_bf16<D, wg::ROWS>(staged_k, rows_of<T>(args.dk, b, h), args.dk.ss, k0w,
                                   args.cos_t != nullptr, args, t, wg::GROUP);
    store_staged_bf16<D, wg::ROWS>(staged_v, rows_of<T>(args.dv, b, h), args.dv.ss, k0w, false,
                                   args, t, wg::GROUP);
  }
}

template <int D>
__global__ void __launch_bounds__(attn::wg::DqPass<D>::THREADS, 1)
    dq_wgmma_kernel(const Args args) {
  namespace wg = attn::wg;
  using T = __nv_bfloat16;
  using Pass = wg::DqPass<D>;
  constexpr int NCONS = Pass::NCONS, NST = Pass::NST, OWN = bwk::own_bytes<D>();
  constexpr int TILE = hop::Tile<D>::BYTES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ wg::Control ctl;
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring_ptr = smem + NCONS * OWN;
  const uint32_t ring = hop::smem_u32(ring_ptr);

  const int S = args.S, H = args.H;
  const int tid = threadIdx.x, group = tid / wg::GROUP, t = tid % wg::GROUP;
  const int q0 = blockIdx.x * (wg::ROWS * NCONS), h = blockIdx.y, b = blockIdx.z;
  const T* cos_t = static_cast<const T*>(args.cos_t);
  const T* sin_t = static_cast<const T*>(args.sin_t);
  if (tid == 0) wg::mbarriers_init(&ctl, NST, NCONS);
  __syncthreads();

  if (group == NCONS) {  // ---- the producer: key tiles, as in the forward ----
    if constexpr (Pass::REALLOC) hop::reg_dealloc<Pass::PRODUCER_REGS>();
    const wg::RotatedRows rk =
        wg::rotated_rows<D, !Pass::TABLES>(args.k, args.rot, 1, cos_t, sin_t, b, h, S, H);
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
    wg::produce<D, NST, true, Pass::TABLES>(ring, ring_ptr, &ctl, st, t);
  } else {  // ---- a consumer warpgroup: 64 queries ----
    if constexpr (Pass::REALLOC) hop::reg_alloc<Pass::CONSUMER_REGS>();
    const int lane = t & 31, warp = t >> 5, g = lane >> 2, qd = lane & 3;
    const int q0w = q0 + group * wg::ROWS;
    unsigned char* own_ptr = smem + group * OWN;
    const uint32_t own_q = hop::smem_u32(own_ptr), own_g = own_q + TILE;
    const wg::RotatedRows rq =
        wg::rotated_rows<D, !Pass::TABLES>(args.q, args.rot, 0, cos_t, sin_t, b, h, S, H);
    wg::load_own<D>(own_q, rq.rows, rq.ss, q0w, S, rq.cos_t, rq.sin_t, t);
    // dO into its tile and, on the way, delta = rowsum(dO * out) of the 64
    // rows: eight products a thread, then a tree over the row's D / 8 lanes.
    // It goes to device memory for the dK/dV pass, which runs after this one.
    float* delta_own = reinterpret_cast<float*>(own_ptr + 2 * TILE);  // [64], beside the tiles
    float* delta_out = args.delta + ((size_t)b * H + h) * S;
    {
      constexpr int CH = D / 8;
      const T* grows = rows_of<const T>(args.g, b, h);
      const T* orows = rows_of<const T>(args.out, b, h);
      const auto chunk_delta = [&](int ch, const uint4& gv, const uint4& ov) {
        const int r = ch / CH, d0 = (ch % CH) * 8, pos = q0w + r;
        hop::sts128(own_g + hop::Tile<D>::chunk(r, d0), gv);
        float gf[8], of[8], part = 0.f;
        unpack8(gv, gf);
        unpack8(ov, of);
#pragma unroll
        for (int i = 0; i < 8; ++i) part += gf[i] * of[i];
#pragma unroll
        for (int off = 1; off < CH; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (d0 == 0) {
          delta_own[r] = part;
          if (pos < S) delta_out[pos] = part;
        }
      };
      const auto load = [&](int ch, uint4& gv, uint4& ov) {
        const int r = ch / CH, d0 = (ch % CH) * 8, pos = q0w + r;
        gv = ov = make_uint4(0, 0, 0, 0);
        if (pos < S) {
          gv = *reinterpret_cast<const uint4*>(grows + (long long)pos * args.g.ss + d0);
          ov = *reinterpret_cast<const uint4*>(orows + (long long)pos * args.out.ss + d0);
        }
      };
      if constexpr (D <= 64) {
        for (int ch = t; ch < wg::ROWS * CH; ch += wg::GROUP) {
          uint4 gv, ov;
          load(ch, gv, ov);
          chunk_delta(ch, gv, ov);
        }
      } else {  // BATCH chunks' loads first, as in store_staged_bf16
        constexpr int BATCH = D > 128 ? 8 : 4;
        for (int ch0 = t; ch0 < wg::ROWS * CH; ch0 += BATCH * wg::GROUP) {
          uint4 gv[BATCH], ov[BATCH];
#pragma unroll
          for (int i = 0; i < BATCH; ++i) load(ch0 + i * wg::GROUP, gv[i], ov[i]);
#pragma unroll
          for (int i = 0; i < BATCH; ++i) chunk_delta(ch0 + i * wg::GROUP, gv[i], ov[i]);
        }
      }
    }
    hop::fence_proxy_async();
    hop::bar_sync(wg::bar_consumer(group), wg::GROUP);

    const float c = args.scale * wg::LOG2E;
    const int window = args.window;
    const int row0 = q0w + warp * 16 + g;  // this thread's queries: row0 and row0 + 8
    const float* lse = args.lse + ((size_t)b * H + h) * S;
    float lse2_r[2], delta_r[2];  // a query past S gets P = 0 through lse = +inf
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = row0 + 8 * i;
      const float l = q < S ? lse[q] : 0.f;
      lse2_r[i] = q < S ? (l == OPT_NEG_BIG ? OPT_NEG_BIG : l * wg::LOG2E) : INFINITY;
      delta_r[i] = delta_own[warp * 16 + g + 8 * i];
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    wg::Reader<D, NST> rd{ring, ring_ptr, &ctl};
    for (int n = 0;; ++n) {
      const int k0 = rd.wait(n);
      if (k0 < 0) break;
      if (wg::band_reach(q0w, k0, window)) {
        float s[32], dp[32];  // 64 queries x 64 keys
        hop::wgmma_fence();
        wg::rows_times_rows<D>(s, own_q, rd.rot(n));
        wg::rows_times_rows<D>(dp, own_g, rd.raw(n));
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::pin<32>(s);
        hop::pin<32>(dp);
        const float* kb = rd.aux0(n);
        uint32_t da[4][4];
        const auto bias = [&](int j, int e) {
          const int kj = k0 + j * 8 + 2 * qd + (e & 1), qi = row0 + 8 * (e >> 1);
          const float b = kb[j * 8 + 2 * qd + (e & 1)];
          return window >= 0 && abs(qi - kj) > window ? fminf(b, OPT_NEG_BIG) : b;
        };
        const auto row_lse = [&](int, int e) { return lse2_r[e >> 1]; };
        const auto row_delta = [&](int, int e) { return delta_r[e >> 1]; };
        if (rd.all_valid(n) && wg::band_free(q0w, k0, window))
          p_ds_frags<false, true>(s, dp, c, bias, row_lse, row_delta, nullptr, da);
        else
          p_ds_frags<false, false>(s, dp, c, bias, row_lse, row_delta, nullptr, da);
        hop::wgmma_fence();
        wg::frags_times_tile<D>(dq, da, rd.rot(n));  // dQ += dS . K
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::pin<D / 2>(dq);
      }
      rd.release(n);
    }

    T* staged = reinterpret_cast<T*>(own_ptr);
    hop::bar_sync(wg::bar_consumer(group), wg::GROUP);  // the own tiles are done with
    wg::stage_acc<D>(dq, args.scale, staged, t);
    hop::bar_sync(wg::bar_consumer(group), wg::GROUP);
    store_staged_bf16<D, wg::ROWS>(staged, rows_of<T>(args.dq, b, h), args.dq.ss, q0w,
                                   args.cos_t != nullptr, args, t, wg::GROUP);
  }
}

// dK/dV at D = 128 (attention_wgmma.cuh: DkvForm::COLUMNS), the D columns
// split over a pair of consumer warpgroups that share 64 keys: two 64 x 128
// accumulators beside S^T and dP^T would pass the 168 registers a thread of
// three warpgroups has. Warpgroup 0 makes S^T = K.Q^T and P^T,
// warpgroup 1 dP^T = V.dO^T and, from warpgroup 0's fp32 P^T, dS^T; P^T goes
// one way and dS^T (rounded to bf16) the other through shared memory, each
// thread to the thread of the same index in the other warpgroup (the two
// accumulators' fragments are alike), at two named barriers. Then each
// accumulates its half of the columns, dV += P^T.dO and dK += dS^T.Q, so
// every product runs once: warpgroup 0 while it waits for dS^T, warpgroup 1
// from its registers. P^T and dS^T are those of p_ds_frags, bit for bit. The
// rounded halves meet in shared memory, where the rope adjoint finds its
// partner column d +- D/2 in the other half.
template <int D>
__global__ void __launch_bounds__(attn::wg::DkvPass<D>::THREADS, 1)
    dkv_split_kernel(const Args args) {
  namespace wg = attn::wg;
  using T = __nv_bfloat16;
  using Pass = wg::DkvPass<D>;
  static_assert(wg::dkv_form<D>() == wg::DkvForm::COLUMNS && Pass::NCONS == 2 && !Pass::REALLOC,
                "a pair at the launch's registers");
  constexpr int NST = Pass::NST, OWN = bwk::own_bytes<D>(), HALF = D / 2;
  constexpr int TILE = hop::Tile<D>::BYTES, PAIR = 2 * wg::GROUP;
  // Named barriers of the pair (attention_wgmma.cuh takes 1 and 2 + group):
  // P^T handed over, dS^T handed over, both done with K and V.
  constexpr int BAR_P = 5, BAR_DS = 6, BAR_PAIR = 7;
  extern __shared__ unsigned char smem_raw[];
  __shared__ wg::Control ctl;
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* own_ptr = smem;  // K, V; dK, dV on the way out
  float4* x_p = reinterpret_cast<float4*>(smem + OWN);               // P^T: [8][128] float4
  uint4* x_ds = reinterpret_cast<uint4*>(smem + OWN + bwk::XCHG_P);  // dS^T: [4][128] uint4
  unsigned char* ring_ptr = smem + OWN + bwk::XCHG_BYTES;
  const uint32_t ring = hop::smem_u32(ring_ptr);

  const int S = args.S, H = args.H;
  const int tid = threadIdx.x, group = tid / wg::GROUP, t = tid % wg::GROUP;
  const int k0 = blockIdx.x * wg::ROWS, h = blockIdx.y, b = blockIdx.z;
  const T* cos_t = static_cast<const T*>(args.cos_t);
  const T* sin_t = static_cast<const T*>(args.sin_t);
  const int* mrow = args.mask == nullptr ? nullptr : args.mask + (size_t)b * S;
  if (tid == 0) wg::mbarriers_init(&ctl, NST, 2);
  __syncthreads();

  if (group == 2) {  // ---- the producer: query tiles ----
    const wg::RotatedRows rq =
        wg::rotated_rows<D, !Pass::TABLES>(args.q, args.rot, 0, cos_t, sin_t, b, h, S, H);
    wg::Stream st;
    st.rot = rq.rows;
    st.rot_ss = rq.ss;
    st.raw = rows_of<const T>(args.g, b, h);
    st.raw_ss = args.g.ss;
    st.cos_t = rq.cos_t;
    st.sin_t = rq.sin_t;
    st.mrow = mrow;
    st.lse = args.lse + ((size_t)b * H + h) * S;
    st.delta = args.delta + ((size_t)b * H + h) * S;
    st.S = S;
    attn::band_range(k0, wg::ROWS, wg::ROWS, S, args.window, &st.first, &st.last);
    st.own_first = k0;
    st.own_rows = wg::ROWS;
    wg::produce<D, NST, false, Pass::TABLES>(ring, ring_ptr, &ctl, st, t);
  } else {  // ---- the pair: warpgroup 0 makes P^T, warpgroup 1 dS^T ----
    const int lane = t & 31, warp = t >> 5, g = lane >> 2, qd = lane & 3;
    const uint32_t own_k = hop::smem_u32(own_ptr), own_v = own_k + TILE;
    if (group == 0) {
      const wg::RotatedRows rk =
          wg::rotated_rows<D, !Pass::TABLES>(args.k, args.rot, 1, cos_t, sin_t, b, h, S, H);
      wg::load_own<D>(own_k, rk.rows, rk.ss, k0, S, rk.cos_t, rk.sin_t, t);
    } else {
      wg::load_own<D>(own_v, rows_of<const T>(args.v, b, h), args.v.ss, k0, S, nullptr,
                      nullptr, t);
    }
    hop::fence_proxy_async();
    hop::bar_sync(wg::bar_consumer(group), wg::GROUP);

    const float c = args.scale * wg::LOG2E;
    const int window = args.window;
    const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0 and key0 + 8
    const float kbias[2] = {attn::key_bias(key0, S, mrow), attn::key_bias(key0 + 8, S, mrow)};
    const bool own_plain = __all_sync(0xffffffffu, kbias[0] == 0.f && kbias[1] == 0.f);
    const int col0 = group * HALF;  // this warpgroup's columns of dK and dV
    float dk[HALF / 2], dv[HALF / 2];
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i) dk[i] = dv[i] = 0.f;

    wg::Reader<D, NST> rd{ring, ring_ptr, &ctl};
    bool compute = k0 < S;
    for (int n = 0;; ++n) {
      const int q0 = rd.wait(n);
      if (q0 < 0) break;
      // The producer's scan of the mask is published with its first stage.
      if (n == 0 && compute && ctl.skip && !ctl.tile_valid[0]) compute = false;
      if (compute && wg::band_reach(k0, q0, window)) {
        float acc[32];  // 64 keys x 64 queries: S^T (warpgroup 0) or dP^T
        uint32_t pa[4][4], da[4][4];
        hop::wgmma_fence();
        wg::rows_times_rows<D>(acc, group == 0 ? own_k : own_v, group == 0 ? rd.rot(n) : rd.raw(n));
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::pin<32>(acc);
        if (group == 0) {
          const float* lse2 = rd.aux0(n);
          const bool plain = own_plain && wg::band_free(k0, q0, window);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = j * 8 + 2 * qd + (e & 1);
              float x;
              if (plain) {
                x = fmaf(acc[4 * j + e], c, -lse2[col]);
              } else {
                const int kj = key0 + 8 * (e >> 1);
                const float kb = kbias[e >> 1];
                const float bias =
                    window >= 0 && abs(q0 + col - kj) > window ? fminf(kb, OPT_NEG_BIG) : kb;
                x = fmaf(acc[4 * j + e], c, bias) - lse2[col];
              }
              acc[4 * j + e] = hop::ex2(x);
            }
            x_p[j * wg::GROUP + t] =
                make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
            pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(acc[4 * j], acc[4 * j + 1]);
            pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
          }
          hop::bar_arrive(BAR_P, PAIR);
          hop::wgmma_fence();
          wg::frags_times_tile<D, HALF>(dv, pa, rd.raw(n), col0);  // dV += P^T . dO
          hop::wgmma_commit();
          hop::bar_sync(BAR_DS, PAIR);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint4 w = x_ds[i * wg::GROUP + t];
            da[i][0] = w.x;
            da[i][1] = w.y;
            da[i][2] = w.z;
            da[i][3] = w.w;
          }
          hop::wgmma_fence();
          wg::frags_times_tile<D, HALF>(dk, da, rd.rot(n), col0);  // dK += dS^T . Q
          hop::wgmma_commit();
        } else {
          const float* delta = rd.aux1(n);
          hop::bar_sync(BAR_P, PAIR);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 p4 = x_p[j * wg::GROUP + t];
            const float p[4] = {p4.x, p4.y, p4.z, p4.w};
            float ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              ds[e] = p[e] * (acc[4 * j + e] - delta[j * 8 + 2 * qd + (e & 1)]);
            pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
            pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
            da[j >> 1][(j & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
            da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            x_ds[i * wg::GROUP + t] = make_uint4(da[i][0], da[i][1], da[i][2], da[i][3]);
          hop::bar_arrive(BAR_DS, PAIR);
          hop::wgmma_fence();
          wg::frags_times_tile<D, HALF>(dv, pa, rd.raw(n), col0);  // dV += P^T . dO
          wg::frags_times_tile<D, HALF>(dk, da, rd.rot(n), col0);  // dK += dS^T . Q
          hop::wgmma_commit();
        }
        hop::wgmma_wait<0>();
        hop::pin<HALF / 2>(dv);
        hop::pin<HALF / 2>(dk);
        wg::pin_frags(pa);
        wg::pin_frags(da);
      }
      rd.release(n);
    }

    T* staged_k = reinterpret_cast<T*>(own_ptr);
    T* staged_v = staged_k + wg::ROWS * (D + 8);
    hop::bar_sync(BAR_PAIR, PAIR);  // both are done with K and V
    wg::stage_acc<HALF, D + 8>(dk, args.scale, staged_k + col0, t);
    wg::stage_acc<HALF, D + 8>(dv, 1.f, staged_v + col0, t);
    hop::bar_sync(BAR_PAIR, PAIR);
    const int pt = group * wg::GROUP + t;
    store_staged_bf16<D, wg::ROWS>(staged_k, rows_of<T>(args.dk, b, h), args.dk.ss, k0,
                                   args.cos_t != nullptr, args, pt, PAIR);
    store_staged_bf16<D, wg::ROWS>(staged_v, rows_of<T>(args.dv, b, h), args.dv.ss, k0, false,
                                   args, pt, PAIR);
  }
}

// dK/dV at D = 256 (attention_wgmma.cuh: DkvForm::ROLES): one consumer
// warpgroup on 64 keys that makes dV (even CTAs of the grid) or dK (odd
// ones), so a thread holds one 64 x 256 accumulator. Both roles rebuild S^T
// and P^T; the dK role also dP^T and dS^T. The same walk, sums and roundings
// as dkv_wgmma_kernel.
template <int D>
__global__ void __launch_bounds__(attn::wg::DkvPass<D>::THREADS, 1)
    dkv_roles_kernel(const Args args) {
  namespace wg = attn::wg;
  using T = __nv_bfloat16;
  using Pass = wg::DkvPass<D>;
  static_assert(wg::dkv_form<D>() == wg::DkvForm::ROLES && Pass::NCONS == 1, "dK/dV form");
  constexpr int NST = Pass::NST, OWN = bwk::own_bytes<D>(), TILE = hop::Tile<D>::BYTES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ wg::Control ctl;
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring_ptr = smem + OWN;
  const uint32_t ring = hop::smem_u32(ring_ptr);

  const int S = args.S, H = args.H;
  const int tid = threadIdx.x, group = tid / wg::GROUP, t = tid % wg::GROUP;
  const bool dk_role = (blockIdx.x & 1) != 0;
  const int k0 = (blockIdx.x >> 1) * wg::ROWS, h = blockIdx.y, b = blockIdx.z;
  const T* cos_t = static_cast<const T*>(args.cos_t);
  const T* sin_t = static_cast<const T*>(args.sin_t);
  const int* mrow = args.mask == nullptr ? nullptr : args.mask + (size_t)b * S;
  if (tid == 0) wg::mbarriers_init(&ctl, NST, 1);
  __syncthreads();

  if (group == 1) {  // ---- the producer: query tiles ----
    const wg::RotatedRows rq =
        wg::rotated_rows<D, !Pass::TABLES>(args.q, args.rot, 0, cos_t, sin_t, b, h, S, H);
    wg::Stream st;
    st.rot = rq.rows;
    st.rot_ss = rq.ss;
    st.raw = rows_of<const T>(args.g, b, h);
    st.raw_ss = args.g.ss;
    st.cos_t = rq.cos_t;
    st.sin_t = rq.sin_t;
    st.mrow = mrow;
    st.lse = args.lse + ((size_t)b * H + h) * S;
    st.delta = args.delta + ((size_t)b * H + h) * S;
    st.S = S;
    attn::band_range(k0, wg::ROWS, wg::ROWS, S, args.window, &st.first, &st.last);
    st.own_first = k0;
    st.own_rows = wg::ROWS;
    wg::produce<D, NST, false, Pass::TABLES>(ring, ring_ptr, &ctl, st, t);
  } else {  // ---- the consumer: 64 keys, dV or dK ----
    const int lane = t & 31, warp = t >> 5, g = lane >> 2, qd = lane & 3;
    const uint32_t own_k = hop::smem_u32(smem), own_v = own_k + TILE;
    const wg::RotatedRows rk =
        wg::rotated_rows<D, !Pass::TABLES>(args.k, args.rot, 1, cos_t, sin_t, b, h, S, H);
    wg::load_own<D>(own_k, rk.rows, rk.ss, k0, S, rk.cos_t, rk.sin_t, t);
    if (dk_role)
      wg::load_own<D>(own_v, rows_of<const T>(args.v, b, h), args.v.ss, k0, S, nullptr, nullptr,
                      t);
    hop::fence_proxy_async();
    hop::bar_sync(wg::bar_consumer(0), wg::GROUP);

    const float c = args.scale * wg::LOG2E;
    const int window = args.window;
    const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0 and key0 + 8
    const float kbias[2] = {attn::key_bias(key0, S, mrow), attn::key_bias(key0 + 8, S, mrow)};
    const bool own_plain = __all_sync(0xffffffffu, kbias[0] == 0.f && kbias[1] == 0.f);
    float acc[D / 2];  // dV or dK
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    wg::Reader<D, NST> rd{ring, ring_ptr, &ctl};
    bool compute = k0 < S;
    for (int n = 0;; ++n) {
      const int q0 = rd.wait(n);
      if (q0 < 0) break;
      // The producer's scan of the mask is published with its first stage.
      if (n == 0 && compute && ctl.skip && !ctl.tile_valid[0]) compute = false;
      if (compute && wg::band_reach(k0, q0, window)) {
        float s[32], dp[32];  // 64 keys x 64 queries
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = 0.f;
        hop::wgmma_fence();
        wg::rows_times_rows<D>(s, own_k, rd.rot(n));
        if (dk_role) wg::rows_times_rows<D>(dp, own_v, rd.raw(n));
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::pin<32>(s);
        hop::pin<32>(dp);
        const float* lse2 = rd.aux0(n);
        const float* delta = rd.aux1(n);
        uint32_t frags[4][4];  // P^T (dV) or dS^T (dK)
        const auto bias = [&](int j, int e) {
          const int qi = q0 + j * 8 + 2 * qd + (e & 1), kj = key0 + 8 * (e >> 1);
          const float kb = kbias[e >> 1];
          return window >= 0 && abs(qi - kj) > window ? fminf(kb, OPT_NEG_BIG) : kb;
        };
        const auto col_lse = [&](int j, int e) { return lse2[j * 8 + 2 * qd + (e & 1)]; };
        const auto col_delta = [&](int j, int e) { return delta[j * 8 + 2 * qd + (e & 1)]; };
        const bool plain = own_plain && wg::band_free(k0, q0, window);
        if (dk_role) {
          if (plain)
            p_ds_frags<false, true>(s, dp, c, bias, col_lse, col_delta, nullptr, frags);
          else
            p_ds_frags<false, false>(s, dp, c, bias, col_lse, col_delta, nullptr, frags);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[e] = hop::ex2(plain ? fmaf(s[4 * j + e], c, -col_lse(j, e))
                                    : fmaf(s[4 * j + e], c, bias(j, e)) - col_lse(j, e));
            frags[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
            frags[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
          }
        }
        hop::wgmma_fence();
        // dK += dS^T . Q or dV += P^T . dO
        wg::frags_times_tile<D>(acc, frags, dk_role ? rd.rot(n) : rd.raw(n));
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::pin<D / 2>(acc);
        wg::pin_frags(frags);
      }
      rd.release(n);
    }

    T* staged = reinterpret_cast<T*>(smem);
    hop::bar_sync(wg::bar_consumer(0), wg::GROUP);  // the own tiles are done with
    wg::stage_acc<D>(acc, dk_role ? args.scale : 1.f, staged, t);
    hop::bar_sync(wg::bar_consumer(0), wg::GROUP);
    if (dk_role)
      store_staged_bf16<D, wg::ROWS>(staged, rows_of<T>(args.dk, b, h), args.dk.ss, k0,
                                     args.cos_t != nullptr, args, t, wg::GROUP);
    else
      store_staged_bf16<D, wg::ROWS>(staged, rows_of<T>(args.dv, b, h), args.dv.ss, k0, false,
                                     args, t, wg::GROUP);
  }
}

// One CTA a tile of `tile` rows (`per_tile` CTAs a tile), head and batch row.
template <typename Kernel>
int launch(Kernel kernel, const Args& args, int batch, int tile, int threads, size_t smem,
           cudaStream_t stream, int per_tile = 1) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((args.S + tile - 1) / tile * per_tile, args.H, batch);
  kernel<<<grid, threads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int run(const Args& args, int batch, cudaStream_t s) {
  namespace wg = attn::wg;
  if constexpr (sizeof(T) == 4) {  // delta, then the two passes
    constexpr int R = simt::tile<D>();
    constexpr size_t smem = simt::smem_bytes<D>();
    const int rows = batch * args.S * args.H;
    delta_kernel<T, D><<<(rows + 7) / 8, 256, 0, s>>>(args, rows);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    err = launch(dkv_fma_kernel<D>, args, batch, R, simt::THREADS, smem, s);
    if (err != 0) return err;
    return launch(dq_fma_kernel<D>, args, batch, R, simt::THREADS, smem, s);
  } else {
    // The dQ pass first: its prologue makes delta, which the dK/dV pass reads.
    using Dq = wg::DqPass<D>;
    using Dkv = wg::DkvPass<D>;
    static_assert(bwk::dq_smem<D>() <= wg::SMEM_LIMIT, "shared memory of a CTA");
    static_assert(bwk::dkv_smem<D>() <= wg::SMEM_LIMIT, "shared memory of a CTA");
    static_assert(2 * hop::Tile<D>::BYTES + wg::ROWS * 4 <= bwk::own_bytes<D>(), "delta");
    static_assert(Dq::TABLES == Dkv::TABLES, "both passes read Q and K alike");
    if constexpr (!Dq::TABLES) {  // Q and K rotated into the scratch first
      if (args.cos_t != nullptr) {
        if (args.rot == nullptr) return (int)cudaErrorInvalidValue;
        const size_t each = (size_t)batch * args.H * args.S * D;
        int err = wg::rotate_rows<D>(args.q, args.cos_t, args.sin_t, args.rot, batch, args.S,
                                     args.H, s);
        if (err != 0) return err;
        err = wg::rotate_rows<D>(args.k, args.cos_t, args.sin_t,
                                 static_cast<__nv_bfloat16*>(args.rot) + each, batch, args.S,
                                 args.H, s);
        if (err != 0) return err;
      }
    }
    const int err = launch(dq_wgmma_kernel<D>, args, batch, wg::ROWS * Dq::NCONS, Dq::THREADS,
                           bwk::dq_smem<D>(), s);
    if (err != 0) return err;
    if constexpr (wg::dkv_form<D>() == wg::DkvForm::COLUMNS)
      return launch(dkv_split_kernel<D>, args, batch, wg::ROWS, Dkv::THREADS, bwk::dkv_smem<D>(),
                    s);
    else if constexpr (wg::dkv_form<D>() == wg::DkvForm::ROLES)  // dV and dK CTAs
      return launch(dkv_roles_kernel<D>, args, batch, wg::ROWS, Dkv::THREADS, bwk::dkv_smem<D>(),
                    s, 2);
    else
      return launch(dkv_wgmma_kernel<D>, args, batch, wg::ROWS * Dkv::NCONS, Dkv::THREADS,
                    bwk::dkv_smem<D>(), s);
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
// scratch: 2 * batch * heads * seq * head_dim elements of the storage type
// where opt_flash_attention_design reports two pre-rotated operands (out[10]
// with `backward`), else null.
extern "C" int opt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const int* mask, const void* cos_t, const void* sin_t,
                                       const void* out, const float* lse, const void* g,
                                       float* delta, void* scratch, void* dq, void* dk, void* dv,
                                       int batch, int seq, int heads, int head_dim,
                                       const long long* strides, int window, float scale,
                                       int dtype, void* stream) {
  const void* ptrs[8] = {q, k, v, out, g, dq, dk, dv};
  attn::Strided t[8];
  for (int i = 0; i < 8; ++i)
    t[i] = attn::Strided{const_cast<void*>(ptrs[i]), strides[3 * i], strides[3 * i + 1],
                         strides[3 * i + 2]};
  const attn::BwdArgs args{t[0], t[1],  t[2],  t[3],  t[4],    t[5], t[6],  t[7],   mask,
                           cos_t, sin_t, lse,   delta, scratch, seq,  heads, window, scale};
  return backward(args, batch, head_dim, dtype, stream);
}

#endif  // OPT_HEAD_DIM
