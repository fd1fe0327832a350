// Helpers shared by the attention forward (flash_attention.cu) and its
// backward (flash_attention_bwd.cu): the strided operands and argument
// blocks, tile sizes, rotary applied while loading, the additive mask bias
// and the band bounds of a tile's loop.
//
// Both sources are compiled once per head dim (-DOPT_HEAD_DIM=32, 64, 128,
// 256: that unit holds the kernels of one D and a host function
// forward_d<D> / backward_d<D>) and once without the macro (the extern "C"
// entry points, which pick the unit by head_dim), so the instances build in
// parallel.
#pragma once

#include "common.cuh"

#include <math.h>

#define OPT_ATTN_CAT2(a, b) a##b
#define OPT_ATTN_CAT(a, b) OPT_ATTN_CAT2(a, b)

namespace attn {

constexpr int BQ = 64, BK = 64;

// A [B, H, S, D] operand read or written through its (batch, head, row)
// strides, in elements; the last dim is contiguous. The packed Wqkv buffer
// [B, S, 3*H*D] is three of these at offsets 0, H*D and 2*H*D with strides
// (S*3*H*D, D, 3*H*D); separate contiguous tensors have (H*S*D, S*D, D).
struct Strided {
  void* p;
  long long sb, sh, ss;
};

template <typename T>
__device__ __forceinline__ T* rows_of(const Strided& t, int b, int h) {
  return static_cast<T*>(t.p) + (size_t)b * t.sb + (size_t)h * t.sh;
}

struct FwdArgs {
  Strided q, k, v, out;
  const int* mask;    // [B, S] or null
  const void* cos_t;  // [S, D] in the storage type, or null
  const void* sin_t;
  float* lse;  // [B, H, S] or null
  void* rot;   // scratch [B, H, S, D]: K rotated, where the head dim streams it so; or null
  int S, H;
  int window;  // < 0: global
  float scale;
};

struct BwdArgs {
  Strided q, k, v, out, g;  // inputs: g = d out, cast to the storage type
  Strided dq, dk, dv;       // outputs
  const int* mask;
  const void* cos_t;
  const void* sin_t;
  const float* lse;  // [B, H, S]
  float* delta;      // [B, H, S] scratch
  void* rot;         // scratch [2, B, H, S, D]: Q, then K, rotated, where the head dim streams
                     // them so; or null
  int S, H;
  int window;
  float scale;
};

// The head dims the kernels are instantiated for, one unit each.
#define OPT_ATTN_FOR_EACH_D(X) X(32) X(64) X(128) X(256)

// Rotary for element d of a row at position pos, rounding as the plain
// composition does: x*cos and rotate_half(x)*sin each rounded to T, then
// their sum. No tables (cos_t == nullptr) means no rotary.
template <typename T, int D>
__device__ __forceinline__ float rope_elem(const T* row, int d, const T* cos_t, const T* sin_t,
                                           int pos) {
  const float x = to_f32(row[d]);
  if (cos_t == nullptr) return x;
  constexpr int half = D / 2;
  const float rot = d < half ? -to_f32(row[d + half]) : to_f32(row[d - half]);
  const float c = to_f32(cos_t[(size_t)pos * D + d]);
  const float s = to_f32(sin_t[(size_t)pos * D + d]);
  return round_to<T>(round_to<T>(x * c) + round_to<T>(rot * s));
}

// rope_elem for the 8 bf16 values d0 .. d0+7 of a row (d0 % 8 == 0), with
// 16-byte loads.
template <int D>
__device__ __forceinline__ uint4 rope_chunk(const __nv_bfloat16* row, int d0,
                                            const __nv_bfloat16* cos_t,
                                            const __nv_bfloat16* sin_t, int pos) {
  const uint4 raw = *reinterpret_cast<const uint4*>(row + d0);
  if (cos_t == nullptr) return raw;
  constexpr int half = D / 2;
  const bool first_half = d0 < half;
  float xs[8], ps[8], cs[8], ss[8], v[8];
  unpack8(raw, xs);
  unpack8(*reinterpret_cast<const uint4*>(row + (first_half ? d0 + half : d0 - half)), ps);
  unpack8(*reinterpret_cast<const uint4*>(cos_t + (size_t)pos * D + d0), cs);
  unpack8(*reinterpret_cast<const uint4*>(sin_t + (size_t)pos * D + d0), ss);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float rot = first_half ? -ps[i] : ps[i];
    v[i] = round_to<__nv_bfloat16>(xs[i] * cs[i]) + round_to<__nv_bfloat16>(rot * ss[i]);
  }
  return pack8(v);  // rounds the sum
}

// Scaled score plus the additive mask bias; -inf for keys past S. Key
// padding and the band each add -FLT_MAX, clamped so two stacked biases
// stay finite.
__device__ __forceinline__ float biased_score(float s, float scale, int qi, int kj, int S,
                                              const int* mrow, int window) {
  if (kj >= S) return -INFINITY;
  float bias = 0.f;
  if (mrow != nullptr && mrow[kj] == 0) bias = OPT_NEG_BIG;
  if (window >= 0 && abs(qi - kj) > window) bias = fmaxf(bias + OPT_NEG_BIG, OPT_NEG_BIG);
  return s * scale + bias;
}

// biased_score in two steps, for a kernel that shares a key tile's mask
// across its threads: key_bias(kj) is 0, -FLT_MAX for a padded key or -inf
// past S, computed once a key; banded_score then adds the band (the two
// stacked biases clamp to -FLT_MAX, and -inf stays -inf). The same bits as
// biased_score.
__device__ __forceinline__ float key_bias(int kj, int S, const int* mrow) {
  if (kj >= S) return -INFINITY;
  return mrow != nullptr && mrow[kj] == 0 ? OPT_NEG_BIG : 0.f;
}

__device__ __forceinline__ float banded_score(float s, float scale, int qi, int kj, float kbias,
                                              int window) {
  if (window >= 0 && abs(qi - kj) > window) kbias = fminf(kbias, OPT_NEG_BIG);
  return s * scale + kbias;
}

// The walk of a tile that starts at row t0 (of `tile` rows) over the other
// side's tiles of `step` rows: the first tile start and the last row inside
// the band (the whole sequence for a global layer, window < 0). The band is
// symmetric, so the same bound serves queries over keys and keys over
// queries.
__device__ __forceinline__ void band_range(int t0, int tile, int step, int S, int window,
                                           int* first, int* last) {
  int lo = 0, hi = S - 1;
  if (window >= 0) {
    lo = max(0, t0 - window);
    hi = min(S - 1, t0 + tile - 1 + window);
  }
  *first = (lo / step) * step;
  *last = hi;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace attn
