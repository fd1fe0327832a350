// Helpers shared by the packed attention forward (flash_attention.cu) and
// its backward (flash_attention_bwd.cu): tile sizes, rotary applied while
// loading, the additive mask bias and the band bounds of a tile's loop.
#pragma once

#include "common.cuh"

#include <math.h>

namespace attn {

constexpr int BQ = 64, BK = 64;

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
