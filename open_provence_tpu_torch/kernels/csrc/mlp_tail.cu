// The whole MLP in one kernel, forward: kernel 8.
//
// opt_ln_geglu_wo replaces ops/geglu.py::_ln_geglu_wo_kernel:
//   out[M, K] = (act(LN(x) . Wi[:I]^T) * (LN(x) . Wi[I:]^T)) . Wo^T
// with Wi [2I, K] and Wo [K, I] in torch's [out, in] layout and the TPU
// kernel's rounding points: the normalized rows, inp and gate rounded to the
// storage type, act(inp) rounded, h = act * gate in the storage type, fp32
// accumulation in all three products, LN statistics as E[x^2] - E[x]^2.
//
// The TPU kernel keeps both halves of Wi, Wo and a [bm, I] pair of fp32
// accumulators resident in VMEM. Two launches on the caller's stream here:
// the normalized rows into scratch [M, K] (the pass kernels 2 and 4 share,
// gemm.cuh), then the fused kernel, in which the [M, I] product never
// reaches device memory.
//
// Work: 6*M*K*I operations (8.7e10 at M = 16384, K = 768, I = 1152), so the
// tensor-core rate bounds it. bf16 (mlp_tail.cuh, wgf::): a cluster of
// ceil(K / 128) CTAs a tile of 128 rows, each owning 128 output columns and
// forming a 64-column share of each chunk of h, which it hands to its peers
// through distributed shared memory; so a cluster reads Wi and Wo once (5.3
// MB at base width) and xn once a chunk's share. Recomputing h for each
// output slice instead would cost 2.3x the operations; a CTA that holds the
// whole [128, K] output is past the register file. What holds it on an H100
// (PERF.md): the card runs 17 clusters of six CTAs at once (102 of
// its 132 SMs), and the same CTAs without the handover ran 1.65x faster
// launched without clusters than with them. fp32: a CTA of 16 rows
// loops over I in chunks of 64 and holds a [16, K] output in registers,
// staging slabs with plain loads (the card's fp32 parity path).
#include "mlp_tail.cuh"

namespace mlp_tail {
namespace {

// ---- bf16 -----------------------------------------------------------------------

// One cluster a tile of 128 rows; CTA `rank` of C owns output columns
// n0 = 128 rank ... The ring runs, a chunk c of I (64 C columns) at a time,
// the K / 64 k-steps of [inp | gate] = xn . Wi[share]^T, then the C panels of
// Wo[n0 .., chunk]. h of the chunk lies in C panels of [128][64] bf16 after
// the ring, 128-byte swizzled (chunk c of row r at c ^ (r % 8)); panel j is
// CTA j's share: its warpgroups write it into their own panel and the
// bulk-copy engine copies each half into every peer's. A CTA's h_full
// completes when its two warpgroups wrote its panel and the peers' copies
// have landed (the bytes complete it); h_free when all 2 C consumer
// warpgroups of the cluster finished reading this CTA's panel (an arrival
// each on every CTA's), so the next chunk may overwrite it, and, after the
// last chunk, the CTA may finish. The warpgroups' own 16-byte stores into
// the peers measured 0.09 ms a call slower at base width (PERF.md).
__global__ void __launch_bounds__(WG_THREADS, 1)
    tail_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap xn_map,
                          const __grid_constant__ CUtensorMap wi_map,
                          const __grid_constant__ CUtensorMap wo_map, bf16* __restrict__ out,
                          int M, int K, int I, int act, int stages) {
  using namespace wgf;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[MAX_STAGES], empty[MAX_STAGES], h_full, h_free;
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = hop::smem_u32(smem), h_base = ring + stages * STAGE_BYTES;
  const int C = gridDim.x, rank = (int)hop::cluster_rank();
  const int tid = threadIdx.x, group = tid / GROUP, t = tid % GROUP, lane = t & 31;
  const int m0 = blockIdx.y * ROWS, n0 = blockIdx.x * OUT_COLS;
  const int n_k = (K + BK - 1) / BK, chunk_cols = SHARE * C;
  const int n_chunks = (I + chunk_cols - 1) / chunk_cols;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hop::mbar_init(&full[s], 1);  // the producer's arrival; the bytes complete it
      hop::mbar_init(&empty[s], CONSUMERS * GROUP / 32);  // lane 0 of each consumer warp
    }
    hop::mbar_init(&h_full, CONSUMERS);  // this CTA's warpgroups; the peers' bytes complete it
    hop::mbar_init(&h_free, CONSUMERS * C);
    hop::fence_barrier_init();
  }
  hop::cluster_sync();  // every CTA's barriers exist before a peer arrives on them

  if (group == CONSUMERS) {  // ---- the producer: one thread issues every copy ----
    hop::reg_dealloc<PRODUCER_REGS>();
    if (t != 0) return;
    int it = 0;
    auto next_stage = [&](uint32_t bytes) {
      const int s = it % stages;
      hop::mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
      hop::mbar_arrive_expect_tx(&full[s], bytes);
      ++it;
      return s;
    };
    for (int c = 0; c < n_chunks; ++c) {
      const int i_share = c * chunk_cols + rank * SHARE;
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = next_stage(STAGE_BYTES);
        const uint32_t a = ring + s * STAGE_BYTES, b = a + PANEL_BYTES;
        hop::tma_load_2d(a, &xn_map, kt * BK, m0, &full[s]);
#pragma unroll
        for (int j = 0; j < SHARE / GATE_BLOCK; ++j)
          hop::tma_load_3d(b + j * 2 * GATE_BLOCK * ROW_BYTES, &wi_map, kt * BK,
                           i_share + j * GATE_BLOCK, 0, &full[s]);
      }
      for (int p = 0; p < C; ++p) {
        const int s = next_stage(PANEL_BYTES);
        hop::tma_load_2d(ring + s * STAGE_BYTES, &wo_map, c * chunk_cols + p * SHARE, n0,
                         &full[s]);
      }
    }
    return;
  }

  // ---- a consumer warpgroup: tile rows 64 * group .. + 63 ----
  hop::reg_alloc<CONSUMER_REGS>();
  const int warp = t >> 5, g = lane >> 2, q = lane & 3;
  const int row0 = group * 64 + warp * 16 + g;  // and row0 + 8; both are g modulo 8
  int it = 0;
  auto wait_stage = [&]() {
    const int s = it % stages;
    hop::mbar_wait(&full[s], (it / stages) & 1);
    return s;
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s]);
  };
  auto arrive_everywhere = [&](uint64_t* bar) {  // one arrival for this warpgroup on every CTA's
    hop::bar_sync(bar_consumer(group), GROUP);
    if (t == 0)
      for (int p = 0; p < C; ++p)
        hop::mbar_arrive_cluster(hop::map_to_rank(hop::smem_u32(bar), p));
  };
  float acc[OUT_COLS / 2];
#pragma unroll
  for (int i = 0; i < OUT_COLS / 2; ++i) acc[i] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    // [inp | gate] of the share: 64 rows x (64 inputs, 64 gates) interleaved
    // by 8, SHARE sums a thread.
    float ig[SHARE];
#pragma unroll
    for (int i = 0; i < SHARE; ++i) ig[i] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = wait_stage();
      const uint32_t a = ring + s * STAGE_BYTES + group * (PANEL_BYTES / 2);
      const uint32_t b = ring + s * STAGE_BYTES + PANEL_BYTES;
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hop::wgmma_ss<2 * SHARE>(ig, hop::k_major<BK>(a, kk), hop::k_major<BK>(b, kk), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();  // the previous k-step's products are done with its stage
      if (prev >= 0) release(prev);
      prev = s;
      ++it;
    }
    hop::wgmma_wait<0>();
    hop::pin<SHARE>(ig);
    release(prev);

    // h of the share into this CTA's panel `rank`, then into every peer's.
    if (c > 0) hop::mbar_wait_cluster(&h_free, (c - 1) & 1);
    const uint32_t own = h_base + rank * PANEL_BYTES;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
#pragma unroll
      for (int j = 0; j < SHARE / 8; ++j) {  // accumulator blocks 2j (inputs), 2j + 1 (gates)
        const float* in = ig + 8 * j + 2 * i;
        const float* gate = in + 4;
        __nv_bfloat162 v;
        v.x = gemm_engine::geglu<bf16>(in[0], gate[0], act);
        v.y = gemm_engine::geglu<bf16>(in[1], gate[1], act);
        hop::sts32(own + r * ROW_BYTES + ((j ^ g) << 4) + 4 * q,
                   *reinterpret_cast<const uint32_t*>(&v));
      }
    }
    hop::fence_proxy_async();  // the copies below read the panel through the async proxy
    hop::bar_sync(bar_consumer(group), GROUP);  // the warpgroup's 64 rows of the panel are whole
    if (t == 0) {
      const uint32_t half = own + group * (PANEL_BYTES / 2);
      for (int p = 0; p < C; ++p)
        if (p != rank)
          hop::bulk_copy_to_peer(hop::map_to_rank(half, p), half, PANEL_BYTES / 2,
                                 hop::map_to_rank(hop::smem_u32(&h_full), p));
      // The peers' halves of the chunk complete this CTA's phase; one
      // warpgroup's arrival announces their bytes.
      if (group == 0)
        hop::mbar_arrive_expect_tx(&h_full, (C - 1) * PANEL_BYTES);
      else
        hop::mbar_arrive(&h_full);
    }
    hop::mbar_wait_cluster(&h_full, c & 1);

    // out[:, n0 ..] += h_chunk . Wo[n0 .., chunk]^T, panel by panel; h from
    // shared memory as wgmma's A in registers (hopper.cuh's m16k16 layout).
    for (int p = 0; p < C; ++p) {
      const int s = wait_stage();
      const uint32_t hp = h_base + p * PANEL_BYTES;
      uint32_t af[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // columns 16 kk + 2q (+ 8 half)
          const uint32_t col = ((2 * kk + half) ^ g) << 4;
          af[kk][2 * half] = hop::lds32(hp + row0 * ROW_BYTES + col + 4 * q);
          af[kk][2 * half + 1] = hop::lds32(hp + (row0 + 8) * ROW_BYTES + col + 4 * q);
        }
      }
      const uint32_t b = ring + s * STAGE_BYTES;
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hop::wgmma_rs<OUT_COLS, 0>(acc, af[kk], hop::k_major<BK>(b, kk), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();  // af is read: the next panel may reuse its registers
      release(s);
      ++it;
    }
    arrive_everywhere(&h_free);  // the chunk's h is read
  }
  // The peers have read (so the copies have read) this CTA's last panel, and
  // no copy or arrival is still on its way here: the CTA may finish.
  hop::mbar_wait_cluster(&h_free, (n_chunks - 1) & 1);
  hop::pin<OUT_COLS / 2>(acc);

  // Both consumers are past their last product and every copy was waited
  // for: the ring is free. Stage the warpgroup's rows at [64][OUT_COLS + 8]
  // and store 16 bytes at a time (K % 16 == 0, out 16-byte aligned).
  hop::bar_sync(BAR_CONSUMERS, CONSUMERS * GROUP);
  bf16* staged = reinterpret_cast<bf16*>(smem) + group * 64 * STAGED_PITCH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* row = staged + (warp * 16 + g + 8 * i) * STAGED_PITCH + 2 * q;
#pragma unroll
    for (int n = 0; n < OUT_COLS / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
  }
  hop::bar_sync(bar_consumer(group), GROUP);
  constexpr int CHUNKS = OUT_COLS / 8;
  for (int idx = t; idx < 64 * CHUNKS; idx += GROUP) {
    const int r = idx / CHUNKS, col = n0 + (idx % CHUNKS) * 8, row = m0 + group * 64 + r;
    if (row < M && col < K)
      *reinterpret_cast<uint4*>(out + (size_t)row * K + col) =
          *reinterpret_cast<const uint4*>(staged + r * STAGED_PITCH + (idx % CHUNKS) * 8);
  }
}

// Clusters of C CTAs the card runs at once (0 if it cannot run one).
int max_clusters(int C) {
  static int known[wgf::MAX_CLUSTER + 1] = {};
  if (known[C] == 0) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(C, 4096);
    config.blockDim = dim3(WG_THREADS);
    config.dynamicSmemBytes = wgf::smem_bytes(C);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    int n = 0;
    if (cudaFuncSetAttribute(tail_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wgf::smem_bytes(C)) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&n, tail_fwd_wgmma_kernel, &config) != cudaSuccess)
      return 0;
    known[C] = n;
  }
  return known[C];
}

int launch_wgmma(const bf16* xn, const bf16* wi, const bf16* wo, bf16* out, int M, int K, int I,
                 int act, cudaStream_t s) {
  using namespace wgf;
  const int C = cluster(K);
  if (K % 16 || I % 8 || C > MAX_CLUSTER || reinterpret_cast<uintptr_t>(xn) % 16 ||
      reinterpret_cast<uintptr_t>(wi) % 16 || reinterpret_cast<uintptr_t>(wo) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xn_map, wi_map, wo_map;
  {  // xn [M, K] in boxes of 128 rows x 64
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M}, strides[1] = {(cuuint64_t)K * 2};
    const cuuint32_t box[2] = {BK, ROWS};
    if (!gemm_engine::bf16_map(&xn_map, xn, 2, dims, strides, box))
      return (int)cudaErrorInvalidValue;
  }
  {  // Wi as [2][I][K] in boxes of 2 x 8 rows x 64: 8 input rows, then their gate rows
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)I, 2};
    const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)I * K * 2};
    const cuuint32_t box[3] = {BK, GATE_BLOCK, 2};
    if (!gemm_engine::bf16_map(&wi_map, wi, 3, dims, strides, box))
      return (int)cudaErrorInvalidValue;
  }
  {  // Wo [K, I] in boxes of 128 rows (output columns) x 64 columns of I
    const cuuint64_t dims[2] = {(cuuint64_t)I, (cuuint64_t)K}, strides[1] = {(cuuint64_t)I * 2};
    const cuuint32_t box[2] = {SHARE, OUT_COLS};
    if (!gemm_engine::bf16_map(&wo_map, wo, 2, dims, strides, box))
      return (int)cudaErrorInvalidValue;
  }
  const int smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(tail_fwd_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(C, (M + ROWS - 1) / ROWS);
  config.blockDim = dim3(WG_THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, tail_fwd_wgmma_kernel, xn_map, wi_map, wo_map, out, M, K, I,
                           act, stages(C));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---- fp32 -----------------------------------------------------------------------

namespace simt_fwd {
constexpr int OS = 16;  // contraction slab (columns of I) of the output product
template <int JN>
constexpr size_t smem_bytes(int K) {
  const size_t slab =
      simt::KS * simt::LDB > OS * (16 * JN + 1) ? simt::KS * simt::LDB : OS * (16 * JN + 1);
  return ((size_t)simt::BM * (K + 1) + simt::BM * simt::LDC + slab) * sizeof(float);
}
}  // namespace simt_fwd

// JN: output columns a thread holds (tx + 16 j), K <= 16 * JN.
template <int JN>
__global__ void __launch_bounds__(THREADS)
    tail_fwd_fma_kernel(const float* __restrict__ xn, const float* __restrict__ wi,
                        const float* __restrict__ wo, float* __restrict__ out, int M, int K,
                        int I, int act) {
  using namespace simt;
  constexpr int OS = simt_fwd::OS, LDW = 16 * JN + 1;
  extern __shared__ float smem_f[];
  const int ldx = K + 1;
  float* Xs = smem_f;          // [BM][ldx]
  float* Hs = Xs + BM * ldx;   // [BM][LDC]
  float* Bs = Hs + BM * LDC;   // a slab of Wi ([KS][LDB]) or of Wo ([OS][LDW])
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * BM;

  for (int idx = threadIdx.x; idx < BM * K; idx += THREADS) {
    const int r = idx / K, c = idx % K;
    Xs[r * ldx + c] = m0 + r < M ? xn[(size_t)(m0 + r) * K + c] : 0.f;
  }

  float o[JN] = {};
  for (int i0 = 0; i0 < I; i0 += CH) {
    float pi[4] = {}, pg[4] = {};  // inp and gate of columns tx + 16 j of the chunk
    for (int k0 = 0; k0 < K; k0 += KS) {
      __syncthreads();
      stage_t(Bs, LDB, 2 * CH, KS, wi, K, [&](int c) { return wi_chunk_row(c, i0, I); }, k0, K);
      __syncthreads();
      const int ks = min(KS, K - k0);
      fma_row<4>(pi, Xs + ty * ldx + k0, Bs + tx, LDB, ks);
      fma_row<4>(pg, Xs + ty * ldx + k0, Bs + CH + tx, LDB, ks);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Hs[ty * LDC + tx + 16 * j] = gemm_engine::geglu<float>(pi[j], pg[j], act);
    for (int s0 = 0; s0 < CH; s0 += OS) {
      __syncthreads();
      // Ws[ii][n] = Wo[n][i0 + s0 + ii]
      stage_t(Bs, LDW, K, OS, wo, I, [&](int n) { return (long long)n; }, i0 + s0, I);
      __syncthreads();
      fma_row<JN>(o, Hs + ty * LDC + s0, Bs + tx, LDW, OS);
    }
  }
  if (m0 + ty < M) {
#pragma unroll
    for (int j = 0; j < JN; ++j)
      if (tx + 16 * j < K) out[(size_t)(m0 + ty) * K + tx + 16 * j] = o[j];
  }
}

template <int JN>
int launch_fma(const float* xn, const float* wi, const float* wo, float* out, int M, int K, int I,
               int act, cudaStream_t s) {
  const size_t smem = simt_fwd::smem_bytes<JN>(K);
  const cudaError_t err = cudaFuncSetAttribute(
      tail_fwd_fma_kernel<JN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tail_fwd_fma_kernel<JN><<<(M + simt::BM - 1) / simt::BM, THREADS, smem, s>>>(xn, wi, wo, out,
                                                                             M, K, I, act);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mlp_tail

// xn: scratch [M, K] in the storage type. All tensors contiguous. K <= 1024;
// bf16 also takes K % 16 == 0 and I % 8 == 0 (the wrapper checks both).
extern "C" int opt_ln_geglu_wo(const void* x, const void* scale, const void* wi, const void* wo,
                               void* out, void* xn, int m, int k, int intermediate, float eps,
                               int act, int dtype, void* stream) {
  if (m <= 0 || k <= 0 || intermediate <= 0) return 0;
  if (k > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    const float* wit = static_cast<const float*>(wi);
    const float* wot = static_cast<const float*>(wo);
    float* xnt = static_cast<float*>(xn);
    float* outt = static_cast<float*>(out);
    OPT_TRY(gemm_engine::normalize<float>(static_cast<const float*>(x),
                                          static_cast<const float*>(scale), xnt, m, k, eps, s));
    if (k <= 256) return mlp_tail::launch_fma<16>(xnt, wit, wot, outt, m, k, intermediate, act, s);
    if (k <= 768) return mlp_tail::launch_fma<48>(xnt, wit, wot, outt, m, k, intermediate, act, s);
    return mlp_tail::launch_fma<64>(xnt, wit, wot, outt, m, k, intermediate, act, s);
  }
  if (dtype == DTYPE_BF16) {
    using mlp_tail::bf16;
    const bf16* wit = static_cast<const bf16*>(wi);
    const bf16* wot = static_cast<const bf16*>(wo);
    bf16* xnt = static_cast<bf16*>(xn);
    bf16* outt = static_cast<bf16*>(out);
    if (k % 16 || intermediate % 8) return (int)cudaErrorInvalidValue;
    OPT_TRY(gemm_engine::normalize<bf16>(static_cast<const bf16*>(x),
                                         static_cast<const bf16*>(scale), xnt, m, k, eps, s));
    return mlp_tail::launch_wgmma(xnt, wit, wot, outt, m, k, intermediate, act, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The bf16 design of kernels 8 and 13 at hidden size K, fixed when the
// library is built: out[0] = the forward's cluster CTAs, out[1] = the
// output columns a CTA owns, out[2] = the columns of h a CTA forms a chunk,
// out[3] = the forward ring's stages, out[4] = the rows of a tile; out[5],
// out[6] = the rows and columns of I of a backward row-pass tile, out[7] =
// its ring's stages; out[8] = the forward's clusters the current card holds
// at once. Returns 0, or -1 for a K the kernels do not take.
extern "C" int opt_mlp_tail_design(int k, int* out) {
  namespace mt = mlp_tail;
  const int C = mt::wgf::cluster(k);
  if (k <= 0 || k % 16 || C > mt::wgf::MAX_CLUSTER) return -1;
  const int design[9] = {C,        mt::wgf::OUT_COLS, mt::wgf::SHARE,  mt::wgf::stages(C),
                         mt::ROWS, mt::wgb::TILE_M,   mt::wgb::NI,     mt::wgb::STAGES,
                         mt::max_clusters(C)};
  for (int i = 0; i < 9; ++i) out[i] = design[i];
  return 0;
}
