// One step of location-sensitive additive attention.
//
// Replaces: `semi_tts_tpu/models/attention.py` `attention_step`, the
// attention half of the decoder step body of `models/decoder.py`
// `decoder_apply` (ROADMAP B4), which runs once per decode step. The query
// projection pq = query_layer(q_h) is a plain product and stays a matmul
// outside; this kernel takes it as an input.
//
// Inputs (float32, contiguous): pq (B, A), processed_memory (B, L, A),
// memory (B, L, D), attn_hist (B, C, L) stacked [weights, summed weights],
// loc_w (F, C, K) location conv weights (no bias, padding (K-1)//2,
// cross-correlation over L exactly as lax.conv with TIO weights),
// loc_lin (A, F), v (A), an optional mask (B, L) of bytes (1 = padded).
// F = 0 (no loc_w) is the location-free attention. Outputs: context (B, D)
// and weights (B, L).
//
// What bounds it on an H100: bytes, in principle. At serving shapes (B=16,
// L=32, A=256, D=512, F=32, K=31) it reads ~1.6 MB (processed_memory and
// memory) and does ~11 MFLOP, so the floor is ~0.5 us of HBM time. What a
// call really pays is latency: the launch, the loads, and a chain of
// dependent phases (location conv -> energies -> softmax -> context), each
// too small to fill an SM. `chip_ablate.py` times the phases (PERF.md).
//
// Design: one thread-block cluster of kCluster CTAs per batch row, so that
// B=16 fills 128 of the 132 SMs and every phase runs on 8 SMs at once.
// - CTA r owns the attention columns [r*Ac, r*Ac + Ac) and the context
//   columns [r*Dc, r*Dc + Dc), Ac = ceil(A/n), Dc = ceil(D/n), cut at A and
//   D (uneven slices: any A, D >= 1, the last CTAs' slices shorter or empty,
//   their loops guarded; no padding launched around the kernel). Its prologue issues every load it needs at
//   once with cp.async, in two groups: first what the location features
//   and energies need (attn_hist zero-padded for the conv, loc_w, its rows
//   of loc_lin, its slices of pq and v), then its slices of
//   processed_memory and memory (16 bytes a copy; memory only when it fits,
//   else the context loop reads it from L2). The conv waits only for the
//   first group; the mask is read into shared memory meanwhile.
// - Location features loc[l, f] are needed whole by every CTA, and each
//   CTA computes them itself (63k FMAs at serving shapes): a thread slides
//   a window of 4 positions of the history through registers, 4 chains of
//   FMAs. They come in tiles of `loc_tile` positions so that L up to ~1,200
//   fits in shared memory. Splitting the filters over the cluster and
//   exchanging them through distributed shared memory read slower.
// - Energies: a warp takes 4 positions at once, lanes over the CTA's
//   attention columns, reading loc_lin and the features as float4 (rows
//   padded to an odd number of float4s, so a warp's reads do not collide in
//   the banks). The partials go into this CTA's slot, then into slot r of
//   every peer as 16-byte stores to distributed shared memory, then one
//   cluster barrier. Each CTA sums the n partials in the order r = 0..n-1,
//   so all CTAs hold the same energies bit for bit, and applies the mask
//   and the softmax itself. CTA 0 writes the weights; each CTA writes its
//   context columns. No CTA touches a peer's shared memory after the
//   barrier, so none can exit while a peer still needs it.
// - tanh and exp use __expf / __fdividef, as the recurrences do.
// The launch plan (cluster, grid, shared memory, loc_tile, whether memory
// is staged) is computed by `kernels/attention.py` `attention_plan`; this
// file lays out shared memory the same way.
//
// The split route (`attention_split_kernel`), past the L one cluster holds
// (1,187 at flagship widths: the regions above take 44 floats a position):
// the grid is (chunk of kCluster * span positions, batch row), a cluster a
// chunk, and the chunk's positions split over its CTAs, `span` each. So the
// location conv of a position is computed once (the first design, a
// cluster a chunk running the body above, computed the chunk's whole conv
// in each of its 8 CTAs), and no energy crosses CTAs: each CTA stages
// loc_lin (whole, or in tiles of rows where it does not fit, as at A=1024
// F=64) and its positions' processed memory and memory rows. A CTA's raw
// masked energies go into `weights`; its maximum, its sum of exp and its
// unnormalised context are combined over the cluster through distributed
// shared memory in rank order into the chunk's (m_c, s_c) and context, and
// the cluster of the last CTA of a row to finish (a ticket a row, an atomic
// after a fence) combines the chunks: m = max m_c, s = sum s_c exp(m_c - m)
// (fixed orders), weights = exp(e - m) / s, context = sum exp(m_c - m) ctx_c
// / s in chunk order, in place of the first design's second kernel.
// Whichever CTA finishes last, a rerun repeats bit for bit; a masked chunk
// adds 0; a row masked everywhere gives NaN, as one cluster does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;   // CTAs per batch row (attention.py CLUSTER)
constexpr int kThreads = 256;
constexpr int kRows = 4;      // energy positions a warp computes together
constexpr int kConvL = 4;     // location-feature positions a thread computes together
constexpr int kSplitRows = 6; // the split route's energy positions a warp computes together
// floats of a split-route CTA's statistics: its m_r, s_r, the chunk's m_c,
// its ticket; the peers' scales and scaled sums; a block reduction's
constexpr int kSplitStat = 4 + 2 * kCluster + kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float tanh_(float x) {
  return copysignf(1.0f - __fdividef(2.0f, __expf(2.0f * fabsf(x)) + 1.0f), x);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Copy a (rows, cols) slice of a row-major array with row stride `ld` into
// shared memory with row stride `ds`; 16 bytes a copy when `vec`.
__device__ __forceinline__ void stage_slice(float* dst, int ds, const float* src, int ld,
                                            int rows, int cols, bool vec) {
  if (vec) {
    const int c4 = cols >> 2;
    for (int i = threadIdx.x; i < rows * c4; i += blockDim.x) {
      const int row = i / c4, c = (i - row * c4) << 2;
      cp_async16(dst + row * ds + c, src + row * ld + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int row = i / cols, c = i - row * cols;
      cp_async4(dst + row * ds + c, src + row * ld + c);
    }
  }
}

// Zero columns [from, ds) of a (rows, ds) shared-memory array.
__device__ __forceinline__ void zero_tail(float* dst, int ds, int rows, int from) {
  const int n = ds - from;
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x) dst[(i / n) * ds + from + i % n] = 0.0f;
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Row stride of loc_lin and of the location features in shared memory: F
// rounded up to whole float4s, an odd number of them, so that the float4
// reads of 8 neighbouring lanes fall in 8 different 16-byte bank groups.
__host__ __device__ __forceinline__ int feature_stride(int F) {
  const int n = round4(F);
  return (n / 4) % 2 ? n : n + 4;
}

// Shared-memory layout in floats, each region a multiple of 4 floats
// (attention.py `attention_plan` adds up the same regions).
struct Layout {
  int pm, mem, part, e, w, hist, locf, lin, wloc, pq, v, red, total;
  __host__ __device__ Layout(int L, int Ac, int Dc, int C, int F, int K, int tile, int stage_mem) {
    int at = 0;
    pm = at;   at += round4(L * Ac);
    mem = at;  at += stage_mem ? round4(L * Dc) : 0;
    part = at; at += kCluster * round4(L);
    e = at;    at += round4(L);
    w = at;    at += round4(L);
    hist = at; at += round4(C * (L + K - 1 + kConvL - 1));
    locf = at; at += tile * feature_stride(F);
    lin = at;  at += Ac * feature_stride(F);
    wloc = at; at += round4(F * (C * K + 1));
    pq = at;   at += round4(Ac);
    v = at;    at += round4(Ac);
    red = at;  at += round4(Dc > kThreads ? Dc : kThreads);
    total = at;
  }
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Cluster blockIdx.x / kCluster takes row b whole.
__global__ void __launch_bounds__(kThreads)
attention_step_kernel(const float* __restrict__ pq, const float* __restrict__ pm,
                      const float* __restrict__ memory, const float* __restrict__ hist,
                      const float* __restrict__ loc_w, const float* __restrict__ loc_lin,
                      const float* __restrict__ v, const unsigned char* __restrict__ mask,
                      float* __restrict__ context, float* __restrict__ weights,
                      int L, int A, int D, int C, int F, int K, int tile, int stage_mem,
                      int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  // Peers write into this CTA's `part` only after every CTA of the cluster
  // has started: arrive now, wait just before the first remote store.
  cluster_arrive_relaxed();
  extern __shared__ __align__(16) float smem[];
  const int r = (int)cluster.block_rank();
  const int b = (int)blockIdx.x / kCluster;
  // this CTA's slices: Ac (Dc) columns from r * Ac (r * Dc), cut at A (D)
  const int Ac = (A + kCluster - 1) / kCluster, Dc = (D + kCluster - 1) / kCluster;
  const int na = max(0, min(Ac, A - r * Ac)), nd = max(0, min(Dc, D - r * Dc));
  const Layout lay(L, Ac, Dc, C, F, K, tile, stage_mem);
  float* pm_s = smem + lay.pm;
  float* mem_s = smem + lay.mem;
  float* part = smem + lay.part;   // (kCluster, Lr) partial energies, slot = sender
  float* e = smem + lay.e;         // (L) the mask as 0/1, then energies
  float* w = smem + lay.w;         // (L) weights
  float* hist_s = smem + lay.hist; // (C, Lp) attn_hist zero-padded by (K-1)/2 on the left
  float* locf = smem + lay.locf;   // (tile, FS) location features, zero past F
  float* lin_s = smem + lay.lin;   // (Ac, FS) this CTA's rows of loc_lin, zero past F
  float* wloc = smem + lay.wloc;   // (F, C*K + 1): loc_w, rows padded by one (no bank conflicts)
  float* pq_s = smem + lay.pq;
  float* v_s = smem + lay.v;
  float* red = smem + lay.red;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  // prologue: every load of the CTA in flight at once, in two groups: what
  // the location features and energies need, then the memory slices
  const int pad = (K - 1) / 2, Lp = L + K - 1 + kConvL - 1, CK = C * K, FS = feature_stride(F);
  for (int i = tid; i < C * Lp; i += blockDim.x) {
    const int c = i / Lp, x = i - c * Lp - pad;
    if (x >= 0 && x < L) cp_async4(hist_s + i, hist + ((size_t)b * C + c) * L + x);
    else hist_s[i] = 0.0f;
  }
  for (int i = tid; i < F * CK; i += blockDim.x) cp_async4(wloc + i + i / CK, loc_w + i);
  if (F > 0) {
    stage_slice(lin_s, FS, loc_lin + (size_t)r * Ac * F, F, na, F, vec && F % 4 == 0);
    zero_tail(lin_s, FS, Ac, F);
    zero_tail(locf, FS, tile, F);
  }
  for (int i = tid; i < na; i += blockDim.x) {
    cp_async4(pq_s + i, pq + (size_t)b * A + r * Ac + i);
    cp_async4(v_s + i, v + r * Ac + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage_slice(pm_s, Ac, pm + (size_t)b * L * A + r * Ac, A, L, na, vec);
  const float* mem_b = memory + (size_t)b * L * D + r * Dc;
  if (stage_mem) stage_slice(mem_s, Dc, mem_b, D, L, nd, vec);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int l = tid; l < L; l += blockDim.x)
    e[l] = mask != nullptr && mask[(size_t)b * L + l];
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // the first group has landed
  __syncthreads();
  cluster_wait();

  const int Lr = round4(L);
  float* own = part + r * Lr;      // this CTA's slot
  const int step = tile > 0 ? tile : L;
  for (int l0 = 0; l0 < L; l0 += step) {
    const int rows = min(step, L - l0);
    if (F > 0) {
      // locf[ll, f] = sum_c sum_k loc_w[f, c, k] * hist[c, l0 + ll + k - pad]
      if (l0 > 0) __syncthreads();  // the previous tile's energies are done with locf
      // a thread makes kConvL neighbouring positions of one filter, sliding
      // a window of the history through registers
      const int groups = (rows + kConvL - 1) / kConvL;
      for (int i = tid; i < groups * F; i += blockDim.x) {
        const int lb = (i / F) * kConvL, f = i - (i / F) * F;
        float acc[kConvL] = {};
        for (int c = 0; c < C; ++c) {
          const float* wk = wloc + f * (CK + 1) + c * K;
          const float* h = hist_s + c * Lp + l0 + lb;  // h[q + k] = hist[c, l0+lb+q + k - pad]
          float win[kConvL];
#pragma unroll
          for (int q = 0; q < kConvL - 1; ++q) win[q + 1] = h[q];
#pragma unroll 4
          for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int q = 0; q < kConvL - 1; ++q) win[q] = win[q + 1];
            win[kConvL - 1] = h[k + kConvL - 1];
            const float wv = wk[k];
#pragma unroll
            for (int q = 0; q < kConvL; ++q) acc[q] = fmaf(wv, win[q], acc[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < kConvL; ++q)
          if (lb + q < rows) locf[(lb + q) * FS + f] = acc[q];
      }
    }
    if (l0 == 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // pm and memory
    __syncthreads();
    // partial energies over this CTA's columns for kRows positions a warp at
    // once (lanes over columns), pushed into slot r of every CTA
    for (int lb = warp * kRows; lb < rows; lb += nwarps * kRows) {
      int lq[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) lq[q] = min(lb + q, rows - 1);
      float acc[kRows] = {};
      for (int a = lane; a < na; a += 32) {
        float loc[kRows] = {};
        const float* la = lin_s + a * FS;
#pragma unroll 2
        for (int f = 0; f < F; f += 4) {
          const float4 lv = *reinterpret_cast<const float4*>(la + f);
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            const float4 lf = *reinterpret_cast<const float4*>(locf + lq[q] * FS + f);
            loc[q] = fmaf(lf.x, lv.x, loc[q]);
            loc[q] = fmaf(lf.y, lv.y, loc[q]);
            loc[q] = fmaf(lf.z, lv.z, loc[q]);
            loc[q] = fmaf(lf.w, lv.w, loc[q]);
          }
        }
        const float pa = pq_s[a], va = v_s[a];
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          acc[q] = fmaf(tanh_((pa + loc[q]) + pm_s[(l0 + lq[q]) * Ac + a]), va, acc[q]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int q = 0; q < kRows; ++q) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          if (lb + q < rows) own[l0 + lb + q] = acc[q];
      }
    }
  }
  // push this CTA's partials into slot r of every peer, 16 bytes a store
  __syncthreads();
  const int L4 = Lr / 4;
  for (int i = tid; i < (kCluster - 1) * L4; i += blockDim.x) {
    const int q = i / L4, m = i - q * L4;
    float4* dst = reinterpret_cast<float4*>(own) + m;
    *cluster.map_shared_rank(dst, q < r ? q : q + 1) = *dst;
  }
  cluster.sync();  // every partial has landed; no remote access after this

  for (int l = tid; l < L; l += blockDim.x) {
    float s = 0.0f;
    for (int q = 0; q < kCluster; ++q) s += part[q * Lr + l];
    e[l] = e[l] != 0.0f ? -INFINITY : s;
  }
  __syncthreads();
  // softmax statistics, computed by every warp for itself (same order, same result)
  float m = -INFINITY;
  for (int l = lane; l < L; l += 32) m = fmaxf(m, e[l]);
  m = warp_max(m);
  float sum = 0.0f;
  for (int l = lane; l < L; l += 32) sum += __expf(e[l] - m);
  sum = warp_sum(sum);
  for (int l = tid; l < L; l += blockDim.x) {
    const float wl = __expf(e[l] - m) / sum;
    w[l] = wl;
    if (r == 0) weights[(size_t)b * L + l] = wl;
  }
  __syncthreads();
  float* ctx_out = context + (size_t)b * D;

  // context[d] = sum_l w[l] * memory[l, d] over this CTA's columns; G groups
  // of positions when the columns leave threads idle, summed in group order
  const int G = nd >= (int)blockDim.x ? 1 : (int)blockDim.x / max(nd, 1);
  for (int i = tid; i < G * nd; i += blockDim.x) {
    const int g = i / nd, d = i - g * nd;
    float acc = 0.0f;
    if (stage_mem) {
      for (int l = g; l < L; l += G) acc = fmaf(w[l], mem_s[l * Dc + d], acc);
    } else {
      for (int l = g; l < L; l += G) acc = fmaf(w[l], mem_b[(size_t)l * D + d], acc);
    }
    if (G == 1) ctx_out[r * Dc + d] = acc;
    else red[i] = acc;
  }
  if (G > 1) {
    __syncthreads();
    for (int d = tid; d < nd; d += blockDim.x) {
      float acc = 0.0f;
      for (int g = 0; g < G; ++g) acc += red[g * nd + d];
      ctx_out[r * Dc + d] = acc;
    }
  }
}

// The split route. Shared-memory layout of a CTA of `span` positions, in
// floats, each region a multiple of 4 floats (attention.py `_split_smem`
// adds up the same regions): its processed memory (span, A) and memory
// (span, D) when staged, `lin_rows` rows of loc_lin (A where they fit),
// its history window, location features (span, FS), loc_w, pq, v, its
// energies and weights (span each), the energies' partials by column part
// (kThreads / 32, span), its context (D), the row's context by group of
// chunks (kThreads) and its statistics.
struct SplitLayout {
  int pm, mem, lin, hist, locf, wloc, pq, v, e, w, red, ctx, comb, stat, total;
  __host__ __device__ SplitLayout(int span, int A, int D, int C, int F, int K, int stage_mem,
                                  int lin_rows) {
    const int sr = round4(span), FS = feature_stride(F);
    int at = 0;
    pm = at;   at += round4(span * A);
    mem = at;  at += stage_mem ? round4(span * D) : 0;
    lin = at;  at += F > 0 ? lin_rows * FS : 0;
    hist = at; at += round4(C * (span + K - 1 + kConvL - 1));
    locf = at; at += F > 0 ? span * FS : 0;
    wloc = at; at += round4(F * (C * K + 1));
    pq = at;   at += round4(A);
    v = at;    at += round4(A);
    e = at;    at += sr;
    w = at;    at += sr;
    red = at;  at += (kThreads / 32) * sr;
    ctx = at;  at += round4(D);
    comb = at; at += kThreads;
    stat = at; at += kSplitStat;
    total = at;
  }
};

// A row's CTAs that have finished, for the launch in flight: the last one
// sets its entry back to 0, so that every launch (and every replay of a
// CUDA graph) finds zeros. One set of entries per card: two split launches
// must not run at once (the port issues them on one stream).
__device__ unsigned g_split_tickets[65536];

// The sum (max) over a CTA of one value a thread, in a fixed order; every
// thread gets it. `tmp`: kThreads / 32 floats of shared memory.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = kMax ? warp_max(x) : warp_sum(x);
  __syncthreads();  // tmp is free
  if (lane == 0) tmp[warp] = x;
  __syncthreads();
  x = kMax ? -INFINITY : 0.0f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) x = kMax ? fmaxf(x, tmp[i]) : x + tmp[i];
  return x;
}

// Cluster blockIdx.x / kCluster takes the chunk of kCluster * span positions
// [chunk * kCluster * span, ...) of row blockIdx.y, CTA r of it the `span`
// positions from (chunk * kCluster + r) * span (none past the row). Each CTA
// computes its positions' location features, energies over all A columns
// (loc_lin in tiles of `lin_rows` rows where it does not fit whole), its
// maximum m_r, s_r = sum exp(e - m_r) and its unnormalised context
// sum exp(e - m_r) memory (all 0 where every position is masked), and
// writes its raw masked energies into `weights`; after a cluster barrier
// every CTA reads the cluster's (m_r, s_r) in rank order from distributed
// shared memory (the chunk's m_c = max m_r, s_c = sum s_r exp(m_r - m_c)),
// and CTA r sums column slice r of the cluster's contexts, scaled by
// exp(m_r - m_c), in rank order into `ctx_part` (B, chunks, D); rank 0
// writes (m_c, s_c) into `stats` (B, chunks, 2). Then each CTA takes a
// ticket of its row, and after a last cluster barrier the cluster of the
// CTA that took the row's last finishes the row from the chunks' partials:
// m = max m_c, s = sum s_c exp(m_c - m) (each in a fixed order), weights =
// exp(e - m) / s, context = sum exp(m_c - m) ctx_c / s in chunk order.
__global__ void __launch_bounds__(kThreads)
attention_split_kernel(const float* __restrict__ pq, const float* __restrict__ pm,
                       const float* __restrict__ memory, const float* __restrict__ hist,
                       const float* __restrict__ loc_w, const float* __restrict__ loc_lin,
                       const float* __restrict__ v, const unsigned char* __restrict__ mask,
                       float* __restrict__ context, float* __restrict__ weights,
                       float* __restrict__ stats, float* __restrict__ ctx_part, int L, int span,
                       int A, int D, int C, int F, int K, int stage_mem, int lin_rows, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int r = (int)cluster.block_rank();
  const int chunk = (int)blockIdx.x / kCluster, chunks = (int)gridDim.x / kCluster;
  const int b = (int)blockIdx.y;
  const int l0 = (chunk * kCluster + r) * span;   // this CTA's first position
  const int n = max(0, min(span, L - l0));        // and its number of positions
  const SplitLayout lay(span, A, D, C, F, K, stage_mem, lin_rows);
  float* pm_s = smem + lay.pm;     // (n, A)
  float* mem_s = smem + lay.mem;   // (n, D)
  float* lin_s = smem + lay.lin;   // (lin_rows, FS) rows of loc_lin, zero past F
  float* hist_s = smem + lay.hist; // (C, Lp): attn_hist from l0 - (K-1)/2, zero outside the row
  float* locf = smem + lay.locf;   // (span, FS) location features, zero past F
  float* wloc = smem + lay.wloc;   // (F, C*K + 1): loc_w, rows padded by one
  float* pq_s = smem + lay.pq;
  float* v_s = smem + lay.v;
  float* e = smem + lay.e;         // (n) the mask as 0/1, then energies
  float* w = smem + lay.w;         // (n) exp(e - m_r)
  float* red = smem + lay.red;     // (H, sr) energies by column part
  float* ctx = smem + lay.ctx;     // (D) this CTA's unnormalised context, read by peers
  float* comb = smem + lay.comb;   // (kThreads) the row's context by group of chunks
  float* stat = smem + lay.stat;   // m_r, s_r, m_c, the ticket; the peers' scales and sums; tmp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int sr = round4(span);

  // prologue: what the location features need, then what the energies
  // need, then the memory rows, each group of copies in flight at once
  const int pad = (K - 1) / 2, Lp = span + K - 1 + kConvL - 1, CK = C * K, FS = feature_stride(F);
  const bool lvec = vec && F % 4 == 0;
  for (int i = tid; i < C * Lp; i += blockDim.x) {
    const int c = i / Lp, x = l0 + i - c * Lp - pad;
    if (x >= 0 && x < L) cp_async4(hist_s + i, hist + ((size_t)b * C + c) * L + x);
    else hist_s[i] = 0.0f;
  }
  for (int i = tid; i < F * CK; i += blockDim.x) cp_async4(wloc + i + i / CK, loc_w + i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (F > 0) {
    stage_slice(lin_s, FS, loc_lin, F, min(lin_rows, A), F, lvec);
    zero_tail(lin_s, FS, lin_rows, F);
    zero_tail(locf, FS, span, F);
  }
  for (int i = tid; i < A; i += blockDim.x) {
    cp_async4(pq_s + i, pq + (size_t)b * A + i);
    cp_async4(v_s + i, v + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const float* mem_b = memory + ((size_t)b * L + l0) * D;
  if (n > 0) {
    stage_slice(pm_s, A, pm + ((size_t)b * L + l0) * A, A, n, A, vec);
    if (stage_mem) stage_slice(mem_s, D, mem_b, D, n, D, vec);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int l = tid; l < n; l += blockDim.x) e[l] = mask != nullptr && mask[(size_t)b * L + l0 + l];
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");  // the history and loc_w have landed
  __syncthreads();

  // locf[l, f] = sum_c sum_k loc_w[f, c, k] * hist[c, l0 + l + k - pad]: a
  // thread kConvL neighbouring positions of one filter, a window of the
  // history sliding through registers
  if (F > 0) {
    const int groups = (n + kConvL - 1) / kConvL;
    for (int i = tid; i < groups * F; i += blockDim.x) {
      const int lb = (i / F) * kConvL, f = i - (i / F) * F;
      float acc[kConvL] = {};
      for (int c = 0; c < C; ++c) {
        const float* wk = wloc + f * (CK + 1) + c * K;
        const float* h = hist_s + c * Lp + lb;
        float win[kConvL];
#pragma unroll
        for (int q = 0; q < kConvL - 1; ++q) win[q + 1] = h[q];
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
#pragma unroll
          for (int q = 0; q < kConvL - 1; ++q) win[q] = win[q + 1];
          win[kConvL - 1] = h[k + kConvL - 1];
          const float wv = wk[k];
#pragma unroll
          for (int q = 0; q < kConvL; ++q) acc[q] = fmaf(wv, win[q], acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kConvL; ++q)
        if (lb + q < n) locf[(lb + q) * FS + f] = acc[q];
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // loc_lin, pq, v, pm and memory
  __syncthreads();

  // energies: a warp kSplitRows positions and every H-th block of 32 columns (H
  // column parts, a pair of blocks a part at A = 64 H, so that every warp
  // works), a lane two columns 32 H apart at a time, over loc_lin's tiles of
  // lin_rows rows, each tile's sums added in tile order
  const int G = (n + kSplitRows - 1) / kSplitRows;
  const int H = max(1, min(nwarps, A / 64));
  const int tiles = F > 0 ? (A + lin_rows - 1) / lin_rows : 1;
  for (int tile = 0; tile < tiles; ++tile) {
    const int a0 = F > 0 ? tile * lin_rows : 0, a1 = F > 0 ? min(A, a0 + lin_rows) : A;
    if (tile > 0) {
      __syncthreads();  // every warp is done with the last tile
      stage_slice(lin_s, FS, loc_lin + (size_t)a0 * F, F, a1 - a0, F, lvec);
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
    }
    for (int item = warp; item < G * H; item += nwarps) {
      const int g = item / H, h = item - g * H, lb = g * kSplitRows;
      int lq[kSplitRows];
#pragma unroll
      for (int q = 0; q < kSplitRows; ++q) lq[q] = min(lb + q, n - 1);
      float acc[kSplitRows] = {};
      for (int a = a0 + h * 32 + lane; a < a1; a += 64 * H) {
        const int a2 = a + 32 * H;
        const bool two = a2 < a1;
        float loc[kSplitRows] = {}, loc2[kSplitRows] = {};
        const float* la = lin_s + (a - a0) * FS;
        const float* la2 = lin_s + ((two ? a2 : a) - a0) * FS;
#pragma unroll 4
        for (int f = 0; f < F; f += 4) {
          const float4 lv = *reinterpret_cast<const float4*>(la + f);
          const float4 lv2 = *reinterpret_cast<const float4*>(la2 + f);
#pragma unroll
          for (int q = 0; q < kSplitRows; ++q) {
            const float4 lf = *reinterpret_cast<const float4*>(locf + lq[q] * FS + f);
            loc[q] = fmaf(lf.x, lv.x, loc[q]);
            loc[q] = fmaf(lf.y, lv.y, loc[q]);
            loc[q] = fmaf(lf.z, lv.z, loc[q]);
            loc[q] = fmaf(lf.w, lv.w, loc[q]);
            loc2[q] = fmaf(lf.x, lv2.x, loc2[q]);
            loc2[q] = fmaf(lf.y, lv2.y, loc2[q]);
            loc2[q] = fmaf(lf.z, lv2.z, loc2[q]);
            loc2[q] = fmaf(lf.w, lv2.w, loc2[q]);
          }
        }
        const float pa = pq_s[a], va = v_s[a];
#pragma unroll
        for (int q = 0; q < kSplitRows; ++q)
          acc[q] = fmaf(tanh_((pa + loc[q]) + pm_s[lq[q] * A + a]), va, acc[q]);
        if (two) {
          const float pa2 = pq_s[a2], va2 = v_s[a2];
#pragma unroll
          for (int q = 0; q < kSplitRows; ++q)
            acc[q] = fmaf(tanh_((pa2 + loc2[q]) + pm_s[lq[q] * A + a2]), va2, acc[q]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int q = 0; q < kSplitRows; ++q) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kSplitRows; ++q)
          if (lb + q < n) red[h * sr + lb + q] = tile > 0 ? red[h * sr + lb + q] + acc[q] : acc[q];
      }
    }
  }
  __syncthreads();
  for (int l = tid; l < n; l += blockDim.x) {
    float s = 0.0f;
    for (int h = 0; h < H; ++h) s += red[h * sr + l];
    e[l] = e[l] != 0.0f ? -INFINITY : s;
    weights[(size_t)b * L + l0 + l] = e[l];   // raw: the row's last CTA normalises it
  }
  __syncthreads();
  // m_r and s_r, computed by every warp for itself (same order, same result);
  // every position masked (or none): m_r = -inf, s_r = 0, weights 0
  float m = -INFINITY;
  for (int l = lane; l < n; l += 32) m = fmaxf(m, e[l]);
  m = warp_max(m);
  const bool dead = m == -INFINITY;
  float sum = 0.0f;
  for (int l = lane; l < n; l += 32) sum += dead ? 0.0f : __expf(e[l] - m);
  sum = warp_sum(sum);
  for (int l = tid; l < n; l += blockDim.x) w[l] = dead ? 0.0f : __expf(e[l] - m);
  if (tid == 0) stat[0] = m, stat[1] = sum, stat[3] = 0.0f;  // not (yet) the row's last
  __syncthreads();
  // this CTA's context over every column: sum_l w[l] memory[l, d]
  for (int d = tid; d < D; d += blockDim.x) {
    float acc = 0.0f;
    if (stage_mem) {
      for (int l = 0; l < n; ++l) acc = fmaf(w[l], mem_s[l * D + d], acc);
    } else {
      for (int l = 0; l < n; ++l) acc = fmaf(w[l], mem_b[(size_t)l * D + d], acc);
    }
    ctx[d] = acc;
  }
  cluster.sync();  // every CTA's m_r, s_r and context are in its shared memory

  // the chunk's statistics: the peers' (m_r, s_r) in rank order; the scale
  // exp(m_r - m_c) of each peer's sums (0 for a CTA whose positions are all
  // masked, and for every CTA of a chunk whose positions all are)
  float* scale = stat + 4;               // (kCluster) the peers' scales
  float* scaled = scale + kCluster;      // (kCluster) s_r times its scale
  float* tmp = scaled + kCluster;        // (kThreads / 32) block reductions
  if (warp == 0) {
    const float* peer = lane < kCluster ? cluster.map_shared_rank(stat, lane) : nullptr;
    const float mr = lane < kCluster ? peer[0] : -INFINITY;
    const float mc = warp_max(mr);
    if (lane < kCluster) {
      const float sc = mr == -INFINITY ? 0.0f : __expf(mr - mc);
      scale[lane] = sc;
      scaled[lane] = sc * peer[1];
    }
    if (lane == 0) stat[2] = mc;
  }
  __syncthreads();
  // CTA r's column slice: Dc columns from r * Dc, cut at D
  const int Dc = (D + kCluster - 1) / kCluster, nd = max(0, min(Dc, D - r * Dc));
  const size_t part = (size_t)b * chunks + chunk;
  for (int d = r * Dc + tid; d < r * Dc + nd; d += blockDim.x) {
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) acc = fmaf(scale[q], cluster.map_shared_rank(ctx, q)[d], acc);
    ctx_part[part * D + d] = acc;
  }
  if (r == 0 && tid == 0) {
    float s = 0.0f;
    for (int q = 0; q < kCluster; ++q) s += scaled[q];
    stats[2 * part] = stat[2];
    stats[2 * part + 1] = s;
  }
  __syncthreads();  // this CTA's partials are written
  if (tid == 0) {
    __threadfence();  // they (seen through the barrier) before the ticket, cumulatively
    if (atomicAdd(&g_split_tickets[b], 1u) == (unsigned)(kCluster * chunks) - 1) {
      g_split_tickets[b] = 0u;  // every CTA of the row has taken its ticket
      __threadfence();          // the others' partials before the reads below
      for (int q = 0; q < kCluster; ++q) *cluster.map_shared_rank(stat + 3, q) = 1.0f;
    }
  }
  cluster.sync();  // every CTA of the cluster knows whether it finishes the row; no remote access after
  if (stat[3] == 0.0f) return;

  // the cluster of the row's last CTA finishes the row: the chunks'
  // statistics (a thread every blockDim-th chunk, then a fixed tree, the
  // same in every CTA), the weights (CTA r every kCluster-th block of
  // blockDim positions) and the context (CTA r its column slice, G groups of
  // threads over the chunks where the slice leaves threads idle, summed in
  // group order). A chunk with every position masked has m_c = -inf and
  // s_c = 0 and adds 0; a row masked everywhere has m = -inf and gives NaN,
  // as the single-cluster kernel does.
  const float* st = stats + (size_t)b * chunks * 2;
  float mrow = -INFINITY;
  for (int c = tid; c < chunks; c += blockDim.x) mrow = fmaxf(mrow, __ldcg(st + 2 * c));
  mrow = block_reduce<true>(mrow, tmp);
  float srow = 0.0f;
  for (int c = tid; c < chunks; c += blockDim.x)
    srow += __ldcg(st + 2 * c + 1) * __expf(__ldcg(st + 2 * c) - mrow);
  srow = block_reduce<false>(srow, tmp);
  float* wrow = weights + (size_t)b * L;
#pragma unroll 4
  for (int l = r * blockDim.x + tid; l < L; l += kCluster * blockDim.x)
    wrow[l] = __expf(__ldcg(wrow + l) - mrow) / srow;
  const float* cp = ctx_part + (size_t)b * chunks * D;
  const int Gc = nd >= (int)blockDim.x ? 1 : (int)blockDim.x / max(nd, 1);
  for (int i = tid; i < Gc * nd; i += blockDim.x) {
    const int g = i / nd, d = r * Dc + i - g * nd;
    float acc = 0.0f;
#pragma unroll 4
    for (int c = g; c < chunks; c += Gc)
      acc = fmaf(__expf(__ldcg(st + 2 * c) - mrow), __ldcg(cp + (size_t)c * D + d), acc);
    if (Gc == 1) context[(size_t)b * D + d] = acc / srow;
    else comb[i] = acc;
  }
  if (Gc > 1) {
    __syncthreads();
    for (int j = tid; j < nd; j += blockDim.x) {
      float acc = 0.0f;
      for (int g = 0; g < Gc; ++g) acc += comb[g * nd + j];
      context[(size_t)b * D + r * Dc + j] = acc / srow;
    }
  }
}

// ------------------------------------------------- K9: the step's backward --
//
// Replaces the autodiff of `semi_tts_tpu/models/attention.py:39`
// `attention_step` inside the decoder's training scan. From the forward's
// inputs, its outputs (weights w (B, L), context (B, D)) and the cotangents
// d_context (B, D) and d_weights (B, L), per batch row:
//   dw[l]   = d_weights[l] + sum_d memory[l, d] * d_context[d]
//   s       = sum_l w[l] d_weights[l] + sum_d context[d] d_context[d]
//           ( = sum_l w[l] dw[l], since context = sum_l w[l] memory[l, :])
//   de[l]   = w[l] * (dw[l] - s)                              (softmax)
//   th      = tanh(pq + loc @ loc_lin^T + processed_memory)   (recomputed)
//   dpre    = de[l] * v[a] * (1 - th^2)                       (L, A)
//   d_pq = sum_l dpre, d_processed_memory = dpre, d_v = sum_l de[l] th[l, :],
//   d_memory[l, d] = w[l] * d_context[d],
//   d_loc_lin = dpre^T loc, d_loc = dpre @ loc_lin            (L, F)
//   d_loc_w[f, c, k] = sum_l d_loc[l, f] hist[c, l + k - pad]
//   d_attn_hist[c, x] = sum_{f, k} loc_w[f, c, k] d_loc[x - k + pad, f]
// A masked position has w = 0 from the forward, so de, dpre and d_memory are
// 0 there with no mask read.
//
// What bounds it: the bytes (pm, memory, d_pm, d_memory: ~13 MB at B=16,
// L=133, ~4 us of HBM time) and ~30k FMAs a position (~2 us of fp32 SIMT
// over the card), so neither: what a call pays is how few SMs work and how
// long the chain of dependent phases is.
//
// Design: the grid covers (span of P positions, batch row), so a row's
// positions run on many SMs at once (P, a multiple of 4 up to 32, from
// `attention_bwd_plan`: the least (CTAs an SM) x (P + a CTA's fixed work),
// as `chip_ablate.py`'s span sweep measured it; 4 at L=32, 20 at B=16
// L=133, 12 at B=2 L=700). No phase needs another span's data: s comes from
// the row's w, d_weights, context and d_context (each CTA sums them itself,
// in the same order), so de is local. A CTA of 256 threads:
// - prologue: the loads of s's operands first, then loc_lin (rows at an
//   odd float4 stride), loc_w, the history window [l0 - pad, l0 + P + pad),
//   pq and v in one cp.async group and the span's processed memory in a
//   second; meanwhile dw a warp per position (a warp's memory rows loaded
//   together, 16 bytes a lane, d_memory written beside them), then s;
// - the location features of the span, once (F x P, a thread each);
// - a thread per attention column a: loc from its row of loc_lin (float4)
//   and the features (float4 broadcasts), tanh, dpre into registers and
//   d_pm, its d_v and d_pq over the span, and its column of d_loc_lin
//   (dpre . loc) over the span;
// - d_loc (F x P, 4 positions and 2 filters a thread, A split into as many
//   groups as leave no thread idle, summed in group order); d_loc_w over
//   the span (4 taps a thread, the history through a register window) and
//   mk = loc_w^T d_loc, from which each element of the span's d_attn_hist
//   window [l0 - pad, l0 + P + pad) (the halo) is a sum over the span.
// Every weight gradient, d_pq and the d_attn_hist windows are written as
// per-(row, span) partials into one buffer (`PartLayout`: each element has
// one writer), and a second kernel, launched as a programmatic dependent
// launch (scheduled while the first runs, waiting for its end), sums them
// in a fixed order: the weight gradients over every (row, span), d_pq over
// a row's spans, d_attn_hist over the spans whose window holds the
// position. No atomics: a rerun repeats bit for bit.

// Row stride of dpre (A, P) in shared memory: an odd number of float4s, so
// the float4 stores of 8 neighbouring columns fall in 8 bank groups.
__host__ __device__ __forceinline__ int dpre_stride(int P) { return (P / 4) % 2 ? P : P + 4; }

struct BwdLayout {
  int lin, wloc, hist, pq, v, red, de, pm, dpre, locf, dloc, mk, total;
  __host__ __device__ BwdLayout(int P, int A, int C, int F, int K, int stage_lin) {
    int at = 0;
    lin = at;  at += stage_lin ? A * feature_stride(F) : 0;
    wloc = at; at += round4(F * C * K);
    hist = at; at += round4(C * (P + K - 1));
    pq = at;   at += round4(A);
    v = at;    at += round4(A);
    red = at;  at += 12 * kThreads;
    de = at;   at += P;
    pm = at;   at += round4(P * A);
    dpre = at; at += A * dpre_stride(P);
    locf = at; at += round4(F) * P;
    dloc = at; at += F * dpre_stride(P);
    mk = at;   at += round4(P * C * K);
    total = at;
  }
};

// One (row, span)'s partials, in floats: d_loc_w (F, C, K), d_loc_lin
// transposed (F, A), d_v (A), d_pq (A), d_attn_hist over the window (C, P + K - 1).
struct PartLayout {
  int lw, ll, v, q, h, total;
  __host__ __device__ PartLayout(int P, int A, int C, int F, int K) {
    int at = 0;
    lw = at; at += round4(F * C * K);
    ll = at; at += round4(F * A);
    v = at;  at += round4(A);
    q = at;  at += round4(A);
    h = at;  at += F > 0 ? round4(C * (P + K - 1)) : 0;
    total = at;
  }
};

template <int P, bool kStageLin>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const float* __restrict__ pq, const float* __restrict__ pm,
                     const float* __restrict__ memory, const float* __restrict__ hist,
                     const float* __restrict__ loc_w, const float* __restrict__ loc_lin,
                     const float* __restrict__ v, const float* __restrict__ weights,
                     const float* __restrict__ context, const float* __restrict__ d_context,
                     const float* __restrict__ d_weights, float* __restrict__ d_pm,
                     float* __restrict__ d_memory, float* __restrict__ part, int L, int A,
                     int D, int C, int F, int K) {
  extern __shared__ __align__(16) float smem[];
  const int span = blockIdx.x, b = blockIdx.y, S = gridDim.x;
  const int l0 = span * P, np = min(P, L - l0);
  const int pad = (K - 1) / 2, W = P + K - 1, CK = C * K, FS = feature_stride(F);
  const int PS = dpre_stride(P), F4 = round4(F);
  const BwdLayout lay(P, A, C, F, K, kStageLin);
  const PartLayout pl(P, A, C, F, K);
  float* lin_s = smem + lay.lin;    // (A, FS) loc_lin, zero past F
  float* wloc = smem + lay.wloc;    // (F, C, K)
  float* hist_s = smem + lay.hist;  // (C, W): hist[c, l0 - pad + j], zero outside [0, L)
  float* pq_s = smem + lay.pq;
  float* v_s = smem + lay.v;
  float* red = smem + lay.red;      // warp sums of s, then d_loc's group partials (G, F, PS)
  float* de = smem + lay.de;        // (P) dw, then de
  float* pm_s = smem + lay.pm;      // (P, A) processed memory, zero past the row
  float* dpre = smem + lay.dpre;    // (A, PS)
  float* locf = smem + lay.locf;    // (F4, P) location features, zero past F
  float* dloc = smem + lay.dloc;    // (F, PS)
  float* mk = smem + lay.mk;        // (P, C, K)
  float* prow = part + (size_t)(b * S + span) * pl.total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  // the sums kernel may be scheduled now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // s's operands first (for rows up to 4 * kThreads and D up to 2 * kThreads;
  // the rest below), so that their loads fly while the copies are issued
  const float* w_b = weights + (size_t)b * L;
  const float* dwt_b = d_weights + (size_t)b * L;
  const float* ctx_b = context + (size_t)b * D;
  const float* g = d_context + (size_t)b * D;
  float sw[4], sd[4], sc[2], sg[2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int l = tid + j * kThreads;
    sw[j] = l < L ? __ldg(w_b + l) : 0.0f;
    sd[j] = l < L ? __ldg(dwt_b + l) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int d = tid + j * kThreads;
    sc[j] = d < D ? __ldg(ctx_b + d) : 0.0f;
    sg[j] = d < D ? __ldg(g + d) : 0.0f;
  }
  // prologue: what the whole CTA holds in one cp.async group, the span's
  // processed memory in a second
  if (kStageLin) {
    stage_slice(lin_s, FS, loc_lin, F, A, F, F % 4 == 0 && ((size_t)loc_lin & 15) == 0);
    zero_tail(lin_s, FS, A, F);
  }
  for (int i = tid; i < F * CK; i += blockDim.x) cp_async4(wloc + i, loc_w + i);
  for (int i = tid; i < C * W; i += blockDim.x) {
    const int c = i / W, x = l0 - pad + i - c * W;
    if (x >= 0 && x < L) cp_async4(hist_s + i, hist + ((size_t)b * C + c) * L + x);
    else hist_s[i] = 0.0f;
  }
  for (int i = tid; i < A; i += blockDim.x) {
    cp_async4(pq_s + i, pq + (size_t)b * A + i);
    cp_async4(v_s + i, v + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage_slice(pm_s, A, pm + ((size_t)b * L + l0) * A, A, np, A,
              A % 4 == 0 && ((size_t)pm & 15) == 0);
  for (int i = np * A + tid; i < P * A; i += blockDim.x) pm_s[i] = 0.0f;
  for (int i = (F4 - F) * P, j = tid; j < i; j += blockDim.x) locf[F * P + j] = 0.0f;
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // dw a warp per position (memory . d_context), the loads of a warp's
  // positions in flight together, and the span's rows of d_memory
  constexpr int PW = (P + kThreads / 32 - 1) / (kThreads / 32);  // positions a warp
  float dot[PW], wl[PW];
#pragma unroll
  for (int q = 0; q < PW; ++q) {
    const int ll = warp + nwarps * q;
    dot[q] = 0.0f;
    wl[q] = ll < np ? __ldg(w_b + l0 + ll) : 0.0f;
  }
  if (D % 4 == 0 && (((size_t)memory | (size_t)d_memory | (size_t)d_context) & 15) == 0) {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int d0 = 4 * lane; d0 < D; d0 += 512) {
      float4 gv[4], m[PW][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + 128 * j;
        gv[j] = d < D ? __ldg(reinterpret_cast<const float4*>(g + d)) : zero;
#pragma unroll
        for (int q = 0; q < PW; ++q) {
          const int ll = warp + nwarps * q;
          m[q][j] = d < D && ll < np ? __ldg(reinterpret_cast<const float4*>(
                                            memory + ((size_t)b * L + l0 + ll) * D + d)) : zero;
        }
      }
#pragma unroll
      for (int q = 0; q < PW; ++q) {
        const int ll = warp + nwarps * q;
        if (ll >= np) continue;
        float* drow = d_memory + ((size_t)b * L + l0 + ll) * D;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = d0 + 128 * j;
          if (d >= D) continue;
          dot[q] = fmaf(m[q][j].x, gv[j].x, dot[q]);
          dot[q] = fmaf(m[q][j].y, gv[j].y, dot[q]);
          dot[q] = fmaf(m[q][j].z, gv[j].z, dot[q]);
          dot[q] = fmaf(m[q][j].w, gv[j].w, dot[q]);
          *reinterpret_cast<float4*>(drow + d) =
              make_float4(wl[q] * gv[j].x, wl[q] * gv[j].y, wl[q] * gv[j].z, wl[q] * gv[j].w);
        }
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < PW; ++q) {
      const int ll = warp + nwarps * q;
      if (ll >= np) continue;
      const float* mrow = memory + ((size_t)b * L + l0 + ll) * D;
      float* drow = d_memory + ((size_t)b * L + l0 + ll) * D;
      for (int d = lane; d < D; d += 32) {
        const float gv = __ldg(g + d);
        dot[q] = fmaf(__ldg(mrow + d), gv, dot[q]);
        drow[d] = wl[q] * gv;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < PW; ++q) {
    const int ll = warp + nwarps * q;
    const float x = warp_sum(dot[q]);
    if (lane == 0 && ll < np) de[ll] = __ldg(dwt_b + l0 + ll) + x;
  }
  // s = sum_l w d_weights + context . d_context, the same order in every CTA
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc = fmaf(sw[j], sd[j], acc);
  for (int l = tid + 4 * kThreads; l < L; l += kThreads) acc = fmaf(__ldg(w_b + l), __ldg(dwt_b + l), acc);
#pragma unroll
  for (int j = 0; j < 2; ++j) acc = fmaf(sc[j], sg[j], acc);
  for (int d = tid + 2 * kThreads; d < D; d += kThreads) acc = fmaf(__ldg(ctx_b + d), __ldg(g + d), acc);
  acc = warp_sum(acc);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (tid < P) {
    float s = 0.0f;
    for (int q = 0; q < nwarps; ++q) s += red[q];
    const float wl = tid < np ? __ldg(w_b + l0 + tid) : 0.0f;
    de[tid] = tid < np ? wl * (de[tid] - s) : 0.0f;
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // the held operands have landed
  __syncthreads();

  // locf[f, l] = sum_c sum_k loc_w[f, c, k] hist[c, l0 + l + k - pad]
  for (int i = tid; i < F * P; i += blockDim.x) {
    const int f = i / P, l = i - f * P;
    float a = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float* h = hist_s + c * W + l;
      const float* wk = wloc + f * CK + c * K;
#pragma unroll 8
      for (int k = 0; k < K; ++k) a = fmaf(wk[k], h[k], a);
    }
    locf[i] = a;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // processed memory
  __syncthreads();

  // a thread per attention column: tanh, dpre, d_pm, and its partials of
  // d_v, d_pq and d_loc_lin over the span
  for (int a = tid; a < A; a += blockDim.x) {
    float loc[P];
#pragma unroll
    for (int l = 0; l < P; ++l) loc[l] = 0.0f;
    for (int f = 0; f < F4; f += 4) {
      float lv[4];
      if (kStageLin) {
        const float4 x = *reinterpret_cast<const float4*>(lin_s + a * FS + f);
        lv[0] = x.x, lv[1] = x.y, lv[2] = x.z, lv[3] = x.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) lv[j] = f + j < F ? __ldg(loc_lin + (size_t)a * F + f + j) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4* lf = reinterpret_cast<const float4*>(locf + (f + j) * P);
#pragma unroll
        for (int q = 0; q < P / 4; ++q) {
          const float4 x = lf[q];
          loc[4 * q] = fmaf(x.x, lv[j], loc[4 * q]);
          loc[4 * q + 1] = fmaf(x.y, lv[j], loc[4 * q + 1]);
          loc[4 * q + 2] = fmaf(x.z, lv[j], loc[4 * q + 2]);
          loc[4 * q + 3] = fmaf(x.w, lv[j], loc[4 * q + 3]);
        }
      }
    }
    const float pa = pq_s[a], va = v_s[a];
    float dv = 0.0f, dq = 0.0f, dp[P];
#pragma unroll
    for (int l = 0; l < P; ++l) {
      const float t = tanh_((pa + loc[l]) + pm_s[l * A + a]);
      dp[l] = de[l] * va * (1.0f - t * t);
      dv = fmaf(de[l], t, dv);
      dq += dp[l];
      if (l < np) d_pm[((size_t)b * L + l0 + l) * A + a] = dp[l];
    }
#pragma unroll
    for (int q = 0; q < P / 4; ++q)
      *reinterpret_cast<float4*>(dpre + a * PS + 4 * q) =
          make_float4(dp[4 * q], dp[4 * q + 1], dp[4 * q + 2], dp[4 * q + 3]);
    prow[pl.v + a] = dv;
    prow[pl.q + a] = dq;
    // unrolled by 2, and not at span 24: no span spills (unrolled by 4,
    // spans 20 and 24 did; by 2, span 24 does)
#pragma unroll (P == 24 ? 1 : 2)
    for (int f = 0; f < F; ++f) {
      const float4* lf = reinterpret_cast<const float4*>(locf + f * P);
      float x = 0.0f;
#pragma unroll
      for (int q = 0; q < P / 4; ++q) {
        const float4 y = lf[q];
        x = fmaf(dp[4 * q], y.x, x);
        x = fmaf(dp[4 * q + 1], y.y, x);
        x = fmaf(dp[4 * q + 2], y.z, x);
        x = fmaf(dp[4 * q + 3], y.w, x);
      }
      prow[pl.ll + f * A + a] = x;
    }
  }
  if (F == 0) return;
  __syncthreads();

  // d_loc[f, l] = sum_a dpre[a, l] loc_lin[a, f]: a thread makes 4 positions
  // of two filters over one of G groups of columns; the groups summed in order
  const int F2 = (F + 1) / 2, items = F2 * (P / 4);
  const int G = items >= (int)blockDim.x ? 1 : (int)blockDim.x / items;
  const int chunk = (A + G - 1) / G;
  for (int i = tid; i < items * G; i += blockDim.x) {
    const int g = i / items, it = i - g * items, f = 2 * (it % F2), lq = it / F2;
    float4 x0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), x1 = x0;
    const int a1 = min(A, (g + 1) * chunk);
#pragma unroll 4
    for (int a = g * chunk; a < a1; ++a) {
      float2 lv;
      if (kStageLin) {
        lv = *reinterpret_cast<const float2*>(lin_s + a * FS + f);
      } else {
        lv.x = __ldg(loc_lin + (size_t)a * F + f);
        lv.y = f + 1 < F ? __ldg(loc_lin + (size_t)a * F + f + 1) : 0.0f;
      }
      const float4 y = *reinterpret_cast<const float4*>(dpre + a * PS + 4 * lq);
      x0.x = fmaf(y.x, lv.x, x0.x);
      x0.y = fmaf(y.y, lv.x, x0.y);
      x0.z = fmaf(y.z, lv.x, x0.z);
      x0.w = fmaf(y.w, lv.x, x0.w);
      x1.x = fmaf(y.x, lv.y, x1.x);
      x1.y = fmaf(y.y, lv.y, x1.y);
      x1.z = fmaf(y.z, lv.y, x1.z);
      x1.w = fmaf(y.w, lv.y, x1.w);
    }
    float* out = (G == 1 ? dloc : red + g * F * PS) + f * PS + 4 * lq;
    *reinterpret_cast<float4*>(out) = x0;
    if (f + 1 < F) *reinterpret_cast<float4*>(out + PS) = x1;
  }
  if (G > 1) {
    __syncthreads();
    for (int i = tid; i < F * PS; i += blockDim.x) {
      float x = 0.0f;
      for (int g = 0; g < G; ++g) x += red[g * F * PS + i];
      dloc[i] = x;
    }
  }
  __syncthreads();

  // d_loc_w over the span, 4 taps a thread (the history through a window of
  // registers); and mk[l, c, k] = sum_f loc_w[f, c, k] d_loc[f, l], what
  // position l0 + l sends to d_attn_hist at l0 + l + k - pad, 4 positions a
  // thread
  const int K4 = (K + 3) / 4;
  for (int i = tid; i < F * C * K4; i += blockDim.x) {
    const int f = i / (C * K4), ck = i - f * C * K4, c = ck / K4, k = 4 * (ck - c * K4);
    const float* h = hist_s + c * W + k;  // may read past the row for taps >= K, unused
    const float* dl = dloc + f * PS;
    float x[4] = {}, win[4];
#pragma unroll
    for (int q = 0; q < 3; ++q) win[q + 1] = h[q];
#pragma unroll
    for (int l = 0; l < P; ++l) {
#pragma unroll
      for (int q = 0; q < 3; ++q) win[q] = win[q + 1];
      win[3] = h[l + 3];
      const float d = dl[l];
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = fmaf(d, win[q], x[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (k + q < K) prow[pl.lw + f * CK + c * K + k + q] = x[q];
  }
  for (int i = tid; i < (P / 4) * CK; i += blockDim.x) {
    const int lq = i / CK, ck = i - lq * CK;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int f = 0; f < F; ++f) {
      const float wv = wloc[f * CK + ck];
      const float4 d = *reinterpret_cast<const float4*>(dloc + f * PS + 4 * lq);
      x.x = fmaf(wv, d.x, x.x);
      x.y = fmaf(wv, d.y, x.y);
      x.z = fmaf(wv, d.z, x.z);
      x.w = fmaf(wv, d.w, x.w);
    }
    mk[(4 * lq) * CK + ck] = x.x;
    mk[(4 * lq + 1) * CK + ck] = x.y;
    mk[(4 * lq + 2) * CK + ck] = x.z;
    mk[(4 * lq + 3) * CK + ck] = x.w;
  }
  __syncthreads();
  // the span's d_attn_hist over the window, j = x - (l0 - pad), summed over
  // the span's positions in order
  for (int o = tid; o < C * W; o += blockDim.x) {
    const int c = o / W, j = o - c * W;
    float x = 0.0f;
    for (int l = max(0, j - K + 1); l <= min(P - 1, j); ++l) x += mk[l * CK + c * K + j - l];
    prow[pl.h + o] = x;
  }
}

// The fixed-order sums of `attention_bwd_kernel`'s partials, read as
// float4s (the `PartLayout` regions are whole float4s). Blocks [0, n_w): 32
// float4s of the weight gradients' columns (d_loc_w, d_loc_lin, d_v) over
// every (row, span); the next B * ceil(A / 128): d_pq of a row over its
// spans. Warp q sums the partial rows r = q mod 8 (8 loads in flight a
// lane), and the 8 warp sums are added in warp order. The rest: d_attn_hist,
// a thread a position, over the spans whose window holds it, in span order.
__global__ void __launch_bounds__(kThreads)
attention_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ d_pq,
                         float* __restrict__ d_hist, float* __restrict__ d_loc_w,
                         float* __restrict__ d_loc_lin, float* __restrict__ d_v, int B, int L,
                         int A, int C, int F, int K, int P, int S, int n_w) {
  __shared__ float4 sums[kThreads];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // every partial is written
  const PartLayout pl(P, A, C, F, K);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int a_blocks = (A + 127) / 128;
  int blk = blockIdx.x;
  if (blk < n_w + B * a_blocks) {
    const bool wgt = blk < n_w;
    int col, r0, nr, bb = 0;
    if (wgt) {
      col = 4 * (blk * 32 + lane);
      r0 = 0, nr = B * S;
      if (col >= pl.q) col = -1;
    } else {
      blk -= n_w;
      bb = blk / a_blocks;
      const int a = (blk - bb * a_blocks) * 128 + 4 * lane;
      col = a < A ? pl.q + a : -1;
      r0 = bb * S, nr = S;
    }
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (col >= 0) {
#pragma unroll 8
      for (int r = warp; r < nr; r += nwarps) {
        const float4 y = __ldg(reinterpret_cast<const float4*>(part + (size_t)(r0 + r) * pl.total + col));
        x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
      }
    }
    sums[tid] = x;
    __syncthreads();
    if (warp != 0 || col < 0) return;
    float y[4] = {};
    for (int q = 0; q < nwarps; ++q) {
      const float4 z = sums[q * 32 + lane];
      y[0] += z.x, y[1] += z.y, y[2] += z.z, y[3] += z.w;
    }
    const int FCK = F * C * K, FA = F * A;
    for (int j = 0; j < 4; ++j) {
      const int c = col + j;
      if (!wgt) {
        if (c - pl.q < A) d_pq[(size_t)bb * A + c - pl.q] = y[j];
      } else if (c < pl.ll) {
        if (c - pl.lw < FCK) d_loc_w[c - pl.lw] = y[j];
      } else if (c < pl.v) {
        const int e = c - pl.ll, f = e / A;
        if (e < FA) d_loc_lin[(size_t)(e - f * A) * F + f] = y[j];
      } else if (c - pl.v < A) {
        d_v[c - pl.v] = y[j];
      }
    }
    return;
  }
  const int i = (blk - n_w - B * a_blocks) * blockDim.x + tid;
  if (i >= B * C * L) return;
  const int bb = i / (C * L), c = (i / L) % C, x = i % L;
  const int pad = (K - 1) / 2, W = P + K - 1;
  // span s holds x when 0 <= x - s * P + pad < W
  const int s_lo = max(0, (x + pad - W + P) / P), s_hi = min(S - 1, (x + pad) / P);
  float y = 0.0f;
#pragma unroll 4
  for (int s = s_lo; s <= s_hi; ++s)
    y += __ldg(part + (size_t)(bb * S + s) * pl.total + pl.h + c * W + x - s * P + pad);
  d_hist[i] = y;
}

template <int P, bool kStageLin>
cudaError_t launch_bwd(const float* pq, const float* pm, const float* memory, const float* hist,
                       const float* loc_w, const float* loc_lin, const float* v,
                       const float* weights, const float* context, const float* d_context,
                       const float* d_weights, float* d_pm, float* d_memory, float* part, int B,
                       int L, int A, int D, int C, int F, int K, cudaStream_t stream) {
  const size_t smem = (size_t)BwdLayout(P, A, C, F, K, kStageLin).total * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<P, kStageLin>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return err;
  }
  attention_bwd_kernel<P, kStageLin><<<dim3((L + P - 1) / P, B), kThreads, smem, stream>>>(
      pq, pm, memory, hist, loc_w, loc_lin, v, weights, context, d_context, d_weights, d_pm,
      d_memory, part, L, A, D, C, F, K);
  return cudaGetLastError();
}

}  // namespace

// d_pq (B, A), d_pm (B, L, A), d_memory (B, L, D), d_hist (B, C, L),
// d_loc_w (F, C, K), d_loc_lin (A, F) and d_v (A) from the forward's inputs,
// weights and context; `part` (part_len floats, at least B * ceil(L / span)
// `PartLayout`s) holds the per-(row, span) partials between the two
// kernels. F = 0 (loc_w, loc_lin, d_hist, d_loc_w and d_loc_lin null) is the
// location-free attention. `span` (a multiple of 4 up to 32) and `stage_lin`
// (loc_lin held in shared memory) come from attention.py `attention_bwd_plan`.
extern "C" int attention_step_bwd_f32(const float* pq, const float* pm, const float* memory,
                                      const float* hist, const float* loc_w,
                                      const float* loc_lin, const float* v,
                                      const float* weights, const float* context,
                                      const float* d_context, const float* d_weights,
                                      float* d_pq, float* d_pm, float* d_memory, float* d_hist,
                                      float* d_loc_w, float* d_loc_lin, float* d_v, float* part,
                                      int B, int L, int A, int D, int C, int F, int K, int span,
                                      int stage_lin, int part_len, void* stream) {
  if (L < 1 || B < 1 || A < 1 || D < 1 || K < 1) return (int)cudaErrorInvalidValue;
  // loc_lin is read from L2 (stage_lin 0) only at the smallest span
  decltype(&launch_bwd<4, true>) launch = nullptr;
  if (!stage_lin) {
    if (span == 4) launch = launch_bwd<4, false>;
  } else {
    switch (span) {
      case 4: launch = launch_bwd<4, true>; break;
      case 8: launch = launch_bwd<8, true>; break;
      case 12: launch = launch_bwd<12, true>; break;
      case 16: launch = launch_bwd<16, true>; break;
      case 20: launch = launch_bwd<20, true>; break;
      case 24: launch = launch_bwd<24, true>; break;
      case 28: launch = launch_bwd<28, true>; break;
      case 32: launch = launch_bwd<32, true>; break;
    }
  }
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  const int S = (L + span - 1) / span;
  if ((long long)B * S * PartLayout(span, A, C, F, K).total > part_len)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch(pq, pm, memory, hist, loc_w, loc_lin, v, weights, context, d_context,
                           d_weights, d_pm, d_memory, part, B, L, A, D, C, F, K, st);
  if (err != cudaSuccess) return (int)err;
  const int n_w = (PartLayout(span, A, C, F, K).q + 127) / 128;
  const int n_h = F > 0 ? (B * C * L + kThreads - 1) / kThreads : 0;
  // a programmatic dependent launch: the sums kernel is scheduled while the
  // per-span kernel runs and waits for its end (griddepcontrol.wait)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_w + B * ((A + 127) / 128) + n_h);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attention_bwd_sum_kernel, (const float*)part, d_pq, d_hist,
                           d_loc_w, d_loc_lin, d_v, B, L, A, C, F, K, span, S, n_w);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// `tile` (location-feature rows per tile, 0 when F = 0), `stage_mem`, and
// the split route's `chunk` (positions a cluster, kCluster times a CTA's
// span), `chunks` (0: one cluster a row, no split) and `lin_rows` (rows of
// loc_lin a CTA stages at once: A where they fit, 0 when F = 0) come from
// attention.py `attention_plan`; `vec`
// = 1 when A, D, ceil(A/kCluster) and ceil(D/kCluster) are multiples of 4
// and processed_memory, memory and loc_lin are 16-byte aligned. Any A, D >= 1. `scratch`
// (split route only): B * chunks * (2 + D) floats, the chunks' statistics
// then their contexts.
extern "C" int attention_step_f32(const float* pq, const float* pm, const float* memory,
                                  const float* hist, const float* loc_w, const float* loc_lin,
                                  const float* v, const unsigned char* mask,
                                  float* context, float* weights, float* scratch,
                                  int B, int L, int A, int D, int C, int F, int K,
                                  int tile, int stage_mem, int vec, int chunk, int chunks,
                                  int lin_rows, void* stream) {
  if (A < 1 || D < 1 || L < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const bool split = chunks > 0;
  if (split && (chunk < kCluster || chunk % kCluster || (long long)chunk * chunks < L ||
                (long long)chunk * (chunks - 1) >= L || scratch == nullptr || B > 65535 ||
                (F > 0 && (lin_rows < 1 || lin_rows > A))))
    return (int)cudaErrorInvalidValue;
  const int span = chunk / kCluster;
  const size_t smem =
      (size_t)(split ? SplitLayout(span, A, D, C, F, K, stage_mem, lin_rows).total
                     : Layout(L, (A + kCluster - 1) / kCluster, (D + kCluster - 1) / kCluster, C,
                              F, K, tile, stage_mem).total) *
      sizeof(float);
  const void* kernel = split ? (const void*)attention_split_kernel : (const void*)attention_step_kernel;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = split ? dim3(kCluster * chunks, B) : dim3(kCluster * B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (split)
    err = cudaLaunchKernelEx(&cfg, attention_split_kernel, pq, pm, memory, hist, loc_w, loc_lin, v,
                             mask, context, weights, scratch, scratch + (size_t)B * chunks * 2, L,
                             span, A, D, C, F, K, stage_mem, lin_rows, vec);
  else
    err = cudaLaunchKernelEx(&cfg, attention_step_kernel, pq, pm, memory, hist, loc_w, loc_lin, v,
                             mask, context, weights, L, A, D, C, F, K, tile, stage_mem, vec);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
