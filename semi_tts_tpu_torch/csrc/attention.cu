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
// - CTA r owns the attention columns [r*A/n, (r+1)*A/n) and the context
//   columns [r*D/n, (r+1)*D/n). Its prologue issues every load it needs at
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;   // CTAs per batch row (attention.py CLUSTER)
constexpr int kThreads = 256;
constexpr int kRows = 4;      // energy positions a warp computes together
constexpr int kConvL = 4;     // location-feature positions a thread computes together

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
  const int b = blockIdx.x / kCluster;
  const int Ac = A / kCluster, Dc = D / kCluster;
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
    stage_slice(lin_s, FS, loc_lin + (size_t)r * Ac * F, F, Ac, F, vec && F % 4 == 0);
    zero_tail(lin_s, FS, Ac, F);
    zero_tail(locf, FS, tile, F);
  }
  for (int i = tid; i < Ac; i += blockDim.x) {
    cp_async4(pq_s + i, pq + (size_t)b * A + r * Ac + i);
    cp_async4(v_s + i, v + r * Ac + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage_slice(pm_s, Ac, pm + ((size_t)b * L) * A + r * Ac, A, L, Ac, vec);
  const float* mem_b = memory + ((size_t)b * L) * D + r * Dc;
  if (stage_mem) stage_slice(mem_s, Dc, mem_b, D, L, Dc, vec);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int l = tid; l < L; l += blockDim.x) e[l] = mask != nullptr && mask[(size_t)b * L + l];
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
      for (int a = lane; a < Ac; a += 32) {
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

  // context[d] = sum_l w[l] * memory[l, d] over this CTA's columns; G groups
  // of positions when the columns leave threads idle, summed in group order
  const int G = Dc >= (int)blockDim.x ? 1 : (int)blockDim.x / Dc;
  for (int i = tid; i < G * Dc; i += blockDim.x) {
    const int g = i / Dc, d = i - g * Dc;
    float acc = 0.0f;
    if (stage_mem) {
      for (int l = g; l < L; l += G) acc = fmaf(w[l], mem_s[l * Dc + d], acc);
    } else {
      for (int l = g; l < L; l += G) acc = fmaf(w[l], mem_b[(size_t)l * D + d], acc);
    }
    if (G == 1) context[(size_t)b * D + r * Dc + d] = acc;
    else red[i] = acc;
  }
  if (G > 1) {
    __syncthreads();
    for (int d = tid; d < Dc; d += blockDim.x) {
      float acc = 0.0f;
      for (int g = 0; g < G; ++g) acc += red[g * Dc + d];
      context[(size_t)b * D + r * Dc + d] = acc;
    }
  }
}

// ------------------------------------------------- K9: the step's backward --
//
// Replaces the autodiff of `semi_tts_tpu/models/attention.py:39`
// `attention_step` inside the decoder's training scan. From the forward's
// inputs, its weights w (B, L) and the cotangents d_context (B, D) and
// d_weights (B, L), per batch row:
//   dw[l]   = d_weights[l] + sum_d memory[l, d] * d_context[d]
//   de[l]   = w[l] * (dw[l] - sum_l' w[l'] dw[l'])            (softmax)
//   th      = tanh(pq + loc @ loc_lin^T + processed_memory)   (recomputed)
//   dpre    = de[l] * v[a] * (1 - th^2)                       (L, A)
//   d_pq = sum_l dpre, d_processed_memory = dpre, d_v = sum_l de[l] th[l, :],
//   d_memory[l, d] = w[l] * d_context[d],
//   d_loc_lin = dpre^T loc, d_loc = dpre @ loc_lin            (L, F)
//   d_loc_w[f, c, k] = sum_l d_loc[l, f] hist[c, l + k - pad]
//   d_attn_hist[c, x] = sum_{f, k} loc_w[f, c, k] d_loc[x - k + pad, f]
// A masked position has w = 0 from the forward, so de, dpre and d_memory are
// 0 there with no mask read. The weight gradients d_v, d_loc_lin and d_loc_w
// are written as per-row partials into one (B, ...) buffer that the wrapper
// sums with one reduction: each element has one writer, so there are no
// atomics and the sum is deterministic.
//
// What bounds it: as K3, a chain of dependent phases, each too small to fill
// an SM; the bytes (pm, memory, d_pm, d_memory, ~2.4 MB at B=8, L=32) put the
// card's floor near 1 us.
//
// Design: K3's layout, one cluster of kCluster CTAs per batch row. CTA r owns
// attention columns [r*Ac, r*Ac + Ac), context columns [r*Dc, r*Dc + Dc),
// and the filters f = r + kCluster*i. Shared memory holds only what has few
// floats a position: the padded history, the weights, dw (then de, in
// place) and this CTA's filters of d_loc (2 + C + Fr floats a position, 32
// bytes at flagship widths, fewer than K3 holds), so K9 takes every L K3
// takes (1,187 at flagship widths; a trimmed unpaired latent is as long as
// the ASR encoder's output, ~680 frames for a 15 s utterance). The prologue
// issues every load of those at once with cp.async and waits once (plain
// loads in a loop would pay a memory round trip per iteration), loc_lin's
// rows at an odd stride so a warp reading down a column hits 32 banks. The
// wide per-position operands are streamed in tiles of `tile` positions:
// memory is read from L2 once in the dw phase, processed memory is staged a
// tile ahead with cp.async into a second buffer, the location features and
// the tanh of the CTA's columns are recomputed per tile. Partial sums cross
// the cluster through distributed shared memory a tile at a time: the
// memory.d_context partials of dw (all-gather, summed in rank order so every
// CTA holds the same dw bit for bit), the partials of d_loc over the CTA's
// columns (reduce-scatter by filter) and the partials of d_attn_hist over
// the CTA's filters (reduce-scatter by position), each through
// double-buffered slots with one cluster barrier a tile: a peer writes the
// buffer of tile i + 2 only after every CTA has passed the barrier of tile
// i + 1, so after it has read tile i's. A thread keeps its positions
// l = g mod G across tiles and every cluster sum is in rank order, so the
// result does not depend on the tile. No CTA touches a peer's shared memory
// after the last barrier.

struct BwdLayout {
  int hist, wloc, lin, dctx, pq, v, w, dw, wslot, red, dloc, pmt, locf, dslot, hslot, total;
  __host__ __device__ BwdLayout(int L, int Ac, int Dc, int C, int F, int K, int tile) {
    const int Fr = (F + kCluster - 1) / kCluster;
    int at = 0;
    hist = at;  at += round4(C * (L + K - 1));
    wloc = at;  at += round4(F * C * K);
    lin = at;   at += round4(Ac * (F | 1));
    dctx = at;  at += round4(Dc);
    pq = at;    at += round4(Ac);
    v = at;     at += round4(Ac);
    w = at;     at += round4(L);
    dw = at;    at += round4(L);
    wslot = at; at += 2 * kCluster * round4(tile);
    red = at;   at += 2 * round4(Ac > kThreads ? Ac : kThreads);
    dloc = at;  at += round4(L * Fr);
    pmt = at;   at += 2 * round4(tile * Ac);
    locf = at;  at += round4(tile * F);
    dslot = at; at += 2 * round4(kCluster * tile * Fr);
    hslot = at; at += 2 * round4(kCluster * C * tile);
    total = at;
  }
};

// Stage rows [l0, l0 + rows) of this CTA's columns of processed memory.
__device__ __forceinline__ void stage_pm_tile(float* dst, const float* pm, int b, int r, int L,
                                              int A, int Ac, int l0, int rows, bool vec) {
  stage_slice(dst, Ac, pm + ((size_t)b * L + l0) * A + r * Ac, A, rows, Ac, vec);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const float* __restrict__ pq, const float* __restrict__ pm,
                           const float* __restrict__ memory, const float* __restrict__ hist,
                           const float* __restrict__ loc_w, const float* __restrict__ loc_lin,
                           const float* __restrict__ v, const float* __restrict__ weights,
                           const float* __restrict__ d_context,
                           const float* __restrict__ d_weights, float* __restrict__ d_pq,
                           float* __restrict__ d_pm, float* __restrict__ d_memory,
                           float* __restrict__ d_hist, float* __restrict__ rows, int L, int A,
                           int D, int C, int F, int K, int tile) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int Ac = A / kCluster, Dc = D / kCluster;
  const int Fr = (F + kCluster - 1) / kCluster;
  const int pad = (K - 1) / 2, Lp = L + K - 1, CK = C * K;
  const int FS = F | 1;  // odd row stride of loc_lin
  const BwdLayout lay(L, Ac, Dc, C, F, K, tile);
  float* hist_s = smem + lay.hist;  // (C, Lp): hist[c, j - pad], zero outside [0, L)
  float* wloc = smem + lay.wloc;    // (F, C, K)
  float* lin_s = smem + lay.lin;    // (Ac, FS): this CTA's rows of loc_lin
  float* dctx = smem + lay.dctx;    // (Dc) this CTA's columns of d_context
  float* pq_s = smem + lay.pq;
  float* v_s = smem + lay.v;
  float* w = smem + lay.w;
  float* dw = smem + lay.dw;        // (L) d_weights, then dw, then de
  float* wslot = smem + lay.wslot;  // 2 x (kCluster, tile4) partials of dw, slot = sender
  float* red = smem + lay.red;      // (2, G * Ac) running d_v and d_pq chains
  float* dloc = smem + lay.dloc;    // (L, Fr) d_loc of this CTA's filters
  float* pmt = smem + lay.pmt;      // 2 x (tile, Ac): processed memory, then dpre
  float* locf = smem + lay.locf;    // (tile, F) location features of the tile
  float* dslot = smem + lay.dslot;  // 2 x (kCluster, tile, Fr) partials of d_loc, slot = sender
  float* hslot = smem + lay.hslot;  // 2 x (kCluster, C, tile) partials of d_attn_hist
  const int pm_buf = round4(tile * Ac), d_buf = round4(kCluster * tile * Fr),
            h_buf = round4(kCluster * C * tile);
  const int ld_rows = F * CK + A * F + A;
  float* dlw_row = rows + (size_t)b * ld_rows;
  float* dll_row = dlw_row + F * CK;
  float* dv_row = dll_row + A * F;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int tile4 = round4(tile), ntiles = (L + tile - 1) / tile;
  const bool vec = Ac % 4 == 0 && ((size_t)pm & 15) == 0;

  // prologue: the operands held for the whole launch in one cp.async group,
  // the first tile of processed memory in a second
  for (int i = tid; i < C * Lp; i += blockDim.x) {
    const int c = i / Lp, x = i - c * Lp - pad;
    if (x >= 0 && x < L) cp_async4(hist_s + i, hist + ((size_t)b * C + c) * L + x);
    else hist_s[i] = 0.0f;
  }
  for (int i = tid; i < F * CK; i += blockDim.x) cp_async4(wloc + i, loc_w + i);
  for (int i = tid; i < Ac * F; i += blockDim.x) {
    const int a = i / F, f = i - a * F;
    cp_async4(lin_s + a * FS + f, loc_lin + (size_t)r * Ac * F + i);
  }
  for (int i = tid; i < Dc; i += blockDim.x) cp_async4(dctx + i, d_context + (size_t)b * D + r * Dc + i);
  for (int i = tid; i < Ac; i += blockDim.x) {
    cp_async4(pq_s + i, pq + (size_t)b * A + r * Ac + i);
    cp_async4(v_s + i, v + r * Ac + i);
  }
  for (int l = tid; l < L; l += blockDim.x) {
    cp_async4(w + l, weights + (size_t)b * L + l);
    cp_async4(dw + l, d_weights + (size_t)b * L + l);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage_pm_tile(pmt, pm, b, r, L, A, Ac, 0, min(tile, L), vec);
  const int G = Ac >= (int)blockDim.x ? 1 : (int)blockDim.x / Ac;
  const int GA = G * Ac;
  for (int i = tid; i < 2 * GA; i += blockDim.x) red[i] = 0.0f;
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // the held operands have landed
  __syncthreads();
  cluster.sync();  // every CTA of the cluster has started: peers' shared memory is live

  // dw = d_weights + memory . d_context a tile of positions at a time: this
  // CTA's partials over its columns (a warp per position, memory read from
  // L2) into slot r of every CTA, then, after the tile's barrier, the slots
  // summed in rank order; and this CTA's columns of d_memory
  const float* mem_b = memory + (size_t)b * L * D + r * Dc;
  for (int it = 0; it < ntiles; ++it) {
    const int l0 = it * tile, nrow = min(tile, L - l0);
    float* ws = wslot + (it & 1) * kCluster * tile4;
    for (int ll = warp; ll < nrow; ll += nwarps) {
      const int l = l0 + ll;
      const float* mrow = mem_b + (size_t)l * D;
      float* drow = d_memory + ((size_t)b * L + l) * D + r * Dc;
      float acc = 0.0f;
      for (int d = lane; d < Dc; d += 32) {
        const float g = dctx[d];
        acc = fmaf(__ldg(mrow + d), g, acc);
        drow[d] = w[l] * g;
      }
      acc = warp_sum(acc);
      if (lane < kCluster) *cluster.map_shared_rank(ws + r * tile4 + ll, lane) = acc;
    }
    cluster.sync();  // this tile's dw partials have landed
    for (int ll = tid; ll < nrow; ll += blockDim.x) {
      float s = dw[l0 + ll];
      for (int q = 0; q < kCluster; ++q) s += ws[q * tile4 + ll];
      dw[l0 + ll] = s;
    }
  }
  __syncthreads();
  float wdw = 0.0f;  // sum_l w[l] dw[l], every warp for itself (same order, same result)
  for (int l = lane; l < L; l += 32) wdw = fmaf(w[l], dw[l], wdw);
  wdw = warp_sum(wdw);
  __syncthreads();  // every warp has read dw before it becomes de
  for (int l = tid; l < L; l += blockDim.x) dw[l] = w[l] * (dw[l] - wdw);
  const float* de = dw;

  for (int it = 0; it < ntiles; ++it) {
    const int l0 = it * tile, nrow = min(tile, L - l0);
    float* pm_cur = pmt + (it & 1) * pm_buf;
    // the next tile's processed memory into the other buffer, whose last
    // reader (the previous tile) finished before the barrier that ended it
    if (it + 1 < ntiles)
      stage_pm_tile(pmt + ((it + 1) & 1) * pm_buf, pm, b, r, L, A, Ac, l0 + tile,
                    min(tile, L - l0 - tile), vec);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    // locf[ll, f] = sum_c sum_k loc_w[f, c, k] hist[c, l0 + ll + k - pad]
    for (int i = tid; i < nrow * F; i += blockDim.x) {
      const int ll = i / F, f = i - ll * F;
      float acc = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float* h = hist_s + c * Lp + l0 + ll;
        const float* wk = wloc + (f * C + c) * K;
        for (int k = 0; k < K; ++k) acc = fmaf(wk[k], h[k], acc);
      }
      locf[i] = acc;
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile's processed memory
    __syncthreads();
    // tanh, dpre in place of processed memory, d_pm, and the d_v and d_pq
    // chains of each (position group g, column a) over l = g mod G
    for (int i = tid; i < GA; i += blockDim.x) {
      const int g = i / Ac, a = i - g * Ac;
      float dv = red[i], dq = red[GA + i];
      for (int l = l0 + ((g - l0) % G + G) % G; l < l0 + nrow; l += G) {
        const int ll = l - l0;
        float loc = 0.0f;
        for (int f = 0; f < F; ++f) loc = fmaf(locf[ll * F + f], lin_s[a * FS + f], loc);
        const float t = tanhf((pq_s[a] + loc) + pm_cur[ll * Ac + a]);
        const float dp = de[l] * v_s[a] * (1.0f - t * t);
        dv = fmaf(de[l], t, dv);
        dq += dp;
        pm_cur[ll * Ac + a] = dp;
        d_pm[((size_t)b * L + l) * A + r * Ac + a] = dp;
      }
      red[i] = dv;
      red[GA + i] = dq;
    }
    __syncthreads();
    if (F > 0) {
      // d_loc_lin of this CTA's columns, summed over l in order across tiles
      // in its row of `rows` (one writer an element)
      for (int i = tid; i < Ac * F; i += blockDim.x) {
        const int a = i / F, f = i - a * F;
        float* out = dll_row + (size_t)r * Ac * F + i;
        float acc = it ? *out : 0.0f;
        for (int ll = 0; ll < nrow; ++ll) acc = fmaf(pm_cur[ll * Ac + a], locf[ll * F + f], acc);
        *out = acc;
      }
      // partial d_loc[l, f] over this CTA's columns, into slot r of the CTA
      // that owns filter f
      float* ds = dslot + (it & 1) * d_buf;
      for (int i = tid; i < nrow * F; i += blockDim.x) {
        const int ll = i / F, f = i - ll * F;
        float acc = 0.0f;
        for (int a = 0; a < Ac; ++a) acc = fmaf(pm_cur[ll * Ac + a], lin_s[a * FS + f], acc);
        *cluster.map_shared_rank(ds + ((size_t)r * tile + ll) * Fr + f / kCluster, f % kCluster) = acc;
      }
      cluster.sync();  // this tile's d_loc partials have landed
      for (int i = tid; i < nrow * Fr; i += blockDim.x) {
        float s = 0.0f;
        for (int q = 0; q < kCluster; ++q) s += ds[(size_t)q * tile * Fr + i];
        dloc[l0 * Fr + i] = s;
      }
    } else {
      __syncthreads();  // the tile's buffers are free for the next
    }
  }
  __syncthreads();

  for (int a = tid; a < Ac; a += blockDim.x) {
    float dvs = 0.0f, dqs = 0.0f;
    for (int g = 0; g < G; ++g) {
      dvs += red[g * Ac + a];
      dqs += red[GA + g * Ac + a];
    }
    dv_row[r * Ac + a] = dvs;
    d_pq[(size_t)b * A + r * Ac + a] = dqs;
  }
  if (F == 0) return;
  // d_loc_w of this CTA's filters, complete over l
  for (int i = tid; i < Fr * CK; i += blockDim.x) {
    const int fi = i / CK, ck = i - fi * CK, c = ck / K, k = ck - c * K;
    const int f = r + kCluster * fi;
    if (f >= F) continue;
    const float* h = hist_s + c * Lp + k;
    float acc = 0.0f;
    for (int l = 0; l < L; ++l) acc = fmaf(dloc[l * Fr + fi], h[l], acc);
    dlw_row[f * CK + ck] = acc;
  }
  // d_attn_hist a tile of positions at a time: partials over this CTA's
  // filters into slot r of the CTA that owns element j = c * tile + xx
  for (int it = 0; it < ntiles; ++it) {
    const int x0 = it * tile, nrow = min(tile, L - x0);
    float* hs = hslot + (it & 1) * h_buf;
    for (int i = tid; i < C * nrow; i += blockDim.x) {
      const int c = i / nrow, xx = i - c * nrow, x = x0 + xx;
      float acc = 0.0f;
      for (int fi = 0; fi < Fr && r + kCluster * fi < F; ++fi) {
        const float* wk = wloc + ((r + kCluster * fi) * C + c) * K;
        const int k0 = max(0, x + pad - L + 1), k1 = min(K - 1, x + pad);
        for (int k = k0; k <= k1; ++k) acc = fmaf(wk[k], dloc[(x - k + pad) * Fr + fi], acc);
      }
      const int j = c * tile + xx;
      *cluster.map_shared_rank(hs + (size_t)r * C * tile + j, j % kCluster) = acc;
    }
    cluster.sync();  // this tile's partials have landed; after the last, no remote access
    for (int j = r + kCluster * tid; j < C * tile; j += kCluster * blockDim.x) {
      const int c = j / tile, xx = j - c * tile;
      if (xx >= nrow) continue;
      float s = 0.0f;
      for (int q = 0; q < kCluster; ++q) s += hs[(size_t)q * C * tile + j];
      d_hist[((size_t)b * C + c) * L + x0 + xx] = s;
    }
  }
}

}  // namespace

// d_pq (B, A), d_pm (B, L, A), d_memory (B, L, D), d_hist (B, C, L) and
// `rows` (B, F*C*K + A*F + A): each batch row's partials of d_loc_w (F, C,
// K), d_loc_lin (A, F) and d_v (A), which the caller sums over the batch.
// F = 0 (loc_w, loc_lin and d_hist null) is the location-free attention.
// `tile` (positions a tile, at least 1) comes from attention.py
// `attention_bwd_plan`.
extern "C" int attention_step_bwd_f32(const float* pq, const float* pm, const float* memory,
                                      const float* hist, const float* loc_w,
                                      const float* loc_lin, const float* v,
                                      const float* weights, const float* d_context,
                                      const float* d_weights, float* d_pq, float* d_pm,
                                      float* d_memory, float* d_hist, float* rows, int B, int L,
                                      int A, int D, int C, int F, int K, int tile, void* stream) {
  if (A % kCluster || D % kCluster || L < 1 || B < 1 || tile < 1) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)BwdLayout(L, A / kCluster, D / kCluster, C, F, K, tile).total * sizeof(float);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attention_bwd_kernel, pq, pm, memory, hist, loc_w, loc_lin, v,
                           weights, d_context, d_weights, d_pq, d_pm, d_memory, d_hist, rows, L,
                           A, D, C, F, K, tile);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// `tile` (location-feature rows per tile, 0 when F = 0) and `stage_mem`
// come from attention.py `attention_plan`; `vec` = 1 when A/kCluster and
// D/kCluster are multiples of 4 and processed_memory and memory are 16-byte
// aligned.
extern "C" int attention_step_f32(const float* pq, const float* pm, const float* memory,
                                  const float* hist, const float* loc_w, const float* loc_lin,
                                  const float* v, const unsigned char* mask,
                                  float* context, float* weights,
                                  int B, int L, int A, int D, int C, int F, int K,
                                  int tile, int stage_mem, int vec, void* stream) {
  if (A % kCluster || D % kCluster || L < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const Layout lay(L, A / kCluster, D / kCluster, C, F, K, tile, stage_mem);
  const size_t smem = (size_t)lay.total * sizeof(float);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(attention_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attention_step_kernel, pq, pm, memory, hist, loc_w, loc_lin, v,
                           mask, context, weights, L, A, D, C, F, K, tile, stage_mem, vec);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
