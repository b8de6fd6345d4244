// Trim/merge of the unpaired speech cycle, and its backward.
//
// Replaces: `semi_tts_tpu/ops/quantize.py:26` `trim_merge_segments` (ROADMAP
// B6), which the speech-first step runs on the unpaired rows of the ASR's
// output: take each frame's argmax token, cut the frames into segments
// where the token changes or a run grows past `max_frames_per_phn` frames,
// drop the blank (token 0) segments, and write each kept segment's mean
// latent, compacted to the left and zero-filled to T. The JAX package does
// it with a `lax.scan` for the segment ids, `segment_sum`s for the means and
// a cumsum scatter for the compaction.
//
// Inputs (contiguous): p_code (B, T, C) float32, or tokens (B, T) int32 to
// use instead of its argmax; latent (B, T, D) float32. Outputs: trimmed
// (B, T, D), lengths (B) int32 (the kept segments of each row), and per
// frame its output slot (int32, -1 where its segment is dropped) and its
// segment's frame count (float32), which the backward needs.
//
// What bounds it on an H100: neither bytes nor operations. At the flagship
// speech-first step (p_code (8, 133, 43), latent (8, 133, 64)) it moves
// ~0.74 MB, ~0.22 us of HBM time; what is left is latency: one CTA a batch
// row, each phase waiting on the one before. So the design takes global
// memory off that chain, and keeps few barriers on it.
// The row route (`trim_merge_kernel`), for rows shorter than
// kernels/quantize.py's SPLIT_FRAMES whose p_code (or tokens), per-frame
// ints and header fit one CTA's shared memory:
// - Entry: thread 0 starts bulk copies (cp.async.bulk, completing an
//   mbarrier) of the row's p_code into shared memory and of the row's
//   latent where it fits beside p_code (else an L2 prefetch of it,
//   cp.async.bulk.prefetch.L2). A copy's unaligned ends (at most 3 floats
//   each side) are loaded by threads. Tokens given in place of p_code are
//   read straight into shared memory.
// - Tokens: a thread per frame, the classes from shared memory; the first
//   maximum wins ties, and NaN counts as the maximum, as jnp.argmax.
// - Scans (`scan_row`), in chunks of blockDim frames, a thread a frame: a
//   frame's run start is the last change point at or before it (the warp's
//   by __ballot_sync and __clz, earlier warps' and chunks' by a carry: one
//   barrier); a frame starts a segment where (t - run_start) %
//   (max_frames_per_phn + 1) == 0 (the JAX scan's `last_pos` resets at each
//   boundary, so a run is cut every max_frames_per_phn + 1 frames); the
//   kept segments (token not 0) before a frame by __ballot_sync and
//   __popc, carried the same way (a second barrier). A segment ends at the
//   next change point or max_frames_per_phn + 1 frames after its start,
//   found by walking the tokens (at most max_frames_per_phn steps).
// - Means: a warp an output row, lanes over D (float2 when D is even), the
//   segment's start and frame count kept by the scans, its rows summed in
//   time order and divided by the count, as `segment_sum` then the
//   division; rows past the kept count are zero.
// The split route, past that (longer rows, or many classes): one CTA a row
// would take the tokens at one SM's copy rate and then hold a row's means
// on its 32 warps (~454 output rows a warp at T = 14,529), a chain of L2
// loads each. So three launches, each a programmatic dependent launch of
// the one before (griddepcontrol: a launch's CTAs start while the one
// before runs and wait for its writes before they read them):
// - `trim_merge_tokens_kernel`, over the whole card: a group of `lanes`
//   lanes a frame (chosen from C: about 8 loads a lane, float4 where the
//   rows allow), lane l keeping the first maximum of its strided classes,
//   then xor shuffles within the group keeping the one first in the
//   argmax's order (NaN the largest, the smaller class on a tie), into a
//   (B, T) scratch. Skipped when tokens are given.
// - `trim_merge_scan_kernel`, a CTA of 1,024 threads a row: the row
//   route's scans on the tokens in device memory, the slot starts and
//   counts into a (B, 2, round4(T)) scratch. Tried and not kept (no faster,
//   chip_ablate.py --b6-long on an H100): the tokens bulk-copied into shared
//   memory first, 4 consecutive frames a thread, an L2 prefetch of the
//   latent for the means (thread 0 issuing a bulk prefetch every 32 KB of a
//   row held the CTA's first barrier).
// - `trim_merge_means_kernel`, over the whole card: a grid of (output-row
//   groups, B), a group of lanes an output row (float4 where D and the
//   rows allow, as the backward's), the segment's frames summed in time
//   order and divided by the count: `mean_row`'s arithmetic, so the result
//   is the row route's bit for bit.
// The backward is a gather: d_latent[b, t] = d_trimmed[b, slot[t]] /
// count[t] on kept frames, 0 elsewhere, no atomics. It moves ~0.55 MB at
// the flagship step (~0.17 us of HBM time) and takes little more than its
// launch, so the design keeps the work a row needs off the chain: a grid of
// (row groups, B), so a frame's (b, t) needs no division; a group of
// `lanes` lanes a frame (two frames a warp at D=64), whose first lane reads
// the frame's slot and count once and hands them to the others by shuffle;
// float4 loads and stores where D % 4 == 0 and the rows are 16-byte
// aligned, scalar ones otherwise; each element divided by the count, as
// the plain version does, so the result is the same bit for bit; and a
// programmatic dependent launch (griddepcontrol.wait before the first
// load), so the launch overlaps the kernel before it.

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBwdThreads = 256;    // trim_merge_bwd, and the split route's tokens and means
constexpr int kMaxThreads = 1024;   // trim_merge, and the split route's scans
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kHeader = 16 * 32;    // 2 mbarriers (32 bytes), two warp arrays of 32 ints

__host__ __device__ constexpr long long round4(long long n) { return (n + 3) & ~3LL; }

// The row route's shared memory in bytes: the header, tokens, slot starts
// and slot frame counts (T ints each), the row's p_code (`pcode`: T*C
// floats, 8 floats of slack for the alignment shift) and the staged latent.
__host__ __device__ constexpr long long trim_smem_bytes(int T, int C, int D, int pcode,
                                                        int stage_latent) {
  return kHeader + 4 * (3 * round4(T) + (pcode ? round4((long long)T * C + 8) : 0) +
                        (stage_latent ? round4((long long)T * D + 8) : 0));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, 1000000;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` of the mbarrier has completed; a
// wait of more than 2 s traps, so a lost copy fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 2000000000ull) __trap();
}

// dst[shift + k] = src[k] for k in [0, n), shift (returned) putting dst at
// src's alignment mod 16 bytes: thread 0 bulk-copies the 16-byte aligned
// interior, completing `bar` (armed for its bytes, or for none); threads
// 0..7 load the ends. Nothing outside src[0, n) is read. The caller
// synchronizes the block before it reads the ends.
__device__ __forceinline__ int bulk_stage(float* dst, const float* src, int n, unsigned bar) {
  const int shift = (int)(((uintptr_t)src & 15) >> 2);
  const int head = min(n, (4 - shift) & 3);  // floats before the first aligned one
  const int body = (n - head) & ~3;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_expect_tx(bar, 4u * body);
    if (body > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(dst + shift + head)),
          "l"(src + head), "r"(4 * body), "r"(bar)
          : "memory");
  }
  if (tid < 4) {
    if (tid < head) dst[shift + tid] = src[tid];
  } else if (tid < 8) {
    const int k = head + body + tid - 4;
    if (k < n) dst[shift + k] = src[k];
  }
  return shift;
}

// x beats the current best (value, index): larger, or NaN over a number.
__device__ __forceinline__ bool beats(float x, float best) {
  return (isnan(x) && !isnan(best)) || x > best;
}

// The end of the segment [s, .) that holds frame t, the frames' tokens in tok.
__device__ __forceinline__ int segment_end(const int* tok, int s, int t, int T, int m1) {
  const int tk = tok[t];
  int e = t + 1;
  while (e < s + m1 && e < T && tok[e] == tk) ++e;
  return e;
}

// (x, i) comes before (y, j) in the argmax's order: the larger value (NaN
// the largest), the smaller index on a tie.
__device__ __forceinline__ bool first_max(float x, int i, float y, int j) {
  return beats(x, y) || (!beats(y, x) && i < j);
}

// Sum over the warp of v, lanes below `upto` only; every lane gets it.
__device__ __forceinline__ int warp_sum_below(int v, int lane, int upto) {
  v = lane < upto ? v : 0;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_max_below(int v, int lane, int upto) {
  v = lane < upto ? v : -1;
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Output row j of a row whose kept segments start at sstart and count scnt
// frames: the mean of the kept segment j, or zeros; lane l of a group of
// `lanes` takes V floats at l*V, l*V + lanes*V, ... The frames are summed
// in time order, then divided by the count, as `segment_sum` and the
// division.
template <int V>
__device__ __forceinline__ void mean_row(const float* x, float* o, const int* sstart,
                                         const int* scnt, int j, int n_kept, int D, int l,
                                         int lanes) {
  using Vec = typename std::conditional<V == 4, float4, typename std::conditional<
                                                            V == 2, float2, float>::type>::type;
  Vec* dst = reinterpret_cast<Vec*>(o);
  const int n = D / V;
  if (j >= n_kept) {
    for (int k = l; k < n; k += lanes) {
      float* z = reinterpret_cast<float*>(dst + k);
#pragma unroll
      for (int i = 0; i < V; ++i) z[i] = 0.0f;
    }
    return;
  }
  const int s = sstart[j], e = s + scnt[j];
  const float cnt = (float)(e - s);
  for (int k = l; k < n; k += lanes) {
    float v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = 0.0f;
    for (int t = s; t < e; ++t) {
      const Vec a = reinterpret_cast<const Vec*>(x + (size_t)t * D)[k];
      const float* af = reinterpret_cast<const float*>(&a);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] += af[i];
    }
    Vec r;
    float* rf = reinterpret_cast<float*>(&r);
#pragma unroll
    for (int i = 0; i < V; ++i) rf[i] = v[i] / cnt;
    dst[k] = r;
  }
}

// The scans of one row of T frames (tokens in tok) over the CTA, a thread a
// frame in chunks of blockDim frames, carried across warps and chunks: each
// frame's slot and count into slot_row and count_row, each kept slot's
// start frame and frame count into sstart and scnt. Returns the row's kept
// segments. wlast and wkept are two shared arrays of 32 ints.
__device__ __forceinline__ int scan_row(const int* tok, int T, int m1, int* slot_row,
                                        float* count_row, int* sstart, int* scnt, int* wlast,
                                        int* wkept) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nt = blockDim.x;
  const int nwarps = nt >> 5;
  const unsigned le = lane == 31 ? 0xffffffffu : (2u << lane) - 1u;  // lanes at or below
  int run_carry = 0, kept_carry = 0;
  for (int c0 = 0; c0 < T; c0 += nt) {
    const int t = c0 + tid, w0 = c0 + 32 * warp;
    const bool in = t < T;
    const int tk = in ? tok[t] : 0;
    const bool chg = in && (t == 0 || tk != tok[t - 1]);
    const unsigned cm = __ballot_sync(0xffffffffu, chg);
    if (lane == 0) wlast[warp] = cm ? w0 + 31 - __clz(cm) : -1;
    __syncthreads();
    const unsigned mine = cm & le;
    const int wl = wlast[lane < nwarps ? lane : 0];
    const int earlier = max(run_carry, warp_max_below(wl, lane, warp));  // whole warp shuffles
    const int run = mine ? w0 + 31 - __clz(mine) : earlier;
    run_carry = max(run_carry, warp_max_below(wl, lane, nwarps));
    const int pos = t - run;
    const bool st = in && pos % m1 == 0;
    const bool ks = st && tk != 0;
    const unsigned km = __ballot_sync(0xffffffffu, ks);
    if (lane == 0) wkept[warp] = __popc(km);
    __syncthreads();
    const int wk = wkept[lane < nwarps ? lane : 0];
    const int before = kept_carry + warp_sum_below(wk, lane, warp) +
                       __popc(km & le);  // kept segments starting at or before t
    kept_carry += warp_sum_below(wk, lane, nwarps);
    if (in) {
      const int s = t - pos % m1, n = segment_end(tok, s, t, T, m1) - s;
      slot_row[t] = tk != 0 ? before - 1 : -1;
      count_row[t] = (float)n;
      if (ks) {
        sstart[before - 1] = t;
        scnt[before - 1] = n;
      }
    }
  }
  return kept_carry;
}

// The row route: a CTA a row, everything the row needs in shared memory.
__global__ void __launch_bounds__(kMaxThreads)
trim_merge_kernel(const float* __restrict__ p_code, const int* __restrict__ tokens,
                  const float* __restrict__ latent, float* __restrict__ out,
                  int* __restrict__ lengths, int* __restrict__ slot, float* __restrict__ count,
                  int T, int C, int D, int max_frames, int stage_latent) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned bar0 = smem_addr(smem);             // p_code: 0; the latent: 1
  int* wlast = reinterpret_cast<int*>(smem + 32);     // (32) a warp's last change point
  int* wkept = wlast + 32;                            // (32) a warp's kept segment starts
  const int b = blockIdx.x, T4 = (int)round4(T);
  int* tok = reinterpret_cast<int*>(smem + kHeader);  // (T) the frame's token
  int* sstart = tok + T4;                             // (T) the start frame of each kept slot
  int* scnt = sstart + T4;                            // (T) ... and its frame count
  float* pc = reinterpret_cast<float*>(scnt + T4);    // (T * C + 8) the row's p_code
  float* lat_s = pc + (tokens != nullptr ? 0 : round4((long long)T * C + 8));  // the latent
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nt = blockDim.x;
  const int nwarps = nt >> 5;
  const float* p_row = p_code + (size_t)b * T * C;
  const float* x_row = latent + (size_t)b * T * D;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // entry: every copy the row needs is started before any phase waits
  int pshift = 0, lshift = 0;
  if (tokens == nullptr) pshift = bulk_stage(pc, p_row, T * C, bar0);
  if (stage_latent) {
    lshift = bulk_stage(lat_s, x_row, T * D, bar0 + 8);
  } else if (tid == 0) {  // the aligned interior of the row's latent, into L2
    const float* a = reinterpret_cast<const float*>(((uintptr_t)x_row + 15) & ~(uintptr_t)15);
    const long long n = ((long long)T * D - (a - x_row)) & ~3LL;
    for (long long i = 0; i < n; i += 8192)  // 32 KB a prefetch
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(a + i),
                   "r"((unsigned)(4 * min(n - i, 8192LL)))
                   : "memory");
  }
  if (tokens != nullptr)
    for (int t = tid; t < T; t += nt) tok[t] = tokens[(size_t)b * T + t];
  __syncthreads();  // the copies' ends (and the given tokens) are in

  // tokens: a thread a frame, the classes in shared memory
  if (tokens == nullptr) {
    mbar_wait(bar0, 0);
    for (int f = tid; f < T; f += nt) {
      const float* p = pc + pshift + (size_t)f * C;
      float best = p[0];
      int bi = 0;
#pragma unroll 8
      for (int c = 1; c < C; ++c) {
        const float x = p[c];
        if (beats(x, best)) {
          best = x;
          bi = c;
        }
      }
      tok[f] = bi;
    }
    __syncthreads();  // the tokens are in
  }

  const int n_kept = scan_row(tok, T, max_frames + 1, slot + (size_t)b * T, count + (size_t)b * T,
                              sstart, scnt, wlast, wkept);
  if (tid == 0) lengths[b] = n_kept;
  __syncthreads();  // every slot's start is in

  // means: a warp an output row
  const float* x = x_row;
  if (stage_latent) {
    mbar_wait(bar0 + 8, 0);
    x = lat_s + lshift;
  }
  float* o_row = out + (size_t)b * T * D;
  if ((D & 1) == 0 && (((uintptr_t)x | (uintptr_t)o_row) & 7) == 0) {
    for (int j = warp; j < T; j += nwarps)
      mean_row<2>(x, o_row + (size_t)j * D, sstart, scnt, j, n_kept, D, lane, 32);
  } else {
    for (int j = warp; j < T; j += nwarps)
      mean_row<1>(x, o_row + (size_t)j * D, sstart, scnt, j, n_kept, D, lane, 32);
  }
}

// The split route's tokens: the argmax of p_code (n frames of C classes)
// into tokens, a group of 1 << lanes_log2 lanes a frame, V floats a load
// (4: C % 4 == 0 and p_code 16-byte aligned). Lane l keeps the first
// maximum of its loads l, l + lanes, ... in class order, then xor shuffles
// within the group keep the one first in the argmax's order.
template <int V>
__global__ void __launch_bounds__(kBwdThreads)
trim_merge_tokens_kernel(const float* __restrict__ p_code, int* __restrict__ tokens, long long n,
                         int C, int lanes_log2) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // p_code is written
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x & 31, lanes = 1 << lanes_log2, l = lane & (lanes - 1);
  const long long f = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> lanes_log2;
  float best = 0.0f;
  int bi = -1;
  if (f < n) {
    if (V == 4) {
      const float4* p = reinterpret_cast<const float4*>(p_code + f * C);
#pragma unroll 4
      for (int k = l; k < C / 4; k += lanes) {
        const float4 x4 = __ldg(p + k);
        const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (bi < 0 || beats(xs[i], best)) {
            best = xs[i];
            bi = 4 * k + i;
          }
      }
    } else {
      const float* p = p_code + f * C;
#pragma unroll 8
      for (int c = l; c < C; c += lanes) {
        const float x = __ldg(p + c);
        if (bi < 0 || beats(x, best)) {
          best = x;
          bi = c;
        }
      }
    }
  }
  for (int o = lanes >> 1; o > 0; o >>= 1) {  // every lane of the warp takes part
    const float y = __shfl_xor_sync(0xffffffffu, best, o);
    const int j = __shfl_xor_sync(0xffffffffu, bi, o);
    if (j >= 0 && (bi < 0 || !first_max(best, bi, y, j))) {
      best = y;
      bi = j;
    }
  }
  if (l == 0 && f < n) tokens[f] = bi;
}

// The split route's scans: a CTA a row, its tokens (given, or the tokens
// kernel's) read from device memory, the slot starts and counts into ints
// (B, 2, round4(T)).
__global__ void __launch_bounds__(kMaxThreads)
trim_merge_scan_kernel(const int* __restrict__ tokens, int* __restrict__ lengths,
                       int* __restrict__ slot, float* __restrict__ count, int* __restrict__ ints,
                       int T, int max_frames) {
  __shared__ int wlast[32], wkept[32];
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the tokens are written
  const int b = blockIdx.x, T4 = (int)round4(T);
  int* sstart = ints + (size_t)b * 2 * T4;
  const int n_kept = scan_row(tokens + (size_t)b * T, T, max_frames + 1, slot + (size_t)b * T,
                              count + (size_t)b * T, sstart, sstart + T4, wlast, wkept);
  if (threadIdx.x == 0) lengths[b] = n_kept;
}

// The split route's means: a CTA of kBwdThreads threads takes kBwdThreads /
// lanes consecutive output rows of batch row blockIdx.y, a group of lanes a
// row, V floats a load (4 or 1).
template <int V>
__global__ void __launch_bounds__(kBwdThreads)
trim_merge_means_kernel(const float* __restrict__ latent, const int* __restrict__ lengths,
                        const int* __restrict__ ints, float* __restrict__ out, int T, int D,
                        int lanes_log2) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the scans are written
  const int lanes = 1 << lanes_log2, l = threadIdx.x & (lanes - 1);
  const int j = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> lanes_log2), b = blockIdx.y;
  if (j >= T) return;
  const int T4 = (int)round4(T);
  const int* sstart = ints + (size_t)b * 2 * T4;
  mean_row<V>(latent + (size_t)b * T * D, out + ((size_t)b * T + j) * D, sstart, sstart + T4, j,
              __ldg(lengths + b), D, l, lanes);
}

// A CTA of blockDim.x threads takes blockDim.x / lanes consecutive frames
// of batch row blockIdx.y; V floats a load (4 or 1).
template <int V>
__global__ void trim_merge_bwd_kernel(const float* __restrict__ d_out,
                                      const int* __restrict__ slot,
                                      const float* __restrict__ count,
                                      float* __restrict__ d_latent, int T, int D, int lanes_log2) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x & 31, lanes = 1 << lanes_log2;
  const int l = lane & (lanes - 1), leader = lane & ~(lanes - 1);
  const int t = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> lanes_log2);
  const size_t row = (size_t)blockIdx.y * T + (t < T ? t : 0);
  int s = -1;
  float c = 1.0f;
  if (l == 0 && t < T) {
    s = slot[row];
    c = count[row];
  }
  s = __shfl_sync(0xffffffffu, s, leader);
  c = __shfl_sync(0xffffffffu, c, leader);
  if (t >= T) return;
  const int n = D / V;
  if (V == 4) {
    float4* dst = reinterpret_cast<float4*>(d_latent + row * D);
    if (s < 0) {
      for (int k = l; k < n; k += lanes) dst[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      return;
    }
    const float4* src = reinterpret_cast<const float4*>(d_out + ((size_t)blockIdx.y * T + s) * D);
    for (int k = l; k < n; k += lanes) {
      const float4 g = src[k];
      dst[k] = make_float4(__fdiv_rn(g.x, c), __fdiv_rn(g.y, c), __fdiv_rn(g.z, c),
                           __fdiv_rn(g.w, c));
    }
  } else {
    float* dst = d_latent + row * D;
    if (s < 0) {
      for (int k = l; k < n; k += lanes) dst[k] = 0.0f;
      return;
    }
    const float* src = d_out + ((size_t)blockIdx.y * T + s) * D;
    for (int k = l; k < n; k += lanes) dst[k] = __fdiv_rn(src[k], c);
  }
}

}  // namespace

// The row route: trimmed (B, T, D), lengths (B), slot (B, T), count (B, T);
// `tokens` null to take the argmax of `p_code`, else `p_code` is not read.
// The plan (`trim_merge_plan` in kernels/quantize.py, route "row"):
// `threads`, `stage_latent`, `smem_bytes` as `trim_smem_bytes` gives them.
extern "C" int trim_merge_f32(const float* p_code, const int* tokens, const float* latent,
                              float* out, int* lengths, int* slot, float* count, int B, int T,
                              int C, int D, int max_frames, int threads, int stage_latent,
                              int smem_bytes, void* stream) {
  if (B < 1 || T < 1 || C < 1 || D < 1 || max_frames < 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || (long long)T * (C > D ? C : D) > 0x3fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long smem = trim_smem_bytes(T, C, D, tokens == nullptr, stage_latent);
  if (smem != smem_bytes || smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        trim_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  trim_merge_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
      p_code, tokens, latent, out, lengths, slot, count, T, C, D, max_frames, stage_latent);
  return (int)cudaGetLastError();
}

// A programmatic dependent launch of `kernel` over `grid` x `threads`.
template <class K, class... Args>
cudaError_t launch_pdl(K kernel, dim3 grid, int threads, int smem, cudaStream_t stream,
                       Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Lanes a frame or a row: n loads of `per` each a lane (at least one lane),
// rounded up to a power of two, at most 32 (`_lanes` in kernels/quantize.py).
__host__ __device__ constexpr int group_lanes(int loads, int per) {
  int lanes = 1;
  while (lanes * per < loads && lanes < 32) lanes *= 2;
  return lanes;
}

__host__ __device__ constexpr int log2i(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

// The split route's tokens kernel over B * T frames of p_code into toks.
cudaError_t launch_tokens(const float* p_code, int* toks, int B, int T, int C, int tok_vec,
                          int tok_lanes, cudaStream_t st) {
  if (B < 1 || T < 1 || C < 1 || (tok_vec != 1 && tok_vec != 4) ||
      tok_lanes != group_lanes(C / tok_vec, 8) ||
      (tok_vec == 4 && (C % 4 != 0 || ((uintptr_t)p_code & 15) != 0)))
    return cudaErrorInvalidValue;
  const long long n = (long long)B * T, frames = kBwdThreads / tok_lanes;
  const dim3 grid((unsigned)((n + frames - 1) / frames));
  return tok_vec == 4 ? launch_pdl(trim_merge_tokens_kernel<4>, grid, kBwdThreads, 0, st, p_code,
                                   toks, n, C, log2i(tok_lanes))
                      : launch_pdl(trim_merge_tokens_kernel<1>, grid, kBwdThreads, 0, st, p_code,
                                   toks, n, C, log2i(tok_lanes));
}

// The split route's tokens alone (B, T) of p_code (B, T, C), at the plan's
// `tok_vec` and `tok_lanes` (timed beside torch.argmax).
extern "C" int trim_merge_tokens_f32(const float* p_code, int* toks, int B, int T, int C,
                                     int tok_vec, int tok_lanes, void* stream) {
  return (int)launch_tokens(p_code, toks, B, T, C, tok_vec, tok_lanes, (cudaStream_t)stream);
}

// The split route: the outputs of trim_merge_f32 in three launches. `toks`:
// B * T ints of scratch for the tokens kernel's tokens (null with given
// `tokens`); `ints`: B * 2 * round4(T) ints of scratch for the slot starts
// and counts. The plan (`trim_merge_plan`, route "split"): `tok_vec` (4 or
// 1) and `tok_lanes` a frame of the tokens kernel, as `group_lanes(C /
// tok_vec, 8)` gives them; `vec` (4 or 1) and `lanes` an output row of
// the means kernel, as `group_lanes(D / vec, 1)` gives them.
extern "C" int trim_merge_split_f32(const float* p_code, const int* tokens, const float* latent,
                                    float* out, int* lengths, int* slot, float* count, int* toks,
                                    int* ints, int B, int T, int C, int D, int max_frames,
                                    int tok_vec, int tok_lanes, int vec, int lanes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || B > 65535 || T < 1 || C < 1 || D < 1 || max_frames < 0 ||
      (tokens == nullptr) == (toks == nullptr) || (vec != 1 && vec != 4) ||
      lanes != group_lanes(D / vec, 1) ||
      (long long)T * (C > D ? C : D) > 0x3fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && (D % 4 != 0 || (((uintptr_t)latent | (uintptr_t)out) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (tokens == nullptr) {  // the tokens first, over the whole card
    err = launch_tokens(p_code, toks, B, T, C, tok_vec, tok_lanes, st);
    if (err != cudaSuccess) return (int)err;
    tokens = toks;
  }
  err = launch_pdl(trim_merge_scan_kernel, dim3(B), kMaxThreads, 0, st, tokens, lengths, slot,
                   count, ints, T, max_frames);
  if (err != cudaSuccess) return (int)err;
  const int rows = kBwdThreads / lanes;  // a CTA's
  const dim3 grid((unsigned)((T + rows - 1) / rows), (unsigned)B);
  err = vec == 4 ? launch_pdl(trim_merge_means_kernel<4>, grid, kBwdThreads, 0, st, latent,
                              (const int*)lengths, (const int*)ints, out, T, D, log2i(lanes))
                 : launch_pdl(trim_merge_means_kernel<1>, grid, kBwdThreads, 0, st, latent,
                              (const int*)lengths, (const int*)ints, out, T, D, log2i(lanes));
  return (int)err;
}

// d_latent (B, T, D) from d_trimmed (B, T, D) and the forward's slot and
// count. The plan: `vec` 4 (D % 4 == 0, 16-byte aligned rows) or 1 and
// `lanes` a frame, as `group_lanes(ceil(D / vec), 1)` gives them.
extern "C" int trim_merge_bwd_f32(const float* d_out, const int* slot, const float* count,
                                  float* d_latent, int B, int T, int D, int vec, int lanes,
                                  void* stream) {
  if (B < 1 || B > 65535 || T < 1 || D < 1 || (vec != 1 && vec != 4) ||
      lanes != group_lanes((D + vec - 1) / vec, 1) || (long long)B * T * D > 0x7fffffffffffLL)
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && (D % 4 != 0 || (((uintptr_t)d_out | (uintptr_t)d_latent) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  const int frames = kBwdThreads / lanes;  // a CTA's
  const dim3 grid((unsigned)((T + frames - 1) / frames), (unsigned)B);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(vec == 4 ? launch_pdl(trim_merge_bwd_kernel<4>, grid, kBwdThreads, 0, st, d_out,
                                     slot, count, d_latent, T, D, log2i(lanes))
                        : launch_pdl(trim_merge_bwd_kernel<1>, grid, kBwdThreads, 0, st, d_out,
                                     slot, count, d_latent, T, D, log2i(lanes)));
}
