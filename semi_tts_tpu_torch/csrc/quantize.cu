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
// - Entry: thread 0 starts bulk copies (cp.async.bulk, completing an
//   mbarrier) of the row's p_code into shared memory, in a ring of two
//   chunks of frames where the row does not fit in one, and of the row's
//   latent where it fits beside p_code (else an L2 prefetch of it,
//   cp.async.bulk.prefetch.L2). A copy's unaligned ends (at most 3 floats
//   each side) are loaded by threads. Tokens given in place of p_code are
//   read straight into shared memory.
// - Tokens: a thread per frame, the classes from shared memory; the first
//   maximum wins ties, and NaN counts as the maximum, as jnp.argmax.
// - Scans, in chunks of blockDim frames, a thread a frame: a frame's run
//   start is the last change point at or before it (the warp's by
//   __ballot_sync and __clz, earlier warps' and chunks' by a carry: one
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
// - Long rows: where the three per-frame int arrays (tokens, slot starts,
//   slot counts) do not fit in shared memory (T past ~19,300), they live in
//   a (B, 3, round4(T)) scratch in device memory that the wrapper
//   allocates, and the phases read and write them there; where not one
//   frame of p_code fits the ring (C past ~7,192 at T = 14,528), a first
//   kernel takes the argmax over the whole card, a warp a frame, lanes
//   strided over the classes and combined by shuffles (the first maximum,
//   NaN the largest, as above), into a (B, T) scratch of tokens that the
//   main kernel reads as given tokens (one CTA a row would read the ~465
//   MB of a row's p_code at one SM's rate).
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

namespace {

constexpr int kBwdThreads = 256;    // trim_merge_bwd
constexpr int kMaxThreads = 1024;   // trim_merge
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kHeader = 16 * 32;    // 3 mbarriers (32 bytes), two warp arrays of 32 ints

__host__ __device__ constexpr long long round4(long long n) { return (n + 3) & ~3LL; }

// The plan's shared memory in bytes: the header, tokens, slot starts and
// slot frame counts (T ints each, unless `ints_global`), the p_code ring
// (`depth` slots of `chunk` frames of C floats, 8 floats of slack each for
// the alignment shift) and the staged latent.
__host__ __device__ constexpr long long trim_smem_bytes(int T, int C, int D, int chunk, int depth,
                                                        int stage_latent, int ints_global) {
  return kHeader + 4 * ((ints_global ? 0 : 3 * round4(T)) +
                        depth * round4((long long)chunk * C + 8) +
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

// Output row j: the mean of the kept segment j, or zeros; V floats a lane.
template <int V>
__device__ __forceinline__ void mean_row(const float* x, float* o, const int* sstart,
                                         const int* scnt, int j, int n_kept, int D, int lane) {
  if (j >= n_kept) {
    for (int d = V * lane; d < D; d += 32 * V) {
      if (V == 2) *reinterpret_cast<float2*>(o + d) = make_float2(0.0f, 0.0f);
      else o[d] = 0.0f;
    }
    return;
  }
  const int s = sstart[j], e = s + scnt[j];
  const float cnt = (float)(e - s);
  for (int d = V * lane; d < D; d += 32 * V) {
    if (V == 2) {
      float2 v = make_float2(0.0f, 0.0f);
      for (int t = s; t < e; ++t) {
        const float2 a = *reinterpret_cast<const float2*>(x + (size_t)t * D + d);
        v.x += a.x;
        v.y += a.y;
      }
      *reinterpret_cast<float2*>(o + d) = make_float2(v.x / cnt, v.y / cnt);
    } else {
      float v = 0.0f;
      for (int t = s; t < e; ++t) v += x[(size_t)t * D + d];
      o[d] = v / cnt;
    }
  }
}

// kGlobalInts: the per-frame ints in `ints` (B, 3, round4(T)) in device
// memory, else in shared memory (a template argument, so that the shared
// route keeps shared-memory addressing).
template <bool kGlobalInts>
__global__ void __launch_bounds__(kMaxThreads)
trim_merge_kernel(const float* __restrict__ p_code, const int* __restrict__ tokens,
                  const float* __restrict__ latent, float* __restrict__ out,
                  int* __restrict__ lengths, int* __restrict__ slot, float* __restrict__ count,
                  int* ints, int T, int C, int D, int max_frames, int chunk, int depth,
                  int stage_latent) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned bar0 = smem_addr(smem);             // p_code ring slots 0, 1; the latent: 2
  int* wlast = reinterpret_cast<int*>(smem + 32);     // (32) a warp's last change point
  int* wkept = wlast + 32;                            // (32) a warp's kept segment starts
  const int b = blockIdx.x, T4 = (int)round4(T);
  int* tok = kGlobalInts ? ints + (size_t)b * 3 * T4  // (T) the frame's token
                         : reinterpret_cast<int*>(smem + kHeader);
  int* sstart = tok + T4;                             // (T) the start frame of each kept slot
  int* scnt = sstart + T4;                            // (T) ... and its frame count
  float* ring = reinterpret_cast<float*>(kGlobalInts ? reinterpret_cast<int*>(smem + kHeader)
                                                     : scnt + T4);
  const int ring_slot = (int)round4((long long)chunk * C + 8);
  float* lat_s = ring + depth * ring_slot;            // (T * D + 8) the staged latent
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nt = blockDim.x;
  const int nwarps = nt >> 5, m1 = max_frames + 1;
  const float* p_row = p_code + (size_t)b * T * C;
  const float* x_row = latent + (size_t)b * T * D;
  const int n_chunks = tokens != nullptr ? 0 : (T + chunk - 1) / chunk;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // entry: every copy the row needs is started before any phase waits
  auto issue = [&](int k) {  // p_code chunk k into ring slot k % depth
    const int f0 = k * chunk, nf = min(chunk, T - f0);
    return bulk_stage(ring + (k % depth) * ring_slot, p_row + (size_t)f0 * C, nf * C,
                      bar0 + 8 * (k % depth));
  };
  int pshift[2] = {0, 0};
  for (int k = 0; k < min(depth, n_chunks); ++k) pshift[k] = issue(k);
  int lshift = 0;
  if (stage_latent) {
    lshift = bulk_stage(lat_s, x_row, T * D, bar0 + 16);
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

  // tokens: a thread a frame of each chunk, the chunk's classes in the ring
  for (int k = 0; k < n_chunks; ++k) {
    const int sl = k % depth, f0 = k * chunk, nf = min(chunk, T - f0);
    mbar_wait(bar0 + 8 * sl, (k / depth) & 1);
    const float* pc = ring + sl * ring_slot + pshift[sl];
    for (int f = tid; f < nf; f += nt) {
      const float* p = pc + (size_t)f * C;
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
      tok[f0 + f] = bi;
    }
    __syncthreads();  // slot sl is read; chunk k's tokens are in
    if (k + depth < n_chunks) {
      pshift[sl] = issue(k + depth);  // its ends are in by the next chunk's barrier
    }
  }

  // scans: a thread a frame, in chunks of nt frames, carried across warps and chunks
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
      slot[(size_t)b * T + t] = tk != 0 ? before - 1 : -1;
      count[(size_t)b * T + t] = (float)n;
      if (ks) {
        sstart[before - 1] = t;
        scnt[before - 1] = n;
      }
    }
  }
  const int n_kept = kept_carry;
  if (tid == 0) lengths[b] = n_kept;
  __syncthreads();  // every slot's start is in

  // means: a warp an output row
  const float* x = x_row;
  if (stage_latent) {
    mbar_wait(bar0 + 16, 0);
    x = lat_s + lshift;
  }
  float* o_row = out + (size_t)b * T * D;
  if ((D & 1) == 0 && (((uintptr_t)x | (uintptr_t)o_row) & 7) == 0) {
    for (int j = warp; j < T; j += nwarps)
      mean_row<2>(x, o_row + (size_t)j * D, sstart, scnt, j, n_kept, D, lane);
  } else {
    for (int j = warp; j < T; j += nwarps)
      mean_row<1>(x, o_row + (size_t)j * D, sstart, scnt, j, n_kept, D, lane);
  }
}

// The argmax of p_code (n frames of C classes) into tokens, a warp a frame:
// lane j keeps the first maximum of classes j, j + 32, ..., then xor
// shuffles keep the one first in the argmax's order.
__global__ void __launch_bounds__(kBwdThreads)
trim_argmax_kernel(const float* __restrict__ p_code, int* __restrict__ tokens, long long n,
                   int C) {
  const long long f = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (f >= n) return;  // whole warps leave together
  const float* p = p_code + f * C;
  float best = 0.0f;
  int bi = -1;
#pragma unroll 4
  for (int c = lane; c < C; c += 32) {
    const float x = __ldg(p + c);
    if (bi < 0 || beats(x, best)) {
      best = x;
      bi = c;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, best, o);
    const int j = __shfl_xor_sync(0xffffffffu, bi, o);
    if (j >= 0 && (bi < 0 || !first_max(best, bi, y, j))) {
      best = y;
      bi = j;
    }
  }
  if (lane == 0) tokens[f] = bi;
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

// trimmed (B, T, D), lengths (B), slot (B, T), count (B, T); `tokens` null
// to take the argmax of `p_code`, else `p_code` is not read. The plan
// (`trim_merge_plan` in kernels/quantize.py): `threads`, the p_code ring's
// `chunk` frames and `depth` slots (0 with tokens, and for the argmax
// pass), `stage_latent`, `smem_bytes` as `trim_smem_bytes` gives them;
// `ints`: null, or B * 3 * round4(T) ints of scratch (the per-frame ints in
// device memory); `argmax`: null, or B * T ints of scratch for the tokens
// of `trim_argmax_kernel`, launched first (with depth 0, no tokens).
extern "C" int trim_merge_f32(const float* p_code, const int* tokens, const float* latent,
                              float* out, int* lengths, int* slot, float* count, int* ints,
                              int* argmax, int B, int T, int C, int D, int max_frames, int threads,
                              int chunk, int depth, int stage_latent, int smem_bytes,
                              void* stream) {
  if (B < 1 || T < 1 || C < 1 || D < 1 || max_frames < 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || depth < 0 || depth > 2 ||
      (tokens != nullptr && (depth > 0 || argmax != nullptr)) ||
      (tokens == nullptr && (depth > 0) == (argmax != nullptr)) || (depth > 0 && chunk < 1) ||
      (depth == 1 && chunk < T) || (long long)T * (C > D ? C : D) > 0x3fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (argmax != nullptr) {  // the tokens first, over the whole card
    const long long n = (long long)B * T;
    trim_argmax_kernel<<<(unsigned)((n + kBwdThreads / 32 - 1) / (kBwdThreads / 32)), kBwdThreads, 0,
                         (cudaStream_t)stream>>>(p_code, argmax, n, C);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tokens = argmax;
  }
  const long long smem =
      trim_smem_bytes(T, C, D, depth > 0 ? chunk : 0, depth, stage_latent, ints != nullptr);
  if (smem != smem_bytes || smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const auto kernel = ints != nullptr ? trim_merge_kernel<true> : trim_merge_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
      p_code, tokens, latent, out, lengths, slot, count, ints, T, C, D, max_frames,
      depth > 0 ? chunk : 1, depth, stage_latent);
  return (int)cudaGetLastError();
}

// Lanes a frame of `trim_merge_bwd`: the D / vec loads of a row rounded up
// to a power of two, at most 32 (`trim_merge_bwd_plan` in kernels/quantize.py).
__host__ __device__ constexpr int bwd_lanes(int D, int vec) {
  int n = (D + vec - 1) / vec, lanes = 1;
  while (lanes < n && lanes < 32) lanes *= 2;
  return lanes;
}

// d_latent (B, T, D) from d_trimmed (B, T, D) and the forward's slot and
// count. The plan: `vec` 4 (D % 4 == 0, 16-byte aligned rows) or 1 and
// `lanes` a frame, as `bwd_lanes` gives them.
extern "C" int trim_merge_bwd_f32(const float* d_out, const int* slot, const float* count,
                                  float* d_latent, int B, int T, int D, int vec, int lanes,
                                  void* stream) {
  if (B < 1 || B > 65535 || T < 1 || D < 1 || (vec != 1 && vec != 4) ||
      lanes != bwd_lanes(D, vec) || (long long)B * T * D > 0x7fffffffffffLL)
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && (D % 4 != 0 || (((uintptr_t)d_out | (uintptr_t)d_latent) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < lanes) ++lanes_log2;
  const int frames = kBwdThreads / lanes;  // a CTA's
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((T + frames - 1) / frames), (unsigned)B);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      vec == 4 ? cudaLaunchKernelEx(&cfg, trim_merge_bwd_kernel<4>, d_out, slot, count, d_latent,
                                    T, D, lanes_log2)
               : cudaLaunchKernelEx(&cfg, trim_merge_bwd_kernel<1>, d_out, slot, count, d_latent,
                                    T, D, lanes_log2);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
