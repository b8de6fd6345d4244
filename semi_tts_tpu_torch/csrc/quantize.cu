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
// ~0.73 MB, ~0.2 us of HBM time; a launch costs more. So the design is the
// simple one: one CTA per batch row, each phase a short loop between block
// barriers.
// - Tokens: a warp per frame, lanes over the classes; the first maximum wins
//   ties, and NaN counts as the maximum, as jnp.argmax.
// - Segment starts without the scan's carry: a max-scan of the frames where
//   the token changes gives each frame its run's start, and a frame starts a
//   segment where (t - run_start) % (max_frames_per_phn + 1) == 0 (the JAX
//   scan's `last_pos` resets at each boundary, so a run is cut every
//   max_frames_per_phn + 1 frames). A sum-scan of the kept starts (token not
//   0) gives each kept segment its output slot. A segment is at most
//   max_frames_per_phn + 1 frames long, so a frame finds its segment's
//   bounds by walking to the neighbouring starts.
// - Means: a thread per (slot, d), the segment's frames summed in time order
//   and divided by the count, as `segment_sum` then the division.
// The backward is a gather: d_latent[b, t] = d_trimmed[b, slot[t]] /
// count[t] on kept frames, 0 elsewhere; one thread per element, no atomics.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct Max {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct Add {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// Inclusive scan of a[0, T) in place (Hillis-Steele, scratch tmp of T ints).
template <class Op>
__device__ void block_scan(int* a, int* tmp, int T, Op op) {
  for (int off = 1; off < T; off <<= 1) {
    for (int t = threadIdx.x; t < T; t += blockDim.x) tmp[t] = t >= off ? op(a[t - off], a[t]) : a[t];
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += blockDim.x) a[t] = tmp[t];
    __syncthreads();
  }
}

// x beats the current best (value, index): larger, or NaN over a number.
__device__ __forceinline__ bool beats(float x, float best) {
  return (isnan(x) && !isnan(best)) || x > best;
}

__global__ void __launch_bounds__(kThreads)
trim_merge_kernel(const float* __restrict__ p_code, const int* __restrict__ tokens,
                  const float* __restrict__ latent, float* __restrict__ out,
                  int* __restrict__ lengths, int* __restrict__ slot, float* __restrict__ count,
                  int T, int C, int D, int max_frames) {
  extern __shared__ int sm[];
  int* tok = sm;           // (T) the frame's token
  int* acc = tok + T;      // (T) run starts, then the count of kept starts so far
  int* start = acc + T;    // (T) 1 where a segment starts
  int* tmp = start + T;    // (T) scan scratch, then the start frame of each slot
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  if (tokens != nullptr) {
    for (int t = tid; t < T; t += blockDim.x) tok[t] = tokens[(size_t)b * T + t];
  } else {
    for (int t = warp; t < T; t += nwarps) {
      const float* p = p_code + ((size_t)b * T + t) * C;
      float best = lane < C ? p[lane] : -INFINITY;
      int bi = lane < C ? lane : C;
      for (int c = lane + 32; c < C; c += 32) {
        const float x = p[c];
        if (beats(x, best)) { best = x; bi = c; }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        const bool tie = ob == best || (isnan(ob) && isnan(best));
        if (beats(ob, best) || (tie && oi < bi)) { best = ob; bi = oi; }
      }
      if (lane == 0) tok[t] = bi;
    }
  }
  __syncthreads();
  for (int t = tid; t < T; t += blockDim.x) acc[t] = (t == 0 || tok[t] != tok[t - 1]) ? t : 0;
  __syncthreads();
  block_scan(acc, tmp, T, Max());  // acc[t]: the start of t's run
  for (int t = tid; t < T; t += blockDim.x) start[t] = (t - acc[t]) % (max_frames + 1) == 0;
  __syncthreads();
  for (int t = tid; t < T; t += blockDim.x) acc[t] = start[t] && tok[t] != 0;
  __syncthreads();
  block_scan(acc, tmp, T, Add());  // acc[t]: kept segments starting at or before t
  const int n_kept = acc[T - 1];
  for (int t = tid; t < T; t += blockDim.x) {
    int s = t, e = t + 1;
    while (!start[s]) --s;
    while (e < T && !start[e]) ++e;
    const bool kept = tok[t] != 0;
    slot[(size_t)b * T + t] = kept ? acc[t] - 1 : -1;
    count[(size_t)b * T + t] = (float)(e - s);
    if (kept && s == t) tmp[acc[t] - 1] = t;
  }
  if (tid == 0) lengths[b] = n_kept;
  __syncthreads();
  for (int i = tid; i < T * D; i += blockDim.x) {
    const int j = i / D, d = i - j * D;
    float v = 0.0f;
    if (j < n_kept) {
      const int s = tmp[j];
      int e = s + 1;
      while (e < T && !start[e]) ++e;
      const float* x = latent + ((size_t)b * T + s) * D + d;
      for (int t = s; t < e; ++t) v += x[(size_t)(t - s) * D];
      v = v / (float)(e - s);
    }
    out[(size_t)b * T * D + i] = v;
  }
}

__global__ void trim_merge_bwd_kernel(const float* __restrict__ d_out,
                                      const int* __restrict__ slot,
                                      const float* __restrict__ count,
                                      float* __restrict__ d_latent, int T, int D, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t bt = i / D;
    const int d = (int)(i - bt * D);
    const int s = slot[bt];
    d_latent[i] = s >= 0 ? d_out[(bt - bt % T + s) * D + d] / count[bt] : 0.0f;
  }
}

}  // namespace

// trimmed (B, T, D), lengths (B), slot (B, T), count (B, T); `tokens` null
// to take the argmax of `p_code`, else `p_code` is not read.
extern "C" int trim_merge_f32(const float* p_code, const int* tokens, const float* latent,
                              float* out, int* lengths, int* slot, float* count, int B, int T,
                              int C, int D, int max_frames, void* stream) {
  if (B < 1 || T < 1 || C < 1 || D < 1 || max_frames < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)4 * T * sizeof(int);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(trim_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  trim_merge_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      p_code, tokens, latent, out, lengths, slot, count, T, C, D, max_frames);
  return (int)cudaGetLastError();
}

// d_latent (B, T, D) from d_trimmed (B, T, D) and the forward's slot and count.
extern "C" int trim_merge_bwd_f32(const float* d_out, const int* slot, const float* count,
                                  float* d_latent, int B, int T, int D, void* stream) {
  if (B < 1 || T < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * T * D;
  const int blocks = (int)((n + kThreads - 1) / kThreads < 4096 ? (n + kThreads - 1) / kThreads : 4096);
  trim_merge_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(d_out, slot, count,
                                                                     d_latent, T, D, n);
  return (int)cudaGetLastError();
}
