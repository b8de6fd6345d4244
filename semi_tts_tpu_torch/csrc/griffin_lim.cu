// The per-round glue of batched Griffin-Lim, around the two DFT GEMMs.
//
// Replaces: the body of `semi_tts_tpu/ops/griffin_lim.py` `griffin_lim`
// between its matmuls: the phase projection (`:73-76`) and the tail of
// `ops/stft.py` `istft_reim` (overlap-add, envelope divide, trim) joined to
// the head of `stft_reim` (whole-signal reflect pad, framing over the window
// support) of the next round. The windowed forward and inverse DFTs stay
// GEMMs (torch.matmul) between these kernels.
//
// gl_project: (re, im) packed as (B*T, 2F), mag (B*T, F) ->
//   (mag*re/r, mag*im/r), or (mag, 0) where r = |z| == 0 (angle(0) = 0).
// gl_ola_frame: inverse-GEMM frames (B, T, span) -> signal
//   sig[s] = OLA(frames)[s + n_fft/2] / max(env, 1e-11)[s], s in [0, S),
//   S = hop*(T-1); emitted either as the signal (B, S) or, for the next
//   round, as the frames (B, T, span) of its reflect-padded form.
//
// What bounds it on an H100: bytes. Both are elementwise or gather passes
// with a handful of FLOPs per element; at serving shapes (B=16, T=300,
// F=1025, span=1102) gl_project moves ~98 MB and gl_ola_frame ~42 MB.
//
// gl_project: one thread per (frame, bin), neighbouring threads on
// neighbouring bins.
//
// gl_ola_frame: one CTA makes `tile` consecutive output frames of one row
// (grid (ceil(T / tile), B)). Those frames read one contiguous segment of
// the trimmed signal, reflected near either end; kernels/griffin_lim.py
// `ola_plan` gives the same segments and sizes shared memory for the
// largest. Step 1: each thread owns signal samples of the segment and sums
// the inverse frames that overlap each one, frames from high to low as the
// plain version adds them (so the result is bit-identical), then divides by
// the envelope once; a warp's loads of one frame are neighbouring words,
// and a sample issues up to kTaps of them at once. Each sample is summed
// once per tile. Step 2: the CTA writes its frames out of the
// segment in shared memory with coalesced float2 stores. On the last round
// (emit_signal) the tile writes its own stretch of the signal,
// [t0*hop, t1*hop), from step 1. Index arithmetic is 32-bit and no division
// by hop is left in per-sample code. Small tiles re-read more inverse
// frames (12 for 8 output frames) but give the card enough CTAs to keep
// loads in flight; chip_smoke.py's `ms_by_tile` picks the default
// (OLA_TILE in kernels/griffin_lim.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void gl_project_kernel(const float* __restrict__ reim, const float* __restrict__ mag,
                                  float* __restrict__ out, long long n, int F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long row = i / F;
  const int f = (int)(i - row * F);
  const long long re_at = row * 2 * F + f;
  const float re = reim[re_at], im = reim[re_at + F], m = mag[i];
  const float r = sqrtf(re * re + im * im);
  if (r > 0.0f) {
    const float scale = m / r;
    out[re_at] = re * scale;
    out[re_at + F] = im * scale;
  } else {
    out[re_at] = m;
    out[re_at + F] = 0.0f;
  }
}

struct Geometry {
  int T, span, hop, off, half, S;
};

constexpr int kTaps = 8;   // inverse-frame loads a sample issues at once

__device__ __forceinline__ int reflect(int x, int S) {
  x = x < 0 ? -x : x;
  return x >= S ? 2 * (S - 1) - x : x;
}

// Overlap-add of the frames of one row (fb) over the signal samples
// [lo, lo + n), divided by the envelope, handed to put(i, value) for sample
// lo + i. Thread k owns samples lo + k, lo + k + blockDim.x, ...
template <typename Put>
__device__ __forceinline__ void ola_segment(const float* __restrict__ fb,
                                            const float* __restrict__ env, int lo, int n,
                                            const Geometry g, Put put) {
  const int stride = blockDim.x;
  const int q_step = stride / g.hop, r_step = stride - q_step * g.hop;
  int rel = lo + threadIdx.x + g.half - g.off;   // frame t covers rel - t*hop in [0, span)
  int t_top = rel / g.hop, rem = rel - t_top * g.hop;
  for (int i = threadIdx.x; i < n; i += stride) {
    int t = min(t_top, g.T - 1);
    int e = rem + (t_top - t) * g.hop;           // position inside frame t
    float acc = 0.0f;
    while (t >= 0 && e < g.span) {
      float x[kTaps];
#pragma unroll
      for (int q = 0; q < kTaps; ++q)
        x[q] = (t - q >= 0 && e + q * g.hop < g.span) ? fb[(t - q) * g.span + e + q * g.hop] : 0.0f;
#pragma unroll
      for (int q = 0; q < kTaps; ++q)
        if (t - q >= 0 && e + q * g.hop < g.span) acc += x[q];
      t -= kTaps;
      e += kTaps * g.hop;
    }
    put(i, acc / env[lo + i]);
    t_top += q_step;
    rem += r_step;
    if (rem >= g.hop) {
      rem -= g.hop;
      ++t_top;
    }
  }
}

template <bool kEmitSignal>
__global__ void gl_ola_frame_kernel(const float* __restrict__ frames, const float* __restrict__ env,
                                    float* __restrict__ out, int tile, Geometry g) {
  extern __shared__ float seg[];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile, t1 = min(g.T, t0 + tile);
  const float* fb = frames + (size_t)b * g.T * g.span;
  if (kEmitSignal) {
    const int lo = t0 * g.hop, hi = min(t1 * g.hop, g.S);
    float* ob = out + (size_t)b * g.S + lo;
    ola_segment(fb, env, lo, hi - lo, g, [&](int i, float v) { ob[i] = v; });
    return;
  }
  // the segment [lo, hi] that frames [t0, t1) read, as ola_plan computes it
  const int x_lo = t0 * g.hop + g.off - g.half;
  const int x_hi = (t1 - 1) * g.hop + g.off + g.span - 1 - g.half;
  const int ra = reflect(x_lo, g.S), rb = reflect(x_hi, g.S);
  const int lo = (x_lo <= 0 && 0 <= x_hi) ? 0 : min(ra, rb);
  const int hi = (x_lo <= g.S - 1 && g.S - 1 <= x_hi) ? g.S - 1 : max(ra, rb);
  ola_segment(fb, env, lo, hi - lo + 1, g, [&](int i, float v) { seg[i] = v; });
  __syncthreads();
  float* ob = out + ((size_t)b * g.T + t0) * g.span;
  for (int t = t0; t < t1; ++t, ob += g.span) {
    const int x0 = t * g.hop + g.off - g.half;
    if (g.span % 2 == 0) {  // rows start 8-byte aligned: float2 stores
      float2* o2 = reinterpret_cast<float2*>(ob);
      for (int j = threadIdx.x; j < g.span / 2; j += blockDim.x)
        o2[j] = make_float2(seg[reflect(x0 + 2 * j, g.S) - lo],
                            seg[reflect(x0 + 2 * j + 1, g.S) - lo]);
    } else {
      for (int j = threadIdx.x; j < g.span; j += blockDim.x) ob[j] = seg[reflect(x0 + j, g.S) - lo];
    }
  }
}

unsigned int blocks_for(long long n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int gl_project_f32(const float* reim, const float* mag, float* out,
                              int rows, int F, void* stream) {
  const long long n = (long long)rows * F;
  gl_project_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(reim, mag, out, n, F);
  return (int)cudaGetLastError();
}

// emit_signal = 1: out is (B, S); 0: out is the next round's frames (B, T, span).
// `tile` frames per CTA; `smem_bytes` holds the largest segment (ola_plan).
extern "C" int gl_ola_frame_f32(const float* frames, const float* env, float* out,
                                int B, int T, int span, int hop, int off, int half,
                                int emit_signal, int tile, int smem_bytes, void* stream) {
  if (tile < 1 || T < 2) return (int)cudaErrorInvalidValue;
  const Geometry g{T, span, hop, off, half, hop * (T - 1)};
  const dim3 grid((T + tile - 1) / tile, B);
  if (emit_signal) {
    gl_ola_frame_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(frames, env, out,
                                                                         tile, g);
  } else {
    if (smem_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          gl_ola_frame_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return (int)err;
    }
    gl_ola_frame_kernel<false><<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
        frames, env, out, tile, g);
  }
  return (int)cudaGetLastError();
}
