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
// Design: one thread per output element, no atomics and no intermediate
// signal in device memory: a frame element of the next round gathers the
// at most ceil(span/hop) inverse-frame samples that overlap its (reflected)
// signal position and divides by the envelope, so OLA, divide, trim, pad
// and framing are one pass. Neighbouring threads read neighbouring samples.

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

// Trimmed, envelope-divided overlap-add signal of row b at position s.
__device__ __forceinline__ float ola_sample(const float* __restrict__ frames,
                                            const float* __restrict__ env,
                                            int b, int s, const Geometry g) {
  const int p = s + g.half;            // position in the untrimmed OLA buffer
  const int rel = p - g.off;           // frame t covers rel - t*hop in [0, span)
  int t_hi = rel / g.hop;
  if (t_hi > g.T - 1) t_hi = g.T - 1;
  const int lo_num = rel - g.span + 1;
  const int t_lo = lo_num <= 0 ? 0 : (lo_num + g.hop - 1) / g.hop;
  const float* fb = frames + (size_t)b * g.T * g.span;
  float acc = 0.0f;
  for (int t = t_hi; t >= t_lo; --t) acc += fb[(size_t)t * g.span + (rel - t * g.hop)];
  return acc / env[s];
}

__global__ void gl_ola_signal_kernel(const float* __restrict__ frames, const float* __restrict__ env,
                                     float* __restrict__ out, int B, Geometry g) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * g.S) return;
  const int b = (int)(i / g.S), s = (int)(i % g.S);
  out[i] = ola_sample(frames, env, b, s, g);
}

__global__ void gl_ola_frame_kernel(const float* __restrict__ frames, const float* __restrict__ env,
                                    float* __restrict__ out, int B, Geometry g) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_row = (long long)g.T * g.span;
  if (i >= (long long)B * per_row) return;
  const int b = (int)(i / per_row);
  const int rem = (int)(i - b * per_row);
  const int t = rem / g.span, j = rem % g.span;
  int s = t * g.hop + g.off + j - g.half;  // reflect pad of n_fft/2 each side
  if (s < 0) s = -s;
  if (s >= g.S) s = 2 * (g.S - 1) - s;
  out[i] = ola_sample(frames, env, b, s, g);
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
extern "C" int gl_ola_frame_f32(const float* frames, const float* env, float* out,
                                int B, int T, int span, int hop, int off, int half,
                                int emit_signal, void* stream) {
  const Geometry g{T, span, hop, off, half, hop * (T - 1)};
  if (emit_signal) {
    gl_ola_signal_kernel<<<blocks_for((long long)B * g.S), kThreads, 0, (cudaStream_t)stream>>>(
        frames, env, out, B, g);
  } else {
    gl_ola_frame_kernel<<<blocks_for((long long)B * T * span), kThreads, 0, (cudaStream_t)stream>>>(
        frames, env, out, B, g);
  }
  return (int)cudaGetLastError();
}
