// K5: the featurizer glue around the DFT and mel GEMMs.
//
// Replaces: the framing and epilogue of the JAX featurizer, B1 and B2:
// `semi_tts_tpu/ops/features.py:158` `featurize` (pre-emphasis, the mask at
// each row's length, `ops/stft.py:297` `stft_magnitude` with
// `reflect_pad_ragged` `:60` and `frame_signal_static` `:128`, the dB
// finalize) and `:183` `_augment_impl` (SNR noise mixing, the framing scan
// at a runtime hop with its start clamped to S_pad - n_fft, the
// `dynamic_hann_window` `:47` of a runtime length, the dB finalize and the
// frame mask). The DFT ([cos | -sin] over the window support) and the mel
// projection stay fp32 GEMMs (torch.matmul) between these kernels, as the
// JAX package leaves them to XLA einsums.
//
// stft_frames: waves (B, S) [+ mix[b] * noise (B, S)] -> frames (B, T, span)
//   frames[b, t, n] = xm(idx) * hann_win(off + n) for t < 1 + L/hop, else 0,
//   where xm is the pre-emphasized signal zeroed at and past L = lengths[b],
//   the frame starts at t*hop (clean) or min(t*hop, S_pad - n_fft)
//   (augmented) in the signal reflect-padded by n_fft/2 around 0 and L, and
//   idx is that padded position mapped back through the reflection. The
//   padded signal is never written out: each output element indexes it.
//   The window is multiplied here on both paths (the DFT basis is
//   unwindowed). hop and win come from a device array, so a stretch rate
//   drawn on the card needs no host round trip.
// spec_db: [re | im] (B, T, 2F) -> magnitude (B, T, F) and/or
//   normalize_db(amp_to_db(mag) - ref_db) over the floor min_db, zeroed at
//   t >= frame_lengths[b]; or an amplitude (B, T, F) -> the same dB output.
//   The caller passes the levels (-100 and 20 dB in `ops/features.py`).
//
// What bounds it on an H100: bytes. Both are gathers or elementwise passes
// with a few FLOPs per element (a cosf for the window); at the flagship
// shapes (B=8, S=66150, T=267, span=1212, F=1025) stft_frames writes 10.4 MB
// and spec_db moves 35 MB. One thread per output element, neighbouring
// threads on neighbouring samples or bins, so loads and stores coalesce.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void stft_frames_kernel(const float* __restrict__ waves, const int* __restrict__ lengths,
                                   const int* __restrict__ geom, const float* __restrict__ noise,
                                   const float* __restrict__ mix, float* __restrict__ frames, int S,
                                   int T, int n_fft, int off, int span, int clamp, float coeff) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= span) return;
  const int row = blockIdx.y;  // b * T + t
  const int b = row / T, t = row - b * T;
  const int L = lengths[b], hop = geom[0], win = geom[1];
  float* out = frames + (size_t)row * span + n;
  if (t >= 1 + L / hop) {
    *out = 0.0f;
    return;
  }
  const int pad = n_fft / 2;
  const int S_pad = S + 2 * pad;
  const int start = clamp ? min(t * hop, S_pad - n_fft) : t * hop;
  const int p = start + off + n;  // position in the padded signal
  const int i = p - pad;          // ... and in the signal
  int idx = -1;
  if (p >= S_pad) {
    idx = -1;  // static hop: zero past the padded signal
  } else if (i < 0) {
    idx = -i;  // left mirror around 0
  } else if (i < L) {
    idx = i;
  } else if (i < L + pad) {  // right mirror around L (start clamped at 0 for L <= pad)
    idx = L >= pad + 1 ? 2 * L - 2 - i : L + pad - 1 - i;
  }
  float v = 0.0f;
  if (idx >= 0 && idx < L) {
    const float* w = waves + (size_t)b * S;
    float cur = w[idx];
    float prev = idx > 0 ? w[idx - 1] : 0.0f;
    if (noise != nullptr) {
      const float* z = noise + (size_t)b * S;
      const float m = mix[b];
      cur = cur + m * z[idx];
      if (idx > 0) prev = prev + m * z[idx - 1];
    }
    v = idx > 0 ? cur - coeff * prev : cur;
  }
  const int k = off + n - (n_fft - win) / 2;
  const float hann =
      (k >= 0 && k < win) ? 0.5f - 0.5f * cosf(6.2831855f * (float)k / (float)win) : 0.0f;
  *out = v * hann;
}

__device__ __forceinline__ float normalized_db(float amp, float min_db, float ref_db) {
  const float db = 20.0f * log10f(fmaxf(amp, 1e-5f)) - ref_db;
  return fminf(fmaxf((db - min_db) / -min_db, 0.0f), 1.0f);
}

__global__ void spec_db_kernel(const float* __restrict__ x, const int* __restrict__ frame_lengths,
                               float* __restrict__ mag, float* __restrict__ out, long long n,
                               int T, int F, int reim, float min_db, float ref_db) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long row = i / F;
  const int f = (int)(i - row * F);
  float amp;
  if (reim) {
    const float re = x[row * 2 * F + f], im = x[row * 2 * F + F + f];
    amp = sqrtf(re * re + im * im);
    if (mag != nullptr) mag[i] = amp;
  } else {
    amp = x[i];
  }
  if (out != nullptr) {
    const int b = (int)(row / T), t = (int)(row - (long long)b * T);
    out[i] = t < frame_lengths[b] ? normalized_db(amp, min_db, ref_db) : 0.0f;
  }
}

}  // namespace

// frames (B, T, span); noise and mix may both be null (no mixing).
extern "C" int stft_frames_f32(const float* waves, const int* lengths, const int* geom,
                               const float* noise, const float* mix, float* frames, int B, int S,
                               int T, int n_fft, int off, int span, int clamp, float coeff,
                               void* stream) {
  // grid.y is one frame row each: at most 65535 of them
  if (B < 1 || T < 1 || span < 1 || off < 0 || off + span > n_fft || (long long)B * T > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((span + kThreads - 1) / kThreads, B * T);
  stft_frames_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      waves, lengths, geom, noise, mix, frames, S, T, n_fft, off, span, clamp, coeff);
  return (int)cudaGetLastError();
}

// reim: x is (B, T, 2F) [re | im], mag (B, T, F) written when not null;
// otherwise x is an amplitude (B, T, F). out (B, T, F) written when not null.
extern "C" int spec_db_f32(const float* x, const int* frame_lengths, float* mag, float* out, int B,
                           int T, int F, int reim, float min_db, float ref_db, void* stream) {
  const long long n = (long long)B * T * F;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  spec_db_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, frame_lengths, mag, out, n, T,
                                                               F, reim, min_db, ref_db);
  return (int)cudaGetLastError();
}
