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
//   the frame starts at t*hop in the signal reflect-padded by n_fft/2
//   around 0 and L, and idx is that padded position mapped back through
//   the reflection. (The augmented path clamps a start to S_pad - n_fft; a
//   kept frame never reaches it, as t*hop <= L <= S.) The padded signal is
//   never written to global memory. The window is multiplied here on both
//   paths (the DFT basis is unwindowed). hop and win come from a device
//   array, so a stretch rate drawn on the card needs no host round trip.
// spec_db: [re | im] (B, T, 2F) -> magnitude (B, T, F) and/or
//   normalize_db(amp_to_db(mag) - ref_db) over the floor min_db, zeroed at
//   t >= frame_lengths[b]; or an amplitude (B, T, F) -> the same dB output.
//   The caller passes the levels (-100 and 20 dB in `ops/features.py`).
//
// What bounds it on an H100: bytes. stft_frames writes B*T*span floats
// (10.36 MB at the flagship augmented shape, B=8 S=66150 T=267 span=1212)
// and reads the waves and the noise once (4.2 MB): 4.355 us at 3.35 TB/s.
// spec_db moves 35 MB with a few FLOPs an element.
//
// stft_frames: one CTA a tile of G consecutive frames of one row (a 1-D
// grid of B * ceil(T / G) CTAs: no limit on B * T; G from the plan, which
// balances the frames of the busiest SM: 6 at the augmented flagship
// shape). A tile's kept frames (t < 1 + L/hop) cover (kept - 1) * hop +
// span consecutive positions of the padded signal, which map back to a
// range of the row's samples (the interior, and the mirrors around 0 and
// L). The CTA
// 1. stages that sample range of the waves (and the noise) in shared
//    memory once, with 16-byte cp.async for the aligned interior and
//    scalar loads at its two ends, and makes the tile's Hann row
//    meanwhile, rounded as `dynamic_hann_window` rounds it;
// 2. makes the padded signal of the tile once a sample: noise mix, the
//    mask at L, pre-emphasis, then the reflection around 0 and around L, in
//    the plain version's order with rounded (never contracted) mul and add
//    (a tile with no mirror takes a path with no index mapping);
// 3. writes the frames, a thread a column of the tile's rows: its window
//    value is read once, and a warp's stores are 128 contiguous bytes.
// It is a programmatic dependent launch: its CTAs may be scheduled while
// the kernel ahead of it ends (they wait for that end before any load),
// which hides part of the launch.
// So a sample is read from global memory once a tile (not ~17 times, as by
// a thread an output element), the cosf runs once a CTA and column, and
// the tiles past a row's kept frames write zeros and load nothing. The
// kernel repeats the plain version bit for bit.
// hop and win stay on the device. The staging buffers are sized by the
// plan from `max_hop`, a host-side bound on hop (the hop at the highest
// stretch rate); a geom whose hop is past it or below 1, or a length
// below 0 or past S, traps on the device instead of reading past them.
// spec_db: one thread per output element, neighbouring threads on
// neighbouring bins.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The plan's shared memory, in floats: the Hann row, the tile's padded
// signal, then the staged waves (and noise). Every region starts 16-byte
// aligned.
__host__ __device__ constexpr int frames_smem_floats(int G, int span, int max_hop, int noisy) {
  const int W = (G - 1) * max_hop + span;  // padded positions of a tile
  const int R = round4(W + 8);             // its samples, one before, the alignment shift
  return round4(span) + round4(W) + (noisy ? 2 : 1) * R;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// dst[shift + k] = src[k] for k in [0, n), where shift (returned) puts dst
// at src's alignment mod 16 bytes: whole aligned chunks by cp.async, the
// partial chunks at the ends by scalar loads. Nothing outside src[0, n) is
// read. dst is 16-byte aligned.
__device__ __forceinline__ int stage_async(float* dst, const float* src, int n) {
  const int shift = (int)(((uintptr_t)src & 15) >> 2);
  const float* base = src - shift;
  for (int c = threadIdx.x; 4 * c < shift + n; c += blockDim.x) {
    const int k0 = 4 * c - shift;
    if (k0 >= 0 && k0 + 4 <= n) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst + 4 * c)),
                   "l"(base + 4 * c)
                   : "memory");
    } else {
      for (int j = 0; j < 4; ++j)
        if (k0 + j >= 0 && k0 + j < n) dst[4 * c + j] = src[k0 + j];
    }
  }
  return shift;
}

// Signal index of padded-signal index i (= p - pad) of a row of length L,
// reflected around 0 and around L; -1 past the right mirror. The value
// there is the row's sample when 0 <= index < L, else 0.
__device__ __forceinline__ int source_index(int i, int L, int pad) {
  if (i < 0) return -i;
  if (i < L) return i;
  if (i < L + pad) return L >= pad + 1 ? 2 * L - 2 - i : L + pad - 1 - i;  // start clamped at 0
  return -1;
}

__device__ __forceinline__ void add_range(int& lo, int& hi, int a, int e) {
  if (a < e) {
    lo = min(lo, a);
    hi = max(hi, e);
  }
}

// A tile: G consecutive frames [t0, t0 + rows) of row b, of which the first
// `kept` hold samples; they cover the W padded positions from signal index
// i0, which read the row's samples [lo, lo + n_raw).
struct Tile {
  int b, t0, L, rows, kept, i0, W, lo, n_raw;
  float m;  // the row's noise mix
};

__device__ __forceinline__ Tile make_tile(int tile, int L, const float* mix, int tiles, int G,
                                          int T, int S, int hop, int off, int span, int pad) {
  Tile tl;
  tl.b = tile / tiles;
  tl.m = mix != nullptr ? mix[tl.b] : 0.0f;
  tl.t0 = (tile - tl.b * tiles) * G;
  tl.L = L;
  if (L < 0 || L > S) __trap();
  tl.rows = min(G, T - tl.t0);
  tl.kept = max(0, min(tl.rows, 1 + L / hop - tl.t0));
  tl.W = (tl.kept - 1) * hop + span;
  tl.i0 = tl.t0 * hop + off - pad;
  const int i1 = tl.i0 + tl.W;
  // the interior, the mirrors, and one sample before each (pre-emphasis)
  int lo = L, hi = 0;
  if (tl.kept > 0) {
    if (tl.i0 < 0) add_range(lo, hi, 1 - min(i1, 0), 1 - tl.i0);
    add_range(lo, hi, max(tl.i0, 0), min(i1, L));
    const int ra = max(tl.i0, L), re = min(i1, L + pad);
    if (ra < re) {
      if (L >= pad + 1) add_range(lo, hi, 2 * L - 1 - re, 2 * L - 1 - ra);
      else add_range(lo, hi, L + pad - re, L + pad - ra);
    }
  }
  tl.lo = max(lo - 1, 0);
  tl.n_raw = max(min(hi, L) - tl.lo, 0);
  return tl;
}

// The tile's padded signal xs[0, W) from its staged samples (waves at
// rw + sw, noise at rz + sz): mix, mask, pre-emphasis, reflection.
__device__ __forceinline__ void padded_signal(float* xs, const Tile& tl, const float* rw,
                                              const float* rz, int sw, int sz, bool noisy,
                                              float m, float coeff, int pad) {
  const int tid = threadIdx.x, nt = blockDim.x, W = tl.W, L = tl.L;
  if (tl.i0 >= 1 && tl.i0 + W <= L) {  // the interior: no mirror, no mask, lo = i0 - 1
    if (noisy) {
      for (int j = tid; j < W; j += nt) {
        const float cur = __fadd_rn(rw[sw + j + 1], __fmul_rn(m, rz[sz + j + 1]));
        const float prev = __fadd_rn(rw[sw + j], __fmul_rn(m, rz[sz + j]));
        xs[j] = __fsub_rn(cur, __fmul_rn(coeff, prev));
      }
    } else {
      for (int j = tid; j < W; j += nt)
        xs[j] = __fsub_rn(rw[sw + j + 1], __fmul_rn(coeff, rw[sw + j]));
    }
    return;
  }
  for (int j = tid; j < W; j += nt) {
    const int idx = source_index(tl.i0 + j, L, pad);
    float v = 0.0f;
    if (idx >= 0 && idx < L) {
      const int k = idx - tl.lo;
      float cur = rw[sw + k];
      float prev = idx > 0 ? rw[sw + k - 1] : 0.0f;
      if (noisy) {
        cur = __fadd_rn(cur, __fmul_rn(m, rz[sz + k]));
        if (idx > 0) prev = __fadd_rn(prev, __fmul_rn(m, rz[sz + k - 1]));
      }
      v = idx > 0 ? __fsub_rn(cur, __fmul_rn(coeff, prev)) : cur;
    }
    xs[j] = v;
  }
}

// A CTA a tile: the row's length and the geometry, the tile's samples
// staged (cp.async) while the window row is made, the padded signal, then
// the frames.
__global__ void __launch_bounds__(kThreads)
stft_frames_kernel(const float* __restrict__ waves, const int* __restrict__ lengths,
                   const int* __restrict__ geom, const float* __restrict__ noise,
                   const float* __restrict__ mix, float* __restrict__ frames, int S, int T,
                   int n_fft, int off, int span, float coeff, int G, int max_hop, int tiles) {
  extern __shared__ __align__(16) float sm[];
  // a programmatic dependent launch: the CTAs may be resident before the
  // kernel ahead of them in the stream ends; nothing is read until it has
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int tid = threadIdx.x, nt = blockDim.x;
  const int hop = geom[0], win = geom[1];
  if (hop < 1 || hop > max_hop) __trap();
  const bool noisy = noise != nullptr;
  const int pad = n_fft / 2;
  const int W_max = (G - 1) * max_hop + span, R = round4(W_max + 8);
  float* hw = sm;                 // (span) the window over the support
  float* xs = hw + round4(span);  // (W) the tile's padded signal
  float* rw = xs + round4(W_max);  // (R) staged waves, then (R) staged noise
  const Tile tl = make_tile(blockIdx.x, lengths[blockIdx.x / tiles], mix, tiles, G, T, S, hop,
                            off, span, pad);
  float* out = frames + ((size_t)tl.b * T + tl.t0) * span;  // rows * span contiguous floats
  if (tl.kept == 0) {  // past the row's frames: zeros, no loads
    for (int n = tid; n < span; n += nt)
      for (int g = 0; g < tl.rows; ++g) out[(size_t)g * span + n] = 0.0f;
    return;
  }
  // 1. the tile's samples on their way; the window row meanwhile
  int sw = 0, sz = 0;
  if (tl.n_raw > 0) {
    if (tl.n_raw + 3 > R) __trap();
    sw = stage_async(rw, waves + (size_t)tl.b * S + tl.lo, tl.n_raw);
    if (noisy) sz = stage_async(rw + R, noise + (size_t)tl.b * S + tl.lo, tl.n_raw);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const int lead = (n_fft - win) / 2;
  for (int n = tid; n < span; n += nt) {  // rounded as the plain version rounds it
    const int k = off + n - lead;
    hw[n] = (k >= 0 && k < win)
                ? __fsub_rn(0.5f, __fmul_rn(0.5f, cosf(__fdiv_rn(__fmul_rn(6.2831855f, (float)k),
                                                                  (float)win))))
                : 0.0f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  // 2. the tile's padded signal, a sample at a time
  padded_signal(xs, tl, rw, rw + R, sw, sz, noisy, tl.m, coeff, pad);
  __syncthreads();
  // 3. the windowed frames: a thread a column of the tile's rows, its window
  // value read once; a warp's stores are 128 contiguous bytes of a row
  for (int n = tid; n < span; n += nt) {
    const float w = hw[n];
    for (int g = 0; g < tl.kept; ++g) out[(size_t)g * span + n] = __fmul_rn(xs[g * hop + n], w);
    for (int g = tl.kept; g < tl.rows; ++g) out[(size_t)g * span + n] = 0.0f;
  }
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

// frames (B, T, span); noise and mix may both be null (no mixing). The plan
// (`frames_plan` in kernels/features.py): `tile` frames a CTA, `threads`,
// `smem_bytes` as `frames_smem_floats` gives them for max_hop.
extern "C" int stft_frames_f32(const float* waves, const int* lengths, const int* geom,
                               const float* noise, const float* mix, float* frames, int B, int S,
                               int T, int n_fft, int off, int span, int max_hop, int tile,
                               int threads, int smem_bytes, float coeff, void* stream) {
  if (B < 1 || T < 1 || span < 1 || off < 0 || off + span > n_fft || max_hop < 1 || tile < 1 ||
      threads < 32 || threads > kThreads || threads % 32 != 0 ||
      (noise == nullptr) != (mix == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long floats = frames_smem_floats(tile, span, max_hop, noise != nullptr);
  const long long tiles = (T + tile - 1) / tile;
  if (4 * floats != smem_bytes || smem_bytes > kSmemLimit || B * tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stft_frames_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * tiles));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, stft_frames_kernel, waves, lengths, geom, noise, mix, frames, S, T,
                         n_fft, off, span, coeff, tile, max_hop, (int)tiles);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
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
