// K6: CTC over the log-semiring lattice, one CTA per utterance.
//
// Replaces: B5, `semi_tts_tpu/ops/ctc.py`: `_alpha_pass` (`:63`, the
// forward recursion and the NLL), `_ctc_nll_bwd` (`:123`, the backward
// recursion, the occupancies and the one-hot gradient einsum) and
// `_logaddexp3` (`:34`). The lattice is z = (blank, y1, blank, ..., blank),
// S = 2U + 1 states; the skip s-2 -> s is allowed into label states whose
// label differs from the one two back; states past 2*target_len are dead.
//
// ctc_alpha: alphas (T, B, S) and nll (B,). Rows freeze past their input
//   length (alpha_t = alpha_{t-1}); nll = -logaddexp(alpha[2L], alpha[2L-1]).
// ctc_beta_grad: two kernels. ctc_beta: beta_t = term for t >= input_len - 1,
//   else the three-way log-add of the next step's (beta + emit), and the
//   occupancy exp(min(alpha + beta + nll, 0)) of each valid state, written
//   to a (T, B, S) scratch. ctc_grad: grad[b, t, c] = -g[b] * sum over the
//   valid states s with z_s = c of the occupancy, zero at t >= input_len and
//   for rows with nll >= 5e29 (an impossible alignment: P = 0).
//
// Every edge of the JAX version is kept: the -1e30 sentinel, the 1e-37
// clamp inside the log-add (a dead branch must not poison the sum), target
// length 0 (only the blank path), T = 1 (alphas are the first step; beta is
// the terminal vector).
//
// What bounds it on an H100: latency. A step is a handful of flops per
// state and T steps depend on each other; the bytes (log_probs once, alphas
// written and read back, the gradient) are ~1 MB at the flagship shapes
// (B=8, T=133, C=43, S<=65). Design: one CTA per utterance with one thread
// per lattice state; the lattice lives in shared memory, double-buffered so
// one __syncthreads a step is race-free; each thread loads the next step's
// emissions (and, backward, alphas) one step ahead. The gradient is not
// summed inside the recursion (a class's sum over states would lengthen
// every step of the chain): the occupancies go to a scratch buffer and a
// second, fully parallel kernel sums them, a thread per (row, step, class)
// adding its states in order of s, without atomics, so the result is
// deterministic.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const bool dead = m <= kNegInf / 2;
  const float ms = dead ? 0.0f : m;
  const float s = expf(a - ms) + expf(b - ms) + expf(c - ms);
  return dead ? kNegInf : ms + logf(fmaxf(s, 1e-37f));
}

// Extended label of state s (blank at even states).
__device__ __forceinline__ int label(const int* tgt, int s, int blank) {
  return (s & 1) ? tgt[(s - 1) >> 1] : blank;
}

__global__ void ctc_alpha_kernel(const float* __restrict__ log_probs, const int* __restrict__ targets,
                                 const int* __restrict__ input_lengths,
                                 const int* __restrict__ target_lengths, float* __restrict__ alphas,
                                 float* __restrict__ nll, int B, int T, int C, int U, int blank) {
  extern __shared__ float a_s[];  // (2, S)
  const int S = 2 * U + 1;
  const int b = blockIdx.x, s = threadIdx.x;
  const bool on = s < S;
  const int* tgt = targets + (size_t)b * U;
  const int tl = min(target_lengths[b], U), il = input_lengths[b];
  const int z = on ? label(tgt, s, blank) : blank;
  const bool valid = on && s < 2 * tl + 1;
  const bool skip = on && (s & 1) && s >= 2 && z != label(tgt, s - 2, blank);
  const float* lp = log_probs + (size_t)b * T * C;

  float a = kNegInf;
  if (s == 0) a = lp[blank];
  else if (s == 1) a = tl > 0 ? lp[z] : kNegInf;
  if (!valid) a = kNegInf;
  if (on) {
    a_s[s] = a;
    alphas[(size_t)b * S + s] = a;
  }
  float emit = (on && T > 1) ? lp[C + z] : 0.0f;
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const float* prev = a_s + ((t - 1) & 1) * S;
    float* next = a_s + (t & 1) * S;
    const float e = emit;
    if (on && t + 1 < T) emit = lp[(size_t)(t + 1) * C + z];
    if (on) {
      const float a0 = prev[s];
      const float a1 = s >= 1 ? prev[s - 1] : kNegInf;
      const float a2 = skip ? prev[s - 2] : kNegInf;
      float nw = valid ? logaddexp3(a0, a1, a2) + e : kNegInf;
      if (t >= il) nw = a0;  // the row's input has ended: frozen
      next[s] = nw;
      alphas[((size_t)t * B + b) * S + s] = nw;
    }
    __syncthreads();
  }
  if (s == 0) {
    const float* fin = a_s + ((T - 1) & 1) * S;
    const float a_end = fin[2 * tl];
    const float a_last = tl > 0 ? fin[2 * tl - 1] : kNegInf;
    const float m = fmaxf(a_end, a_last);
    nll[b] = -(m + log1pf(expf(-fabsf(a_end - a_last))));
  }
}

__global__ void ctc_beta_kernel(const float* __restrict__ log_probs, const int* __restrict__ targets,
                                const int* __restrict__ input_lengths,
                                const int* __restrict__ target_lengths,
                                const float* __restrict__ alphas, const float* __restrict__ nll,
                                float* __restrict__ occ, int B, int T, int C, int U, int blank) {
  extern __shared__ float b_s[];  // (2, S) betas
  const int S = 2 * U + 1;
  const int b = blockIdx.x, s = threadIdx.x;
  const bool on = s < S;
  const int* tgt = targets + (size_t)b * U;
  const int tl = min(target_lengths[b], U), il = input_lengths[b];
  const float nll_b = nll[b];
  const float* lp = log_probs + (size_t)b * T * C;

  auto valid_at = [&](int q) { return q < S && q < 2 * tl + 1; };
  const int z0 = on ? label(tgt, s, blank) : blank;
  const int z1 = s + 1 < S ? label(tgt, s + 1, blank) : blank;
  const int z2 = s + 2 < S ? label(tgt, s + 2, blank) : blank;
  const bool v0 = valid_at(s), v1 = valid_at(s + 1), v2 = valid_at(s + 2);
  // s -> s+2 is allowed iff the skip into s+2 is
  const bool skip_from = (s & 1) && s + 2 < S && z2 != z0;
  const int end = 2 * tl;
  const float term = (v0 && (s == end || (s == end - 1 && tl > 0))) ? 0.0f : kNegInf;

  // emissions of step t+1 and alphas of step t, loaded one step ahead
  float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f;
  float al = on ? alphas[((size_t)(T - 1) * B + b) * S + s] : 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const float ce0 = e0, ce1 = e1, ce2 = e2, cal = al;
    if (on && t > 0) {
      const float* row = lp + (size_t)t * C;  // the emissions that step t-1 needs
      e0 = row[z0];
      e1 = row[z1];
      e2 = row[z2];
      al = alphas[((size_t)(t - 1) * B + b) * S + s];
    }
    if (on) {
      float beta = term;
      if (t < T - 1 && t < il - 1) {
        const float* nx = b_s + ((t + 1) & 1) * S;
        const float x0 = v0 ? nx[s] + ce0 : kNegInf;
        const float x1 = v1 ? nx[s + 1] + ce1 : kNegInf;
        const float x2 = (skip_from && v2) ? nx[s + 2] + ce2 : kNegInf;
        beta = logaddexp3(x0, x1, x2);
      }
      b_s[(t & 1) * S + s] = beta;
      occ[((size_t)t * B + b) * S + s] = v0 ? expf(fminf(cal + beta + nll_b, 0.0f)) : 0.0f;
    }
    __syncthreads();
  }
}

// grad[b, t, c] = -g[b] * sum_{valid s, z_s = c} occ[t, b, s] for t < il and a
// finite nll, else 0: a thread per (t, c) of a row, states summed in order.
__global__ void ctc_grad_kernel(const int* __restrict__ targets, const int* __restrict__ input_lengths,
                                const int* __restrict__ target_lengths, const float* __restrict__ nll,
                                const float* __restrict__ g, const float* __restrict__ occ,
                                float* __restrict__ grad, int B, int T, int C, int U, int blank) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T * C) return;
  const int t = i / C, c = i - t * C;
  const int S = 2 * U + 1;
  const int tl = min(target_lengths[b], U);
  float out = 0.0f;
  if (t < input_lengths[b] && nll[b] < -kNegInf / 2) {
    const float* o = occ + ((size_t)t * B + b) * S;
    const int* tgt = targets + (size_t)b * U;
    float acc = 0.0f;
    for (int s = 0; s < 2 * tl + 1; ++s)
      if (label(tgt, s, blank) == c) acc += o[s];
    out = -acc * g[b];
  }
  grad[((size_t)b * T + t) * C + c] = out;
}

int threads_for(int n) { return (n + 31) / 32 * 32; }

}  // namespace

extern "C" int ctc_alpha_f32(const float* log_probs, const int* targets, const int* input_lengths,
                             const int* target_lengths, float* alphas, float* nll, int B, int T,
                             int C, int U, int blank, void* stream) {
  const int S = 2 * U + 1;
  if (B < 1 || T < 1 || U < 1 || S > kMaxThreads || blank < 0 || blank >= C)
    return (int)cudaErrorInvalidValue;
  ctc_alpha_kernel<<<B, threads_for(S), 2 * S * sizeof(float), (cudaStream_t)stream>>>(
      log_probs, targets, input_lengths, target_lengths, alphas, nll, B, T, C, U, blank);
  return (int)cudaGetLastError();
}

// occ (T, B, S) is scratch for the occupancies between the two kernels.
extern "C" int ctc_beta_grad_f32(const float* log_probs, const int* targets,
                                 const int* input_lengths, const int* target_lengths,
                                 const float* alphas, const float* nll, const float* g, float* occ,
                                 float* grad, int B, int T, int C, int U, int blank, void* stream) {
  const int S = 2 * U + 1;
  if (B < 1 || T < 1 || U < 1 || S > kMaxThreads || blank < 0 || blank >= C || B > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  ctc_beta_kernel<<<B, threads_for(S), 2 * S * sizeof(float), st>>>(
      log_probs, targets, input_lengths, target_lengths, alphas, nll, occ, B, T, C, U, blank);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T * C + 255) / 256, B);
  ctc_grad_kernel<<<grid, 256, 0, st>>>(targets, input_lengths, target_lengths, nll, g, occ, grad,
                                        B, T, C, U, blank);
  return (int)cudaGetLastError();
}
