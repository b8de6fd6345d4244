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
// Outputs: context (B, D) and weights (B, L).
//
// What bounds it on an H100: bytes. At serving shapes (B=16, L=32, A=256,
// D=512, F=32, K=31) it reads ~1.6 MB (processed_memory and memory) and
// does ~11 MFLOP, so the floor is ~0.5 us of HBM time; the real cost is
// the launch and the dependent phases (conv -> energy -> softmax -> context).
//
// Design: one block per batch row, all phases in one launch, intermediates
// (location features, energies, weights) in shared memory only. The small
// location weights are staged in shared memory first (loc_lin transposed to
// (F, A) so a warp's lanes read neighbouring words): the phases are bound by
// the latency of dependent loads, and shared memory is the nearest store.
// Energies: one warp per position l, lanes over the attention dim (coalesced
// reads of processed_memory), shuffle reduction. Softmax: one warp over L,
// with -inf for masked positions. Context: threads over D (coalesced reads).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void attention_step_kernel(const float* __restrict__ pq, const float* __restrict__ pm,
                                      const float* __restrict__ memory,
                                      const float* __restrict__ hist,
                                      const float* __restrict__ loc_w,
                                      const float* __restrict__ loc_lin,
                                      const float* __restrict__ v,
                                      const unsigned char* __restrict__ mask,
                                      float* __restrict__ context, float* __restrict__ weights,
                                      int L, int A, int D, int C, int F, int K) {
  extern __shared__ float smem[];
  float* hist_s = smem;           // (C, L)
  float* locf = hist_s + C * L;   // (L, F)
  float* e = locf + L * F;        // (L) energies, then weights
  float* wloc = e + L;            // (F, C, K) loc_w
  float* lin_t = wloc + F * C * K;  // (F, A) loc_lin transposed
  __shared__ float stat[2];       // softmax max and sum
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int pad = (K - 1) / 2;

  for (int i = threadIdx.x; i < C * L; i += blockDim.x) hist_s[i] = hist[(size_t)b * C * L + i];
  for (int i = threadIdx.x; i < F * C * K; i += blockDim.x) wloc[i] = loc_w[i];
  for (int i = threadIdx.x; i < A * F; i += blockDim.x) lin_t[(i % F) * A + i / F] = loc_lin[i];
  __syncthreads();

  // location features: locf[l, f] = sum_c sum_k loc_w[f, c, k] * hist[c, l + k - pad]
  for (int i = threadIdx.x; i < L * F; i += blockDim.x) {
    const int l = i / F, f = i % F;
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float* w = wloc + (f * C + c) * K;
      for (int k = 0; k < K; ++k) {
        const int src = l + k - pad;
        if (src >= 0 && src < L) acc = fmaf(w[k], hist_s[c * L + src], acc);
      }
    }
    locf[i] = acc;
  }
  __syncthreads();

  // energies: e[l] = sum_a v[a] * tanh(pq[a] + loc[l, a] + pm[l, a])
  const float* pq_b = pq + (size_t)b * A;
  for (int l = warp; l < L; l += nwarps) {
    const float* pm_l = pm + ((size_t)b * L + l) * A;
    const float* lf = locf + l * F;
    float acc = 0.0f;
    for (int a = lane; a < A; a += 32) {
      float loc = 0.0f;
#pragma unroll 8
      for (int f = 0; f < F; ++f) loc = fmaf(lf[f], lin_t[f * A + a], loc);
      acc = fmaf(tanhf((pq_b[a] + loc) + pm_l[a]), v[a], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const bool masked = mask != nullptr && mask[(size_t)b * L + l];
      e[l] = masked ? -INFINITY : acc;
    }
  }
  __syncthreads();

  // softmax over L (one warp)
  if (warp == 0) {
    float m = -INFINITY;
    for (int l = lane; l < L; l += 32) m = fmaxf(m, e[l]);
    m = warp_max(m);
    float s = 0.0f;
    for (int l = lane; l < L; l += 32) s += expf(e[l] - m);
    s = warp_sum(s);
    if (lane == 0) { stat[0] = m; stat[1] = s; }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const float w = expf(e[l] - stat[0]) / stat[1];
    weights[(size_t)b * L + l] = w;
    e[l] = w;  // each thread rewrites only its own entries
  }
  __syncthreads();

  // context[d] = sum_l w[l] * memory[l, d]
  const float* mem_b = memory + (size_t)b * L * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.0f;
    for (int l = 0; l < L; ++l) acc = fmaf(e[l], mem_b[(size_t)l * D + d], acc);
    context[(size_t)b * D + d] = acc;
  }
}

}  // namespace

extern "C" int attention_step_f32(const float* pq, const float* pm, const float* memory,
                                  const float* hist, const float* loc_w, const float* loc_lin,
                                  const float* v, const unsigned char* mask,
                                  float* context, float* weights,
                                  int B, int L, int A, int D, int C, int F, int K, void* stream) {
  const size_t smem = (size_t)(C * L + L * F + L + F * C * K + F * A) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(attention_step_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  attention_step_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      pq, pm, memory, hist, loc_w, loc_lin, v, mask, context, weights, L, A, D, C, F, K);
  return (int)cudaGetLastError();
}
